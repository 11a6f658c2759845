"""The paper's acoustic models (Section 2 / 3.2).

Student: 5x768 unidirectional LSTM over 192-d stacked log-mel features,
3,183 senone outputs, ~24M params.  Teacher: 5x768 *bidirectional* LSTM
(~78M).  No residuals/norms — the plain stacked-LSTM hybrid AM of 2019.

Parameter names follow the reference's param tree with ``.`` for ``/``:
``l{i}.wx`` / ``l{i}.wh`` / ``l{i}.b`` (``l{i}.fwd.*`` / ``l{i}.bwd.*``
for the biLSTM) and ``out`` (H * dirs, V).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import layers, recurrent

State = List[Tuple[torch.Tensor, torch.Tensor]]


def is_bidirectional(cfg) -> bool:
    """Single source of truth for the AM's directionality."""
    return any(m == "bilstm" for m in cfg.mixers())


def _lstm_params(d_in, d_h, generator, device) -> nn.ParameterDict:
    if generator is None:           # meta device: shapes only
        p = {"wx": torch.empty((d_in, 4 * d_h), device=device),
             "wh": torch.empty((d_h, 4 * d_h), device=device),
             "b": torch.empty((4 * d_h,), device=device)}
    else:
        p = recurrent.init_lstm(d_in, d_h, generator=generator,
                                device=device)
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in p.items()})


class LstmAM(nn.Module):
    """The AM as a module.  ``generator`` draws the random init (a CPU
    ``torch.Generator``); it may be None only on the ``meta`` device,
    where the module is a shape template for loading weights."""

    def __init__(self, cfg, *, device, generator: Optional[torch.Generator]):
        super().__init__()
        device = torch.device(device)
        if generator is None and device.type != "meta":
            raise ValueError("random init needs an explicit generator")
        self.cfg = cfg
        self.bidirectional = is_bidirectional(cfg)
        self.n_layers = cfg.n_layers
        d_h = cfg.lstm_hidden
        d_in = cfg.feat_dim
        for i in range(self.n_layers):
            if self.bidirectional:
                self.add_module(f"l{i}", nn.ModuleDict({
                    "fwd": _lstm_params(d_in, d_h, generator, device),
                    "bwd": _lstm_params(d_in, d_h, generator, device)}))
                d_in = 2 * d_h
            else:
                self.add_module(f"l{i}", _lstm_params(d_in, d_h, generator,
                                                      device))
                d_in = d_h
        d_out = d_h * (2 if self.bidirectional else 1)
        self.out = nn.Parameter(
            torch.empty((d_out, cfg.n_senones), device=device)
            if generator is None else
            layers.dense_init(d_out, cfg.n_senones, generator=generator,
                              device=device))

    @property
    def device(self) -> torch.device:
        return self.out.device

    def layer(self, i: int):
        return getattr(self, f"l{i}")

    def apply(self, feats: torch.Tensor, *, state: Optional[State] = None,
              lens: Optional[torch.Tensor] = None):
        """feats (B,T,F) -> (hidden (B,T,H), aux). state: list of (h,c).

        (Shadows ``nn.Module.apply``, as the reference names its forward.)
        lens (B,) optional valid lengths for padded batches: recurrent
        state freezes at each row's length and the backward direction of
        a biLSTM starts at the last valid frame.
        """
        x = feats
        new_state = []
        for i in range(self.n_layers):
            p = self.layer(i)
            if self.bidirectional:
                x = recurrent.bilstm_apply(p["fwd"], p["bwd"], x, lens=lens)
            else:
                x, st = recurrent.lstm_apply(
                    p, x, None if state is None else state[i], lens=lens)
                new_state.append(st)
        return x, {"state": None if self.bidirectional else new_state}

    def forward(self, feats: torch.Tensor, **kw):
        """``apply``, so that ``torch.func.functional_call`` can run the
        model on a state dict of other tensors (the trainer's params)."""
        return self.apply(feats, **kw)

    def unembed_matrix(self, params=None) -> torch.Tensor:
        """The (H * dirs, V) output matrix: ``params["out"]`` of a state
        dict, or the module's own."""
        return self.out if params is None else params["out"]

    def unembed(self, h: torch.Tensor) -> torch.Tensor:
        return (h @ self.out.to(h.dtype)).float()

    def logits(self, feats, state=None):
        h, aux = self.apply(feats, state=state)
        return self.unembed(h), aux

    def init_state(self, batch: int, dtype=torch.float32) -> Optional[State]:
        if self.bidirectional:
            return None
        h = self.cfg.lstm_hidden
        return [(torch.zeros((batch, h), dtype=dtype, device=self.device),
                 torch.zeros((batch, h), dtype=torch.float32,
                             device=self.device))
                for _ in range(self.n_layers)]

    # ------------------------------------------------- streaming surface
    # Chunked online inference: feeding an utterance in chunks, carrying
    # the per-layer (h, c) state across calls, equals one full apply().

    def init_stream_state(self, batch: int, dtype=torch.float32,
                          **_sizing) -> State:
        """Fresh per-stream recurrent state (batch = concurrent streams);
        sizing kwargs are accepted for surface uniformity and ignored."""
        if self.bidirectional:
            raise ValueError(
                "bidirectional AM has no streaming form; use the batched "
                "full-utterance path (serve.StreamingEngine.run)")
        return self.init_state(batch, dtype)

    def stream_step(self, state: State, feats: torch.Tensor, *,
                    lens: Optional[torch.Tensor] = None):
        """One streaming chunk: feats (B,T,F) -> (hidden (B,T,H), state);
        shorter streams' states freeze at their ``lens``."""
        h, aux = self.apply(feats, state=state, lens=lens)
        return h, aux["state"]

    def reset_stream_rows(self, state: State, rows: torch.Tensor) -> State:
        """Zero the (h, c) rows selected by the (B,) bool mask."""
        rows = rows.to(self.device)[:, None]
        return [tuple(torch.where(rows, torch.zeros((), dtype=a.dtype,
                                                    device=a.device), a)
                      for a in hc) for hc in state]

    def pull_stream_row(self, state: State, i: int):
        """Stream ``i``'s state row, as host tensors (detach: the serving
        layer parks it).  Round-trips bitwise through ``put_stream_row``."""
        return [tuple(a[i].cpu() for a in hc) for hc in state]

    def put_stream_row(self, state: State, i: int, row) -> State:
        """Write a pulled row back into slot ``i``, in place (the state
        tensors are the server's own), and return the state."""
        for hc, r in zip(state, row):
            for a, ra in zip(hc, r):
                a[i].copy_(ra)
        return state
