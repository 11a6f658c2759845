"""Continuous-batching decode engine for the token-LM serving surface.

The model's ``init_cache(per_row=True)`` carries one int32 position per
batch row, so rows of one batch may sit at different sequence positions.
``TokenServer`` uses that as a slot-based continuous batcher:

  * each of ``policy.max_batch`` device slots holds one in-flight
    request; a newly admitted request's row is zeroed
    (``model.reset_cache_rows``) and then consumes its own prompt
    token-by-token through the decode path at its own position — ragged
    batched prefill, no equal-length grouping, no head-of-line blocking;
  * rows retire individually on their own ``max_new`` (or ``eos_id``)
    and their slot is re-admitted from the queue mid-flight, while the
    other rows keep decoding;
  * a window is ``sync_every`` decode steps whose emissions stay in a
    (k, B) device buffer — the host syncs **once per window**, at the
    window's single transfer, and does all admit/retire bookkeeping at
    that cadence.  Nothing inside the step loop reads a device value on
    the host.

Rows are row-pure (a row only reads its own cache row), so a retired
slot overshooting until the next sync is waste, not corruption — the
host discards tokens past the request's retirement point and the cost
accounting (``stats["active_slot_steps"]``) excludes them.

Per-request sampling (``submit(..., sampling=SamplingParams(...))``)
runs through a second window that draws Gumbel-max samples per step —
still one host sync per window.  Greedy-only windows keep bitwise
argmax.  With ``decode_kernel=True`` the attention tail is the fused
``decode_attention`` op and next-token selection the fused
``topk_sample`` op (the Hopper kernels on the card, their plain versions
on the host); rows whose ``top_k`` the sampler's candidate set can't
honor take the full-vocab sampler in a mixed window.

Ported from the reference: the contiguous cache only (``paging=``
raises: ``models/paging.py`` and ``serve/paging.py`` are not ported),
and not ``RoundTokenServer``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.launch.steps import make_serve_step
from repro_torch.models import build_model
from repro_torch.serve.batcher import LATENCY, BatchPolicy
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.slots import SlotServer

_PAGED = ("paged KV caches are not ported yet (models/paging.py, "
          "serve/paging.py: ROADMAP Queue 1, step 10b)")


@dataclass
class TokenRequest:
    rid: int
    prompt: np.ndarray              # (L,) int32
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False
    finished_sync: int = -1         # pump index at completion (latency
                                    # accounting; -1 while in flight)
    sampling: Optional[SamplingParams] = None   # None = greedy
    tier: Optional[str] = None      # SLO tier name (None = default tier)


def _validate_submit(prompt, max_new, max_seq):
    prompt = np.asarray(prompt, np.int32)
    if prompt.ndim != 1 or prompt.shape[0] < 1:
        raise ValueError(
            f"expected a non-empty 1-D token prompt, got shape "
            f"{prompt.shape}")
    if max_new < 1:
        raise ValueError("max_new must be >= 1")
    if prompt.shape[0] + max_new - 1 > max_seq:
        # a request consumes plen prefill entries + (max_new - 1) decode
        # entries (the last token is emitted without being fed back);
        # past max_seq the cache position would wrap its ring silently —
        # refuse rather than return corrupted output
        raise ValueError(
            f"prompt ({prompt.shape[0]}) + max_new ({max_new}) needs "
            f"{prompt.shape[0] + max_new - 1} cache entries > max_seq "
            f"({max_seq})")
    return prompt


class TokenServer(SlotServer):
    """Slot-based continuous batcher over the per-row decode surface —
    the token-decode session type of the ``serve.slots.SlotServer``
    core.

    ``params`` is the model's state dict (tensors already on ``device``
    in float32 are used in place, so servers can share weights);
    ``device`` defaults to ``cuda`` and raises without it.  ``pump()``
    runs one sync window and returns the requests it completed;
    ``drain()`` pumps until the queue is empty.  ``policy`` sets the
    slot count (``max_batch``) and the default sync cadence
    (``sync_every``); ``tiers=TieredPolicy(...)`` makes the window
    length and admission SLO-aware (``submit(..., tier=...)``).
    """

    def __init__(self, cfg, params, *, policy: BatchPolicy = LATENCY,
                 max_seq: int = 256, cache_dtype=torch.bfloat16,
                 sync_every: Optional[int] = None,
                 eos_id: Optional[int] = None, paging=None,
                 decode_kernel: bool = False, tiers=None, device=None):
        if cfg.family == "lstm_am":
            raise ValueError("TokenServer is the token-LM decode surface; "
                             "acoustic models go through StreamingEngine")
        if paging is not None:
            raise NotImplementedError(_PAGED)
        self.cfg = cfg
        self.decode_kernel = decode_kernel
        torch.backends.cuda.matmul.allow_tf32 = False
        self.model = build_model(cfg, device=device, params=params,
                                 decode_kernel=decode_kernel)
        self.model.requires_grad_(False)
        self.device = self.model.device
        self.max_seq = max_seq
        self.cache_dtype = cache_dtype
        super().__init__(policy.max_batch,
                         sync_every=int(sync_every if sync_every is not None
                                        else policy.sync_every),
                         tiers=tiers)
        self.eos_id = eos_id
        self.serve = self._make_window(self.sync_every)
        self._windows = {}              # (k, mode) -> window
        # device state (built on the first pump)
        self._cache = None
        self._tok = None
        self._prompts_d = None          # device prompt buffer / lens,
        self._plens_d = None            # refreshed on admission only
        # host-side slot mirrors
        self._pos = np.zeros((self.b,), np.int64)       # tokens consumed
        self._prompts = np.zeros((self.b, self.max_seq), np.int32)
        self._plens = np.zeros((self.b,), np.int32)
        # per-row sampling knobs (greedy defaults; refreshed on admission)
        self._temp = np.zeros((self.b,), np.float32)
        self._topk = np.zeros((self.b,), np.int32)
        self._topp = np.ones((self.b,), np.float32)
        self._seed = np.zeros((self.b,), np.int32)
        self.stats["tokens_out"] = 0

    # -------------------------------------------------------------- window

    def _make_window(self, k: int, mode: str = "greedy"):
        """k decode steps: each row feeds its own prompt token while
        ``pos < plen`` (ragged prefill) and its last sampled token after;
        emissions accumulate on the device as a (k, B) tensor.

        ``mode`` picks the per-step sampler: ``greedy`` (bitwise argmax),
        ``sample`` (per-row knobs), or ``mixed`` (fused sampler with the
        argsort fallback for rows whose top_k exceeds the kernel's
        candidate set)."""
        sample = mode != "greedy"
        serve_step = make_serve_step(self.model, self.cfg,
                                     greedy=not sample,
                                     use_kernel=self.decode_kernel,
                                     wide_fallback=mode == "mixed")

        def window(cache, tok, prompts, plens, samp=None):
            pmax = prompts.shape[1]
            emitted = []
            for _ in range(k):
                pos = cache["pos"]                       # (B,) per-row
                ptok = prompts.gather(
                    1, torch.clamp(pos, max=pmax - 1).long()[:, None])
                feed = torch.where((pos < plens)[:, None], ptok, tok)
                if sample:
                    tok, _, cache = serve_step(cache, feed, samp)
                else:
                    tok, _, cache = serve_step(cache, feed)
                emitted.append(tok[:, 0])
            return cache, tok, torch.stack(emitted)      # emitted (k, B)
        return window

    def _get_window(self, k: int, mode: str):
        """The window for this pump: the default greedy one is ``serve``
        (the failure-injection seam the tests patch); other lengths and
        modes are built once per distinct (k, mode)."""
        if k == self.sync_every and mode == "greedy":
            return self.serve
        if (k, mode) not in self._windows:
            self._windows[(k, mode)] = self._make_window(k, mode)
        return self._windows[(k, mode)]

    # -------------------------------------------------------------- submit

    def submit(self, prompt: np.ndarray, max_new: int = 16,
               sampling: Optional[SamplingParams] = None,
               tier: Optional[str] = None) -> int:
        prompt = _validate_submit(prompt, max_new, self.max_seq)
        if self.tiers is not None:
            self.tiers.tier(tier)       # unknown tier names fail loudly
        req = TokenRequest(-1, prompt, max_new, sampling=sampling,
                           tier=tier)
        req.rid = self.queue.submit(req)
        return req.rid

    # ---------------------------------------------------------- slot hooks

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _ensure_device_state(self):
        if self._cache is None:
            self._cache = self.model.init_cache(
                self.b, self.max_seq, self.cache_dtype, per_row=True)
            self._tok = torch.zeros((self.b, 1), dtype=torch.int32,
                                    device=self.device)

    def _admit_slot(self, slot: int, req) -> bool:
        """Install one request's host mirrors."""
        r = req.payload
        self._pos[slot] = 0
        self._prompts[slot] = 0
        self._prompts[slot, :r.prompt.shape[0]] = r.prompt
        self._plens[slot] = r.prompt.shape[0]
        s = r.sampling or SamplingParams()
        self._temp[slot] = s.temperature
        self._topk[slot] = s.top_k
        self._topp[slot] = s.top_p
        self._seed[slot] = np.int32(np.uint32(s.seed & 0xFFFFFFFF))
        return True

    def _reset_payload(self, payload):
        payload.out.clear()
        payload.done = False

    def _drop_state(self):
        """Abort hygiene (as StreamServer's): device state dropped, host
        mirrors zeroed."""
        self._plens[:] = 0
        self._pos[:] = 0
        self._cache = None
        self._tok = None
        self._prompts_d = None
        self._plens_d = None

    def _pre_window(self, admitted: List[int]):
        self._ensure_device_state()
        if admitted:
            mask = np.zeros((self.b,), bool)
            mask[admitted] = True
            self._cache = self.model.reset_cache_rows(self._cache,
                                                      self._upload(mask))
            # prompts/plens only change on admission: refresh the device
            # copies here, not once per window (a retired slot's stale
            # device plen is harmless — the row is garbage until its next
            # admission re-uploads)
            self._prompts_d = self._upload(self._prompts)
            self._plens_d = self._upload(self._plens)

    def _window_mode(self) -> str:
        """greedy | sample | mixed, from the rows actually in flight.
        ``mixed`` (fused sampler + per-row argsort fallback) only when a
        fused server holds a row whose top_k its candidate set can't
        honor — greedy-only windows stay on bitwise argmax."""
        sampled = [req.payload.sampling for req in self._slots
                   if req is not None and req.payload.sampling is not None
                   and not req.payload.sampling.greedy]
        if not sampled:
            return "greedy"
        if self.decode_kernel:
            from repro_torch.kernels.topk_sample import K_CAP_DEFAULT
            if any(s.top_k <= 0 or s.top_k > K_CAP_DEFAULT
                   for s in sampled):
                return "mixed"
        return "sample"

    def _run_window(self, k: int) -> np.ndarray:
        mode = self._window_mode()
        win = self._get_window(k, mode)
        args = (self._cache, self._tok, self._prompts_d, self._plens_d)
        with torch.no_grad():
            if mode == "greedy":
                cache, tok, emitted = win(*args)
            else:
                samp = {"temperature": self._upload(self._temp),
                        "top_k": self._upload(self._topk),
                        "top_p": self._upload(self._topp),
                        "seed": self._upload(self._seed)}
                cache, tok, emitted = win(*args, samp)
        emitted = emitted.cpu().numpy()      # THE host sync of this window
        self._cache, self._tok = cache, tok
        return emitted

    def _consume(self, i: int, req, emitted, k: int):
        p0 = int(self._pos[i])
        self._pos[i] += k
        r = req.payload
        plen = int(self._plens[i])
        live = 0
        for j in range(k):
            if r.done:          # overshoot past retirement: excluded
                break           # from cost, tokens discarded
            live += 1
            g = p0 + j - (plen - 1)     # generated-token index
            if g < 0:                   # still consuming the prompt
                continue
            t = int(emitted[j, i])
            r.out.append(t)
            self.stats["tokens_out"] += 1
            if (self.eos_id is not None and t == self.eos_id) \
                    or len(r.out) >= r.max_new:
                r.done = True
        # useful == live: prefill consumption and kept generations are
        # both requested work; only post-retirement overshoot is waste
        return live, live

    def _retire_slot(self, i: int):
        self._plens[i] = 0
        self._temp[i] = 0.0          # stale rows back to cheap argmax

    def slot_positions(self):
        """(host, device) consumed-token positions for debugging and the
        slot-invariant test; device is None before the first pump (and
        reading it is a host sync)."""
        host = self._pos.copy()
        dev = (self._cache["pos"].cpu().numpy() if self._cache is not None
               else None)
        return host, dev
