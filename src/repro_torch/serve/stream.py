"""Slot-based continuous batching for the streaming-AM serving surface.

``StreamingEngine``'s ``open_stream``/``feed``/``close_stream`` loop is
lockstep: every caller synchronizes every chunk, and a slow stream
stalls the batch.  ``StreamServer`` is the same workload as a session
type of the ``serve.slots.SlotServer`` core:

  * one session = one long-running audio stream; each slot carries the
    stream's recurrent state row (LSTM (h, c), or whisper's chunked
    encoder and incremental-decoder state);
  * a window step consumes one ``chunk_frames`` feature chunk per row —
    ragged per-stream consumption (a stream's last chunk may be short,
    a starved stream's row runs dead at lens 0);
  * emissions (top-k posteriors per frame for the AM, one decode
    position per chunk for whisper) stay on the device across the
    window's ``kw`` chunk steps and come to the host in one transfer —
    one host sync per window, not one per chunk;
  * streams **attach and detach mid-flight**: ``detach`` pulls the
    slot's state row to the host and frees the slot for queued work;
    ``reattach`` queues the stream for re-admission, and its row is
    restored bitwise — an interrupted stream emits exactly what an
    uninterrupted one would.  SLO admission control (``TieredPolicy``)
    parks preemptible (firehose) streams through the same mechanism
    when interactive streams are waiting.

Work accounting is in *frames*: ``useful_units`` counts frames streams
actually consumed, ``padded_units`` counts ``slots x window x chunk``
frames the padded batch computed.  Whisper's cross-attention buffers
hold ``max_frames`` frames a stream, and ``submit`` and ``append``
refuse audio past them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.api import (stream_feat_dim, stream_frame_sync,
                                    supports_streaming)
from repro_torch.serve.engine import make_topk_emitter, serving_model, to_host
from repro_torch.serve.slots import SlotServer


@dataclass
class StreamSession:
    """One audio stream's host-side record (the slot payload)."""
    rid: int
    feats: np.ndarray               # (T, F) frames submitted so far
    closed: bool = True             # no more audio will arrive
    consumed: int = 0               # frames fed to the model
    out: List[tuple] = field(default_factory=list)  # per-chunk (vals, idx)
    done: bool = False
    finished_sync: int = -1         # pump index at completion (-1 in flight)
    tier: Optional[str] = None      # SLO tier name (None = default tier)
    parked_state: Any = None        # host copy of the state row (detached)

    def emissions(self):
        """Concatenated (vals (T_out, k), idx (T_out, k)) over every
        chunk emitted so far."""
        if not self.out:
            return (np.zeros((0, 0), np.float32), np.zeros((0, 0), np.int32))
        return (np.concatenate([v for v, _ in self.out], axis=0),
                np.concatenate([i for _, i in self.out], axis=0))


class StreamServer(SlotServer):
    """Continuous batcher over the model streaming surface
    (``init_stream_state`` / ``stream_step`` / ``reset_stream_rows``).

    ``params`` is the model's state dict; ``device`` defaults to
    ``cuda`` and raises without it.  ``max_frames`` and ``state_dtype``
    size whisper's streaming state (the AM's has no cap).

    ``submit(feats)`` enqueues a finite stream (audio known up front —
    the firehose shape); ``submit(feats, final=False)`` opens a live
    stream the caller extends with ``append`` and ends with ``close``.
    ``pump()`` runs one sync window and returns the sessions that
    finished; ``drain()`` pumps until nothing is pending (every live
    stream must be ``close``d first or drain would spin forever —
    refused loudly).
    """

    def __init__(self, cfg, params, *, n_slots: int = 4,
                 chunk_frames: int = 16, sync_every: int = 4,
                 k: int = 20, temperature: float = 1.0,
                 tiers=None, topk_impl: str = "kernel", device=None,
                 max_frames: int = 256, state_dtype=torch.float32):
        if not supports_streaming(cfg):
            raise ValueError(f"{cfg.name} has no streaming form "
                             "(bidirectional AM / decoder-only LM)")
        if chunk_frames < 1:
            raise ValueError("chunk_frames must be >= 1")
        self.cfg = cfg
        self.model = serving_model(cfg, params, device)
        self.device = self.model.device
        self.chunk = int(chunk_frames)
        self.k = k
        self.temperature = temperature
        self.frame_sync = stream_frame_sync(cfg)
        self.feat_dim = stream_feat_dim(cfg)
        # whisper's cross-attention buffers cap a stream's audio; the
        # frame-synchronous AM's O(1) state has no cap
        self.max_frames = None if self.frame_sync else int(max_frames)
        self.state_dtype = state_dtype
        super().__init__(n_slots, sync_every=sync_every, tiers=tiers)
        self._emit = make_topk_emitter(k, topk_impl)
        self._state = None                       # device state (lazy)
        self._fresh: List[int] = []              # slots to zero-reset
        self._restores: Dict[int, Any] = {}      # slot -> host state row

    # -------------------------------------------------------------- window

    def _window(self, feats: torch.Tensor, lens: torch.Tensor):
        """kw stream steps: feats (kw, B, chunk, F) / lens (kw, B) run
        through ``stream_step`` in turn, the top-k emissions staying on
        the device.  Returns (vals (kw, B, t_out, k), idx): t_out is the
        chunk for the AM, 1 for whisper."""
        vals, idx = [], []
        for f, n in zip(feats, lens):
            h, self._state = self.model.stream_step(self._state, f, lens=n)
            v, i = self._emit(self.model.unembed(h) / self.temperature)
            vals.append(v)
            idx.append(i)
        return torch.stack(vals), torch.stack(idx)

    # ------------------------------------------------------------- submit

    def _validate_feats(self, feats, *, base: int = 0) -> np.ndarray:
        feats = np.asarray(feats, np.float32)
        if feats.ndim != 2 or feats.shape[1] != self.feat_dim:
            raise ValueError(f"expected (T, {self.feat_dim}) features, "
                             f"got {feats.shape}")
        if self.max_frames is not None \
                and base + feats.shape[0] > self.max_frames:
            raise ValueError(
                f"stream would hold {base + feats.shape[0]} frames > "
                f"max_frames ({self.max_frames}) — the enc-dec streaming "
                f"state's cross-attention buffer capacity")
        return feats

    def submit(self, feats: np.ndarray, *, final: bool = True,
               tier: Optional[str] = None) -> int:
        """Enqueue a stream.  ``final=True``: the audio is complete and
        the session retires once it's consumed.  ``final=False``: a live
        stream — feed more with ``append(rid, ...)``, end with
        ``close(rid)``; until then its slot idles (dead row) whenever it
        runs out of submitted frames."""
        feats = self._validate_feats(feats)
        if final and feats.shape[0] < 1:
            raise ValueError("a final stream needs at least one frame")
        if self.tiers is not None:
            self.tiers.tier(tier)       # unknown tier names fail loudly
        s = StreamSession(-1, feats, closed=final, tier=tier)
        s.rid = self.queue.submit(s)
        return s.rid

    def _find(self, rid: int) -> StreamSession:
        for req in self._slots:
            if req is not None and req.rid == rid:
                return req.payload
        for req in self.queue.peek_pending():
            if req.rid == rid:
                return req.payload
        held = self.queue._in_flight.get(rid)
        if held is not None:
            return held.payload
        raise KeyError(f"stream {rid} is not live")

    def append(self, rid: int, feats: np.ndarray):
        """Extend a live stream's audio (any attachment state)."""
        s = self._find(rid)
        if s.closed:
            raise ValueError(f"stream {rid} is closed")
        feats = self._validate_feats(feats, base=s.feats.shape[0])
        s.feats = np.concatenate([s.feats, feats], axis=0)

    def close(self, rid: int):
        """Mark a live stream complete; it retires once consumed."""
        s = self._find(rid)
        s.closed = True

    # ----------------------------------------------------- detach/reattach

    def detach(self, rid: int):
        """Pull a stream out of its slot mid-flight: its state row goes
        to the host, the slot frees for queued work, and the session is
        *held* (neither pending nor active) until ``reattach``."""
        for i, req in enumerate(self._slots):
            if req is not None and req.rid == rid:
                req.payload.parked_state = self.model.pull_stream_row(
                    self._state, i)
                self._slots[i] = None
                self.stats["parked"] += 1
                return
        raise KeyError(f"stream {rid} is not attached")

    def _held_rids(self) -> List[int]:
        """Detached sessions: in-flight in the queue but holding no slot
        (waiting for an explicit ``reattach``)."""
        slotted = {req.rid for req in self._slots if req is not None}
        return [rid for rid in self.queue._in_flight if rid not in slotted]

    def reattach(self, rid: int):
        """Queue a detached stream for re-admission; its state row is
        restored bitwise when a slot frees."""
        if rid not in self._held_rids():
            raise ValueError(f"stream {rid} is not detached")
        self.queue.requeue([rid])

    def _park_slot(self, i: int) -> bool:
        """SLO preemption: detach the (preemptible) stream and requeue
        it — unlike ``detach``, it re-admits automatically once
        interactive pressure clears."""
        req = self._slots[i]
        if self._state is None:
            return False
        req.payload.parked_state = self.model.pull_stream_row(self._state, i)
        self._slots[i] = None
        self.queue.requeue([req.rid])
        return True

    # ----------------------------------------------------------- slot hooks

    def _ensure_state(self):
        if self._state is None:
            kw = {} if self.frame_sync else \
                {"max_frames": self.max_frames,
                 "max_tokens": self.max_frames}
            self._state = self.model.init_stream_state(
                self.b, self.state_dtype, **kw)

    def _admit_slot(self, slot: int, req) -> bool:
        s = req.payload
        if s.parked_state is not None:
            self._restores[slot] = s.parked_state   # bitwise row restore
            s.parked_state = None
        else:
            self._fresh.append(slot)                # zero-reset the row
        return True

    def _retire_slot(self, slot: int):
        pass        # state rows are zeroed on the *next* admission

    def _pre_window(self, admitted: List[int]):
        self._ensure_state()
        if self._fresh:
            mask = np.zeros((self.b,), bool)
            mask[self._fresh] = True
            self._state = self.model.reset_stream_rows(
                self._state, torch.from_numpy(mask))
            self._fresh = []
        for slot, row in self._restores.items():
            self._state = self.model.put_stream_row(self._state, slot, row)
        self._restores = {}

    def _run_window(self, kw: int):
        feats = np.zeros((kw, self.b, self.chunk, self.feat_dim),
                         np.float32)
        lens = np.zeros((kw, self.b), np.int32)
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            s = req.payload
            c = s.consumed
            for j in range(kw):
                n = min(self.chunk, s.feats.shape[0] - c)
                if n <= 0:
                    break               # starved/finished: dead row
                feats[j, i, :n] = s.feats[c:c + n]
                lens[j, i] = n
                c += n
        with torch.no_grad():
            vals, idx = self._window(
                torch.from_numpy(feats).to(self.device, non_blocking=True),
                torch.from_numpy(lens).to(self.device, non_blocking=True))
        vals, idx = to_host(vals, idx)      # THE sync of this window
        return vals, idx, lens

    def _consume(self, i: int, req, emitted, kw: int):
        vals, idx, lens = emitted
        s = req.payload
        live = useful = 0
        for j in range(kw):
            n = int(lens[j, i])
            if n > 0:
                live += 1
                useful += n
                t_out = n if self.frame_sync else 1
                # copies: the results ledger must not pin the window batch
                s.out.append((vals[j, i, :t_out].copy(),
                              idx[j, i, :t_out].copy()))
                s.consumed += n
        if s.closed and s.consumed >= s.feats.shape[0]:
            s.done = True
        return live, useful

    def _padded_units(self, kw: int) -> int:
        return kw * self.chunk          # frames one slot computed

    def _reset_payload(self, payload):
        # abort hygiene: device state is gone, so the stream restarts
        # from frame 0 on re-admission
        payload.out.clear()
        payload.consumed = 0
        payload.done = False
        payload.parked_state = None

    def _drop_state(self):
        self._state = None
        self._fresh = []
        self._restores = {}

    def drain(self):
        live = [req.rid for req in (list(self._slots)
                                    + self.queue.peek_pending())
                if req is not None and not req.payload.closed]
        if live:
            raise RuntimeError(
                f"drain() with open streams {live}: close() them or keep "
                f"pump()ing — draining an open stream would spin forever")
        held = self._held_rids()
        if held:
            raise RuntimeError(
                f"drain() with detached streams {held}: reattach() them "
                f"first — a held stream never completes on its own")
        return super().drain()
