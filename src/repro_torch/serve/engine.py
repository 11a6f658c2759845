"""Batched streaming-inference engine.

One engine, two consumers (the paper's framing: target generation *is*
inference-as-a-service):

  * **Teacher target generation** (paper §3.2.2): submit the unlabeled
    firehose as per-utterance requests; the batcher buckets them into
    padded batches (THROUGHPUT policy), one forward per batch emits
    top-k logits, and the caller drains the results.
  * **Online serving**: the same engine under a LATENCY policy, plus a
    slot-based *streaming* path that carries each stream's state across
    chunks (the LSTM's (h, c), or whisper's caches: one decode position
    a chunk).  ``feed_async``/``feed_pipelined`` keep a step's
    outputs on the device until the caller asks for them, so the next
    chunk is staged while the current step computes.

Length correctness is delegated to the model's ``lens`` support
(``models/recurrent.py``): padded rows freeze their recurrent state at
their true length and the biLSTM backward pass starts at the last valid
frame, so batched == sequential to fp tolerance.

Top-k emission is the logit-store codec, whose selection runs the Hopper
``topk_logits`` kernel on the card (its plain version only on a CPU
tensor).  It emits the wire format: max logit shifted to 0, bf16
values, int32 ids.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import logit_store as ls
from repro_torch.models import build_model
from repro_torch.models.api import (stream_feat_dim, stream_frame_sync,
                                    supports_streaming)
from repro_torch.serve.batcher import (THROUGHPUT, BatchPolicy,
                                       bucket_length, form_batches)
from repro_torch.serve.request import CompletedRequest, RequestQueue


def make_topk_emitter(k: int, impl: str = "kernel"):
    """logits (..., V) -> (vals (..., k) bf16 shifted, idx (..., k) i32).

    "kernel" is the only impl: selection goes through
    ``kernels/topk_logits``, and the tensor's device picks the CUDA
    kernel or its plain version.  The reference's "lax" has no
    counterpart here.
    """
    if impl != "kernel":
        raise ValueError(f"unknown topk impl {impl!r}")
    return lambda logits: ls.topk_compress(logits, k)


def serving_model(cfg, params, device):
    """The model for an engine: weights loaded from ``params`` on
    ``device``, gradients off, float32 matmuls in full precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(cfg, device=device, params=params)
    model.requires_grad_(False)
    return model


def to_host(vals: torch.Tensor, idx: torch.Tensor):
    """Device emissions -> numpy (vals as float32): the host sync."""
    return vals.float().cpu().numpy(), idx.cpu().numpy()


class StreamFeed:
    """Handle for a dispatched streaming step: holds the (still
    device-resident) padded outputs plus the chunk map needed to unpad.
    ``result()`` is the step's only host sync and is idempotent."""

    def __init__(self, vals, idx, chunk_lens: Dict[int, int]):
        """``chunk_lens``: {sid: output positions of the step} (the
        chunk's frames for the AM, 1 for whisper)."""
        self._vals, self._idx = vals, idx
        self._chunk_lens = chunk_lens
        self._out: Optional[dict] = None
        self._done = not chunk_lens

    def result(self) -> Dict[int, tuple]:
        """{sid: (vals (t, k), idx (t, k))} — blocks until the step's
        outputs are on host."""
        if self._done:
            return self._out or {}
        vals, idx = to_host(self._vals, self._idx)
        # copies, not views: accumulating consumers must not pin the
        # whole padded slot batch per chunk (same invariant as run())
        self._out = {sid: (vals[sid, :t].copy(), idx[sid, :t].copy())
                     for sid, t in self._chunk_lens.items()}
        self._vals = self._idx = None        # release the device refs
        self._done = True
        return self._out


class StreamingEngine:
    """Batched inference over an acoustic model with top-k emission.

    ``params`` is the model's state dict (``model.state_dict()`` or
    ``checkpoint.convert.params_from_numpy``); ``device`` defaults to
    ``cuda`` and raises without it.

    Batch path: ``submit()`` feature utterances, ``run()`` drains the
    queue through the policy's batcher.  Streaming path: ``open_stream``/
    ``feed``/``close_stream`` carry per-stream recurrent state across
    chunks (causal models only).
    """

    def __init__(self, cfg, params, *, k: int = 20, temperature: float = 1.0,
                 policy: BatchPolicy = THROUGHPUT, n_slots: int = 4,
                 topk_impl: str = "kernel", device=None):
        self.cfg = cfg
        self.model = serving_model(cfg, params, device)
        self.device = self.model.device
        self.k = k
        self.temperature = temperature
        self.policy = policy
        self.queue = RequestQueue()
        self._emit = make_topk_emitter(k, topk_impl)
        # ---- streaming slots
        self.n_slots = n_slots
        self._stream_state = None
        self._slot_free = list(range(n_slots))

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype).to(self.device,
                                                  non_blocking=True)

    # ------------------------------------------------------------ forwards

    def _batch_forward(self, feats, lens):
        h, _ = self.model.apply(feats, lens=lens)
        return self._emit(self.model.unembed(h) / self.temperature)

    def _stream_forward(self, state, feats, lens):
        h, new_state = self.model.stream_step(state, feats, lens=lens)
        vals, idx = self._emit(self.model.unembed(h) / self.temperature)
        return vals, idx, new_state

    # ---------------------------------------------------------- batch path

    def forward_topk(self, batch: dict):
        """One pre-formed batch -> device (vals, idx).  No queue, no
        padding bookkeeping.  ``batch["feats"]`` (B, T, F) with optional
        ``lens`` (B,), or a frame ``mask`` (B, T) from which lens are
        taken (without them the biLSTM backward pass would read the
        zero padding of partial chunks)."""
        lens = batch.get("lens")
        if lens is None and "mask" in batch:
            lens = self._tensor(batch["mask"]).sum(dim=-1).to(torch.int32)
        with torch.no_grad():
            return self._batch_forward(
                self._tensor(batch["feats"], torch.float32),
                None if lens is None else self._tensor(lens))

    def submit(self, feats: np.ndarray, meta: Optional[dict] = None) -> int:
        """Enqueue one (T, F) utterance; returns its request id.

        Shape is validated here, at the API boundary: a malformed
        request failing later inside run() would strand the valid
        requests batched alongside it.
        """
        if self.cfg.family != "lstm_am":
            raise ValueError(
                "the queued feature path is the acoustic-model surface; "
                "whisper streams through open_stream/feed or StreamServer")
        feats = np.asarray(feats)
        if feats.ndim != 2 or feats.shape[1] != self.cfg.feat_dim:
            raise ValueError(
                f"expected (T, {self.cfg.feat_dim}) features, got "
                f"{feats.shape}")
        return self.queue.submit(feats, meta)

    def run(self) -> Dict[int, CompletedRequest]:
        """Drain the queue: bucket, batch, forward, unpad, complete.

        Returns the results completed by *this* call, keyed by rid, and
        evicts them from the queue's ledger.
        """
        reqs = self.queue.pop_pending()
        try:
            for fb in form_batches(reqs, self.policy):
                with torch.no_grad():
                    vals, idx = self._batch_forward(
                        self._tensor(fb.feats), self._tensor(fb.lens))
                vals, idx = to_host(vals, idx)
                for i, r in enumerate(fb.requests):
                    # copy: a slice view would pin the whole padded batch
                    # array in the results ledger for its lifetime
                    self.queue.complete(r.rid, (vals[i, :r.length].copy(),
                                                idx[i, :r.length].copy()))
        except BaseException:
            # a failed forward must not strand its sibling requests:
            # everything unfulfilled goes back to pending for retry
            self.queue.restore_in_flight()
            raise
        return self.queue.pop_completed()

    # ------------------------------------------------------ streaming path

    def _ensure_stream_state(self):
        if self._stream_state is None:
            self._stream_state = self.model.init_stream_state(self.n_slots)

    def open_stream(self) -> int:
        """Claim a slot with fresh state; returns stream id.  The slot's
        row of every state buffer is zeroed (``reset_stream_rows``); the
        reference zeroes index ``sid`` of each buffer's first axis, which
        for whisper's layer-stacked caches is a layer of every stream."""
        if not supports_streaming(self.cfg):
            raise ValueError("model has no streaming form (bidirectional)")
        if not self._slot_free:
            raise RuntimeError("all stream slots busy")
        self._ensure_stream_state()
        sid = self._slot_free.pop(0)
        rows = torch.zeros((self.n_slots,), dtype=torch.bool)
        rows[sid] = True
        self._stream_state = self.model.reset_stream_rows(self._stream_state,
                                                          rows)
        return sid

    def close_stream(self, sid: int):
        if not 0 <= sid < self.n_slots or sid in self._slot_free:
            raise ValueError(f"stream {sid} is not open")
        self._slot_free.append(sid)
        self._slot_free.sort()

    def feed_async(self, chunks: Dict[int, np.ndarray]) -> "StreamFeed":
        """Stage and dispatch one batched streaming step without waiting
        for its results.

        The host->device copy and the step's kernels are queued on the
        current stream and return at once, so a caller that dispatches
        chunk *n+1* before collecting chunk *n*'s results
        (``StreamFeed.result()``) overlaps next-chunk host-side staging
        with the current step's device compute.  ``feed_pipelined`` is
        the packaged driver.

        A zero-frame ``(0, F)`` chunk is refused: it would write
        ``lens[sid] = 0`` and silently waste a batched step.  An empty
        ``chunks`` dict (e.g. every stream closed) is an explicit no-op
        — no step is dispatched.
        """
        if not chunks:
            return StreamFeed(None, None, {})
        chunks = {sid: np.asarray(c) for sid, c in chunks.items()}
        fd = stream_feat_dim(self.cfg)
        for sid, c in chunks.items():
            if not 0 <= sid < self.n_slots or sid in self._slot_free:
                raise ValueError(f"stream {sid} is not open")
            if c.ndim != 2 or c.shape[1] != fd:
                raise ValueError(
                    f"stream {sid}: expected (t, {fd}) chunk, got "
                    f"{c.shape}")
            if c.shape[0] == 0:
                raise ValueError(
                    f"stream {sid}: zero-frame chunk — skip the stream "
                    f"this step instead of feeding an empty chunk")
        self._ensure_stream_state()
        t_max = bucket_length(max(c.shape[0] for c in chunks.values()),
                              self.policy.bucket_multiple)
        feats = np.zeros((self.n_slots, t_max, fd), np.float32)
        lens = np.zeros((self.n_slots,), np.int32)
        for sid, c in chunks.items():
            feats[sid, :c.shape[0]] = c
            lens[sid] = c.shape[0]
        with torch.no_grad():
            vals, idx, self._stream_state = self._stream_forward(
                self._stream_state, self._tensor(feats), self._tensor(lens))
        frame_sync = stream_frame_sync(self.cfg)
        return StreamFeed(vals, idx,
                          {sid: c.shape[0] if frame_sync else 1
                           for sid, c in chunks.items()})

    def feed(self, chunks: Dict[int, np.ndarray]):
        """One batched streaming step over all active streams.

        chunks: {sid: (t, F)} — chunk lengths may differ per stream
        (each stream's state freezes at its own valid length); every
        chunk must have at least one frame.  Returns
        {sid: (vals (t, k), idx (t, k))}, t the chunk's frames for the
        frame-synchronous AM and 1 for whisper.  Synchronous wrapper over
        ``feed_async``.
        """
        return self.feed_async(chunks).result()

    def feed_pipelined(self, chunk_iter, *, depth: int = 2):
        """Drive ``feed_async`` over an iterator of chunk dicts with a
        ``depth``-deep in-flight window, yielding each step's results in
        order.  Results are identical to sequential ``feed()`` calls."""
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        pending: deque = deque()
        for chunks in chunk_iter:
            pending.append(self.feed_async(chunks))
            while len(pending) >= depth:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
