"""Request/response plumbing for the batched inference engines.

The queue is payload-agnostic: one request = one unit of work — a
(T, F) feature matrix for the acoustic model, a TokenRequest for the
token-LM decode surface.  It is deliberately simple and
single-threaded: the engine drains it in arrival order, the batcher
regroups for padding efficiency (or the continuous batcher admits the
queue head into freed decode slots mid-flight), and completion order is
therefore *not* arrival order — results are keyed by request id and the
queue tracks completeness so callers can assert nothing was dropped.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

import numpy as np


@dataclass
class InferenceRequest:
    """A single unit of work awaiting inference.

    ``payload`` is engine-defined (the feature engine stores a (T, F)
    float matrix; the token server stores its TokenRequest record).
    ``meta`` rides along untouched (e.g. the corpus utterance id for
    LogitStore bookkeeping).
    """
    rid: int
    payload: Any
    meta: dict = field(default_factory=dict)

    @property
    def feats(self) -> np.ndarray:
        """Feature-engine view of the payload."""
        return self.payload

    @property
    def length(self) -> int:
        return int(self.payload.shape[0])


@dataclass
class CompletedRequest:
    """Result record; ``result`` is engine-defined — the feature engine
    stores a (vals, idx) top-k pair, the token server its finished
    TokenRequest."""
    rid: int
    result: Any
    meta: dict = field(default_factory=dict)

    @property
    def vals(self) -> np.ndarray:          # (T, k) shifted logit values
        return self.result[0]

    @property
    def idx(self) -> np.ndarray:           # (T, k) int32 vocab indices
        return self.result[1]


class RequestQueue:
    """FIFO of pending requests + completion ledger.

    submit() assigns monotonically increasing rids; the engine pops
    pending work, fulfils it in any order, and ``complete()`` records
    results.  ``drained`` is True only when every submitted rid has a
    result — the completeness invariant the tests pin down.
    """

    # diagnostic ring: recent completion order only — bounded so the
    # queue's memory stays flat over engine uptime
    ORDER_RING = 4096

    def __init__(self):
        self._next_rid = 0
        self._pending: deque[InferenceRequest] = deque()
        self._in_flight: Dict[int, InferenceRequest] = {}
        self._done: Dict[int, CompletedRequest] = {}
        self._completion_order: deque[int] = deque(maxlen=self.ORDER_RING)

    def submit(self, payload: Any, meta: Optional[dict] = None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self._pending.append(
            InferenceRequest(rid, payload, dict(meta or {})))
        return rid

    def pop_pending(self, max_n: Optional[int] = None
                    ) -> List[InferenceRequest]:
        """Move up to max_n requests (all, if None) into the in-flight set."""
        out = []
        while self._pending and (max_n is None or len(out) < max_n):
            req = self._pending.popleft()
            self._in_flight[req.rid] = req
            out.append(req)
        return out

    def peek_pending(self) -> List[InferenceRequest]:
        """Read-only view of the pending queue in arrival order — the
        admission controller's pressure probe (no state change)."""
        return list(self._pending)

    def pop_pending_where(self, pred, max_n: Optional[int] = None
                          ) -> List[InferenceRequest]:
        """Move up to max_n requests satisfying ``pred`` into the
        in-flight set, scanning in arrival order.  Non-matching requests
        stay pending *in place* (order preserved) — the tier-aware
        admission hook: a shed firehose session is deferred, not
        dropped, and doesn't block the interactive session behind it."""
        out: List[InferenceRequest] = []
        keep: List[InferenceRequest] = []
        while self._pending:
            req = self._pending.popleft()
            if (max_n is None or len(out) < max_n) and pred(req):
                self._in_flight[req.rid] = req
                out.append(req)
            else:
                keep.append(req)
        self._pending.extend(keep)
        return out

    def complete(self, rid: int, result: Any):
        req = self._in_flight.pop(rid)
        self._done[rid] = CompletedRequest(rid, result, req.meta)
        self._completion_order.append(rid)

    def pop_completed(self) -> Dict[int, CompletedRequest]:
        """Hand over (and evict) every completed result.  The ledger must
        not grow with engine uptime — results live with the caller, not
        the queue (the firehose writes them straight to the LogitStore)."""
        done, self._done = self._done, {}
        return done

    def discard_pending(self) -> int:
        """Drop every pending request (recovery hygiene: a consumer
        starting a fresh self-contained drain must not inherit another
        call's queued work).  Returns the number discarded."""
        n = len(self._pending)
        self._pending.clear()
        return n

    def requeue(self, rids: Iterable[int]):
        """Move specific in-flight requests back to the head of the
        queue in rid (arrival) order — the round-forming hook: an engine
        that popped everything but can only serve a subset this round
        returns the rest without losing their place."""
        back = sorted((self._in_flight.pop(r) for r in rids),
                      key=lambda r: r.rid)
        self._pending.extendleft(reversed(back))

    def restore_in_flight(self):
        """Put popped-but-unfulfilled requests back at the head of the
        queue (rid order) — the engine's failure-recovery hook, so a
        forward error mid-drain never strands its sibling requests."""
        self.requeue(list(self._in_flight))

    @property
    def n_submitted(self) -> int:
        return self._next_rid

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    @property
    def n_in_flight(self) -> int:
        return len(self._in_flight)

    @property
    def n_completed(self) -> int:
        return len(self._done)

    @property
    def drained(self) -> bool:
        return not self._pending and not self._in_flight

    @property
    def completion_order(self) -> List[int]:
        return list(self._completion_order)
