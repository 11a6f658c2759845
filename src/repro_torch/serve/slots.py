"""Generic slot-based session core of the serving surfaces (host-only;
the port's copy of the reference's ``serve/slots.py``).

Token-LM decode and the streaming acoustic model are the same machine
underneath: ``n_slots`` device rows, each holding one long-lived
*session* (a decode request, a live audio stream), with

  * **mid-flight admission** — a retired/parked slot re-admits the
    queue head while the other rows keep working (no head-of-line
    drain barriers);
  * a **windowed pump**: ``sync_every`` fused device steps per host
    sync, with emissions accumulating in a device-side buffer — the
    host does all admit/retire bookkeeping at window cadence, O(steps/K)
    transfers instead of one per step;
  * **failure recovery** (``_abort``) — a failed window must never
    strand its sessions: outputs reset, sessions requeued, device state
    dropped;
  * honest **utilization stats** — ``useful_units`` vs ``padded_units``
    count the work actually requested against the work the padded batch
    computed, in each surface's own unit (slot-steps for token decode,
    frames for streaming audio), so one number compares both surfaces.

``SlotServer`` owns that machinery; session types subclass it:

  ``serve.decode.TokenServer``  — one session = one decode request;
      a window step consumes one token per row (ragged prefill, then
      generation until max_new/EOS).
  ``serve.stream.StreamServer`` — one session = one audio stream; a
      window step consumes one feature chunk per row (ragged chunk
      consumption), and streams **attach/detach mid-flight**: a
      detached stream's recurrent-state row is pulled to the host, its
      slot re-admits queued work, and a later reattach restores the row
      bitwise.

SLO tiers (``serve.batcher.TieredPolicy``): sessions carry a tier name
(``interactive`` / ``firehose``).  The core derives the window length
from the *active* tiers (interactive present -> short windows for fast
emission visibility; firehose-only -> long windows amortizing syncs),
caps per-tier slot occupancy, and under interactive pressure defers
admission of preemptible sessions ("sheds") and parks active ones
(``_park_slot``) to free their slots.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.serve.request import RequestQueue


class SlotServer:
    """Slot/session core: admission, the windowed pump, retirement,
    abort recovery and utilization accounting.

    Subclass hooks (see TokenServer / StreamServer):

      _admit_slot(slot, req) -> bool   host-side slot mirrors; False
                                       means "does not fit right now"
                                       (stops admission, FIFO no-skip)
      _retire_slot(slot)               release per-slot resources
      _pre_window(admitted)            device prep (row resets, uploads)
      _run_window(k) -> emissions      run k fused steps; ends with THE
                                       host sync; commits device state
      _consume(slot, req, emitted, k)  per-slot host bookkeeping; returns
                                       (live_steps, useful_units) and
                                       may mark the payload .done
      _padded_units(k)                 units ONE slot (occupied or dead)
                                       computes in a k-step window
      _reset_payload(payload)          abort hygiene: clear outputs
      _drop_state()                    abort hygiene: drop device state
      _park_slot(slot) -> bool         detach the session back to the
                                       queue (streams); False = cannot
    """

    def __init__(self, n_slots: int, *, sync_every: int, tiers=None):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.b = n_slots
        self.sync_every = int(sync_every)
        if self.sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        self.tiers = tiers
        self.queue = RequestQueue()
        self._slots: List[Optional[object]] = [None] * self.b
        self.stats = {"steps": 0, "syncs": 0, "slot_steps": 0,
                      "active_slot_steps": 0, "admitted": 0, "parked": 0,
                      "useful_units": 0, "padded_units": 0}

    # --------------------------------------------------------- tier logic

    def _tier_of(self, payload):
        """Resolve a session's SLOTier (None when untiered)."""
        if self.tiers is None:
            return None
        return self.tiers.tier(getattr(payload, "tier", None))

    def _window_k(self) -> int:
        """Window length for this pump: the tightest ``sync_every``
        among the tiers currently holding slots (an active interactive
        session shortens everyone's window — its emissions must reach
        the host quickly), the server default otherwise."""
        if self.tiers is None:
            return self.sync_every
        ks = [self._tier_of(r.payload).sync_every
              for r in self._slots if r is not None]
        return min(ks) if ks else self.sync_every

    def _tier_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for r in self._slots:
            if r is not None:
                name = self._tier_of(r.payload).name
                counts[name] = counts.get(name, 0) + 1
        return counts

    def _interactive_pressure(self) -> int:
        """Pending non-preemptible sessions that can't get a free slot."""
        pend = sum(1 for req in self.queue.peek_pending()
                   if not self._tier_of(req.payload).preemptible)
        free = sum(1 for s in self._slots if s is None)
        return max(0, pend - free)

    def _rebalance(self):
        """Admission control, park half: when non-preemptible sessions
        are waiting and no slot is free, detach preemptible sessions
        (newest slots first) until the pressure clears.  Parked sessions
        go back to pending and re-admit when occupancy allows."""
        if self.tiers is None:
            return
        need = self._interactive_pressure()
        if need <= 0:
            return
        for i in reversed(range(self.b)):
            if need <= 0:
                break
            req = self._slots[i]
            if req is None or not self._tier_of(req.payload).preemptible:
                continue
            if self._park_slot(i):
                self.stats["parked"] += 1
                need -= 1

    def _pop_admissible(self, max_n: int):
        """Admission control, shed half: pop up to ``max_n`` pending
        sessions in arrival order.  Untiered servers take the queue head
        verbatim (FIFO no-skip stays with ``_admit_slot``); tiered
        servers skip (leave pending) sessions whose tier is at its slot
        cap, and preemptible sessions while interactive occupancy is at
        or past ``shed_threshold`` — deferred, not dropped."""
        if self.tiers is None:
            return self.queue.pop_pending(max_n=max_n)
        counts = self._tier_counts()
        # non-preemptible sessions waiting: preemptible ones must not
        # take the slots just freed for them (parked sessions requeue at
        # the head, ahead of the interactive arrivals that evicted them)
        waiting = [sum(1 for req in self.queue.peek_pending()
                       if not self._tier_of(req.payload).preemptible)]

        def admissible(req):
            t = self._tier_of(req.payload)
            if t.max_batch is not None and counts.get(t.name, 0) >= t.max_batch:
                if not t.preemptible:
                    waiting[0] -= 1     # capped: can't use a slot, so it
                return False            # must not block preemptible work
            if t.preemptible:
                if waiting[0] > 0:
                    return False
                occ = sum(counts.get(u.name, 0) for u in self.tiers.tiers
                          if not u.preemptible) / self.b
                if occ >= self.tiers.shed_threshold:
                    return False
            else:
                waiting[0] -= 1
            counts[t.name] = counts.get(t.name, 0) + 1
            return True

        return self.queue.pop_pending_where(admissible, max_n=max_n)

    # ---------------------------------------------------------- admission

    def _admit(self) -> List[int]:
        """Fill free slots from the queue head (arrival order), after
        giving admission control a chance to park preemptible sessions
        under interactive pressure.  Stops at the first session
        ``_admit_slot`` can't place (FIFO no-skip: it and everything
        behind it requeue in order)."""
        self._rebalance()
        free = [i for i in range(self.b) if self._slots[i] is None]
        if not free:
            return []
        reqs = self._pop_admissible(len(free))
        admitted = []
        for n, (slot, req) in enumerate(zip(free, reqs)):
            if not self._admit_slot(slot, req):
                self.queue.requeue([q.rid for q in reqs[n:]])
                break
            self._slots[slot] = req
            admitted.append(slot)
        self.stats["admitted"] += len(admitted)
        return admitted

    # --------------------------------------------------------------- pump

    def pump(self) -> Dict[int, object]:
        """One sync window: admit into free slots, run ``_window_k()``
        fused device steps, one device→host sync for the window's
        emissions, then retire sessions that finished.  Returns (and
        evicts) the sessions completed by this window."""
        try:
            admitted = self._admit()
            if all(s is None for s in self._slots):
                return {rid: cr.result
                        for rid, cr in self.queue.pop_completed().items()}
            k = self._window_k()
            self._pre_window(admitted)
            emitted = self._run_window(k)
        except BaseException:
            # admission, row resets and the window itself all recover
            # the same way: nothing may stay stranded in a slot
            self._abort()
            raise
        self.stats["syncs"] += 1
        self.stats["steps"] += k
        self.stats["slot_steps"] += k * self.b
        # every slot — occupied, retired-overshooting, or empty — computed
        # the full window; the honest denominator counts them all
        self.stats["padded_units"] += self.b * self._padded_units(k)
        for i, req in enumerate(self._slots):
            if req is None:
                continue        # empty slots don't advance: their host
                                # mirrors must keep matching the device
                                # rows (reset on admission), not drift
            live, useful = self._consume(i, req, emitted, k)
            self.stats["active_slot_steps"] += live
            self.stats["useful_units"] += useful
            if req.payload.done:
                self._finish(i, req)
        return {rid: cr.result
                for rid, cr in self.queue.pop_completed().items()}

    def _finish(self, i: int, req):
        r = req.payload
        r.finished_sync = self.stats["syncs"]
        self._slots[i] = None
        self._retire_slot(i)
        self.queue.complete(r.rid, r)

    def _abort(self):
        """Failure recovery: a failed window must not strand its slots —
        outputs reset, sessions requeued, device state dropped."""
        for req in self._slots:
            if req is not None:
                self._reset_payload(req.payload)
        self._slots = [None] * self.b
        self._drop_state()
        self.queue.restore_in_flight()

    def drain(self) -> Dict[int, object]:
        """Pump until no pending or in-flight work remains.  Returns
        (and evicts) the sessions completed since the last drain — the
        server's ledger must not grow with uptime."""
        done: Dict[int, object] = {}
        while self.queue.n_pending or self.n_active:
            done.update(self.pump())
        done.update({rid: cr.result
                     for rid, cr in self.queue.pop_completed().items()})
        return done

    # -------------------------------------------------------------- stats

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self._slots)

    def utilization(self) -> float:
        """Useful work / computed work, in the surface's own unit
        (slot-steps for token decode, frames for streaming audio) — the
        one honest number both session types report."""
        return self.stats["useful_units"] / max(self.stats["padded_units"],
                                                1)

    def occupancy(self) -> Dict[str, float]:
        """Slot occupancy, total and per tier (fractions of ``b``)."""
        occ = {"total": self.n_active / self.b}
        if self.tiers is not None:
            for name, n in self._tier_counts().items():
                occ[name] = n / self.b
        return occ

    # -------------------------------------------------------------- hooks

    def _admit_slot(self, slot: int, req) -> bool:
        raise NotImplementedError

    def _retire_slot(self, slot: int):
        raise NotImplementedError

    def _pre_window(self, admitted: List[int]):
        raise NotImplementedError

    def _run_window(self, k: int) -> np.ndarray:
        raise NotImplementedError

    def _consume(self, slot: int, req, emitted, k: int):
        raise NotImplementedError

    def _reset_payload(self, payload):
        raise NotImplementedError

    def _drop_state(self):
        raise NotImplementedError

    def _padded_units(self, k: int) -> int:
        """Units one slot computes over a k-step window — slot-steps by
        default (token decode); the stream surface counts frames."""
        return k

    def _park_slot(self, slot: int) -> bool:
        """Detach the session in ``slot`` back to the queue (streams
        carry their recurrent state to the host).  Token sessions can't
        be parked — their KV rows die with the slot."""
        return False
