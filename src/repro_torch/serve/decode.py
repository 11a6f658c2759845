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

With ``paging=PagedCacheConfig(...)`` the K/V cache becomes a pool of
fixed-size pages shared by all slots (vLLM-style): each admission rents
exactly ``ceil((plen + max_new - 1) / page_size)`` pages from a
host-side free list (``serve.paging.PageAllocator``), retirement
returns them, and rows with a common prompt prefix share read-only
prefix pages through refcounted content hashes.  Memory then scales
with tokens in flight instead of ``slots x max_seq``, and one prompt may
be longer than an equal-budget contiguous cache allows.  Admission is
FIFO no-skip: if the head request's pages do not fit, it (and everything
behind it) waits.

Per-request sampling (``submit(..., sampling=SamplingParams(...))``)
runs through a second window that draws Gumbel-max samples per step —
still one host sync per window.  Greedy-only windows keep bitwise
argmax.  With ``decode_kernel=True`` the attention tail is the fused
``decode_attention`` op and next-token selection the fused
``topk_sample`` op (the Hopper kernels on the card, their plain versions
on the host); rows whose ``top_k`` the sampler's candidate set can't
honor take the full-vocab sampler in a mixed window.

``RoundTokenServer`` is the reference's previous engine — generation
rounds of exactly equal prompt length over the 0-d (lockstep) position
cache — kept as the lockstep baseline.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.launch.steps import make_serve_step
from repro_torch.models import build_model
from repro_torch.models.paging import prefix_sharing_supported
from repro_torch.serve.batcher import LATENCY, BatchPolicy
from repro_torch.serve.paging import PageAllocator, block_hashes
from repro_torch.serve.request import RequestQueue
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.slots import SlotServer


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


def _validate_submit(prompt, max_new, max_seq, paging=None):
    prompt = np.asarray(prompt, np.int32)
    if prompt.ndim != 1 or prompt.shape[0] < 1:
        raise ValueError(
            f"expected a non-empty 1-D token prompt, got shape "
            f"{prompt.shape}")
    if max_new < 1:
        raise ValueError("max_new must be >= 1")
    cap = prompt.shape[0] + max_new - 1
    if paging is not None:
        # paged capacity: the request needs ceil(cap / page_size) pages
        # and a block-table row wide enough to hold them — the page
        # budget bounds the prompt, not max_seq
        blocks = -(-cap // paging.page_size)
        if cap > paging.resolved_max_ctx or blocks > paging.n_pages:
            raise ValueError(
                f"prompt ({prompt.shape[0]}) + max_new ({max_new}) needs "
                f"{blocks} pages of {paging.page_size} (ctx {cap}) > page "
                f"budget (n_pages {paging.n_pages}, max_ctx "
                f"{paging.resolved_max_ctx})")
    elif cap > max_seq:
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
    ``paging`` (a ``PagedCacheConfig``) pages the KV cache, with
    ``max_seq`` the page budget's ``resolved_max_ctx``; ``prefix_cache``
    shares published prompt pages where the model allows it
    (``prefix_sharing_supported``).
    """

    def __init__(self, cfg, params, *, policy: BatchPolicy = LATENCY,
                 max_seq: int = 256, cache_dtype=torch.bfloat16,
                 sync_every: Optional[int] = None,
                 eos_id: Optional[int] = None, paging=None,
                 prefix_cache: bool = True, decode_kernel: bool = False,
                 tiers=None, device=None):
        if cfg.family == "lstm_am":
            raise ValueError("TokenServer is the token-LM decode surface; "
                             "acoustic models go through StreamingEngine")
        self.cfg = cfg
        self.paging = paging
        self.decode_kernel = decode_kernel
        torch.backends.cuda.matmul.allow_tf32 = False
        self.model = build_model(cfg, device=device, params=params,
                                 paging=paging, decode_kernel=decode_kernel)
        self.model.requires_grad_(False)
        self.device = self.model.device
        # with paging the context bound is the page budget, not max_seq
        self.max_seq = (paging.resolved_max_ctx if paging is not None
                        else max_seq)
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
        # paged mode's host state: block-table mirror + per-slot leases
        if paging is not None:
            self.alloc = PageAllocator(
                paging.n_pages, paging.page_size,
                prefix_cache=prefix_cache and prefix_sharing_supported(cfg))
            self._tables = np.zeros((self.b, paging.max_blocks), np.int32)
            self._caps = np.zeros((self.b,), np.int32)
            self._tables_dirty = False
            self._blocks: List[Optional[List[int]]] = [None] * self.b
            self._hashes: List[Optional[List[int]]] = [None] * self.b
            self._nshared = [0] * self.b
        else:
            self.alloc = None
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
        prompt = _validate_submit(prompt, max_new, self.max_seq,
                                  paging=self.paging)
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
        """Install one request's host mirrors.  Paged mode also rents
        every page the request can ever need up front (no mid-flight
        out-of-pages), reusing published prefix pages whose hashes match
        the prompt's leading blocks; False (does not fit) makes the base
        class requeue it and everything behind it — FIFO no-skip."""
        r = req.payload
        start = 0
        if self.paging is not None:
            start = self._admit_pages(slot, r)
            if start < 0:
                return False
        self._pos[slot] = start
        self._prompts[slot] = 0
        self._prompts[slot, :r.prompt.shape[0]] = r.prompt
        self._plens[slot] = r.prompt.shape[0]
        s = r.sampling or SamplingParams()
        self._temp[slot] = s.temperature
        self._topk[slot] = s.top_k
        self._topp[slot] = s.top_p
        self._seed[slot] = np.int32(np.uint32(s.seed & 0xFFFFFFFF))
        return True

    def _admit_pages(self, slot, r) -> int:
        """Lease pages for one request.  Returns the row's start
        position (past the shared prefix pages) or -1 if the pool cannot
        cover it now."""
        ps = self.paging.page_size
        plen = r.prompt.shape[0]
        cap = plen + r.max_new - 1
        total = -(-cap // ps)
        hashes = block_hashes(r.prompt, ps)
        n_hit = self.alloc.peek_prefix(hashes)
        # hit pages parked in the LRU stop being free capacity once
        # acquired (the reference's check leaves them out and its alloc
        # raises there)
        if not self.alloc.can_alloc(total - n_hit + self.alloc.parked_prefix(
                hashes[:n_hit])):
            return -1
        shared = self.alloc.acquire_prefix(hashes[:n_hit])
        self.alloc.note_miss(len(hashes) - n_hit)
        blocks = shared + self.alloc.alloc(total - n_hit)
        self._blocks[slot] = blocks
        self._hashes[slot] = hashes
        self._nshared[slot] = n_hit
        self._tables[slot] = 0
        self._tables[slot, :len(blocks)] = blocks
        self._caps[slot] = cap
        self._tables_dirty = True
        # the row starts past the cached prefix; its first write lands in
        # block n_hit, so shared pages are never written.  block_hashes
        # guarantees n_hit * ps <= plen - 1: at least one prompt token is
        # fed, so the row always produces a real first logit
        return n_hit * ps

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
        if self.paging is not None:
            # the device pools were just dropped, so every cached page's
            # contents are gone too — a full allocator reset, not a
            # release (a released published page would advertise stale
            # contents)
            self.alloc.reset()
            self._tables[:] = 0
            self._caps[:] = 0
            self._tables_dirty = False
            self._blocks = [None] * self.b
            self._hashes = [None] * self.b
            self._nshared = [0] * self.b

    def _pre_window(self, admitted: List[int]):
        self._ensure_device_state()
        if self.paging is not None and self._tables_dirty:
            # block-table changes (admission leases, retirement returns)
            # reach the device as a fresh pages dict; rows whose table
            # row is all zero point at the trash page
            self._cache["pages"] = {"tables": self._upload(self._tables),
                                    "caps": self._upload(self._caps)}
            self._tables_dirty = False
        if admitted:
            mask = np.zeros((self.b,), bool)
            mask[admitted] = True
            # a prefix-cache hit starts its row past the shared pages
            starts = None if self.paging is None \
                else self._upload(self._pos.astype(np.int32))
            self._cache = self.model.reset_cache_rows(
                self._cache, self._upload(mask), starts)
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
        if self.paging is not None:
            self._release_slot(i)

    def _release_slot(self, i):
        """Return a retired slot's pages.  Its freshly written prompt
        blocks are published first, so later requests with the same
        prefix can share them; the zeroed table row sends the retired
        row's overshoot writes to trash page 0."""
        blocks, hashes = self._blocks[i], self._hashes[i]
        for j in range(self._nshared[i], len(hashes)):
            self.alloc.publish(blocks[j], hashes[j])
        self.alloc.release(blocks)
        self._blocks[i] = None
        self._hashes[i] = None
        self._nshared[i] = 0
        self._tables[i] = 0
        self._caps[i] = 0
        self._tables_dirty = True

    def slot_positions(self):
        """(host, device) consumed-token positions for debugging and the
        slot-invariant test; device is None before the first pump (and
        reading it is a host sync)."""
        host = self._pos.copy()
        dev = (self._cache["pos"].cpu().numpy() if self._cache is not None
               else None)
        return host, dev

    def paging_stats(self):
        """Allocator counters and current occupancy (paged mode only;
        None otherwise)."""
        if self.alloc is None:
            return None
        s = dict(self.alloc.stats)
        s["free"] = self.alloc.free_pages()
        s["live"] = self.alloc.live_pages()
        return s


class RoundTokenServer:
    """Generation-round batched decoding over the 0-d (lockstep)
    position cache — the reference's engine before continuous batching,
    kept as the lockstep baseline.

    Rounds group requests by exactly equal prompt length, prefill
    token by token in lockstep, and decode until every row hit its
    ``max_new`` — early-finished rows burn steps until the slowest row
    completes, and each decode step pays one device-to-host sync.  The
    continuous ``TokenServer`` removes all three costs.  ``params`` and
    ``device`` are as ``TokenServer``'s; the attention tail and the
    next-token choice are the plain ones (lockstep decode takes no
    fused op)."""

    def __init__(self, cfg, params, *, policy: BatchPolicy = LATENCY,
                 max_seq: int = 256, cache_dtype=torch.bfloat16,
                 eos_id: Optional[int] = None, device=None):
        self.cfg = cfg
        torch.backends.cuda.matmul.allow_tf32 = False
        self.model = build_model(cfg, device=device, params=params)
        self.model.requires_grad_(False)
        self.device = self.model.device
        self.policy = policy
        self.max_seq = max_seq
        self.cache_dtype = cache_dtype
        self.b = policy.max_batch
        self.eos_id = eos_id
        self.serve = make_serve_step(self.model, cfg)
        self.queue = RequestQueue()

    def submit(self, prompt: np.ndarray, max_new: int = 16) -> int:
        prompt = _validate_submit(prompt, max_new, self.max_seq)
        req = TokenRequest(-1, prompt, max_new)
        req.rid = self.queue.submit(req)
        return req.rid

    def _next_round(self) -> List[TokenRequest]:
        """Pop up to max_batch pending requests of one equal prompt
        length (arrival order decides which length goes first); the rest
        go back to the queue head through its requeue hook."""
        reqs = self.queue.pop_pending()
        if not reqs:
            return []
        length = reqs[0].payload.prompt.shape[0]
        round_, keep = [], []
        for r in reqs:
            if (r.payload.prompt.shape[0] == length
                    and len(round_) < self.b):
                round_.append(r.payload)
            else:
                keep.append(r.rid)
        self.queue.requeue(keep)
        return round_

    @torch.no_grad()
    def _run_round(self, round_: List[TokenRequest]):
        plen = round_[0].prompt.shape[0]
        cache = self.model.init_cache(self.b, self.max_seq, self.cache_dtype)
        prompts = np.zeros((self.b, plen), np.int32)
        for i, r in enumerate(round_):
            prompts[i] = r.prompt
        prompts = torch.from_numpy(prompts).to(self.device)
        # batched prefill through the decode path: each row feeds its own
        # prompt token, so caches stay row-pure
        for t in range(plen):
            nxt, _, cache = self.serve(cache, prompts[:, t:t + 1])
        tokens = nxt
        for _ in range(max(r.max_new for r in round_)):
            host_tok = tokens.cpu().numpy()  # one device->host sync a step
            for i, r in enumerate(round_):
                if not r.done:
                    t = int(host_tok[i, 0])
                    r.out.append(t)
                    if (self.eos_id is not None and t == self.eos_id) \
                            or len(r.out) >= r.max_new:
                        r.done = True
            if all(r.done for r in round_):
                break
            nxt, _, cache = self.serve(cache, tokens)
            tokens = nxt
        for r in round_:
            r.done = True
            self.queue.complete(r.rid, r)

    def drain(self) -> Dict[int, TokenRequest]:
        """Run rounds until no pending work remains.  Returns (and
        evicts) the requests completed since the last drain."""
        while self.queue.n_pending:
            round_ = self._next_round()
            if not round_:
                break
            try:
                self._run_round(round_)
            except BaseException:
                # a failed step must not strand the round: reset partial
                # outputs and put the requests back for retry
                for r in round_:
                    r.out.clear()
                    r.done = False
                self.queue.restore_in_flight()
                raise
        return {rid: cr.result
                for rid, cr in self.queue.pop_completed().items()}
