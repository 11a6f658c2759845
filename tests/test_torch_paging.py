"""Port parity: the paged KV cache (``models/paging.py``,
``serve/paging.py``), the paged ``TokenServer``, ``RoundTokenServer``
and the three dense configs it serves (gemma3-27b, deepseek-67b,
chameleon-34b), against the JAX reference on the host.

Bars:
  * allocator: the same calls give the same page ids, refcounts, LRU
    order, ``stats`` and ``check()`` in both packages; ``block_hashes``
    equal (one process, so Python's salted ``str`` hash is shared);
  * device helpers: ``write_index`` and ``gather_indices`` equal, and
    pools after ``pool_write`` equal outside trash page 0 (the port
    writes in place, the reference sums colliding rows there);
  * servers (reduced qwen2.5-3b, weights initialised in JAX and bridged
    by ``checkpoint/convert.py``, the embedding scaled by 1/sqrt(d)):
    greedy tokens of the paged server equal the reference's paged
    server's and the port's contiguous server's, with the prefix cache
    and the fused decode op on and off, and the allocator's counts
    equal; ``RoundTokenServer`` tokens equal;
  * ``decode_step`` over a paged cache, float32: logits within 1e-5 of
    max(1, |ref|) of the reference's (the mixed sliding-window/global
    gemma3 group, whisper's decoder, and each new config reduced).
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # hypothesis absent: the deterministic shim
    from _hypothesis_fallback import given, settings, st

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serve as jserve  # noqa: E402
import repro_torch.serve as pserve  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import LayerSpec as JaxLayerSpec  # noqa: E402
from repro.configs.base import Segment as JaxSegment  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import paging as jax_paging  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.configs.base import LayerSpec, Segment  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import paging  # noqa: E402

REL = 1e-5
CPU = dict(device="cpu")
PAGING = dict(page_size=8, n_pages=32, max_ctx=64)
POL = dict(name="t", max_batch=4, bucket_multiple=16, sort_by_length=False,
           sync_every=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Reduced widths: torch's intra-op threads only contend, and under
    the suite's parallel workers they made a server test ~100x slower
    than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pagings():
    return (jax_paging.PagedCacheConfig(**PAGING),
            paging.PagedCacheConfig(**PAGING))


def _policies():
    return jserve.BatchPolicy(**POL), pserve.BatchPolicy(**POL)


def _jax_params(jcfg, seed):
    """Reference init with the embedding scaled by 1/sqrt(d) (a spread
    of logits to choose among), as numpy and as a JAX tree."""
    jp = jax.device_get(jax_build_model(jcfg).init(jax.random.key(seed)))
    jp["embed"] = jp["embed"] / np.sqrt(jcfg.d_model)
    return jp


class Pair:
    """One config in both packages with the same weights."""

    def __init__(self, arch, seed=0, segments=None):
        self.jcfg = jax_reduced(jax_get_arch(arch))
        self.pcfg = reduced(get_arch(arch))
        if segments is not None:
            jseg, pseg = segments
            self.jcfg = self.jcfg.replace(segments=jseg)
            self.pcfg = self.pcfg.replace(segments=pseg)
        self.jp = _jax_params(self.jcfg, seed)
        self.pp = params_from_numpy(self.jp, self.pcfg, **CPU)


_PAIRS = {}


def pair(key="qwen2.5-3b") -> Pair:
    if key not in _PAIRS:
        if key == "gemma3-mixed":
            # one (swa window 8, global) group: the ring and the pool in
            # one step (reduced() alone keeps only swa layers)
            segs = (
                (JaxSegment((JaxLayerSpec("swa", "mlp", window=8),
                             JaxLayerSpec("attn", "mlp")), 1),),
                (Segment((LayerSpec("swa", "mlp", window=8),
                          LayerSpec("attn", "mlp")), 1),))
            _PAIRS[key] = Pair("gemma3-27b", seed=3, segments=segs)
        else:
            _PAIRS[key] = Pair(key, seed=len(_PAIRS) + 1)
    return _PAIRS[key]


def _close_logits(got, ref, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = np.maximum(1.0, np.abs(ref).max(axis=-1, keepdims=True))
    err = np.abs(got - ref) / scale
    assert err.max() <= REL, f"{what}: {err.max():.3e} > {REL}"


# --------------------------------------------------------------- allocator

def _state(a):
    return (list(a._free), dict(a._ref), dict(a._hash_of),
            list(a._lru), dict(a.stats), a.free_pages(), a.live_pages())


@settings(max_examples=10, deadline=None)
@given(n_pages=st.integers(min_value=1, max_value=24),
       seed=st.integers(min_value=0, max_value=1000))
def test_allocator_never_aliases_live_pages(n_pages, seed):
    """Random alloc/release interleavings into both allocators: the
    same leases, live leases pairwise disjoint, free + live + cached
    conserved."""
    rng = np.random.default_rng(seed)
    ours = pserve.PageAllocator(n_pages, 8, prefix_cache=False)
    ref = jserve.PageAllocator(n_pages, 8, prefix_cache=False)
    leases = []
    for _ in range(50):
        if leases and rng.random() < 0.4:
            lease = leases.pop(rng.integers(len(leases)))
            ours.release(lease)
            ref.release(lease)
        else:
            want = int(rng.integers(1, max(2, n_pages // 2 + 1)))
            assert ours.can_alloc(want) == ref.can_alloc(want)
            if ours.can_alloc(want):
                lease = ours.alloc(want)
                assert lease == ref.alloc(want)
                leases.append(lease)
            else:
                with pytest.raises(RuntimeError):
                    ours.alloc(want)
        flat = [p for lease in leases for p in lease]
        assert len(flat) == len(set(flat)), "page aliased across live rows"
        assert all(1 <= p <= n_pages for p in flat)
        ours.check()
        assert _state(ours) == _state(ref)
    for lease in leases:
        ours.release(lease)
    ours.check()
    assert ours.free_pages() == n_pages and ours.live_pages() == 0


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(min_value=0, max_value=1000))
def test_allocator_prefix_refcounts(seed):
    """A published block stays resident while any sharer holds it, parks
    in the LRU when the last sharer releases, and is evicted only when
    the free list runs dry — in the reference's order."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 100, 9)
    for mod in (pserve, jserve):
        alloc = mod.PageAllocator(8, 4)
        hashes = mod.block_hashes(toks, 4)   # 2 sharable blocks of 9 toks
        assert len(hashes) == 2
        first = alloc.alloc(2)
        for page, h in zip(first, hashes):
            alloc.publish(page, h)
        assert alloc.peek_prefix(hashes) == 2
        sharers = [alloc.acquire_prefix(hashes) for _ in range(3)]
        alloc.release(first)
        for s in sharers[:-1]:
            alloc.release(s)
            assert alloc.peek_prefix(hashes) == 2
            alloc.check()
        alloc.release(sharers[-1])
        alloc.check()
        assert alloc.live_pages() == 0 and alloc.free_pages() == 8
        assert alloc.peek_prefix(hashes) == 2
        all_pages = alloc.alloc(8)
        assert sorted(all_pages) == list(range(1, 9))
        assert alloc.peek_prefix(hashes) == 0
        assert alloc.stats["evictions"] == 2
        alloc.release(all_pages)
        alloc.check()
        if mod is pserve:
            ours = (all_pages, dict(alloc.stats), list(alloc._free))
    assert ours == (all_pages, dict(alloc.stats), list(alloc._free))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_matches_reference_call_for_call(seed):
    """The server's calls — a prefix peek and hit, fresh pages, misses,
    publish-then-release at retirement, now and then a reset — over
    prompts from three shared prefixes, into both allocators: the same
    ids, refcounts, LRU order and counters after every call."""
    rng = np.random.default_rng(seed)
    ours = pserve.PageAllocator(10, 4)
    ref = jserve.PageAllocator(10, 4)
    prefixes = [rng.integers(1, 50, 8) for _ in range(3)]
    live = []
    for _ in range(120):
        if live and (rng.random() < 0.45 or len(live) > 3):
            blocks, hashes, n_hit = live.pop(int(rng.integers(len(live))))
            for alloc in (ours, ref):
                for j in range(n_hit, len(hashes)):
                    alloc.publish(blocks[j], hashes[j])
                alloc.release(blocks)
        elif rng.random() < 0.03:
            ours.reset()
            ref.reset()
            live = []
        else:
            prompt = np.concatenate([prefixes[int(rng.integers(3))],
                                     rng.integers(1, 50, int(
                                         rng.integers(1, 9)))])
            hashes = pserve.block_hashes(prompt, 4)
            assert hashes == jserve.block_hashes(prompt, 4)
            total = -(-(prompt.shape[0] + int(rng.integers(1, 6))) // 4)
            n_hit = ours.peek_prefix(hashes)
            assert n_hit == ref.peek_prefix(hashes)
            fits = ours.can_alloc(total - n_hit
                                  + ours.parked_prefix(hashes[:n_hit]))
            if fits:
                got = []
                for alloc in (ours, ref):
                    shared = alloc.acquire_prefix(hashes[:n_hit])
                    alloc.note_miss(len(hashes) - n_hit)
                    got.append(shared + alloc.alloc(total - n_hit))
                assert got[0] == got[1]
                live.append((got[0], hashes, n_hit))
        ours.check()
        ref.check()
        assert _state(ours) == _state(ref)
        assert ours._page_of == ref._page_of
    assert ours.stats["hits"] > 0 and ours.stats["evictions"] > 0


def test_block_hashes_match_reference_and_exclude_final_position():
    """Equal chains in both packages; the block holding the last prompt
    token is never sharable (the retirement overshoot clamp may rewrite
    that position in place)."""
    toks = list(range(100, 117))          # 17 tokens, page_size 8
    for n in (8, 9, 16, 17):
        for ps in (4, 8):
            assert pserve.block_hashes(toks[:n], ps) == \
                jserve.block_hashes(toks[:n], ps)
    assert len(pserve.block_hashes(toks, 8)) == 2
    assert len(pserve.block_hashes(toks[:16], 8)) == 1
    assert len(pserve.block_hashes(toks[:8], 8)) == 0
    a = pserve.block_hashes(list(range(20)), 4)
    b = pserve.block_hashes(list(range(4)) + list(range(50, 66)), 4)
    assert a[0] == b[0] and a[1] != b[1]
    assert pserve.block_hashes(np.arange(20), 4) == a


# ----------------------------------------------------------- device helpers

def test_paged_config_and_token_bytes_match_reference():
    for kw in (PAGING, dict(page_size=16, n_pages=384, max_ctx=512),
               dict(page_size=4, n_pages=3)):
        j, p = jax_paging.PagedCacheConfig(**kw), paging.PagedCacheConfig(**kw)
        assert (p.resolved_max_ctx, p.max_blocks, p.pool_slots) == \
            (j.resolved_max_ctx, j.max_blocks, j.pool_slots)
    for bad in (dict(page_size=0), dict(n_pages=0),
                dict(page_size=8, max_ctx=12)):
        with pytest.raises(ValueError):
            paging.PagedCacheConfig(**bad)
    for arch in ("qwen2.5-3b", "gemma3-27b", "deepseek-67b",
                 "chameleon-34b", "whisper-medium", "qwen2.5-3b+swa"):
        jc, pc = jax_get_arch(arch), get_arch(arch)
        for jd, pd in ((jnp.bfloat16, torch.bfloat16),
                       (jnp.float32, torch.float32)):
            assert paging.paged_token_bytes(pc, pd) == \
                jax_paging.paged_token_bytes(jc, jd)
        assert paging.prefix_sharing_supported(pc) == \
            jax_paging.prefix_sharing_supported(jc)
    # qwen2.5-3b: 36 layers x 2 x 2 kv heads x 128 x 2 bytes
    assert paging.paged_token_bytes(get_arch("qwen2.5-3b"),
                                    torch.bfloat16) == 36_864
    assert not paging.prefix_sharing_supported(get_arch("gemma3-27b"))


def test_write_gather_and_pool_write_match_reference():
    """Ragged rows, one past its cap (clamped to its own last slot), two
    retired rows at cap 0 (both in trash page 0): write slots and gather
    slots equal, pools equal outside page 0."""
    rng = np.random.default_rng(0)
    ps, nb, n_pages = 4, 5, 16
    tables = np.zeros((6, nb), np.int32)
    caps = np.array([17, 3, 9, 20, 0, 0], np.int32)
    perm = rng.permutation(np.arange(1, n_pages + 1))
    at = 0
    for b, cap in enumerate(caps):
        n = -(-int(cap) // ps)
        tables[b, :n] = perm[at:at + n]
        at += n
    pos = np.array([5, 7, 8, 19, 2, 11], np.int32)      # row 1 past cap
    slots = (n_pages + 1) * ps
    pool = rng.normal(size=(slots, 2, 3)).astype(np.float32)
    new = rng.normal(size=(6, 2, 3)).astype(np.float32)
    jref = jax_paging.PageRef(jnp.asarray(tables), jnp.asarray(caps), ps)
    pref = paging.PageRef(torch.from_numpy(tables), torch.from_numpy(caps),
                          ps)
    jw = np.asarray(jax_paging.write_index(jref, jnp.asarray(pos)))
    pw = paging.write_index(pref, torch.from_numpy(pos))
    np.testing.assert_array_equal(pw.numpy(), jw)
    assert jw[1] == tables[1, 0] * ps + 2 and jw[4] == jw[5] == 0
    np.testing.assert_array_equal(paging.gather_indices(pref).numpy(),
                                  np.asarray(jax_paging.gather_indices(jref)))
    jpool = np.asarray(jax_paging.pool_write(jnp.asarray(pool),
                                             jnp.asarray(new),
                                             jnp.asarray(jw)))
    ppool = torch.from_numpy(pool.copy())
    out = paging.pool_write(ppool, torch.from_numpy(new), pw)
    assert out is ppool
    np.testing.assert_array_equal(ppool.numpy()[ps:], jpool[ps:])
    gathered = paging.gather_pool(ppool, paging.gather_indices(pref))
    assert gathered.is_contiguous() and tuple(gathered.shape) == \
        (6, 2, nb * ps, 3)
    gidx = np.asarray(jax_paging.gather_indices(jref))
    real = gidx >= ps                       # slots outside trash page 0
    np.testing.assert_array_equal(
        gathered.numpy().transpose(0, 2, 1, 3)[real], jpool[gidx][real])


# ----------------------------------------------------------------- servers

def _workload(seed, vocab, n=8, prefix=16):
    """Ragged greedy requests; half share a 16-token prefix (two
    sharable pages of 8)."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(1, vocab, prefix).astype(np.int32)
    subs = []
    for i in range(n):
        tail = rng.integers(1, vocab, int(rng.integers(3, 14))).astype(
            np.int32)
        subs.append((np.concatenate([pre, tail]) if i % 2 else tail,
                     int(rng.integers(2, 12))))
    return subs


def _drain(srv, subs):
    rids = [srv.submit(p, n) for p, n in subs]
    done = srv.drain()
    return [list(done[r].out) for r in rids]


@pytest.fixture(scope="module")
def served():
    """The reference's paged server (prefix cache on) over one workload,
    drained once for the module's comparisons."""
    p = pair()
    jpag, _ = _pagings()
    jpol, _ = _policies()
    subs = _workload(3, p.pcfg.vocab_size)
    js = jserve.TokenServer(p.jcfg, p.jp, policy=jpol, paging=jpag)
    return subs, _drain(js, subs), js.paging_stats()


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_paged_greedy_matches_reference_and_contiguous(served,
                                                       decode_kernel):
    p = pair()
    _, ppag = _pagings()
    _, ppol = _policies()
    subs, ref_out, ref_stats = served
    on = pserve.TokenServer(p.pcfg, p.pp, policy=ppol, paging=ppag,
                            decode_kernel=decode_kernel, **CPU)
    off = pserve.TokenServer(p.pcfg, p.pp, policy=ppol, paging=ppag,
                             prefix_cache=False,
                             decode_kernel=decode_kernel, **CPU)
    contiguous = pserve.TokenServer(p.pcfg, p.pp, policy=ppol, max_seq=64,
                                    decode_kernel=decode_kernel, **CPU)
    got = _drain(on, subs)
    assert got == ref_out
    assert got == _drain(off, subs) == _drain(contiguous, subs)
    assert on.paging_stats() == ref_stats
    s_on, s_off = on.paging_stats(), off.paging_stats()
    assert s_on["hits"] > 0 and s_off["hits"] == 0
    assert s_on["allocs"] < s_off["allocs"]
    for srv in (on, off):
        srv.alloc.check()
        assert srv.alloc.live_pages() == 0
    # the pool's high water stayed below the contiguous slots x max_seq
    assert 0 < s_off["peak_pages"] * ppag.page_size < ppol.max_batch * 64


def test_paged_long_prompt_beyond_contiguous_budget():
    """An 80-token prompt: refused by a 64-slot contiguous server, served
    from a 128-context page budget, with the tokens of a 128-slot
    contiguous server; a request past the budget is refused."""
    p = pair()
    _, ppol = _policies()
    prompt = np.random.default_rng(4).integers(
        1, p.pcfg.vocab_size, 80).astype(np.int32)
    with pytest.raises(ValueError):
        pserve.TokenServer(p.pcfg, p.pp, policy=ppol, max_seq=64,
                           **CPU).submit(prompt, 6)
    big = paging.PagedCacheConfig(page_size=8, n_pages=32, max_ctx=128)
    srv = pserve.TokenServer(p.pcfg, p.pp, policy=ppol, paging=big, **CPU)
    assert srv.max_seq == 128
    out = _drain(srv, [(prompt, 6)])
    ref = pserve.TokenServer(p.pcfg, p.pp, max_seq=128,
                             policy=replace(pserve.LATENCY, max_batch=1),
                             **CPU)
    assert out == _drain(ref, [(prompt, 6)])
    with pytest.raises(ValueError, match="page budget"):
        srv.submit(np.ones(300, np.int32), 6)


def test_abort_leaks_no_pages_and_reruns_identically():
    """A window that dies mid-flight returns every page (``_drop_state``
    resets the allocator); the requeued requests then complete with the
    tokens of an uninterrupted server."""
    p = pair()
    _, ppag = _pagings()
    _, ppol = _policies()
    subs = _workload(6, p.pcfg.vocab_size, n=5)
    srv = pserve.TokenServer(p.pcfg, p.pp, policy=ppol, paging=ppag, **CPU)
    rids = [srv.submit(q, n) for q, n in subs]
    srv.pump()
    assert srv.alloc.live_pages() > 0
    good = srv.serve

    def die(*a, **k):
        raise RuntimeError("die")
    srv.serve = die
    with pytest.raises(RuntimeError):
        srv.pump()
    srv.alloc.check()
    assert srv.alloc.live_pages() == 0
    assert srv.alloc.free_pages() == ppag.n_pages
    assert all(b is None for b in srv._blocks) and not srv._caps.any()
    srv.serve = good
    done = srv.drain()
    base = pserve.TokenServer(p.pcfg, p.pp, policy=ppol, paging=ppag, **CPU)
    assert [list(done[r].out) for r in rids] == _drain(base, subs)


def test_admission_waits_for_pages_and_positions_agree():
    """FIFO no-skip: with pages for two requests at a time the others
    wait (requeued, not dropped) and complete once pages free up; the
    host and device positions of every occupied slot agree at every
    sync, prefix-hit rows included."""
    p = pair()
    _, ppol = _policies()
    tight = paging.PagedCacheConfig(page_size=8, n_pages=8, max_ctx=64)
    srv = pserve.TokenServer(p.pcfg, p.pp, policy=ppol, paging=tight,
                             prefix_cache=False, **CPU)
    rng = np.random.default_rng(8)
    # each needs ceil((20 + 13 - 1) / 8) = 4 pages: 2 fit at once
    rids = [srv.submit(rng.integers(1, p.pcfg.vocab_size, 20).astype(
        np.int32), 13) for _ in range(4)]
    srv.pump()
    assert srv.n_active == 2 and srv.queue.n_pending == 2
    out = srv.drain()
    assert sorted(out) == sorted(rids)
    assert all(len(out[r].out) == 13 for r in rids)
    srv.alloc.check()
    assert srv.alloc.live_pages() == 0
    _, ppag = _pagings()
    srv = pserve.TokenServer(p.pcfg, p.pp, policy=ppol, paging=ppag, **CPU)
    for q, n in _workload(7, p.pcfg.vocab_size, n=12):
        srv.submit(q, n)
    starts = set()
    while srv.queue.n_pending or srv.n_active:
        srv.pump()
        host, dev = srv.slot_positions()
        for i, s in enumerate(srv._slots):
            if s is not None:
                assert host[i] == dev[i], (i, host, dev)
                starts.add(srv._nshared[i])
    assert max(starts) > 0                 # a row started mid-prompt


def test_prefix_hit_on_parked_pages_waits_for_capacity():
    """A request whose prefix pages sit parked in the LRU needs fresh
    pages beyond the free list: acquiring the hit pages takes them out
    of the free capacity, so the port waits until a row retires (the
    reference's check leaves them out and its allocator raises from
    ``pump``).  Tokens equal a contiguous server's."""
    p = pair()
    jpol, ppol = _policies()
    kw = dict(page_size=4, n_pages=7, max_ctx=16)
    rng = np.random.default_rng(12)
    pre = rng.integers(1, p.pcfg.vocab_size, 8).astype(np.int32)
    subs = [(np.concatenate([pre, [5]]).astype(np.int32), 4),   # 3 pages
            (rng.integers(1, p.pcfg.vocab_size, 12).astype(np.int32),
             5),                                               # 4 pages
            (np.concatenate([pre, [7]]).astype(np.int32), 8)]  # 2 + 2
    srv = pserve.TokenServer(p.pcfg, p.pp, policy=ppol,
                             paging=paging.PagedCacheConfig(**kw), **CPU)
    out = _drain(srv, subs)
    assert srv.paging_stats()["hits"] == 2
    srv.alloc.check()
    cont = pserve.TokenServer(p.pcfg, p.pp, policy=ppol, max_seq=16, **CPU)
    assert out == _drain(cont, subs)
    js = jserve.TokenServer(p.jcfg, p.jp, policy=jpol,
                            paging=jax_paging.PagedCacheConfig(**kw))
    for q, n in subs:
        js.submit(q, n)
    with pytest.raises(RuntimeError, match="exhausted"):
        js.drain()


def test_retiring_row_overshoot_stays_in_its_pages():
    """A row retiring early in a window keeps writing until the window
    ends: its writes clamp to its own last slot, so the neighbour's
    tokens equal a run where the neighbour is alone."""
    p = pair()
    _, ppag = _pagings()
    pol = replace(_policies()[1], sync_every=8)
    rng = np.random.default_rng(9)
    short = (rng.integers(1, p.pcfg.vocab_size, 3).astype(np.int32), 2)
    long_ = (rng.integers(1, p.pcfg.vocab_size, 9).astype(np.int32), 10)
    both = pserve.TokenServer(p.pcfg, p.pp, policy=pol, paging=ppag, **CPU)
    out = _drain(both, [short, long_])
    alone = pserve.TokenServer(p.pcfg, p.pp, policy=pol, paging=ppag, **CPU)
    assert out[1] == _drain(alone, [long_])[0]
    assert both.stats["steps"] > short[0].shape[0] + short[1] - 1


def test_round_token_server_matches_reference_and_continuous():
    """Equal-length rounds in lockstep: tokens equal the reference's
    RoundTokenServer's and the port's continuous greedy server's."""
    p = pair()
    jpol, ppol = _policies()
    rng = np.random.default_rng(10)
    subs = [(rng.integers(1, p.pcfg.vocab_size, ln).astype(np.int32),
             int(rng.integers(2, 8))) for ln in (5, 5, 7, 5, 7, 5, 5)]
    js = jserve.RoundTokenServer(p.jcfg, p.jp, policy=jpol, max_seq=64,
                                 cache_dtype=jnp.float32)
    ps = pserve.RoundTokenServer(p.pcfg, p.pp, policy=ppol, max_seq=64,
                                 cache_dtype=torch.float32, **CPU)
    got = _drain(ps, subs)
    assert got == _drain(js, subs)
    cont = pserve.TokenServer(p.pcfg, p.pp, policy=ppol, max_seq=64,
                              cache_dtype=torch.float32, **CPU)
    assert got == _drain(cont, subs)
    # a failed round goes back to the queue, outputs cleared
    ps.submit(subs[0][0], 3)
    good = ps.serve
    ps.serve = lambda *a: (_ for _ in ()).throw(RuntimeError("die"))
    with pytest.raises(RuntimeError):
        ps.drain()
    assert ps.queue.n_pending == 1
    ps.serve = good
    assert [len(r.out) for r in ps.drain().values()] == [3]


# ------------------------------------------------ decode_step over pools

def _tables(b, pag, caps):
    """Block tables giving rows disjoint pages for ``caps`` positions
    (cap 0: the trash page)."""
    tables = np.zeros((b, pag.max_blocks), np.int32)
    nxt = 1
    for i, cap in enumerate(caps):
        n = -(-cap // pag.page_size)
        tables[i, :n] = np.arange(nxt, nxt + n)
        nxt += n
    return tables, np.asarray(caps, np.int32)


def _paged_steps(p, *, steps, caps, whisper=False, seed=0):
    """Teacher-forced per-row decode_steps over float32 paged caches in
    both packages; returns (reference logits, port logits, reference
    cache, port cache), each logits (steps, B, V)."""
    jpag, ppag = _pagings()
    b = len(caps)
    jm = jax_build_model(p.jcfg, paging=jpag)
    pm = build_model(p.pcfg, params=p.pp, paging=ppag, **CPU)
    tables, caps = _tables(b, ppag, caps)
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, p.pcfg.vocab_size, (steps, b)).astype(np.int32)
    seq = ppag.resolved_max_ctx
    jc = jm.init_cache(b, seq, jnp.float32, per_row=True)
    pc = pm.init_cache(b, seq, torch.float32, per_row=True)
    jc["pages"] = {"tables": jnp.asarray(tables), "caps": jnp.asarray(caps)}
    pc["pages"] = {"tables": torch.from_numpy(tables),
                   "caps": torch.from_numpy(caps)}
    if whisper:
        enc = (rng.normal(size=(b, 12, p.pcfg.d_model)) * 0.1).astype(
            np.float32)
        jc = jm.prefill_cache(p.jp, jnp.asarray(enc), jc)
        pc = pm.prefill_cache(torch.from_numpy(enc), pc)
    jstep = jax.jit(jm.decode_step)
    jl, pl = [], []
    for t in range(steps):
        lg, jc = jstep(p.jp, jc, jnp.asarray(toks[t][:, None]))
        jl.append(np.asarray(lg[:, 0]))
        lg, pc = pm.decode_step(pc, torch.from_numpy(toks[t][:, None]))
        pl.append(lg[:, 0].numpy())
    return np.stack(jl), np.stack(pl), jc, pc


def _same_pools(jc, pc, ps):
    """Every cache leaf equal within 1e-5, the pools (4-D: layers, pool
    slots, heads, hd) outside trash page 0; returns the pools' count."""
    from repro_torch.utils.trees import tree_paths
    ref = dict(tree_paths(jax.device_get(jc)))
    n = 0
    for path, a in tree_paths(pc):
        if path.startswith("pages") or path == "pos":
            continue
        got, r = a.numpy(), np.asarray(ref[path])
        if got.ndim == 4:
            got, r = got[:, ps:], r[:, ps:]
            n += 1
        np.testing.assert_allclose(got, r, rtol=REL, atol=REL, err_msg=path)
    return n


def test_mixed_gemma3_paged_decode_matches_reference():
    """One (swa window 8, global) group: the window ring wraps, the
    global layer pages; logits within 1e-5 each step, argmax equal,
    pools and rings equal (page 0 aside)."""
    p = pair("gemma3-mixed")
    jl, pl, jc, pc = _paged_steps(p, steps=14, caps=[20, 14, 0], seed=1)
    for t in range(jl.shape[0]):
        _close_logits(pl[t], jl[t], f"step {t}")
    np.testing.assert_array_equal(pl[:, :2].argmax(-1), jl[:, :2].argmax(-1))
    assert tuple(pc["seg0"]["p0"]["k"].shape)[3] == 8        # the ring
    assert pc["seg0"]["p1"]["k"].dim() == 4                   # the pool
    assert _same_pools(jc, pc, 8) == 2


def test_mixed_gemma3_server_tokens_match_reference():
    """The mixed group through both packages' paged servers: the prefix
    cache is refused (a ring holds state no page does), tokens equal,
    and the fused route ropes the ring layer in the kernel and the pool
    layer in its projection."""
    p = pair("gemma3-mixed")
    jpag, ppag = _pagings()
    jpol, ppol = _policies()
    subs = _workload(11, p.pcfg.vocab_size, n=5)
    js = jserve.TokenServer(p.jcfg, p.jp, policy=jpol, paging=jpag,
                            cache_dtype=jnp.float32)
    ref = _drain(js, subs)
    for decode_kernel in (False, True):
        srv = pserve.TokenServer(p.pcfg, p.pp, policy=ppol, paging=ppag,
                                 cache_dtype=torch.float32,
                                 decode_kernel=decode_kernel, **CPU)
        assert _drain(srv, subs) == ref
        assert srv.paging_stats()["hits"] == 0
        assert not srv.alloc.prefix_cache
        assert srv.paging_stats() == js.paging_stats()


def test_whisper_paged_decode_matches_reference():
    """whisper's decoder self-attention over pools, cross-attention over
    the contiguous encoder K/V: logits within 1e-5 of the reference's."""
    p = pair("whisper-medium")
    jl, pl, jc, pc = _paged_steps(p, steps=6, caps=[9, 6], whisper=True)
    for t in range(jl.shape[0]):
        _close_logits(pl[t], jl[t], f"step {t}")
    assert tuple(pc["k"].shape) == (p.pcfg.n_layers, _pagings()[1].pool_slots,
                                    p.pcfg.n_kv_heads,
                                    p.pcfg.resolved_head_dim)
    assert _same_pools(jc, pc, 8) == 2


@pytest.mark.parametrize("arch", ["gemma3-27b", "deepseek-67b",
                                  "chameleon-34b"])
def test_new_configs_forward_and_paged_decode_match_reference(arch):
    """Each new config reduced: the full-sequence forward's hidden within
    1e-5, and 8 paged decode steps' logits within 1e-5 (reduced gemma3
    keeps only its sliding-window layers, so nothing of it pages)."""
    p = pair(arch)
    toks = np.random.default_rng(5).integers(
        1, p.pcfg.vocab_size, (2, 12)).astype(np.int32)
    jh, _ = jax_build_model(p.jcfg).apply(p.jp, jnp.asarray(toks))
    ph, _ = build_model(p.pcfg, params=p.pp, **CPU).apply(
        torch.from_numpy(toks))
    _close_logits(ph.detach().numpy(), np.asarray(jh), f"{arch} forward")
    jl, pl, _, pc = _paged_steps(p, steps=8, caps=[10, 8])
    for t in range(jl.shape[0]):
        _close_logits(pl[t], jl[t], f"{arch} step {t}")
    pools = [a for g in pc["seg0"].values() for a in g.values()]
    assert all(a.dim() == (5 if arch == "gemma3-27b" else 4) for a in pools)


# ---------------------------------------------------------------- refusals

def test_paging_refusals_match_reference():
    """Lockstep positions with paging, paged streaming whisper, and
    paging on the LSTM AM are refused by both packages."""
    jpag, ppag = _pagings()
    lm = pair()
    with pytest.raises(ValueError, match="per-row"):
        build_model(lm.pcfg, params=lm.pp, paging=ppag, **CPU).init_cache(
            2, 64)
    with pytest.raises(ValueError, match="per-row"):
        jax_build_model(lm.jcfg, paging=jpag).init_cache(2, 64)
    wcfg = reduced(get_arch("whisper-medium"))
    wm = build_model(wcfg, paging=ppag, generator=torch.Generator()
                     .manual_seed(0), **CPU)
    with pytest.raises(ValueError, match="without paging"):
        wm.init_stream_state(2)
    with pytest.raises(ValueError, match="without paging"):
        jax_build_model(jax_reduced(jax_get_arch("whisper-medium")),
                        paging=jpag).init_stream_state(2)
    am = reduced(get_arch("lstm-am-7khr"))
    with pytest.raises(ValueError, match="no KV cache"):
        build_model(am, paging=ppag, generator=torch.Generator(), **CPU)
    with pytest.raises(ValueError, match="no KV cache"):
        jax_build_model(jax_reduced(jax_get_arch("lstm-am-7khr")),
                        paging=jpag)
    with pytest.raises(ValueError, match="token-LM"):
        pserve.TokenServer(am, {}, paging=ppag, **CPU)
