"""Host-side page allocator for the paged decode cache.

The port's copy of the reference's ``serve/paging.py``, line for line:
under the same sequence of calls it hands out the same page ids, keeps
the same LRU order and counts the same ``stats``.

The device side (``repro_torch.models.paging``) only sees a block table;
every policy decision — which pages a row gets, when they return to the
free list, which prompt-prefix blocks are shared between rows — lives
here, in plain Python.  vLLM's design, scaled down: fixed-size pages, a
free list, refcounts for copy-on-nothing prefix sharing (a shared page
is never written: writes start at the first non-shared block), and an
LRU of ref-0 published pages that is only cannibalised when the free
list runs dry.

Page id 0 is the trash page (retired rows point at it) and is never
handed out; valid ids are 1..n_pages.

``block_hashes`` chains Python's ``hash`` from ``hash(("paged-kv",
page_size))``.  Python salts the hash of a ``str`` per process
(``PYTHONHASHSEED``), so a hash is comparable only within one process:
an allocator and the prompts it hashes live in one server, and the two
packages agree on the hashes only when they run in the same process.
"""
from __future__ import annotations

from collections import OrderedDict


def block_hashes(tokens, page_size):
    """Chained content hashes for the *sharable* prompt blocks.

    Block j is sharable only if the prompt extends strictly past it
    (``(j+1)*page_size <= len(tokens) - 1``): the last prompt position
    may be overwritten in-place by the overshoot clamp when a row
    retires, so a block containing it can never be published.  Chaining
    makes hash j depend on all tokens before it, so equal hashes ⇒ equal
    prefixes (modulo hash collisions, same trade-off vLLM makes).
    """
    hashes = []
    h = hash(("paged-kv", page_size))
    for j in range(len(tokens) // page_size):
        if (j + 1) * page_size > len(tokens) - 1:
            break
        h = hash((h, tuple(int(t) for t in
                           tokens[j * page_size:(j + 1) * page_size])))
        hashes.append(h)
    return hashes


class PageAllocator:
    """Free-list allocator with refcounted prefix caching.

    Invariant (checked by ``check()``): every page 1..n_pages is in
    exactly one of {free list, live (ref > 0), cached (ref == 0, in the
    LRU awaiting reuse or eviction)}.
    """

    def __init__(self, n_pages, page_size, *, prefix_cache=True):
        if n_pages < 1:
            raise ValueError("need at least one page")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.prefix_cache = bool(prefix_cache)
        # pop() yields ascending ids — keeps early pages hot/debuggable
        self._free = list(range(self.n_pages, 0, -1))
        self._ref = {}            # page -> refcount (live pages only)
        self._hash_of = {}        # page -> content hash (published)
        self._page_of = {}        # content hash -> page (published)
        self._lru = OrderedDict() # ref-0 published pages, oldest first
        self.stats = {"hits": 0, "misses": 0, "evictions": 0,
                      "allocs": 0, "peak_pages": 0}

    # ---- capacity ----
    def free_pages(self):
        return len(self._free) + len(self._lru)

    def live_pages(self):
        return sum(1 for r in self._ref.values() if r > 0)

    def can_alloc(self, n):
        return n <= self.free_pages()

    # ---- alloc / release ----
    def alloc(self, n):
        """Take ``n`` fresh pages (ref=1 each).  Evicts cached ref-0
        pages LRU-first only when the free list is empty."""
        if not self.can_alloc(n):
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {self.free_pages()}")
        out = []
        for _ in range(n):
            if self._free:
                page = self._free.pop()
            else:
                page, _ = self._lru.popitem(last=False)
                h = self._hash_of.pop(page)
                del self._page_of[h]
                del self._ref[page]
                self.stats["evictions"] += 1
            self._ref[page] = 1
            out.append(page)
        self.stats["allocs"] += n
        self.stats["peak_pages"] = max(self.stats["peak_pages"],
                                       self.live_pages())
        return out

    def release(self, pages):
        """Drop one reference from each page.  A published page whose
        refcount hits zero parks in the LRU (contents stay valid for
        future prefix hits); an unpublished one returns to the free
        list."""
        for page in pages:
            self._ref[page] -= 1
            if self._ref[page] > 0:
                continue
            if page in self._hash_of:
                self._lru[page] = None
                self._lru.move_to_end(page)
            else:
                del self._ref[page]
                self._free.append(page)

    # ---- prefix cache ----
    def peek_prefix(self, hashes):
        """How many leading blocks of ``hashes`` are already resident."""
        if not self.prefix_cache:
            return 0
        n = 0
        for h in hashes:
            if h not in self._page_of:
                break
            n += 1
        return n

    def parked_prefix(self, hashes):
        """How many of the resident blocks ``hashes`` name are parked in
        the LRU (ref 0).  ``acquire_prefix`` takes them out of the free
        capacity, so an admission needs ``can_alloc(fresh + parked)``.
        The port's addition: the reference's server checks
        ``can_alloc(fresh)`` alone, and its ``alloc`` then raises when
        the hit pages were the capacity that made the check pass."""
        return sum(self._page_of[h] in self._lru for h in hashes)

    def acquire_prefix(self, hashes):
        """Take a reference on each published block (must all be
        resident — call ``peek_prefix`` first).  Returns the pages."""
        pages = []
        for h in hashes:
            page = self._page_of[h]
            if page in self._lru:          # ref 0 -> back to live
                del self._lru[page]
                self._ref[page] = 1
            else:
                self._ref[page] += 1
            pages.append(page)
            self.stats["hits"] += 1
        return pages

    def publish(self, page, h):
        """Register a full, final block for future prefix sharing."""
        if not self.prefix_cache:
            return
        if page in self._hash_of or h in self._page_of:
            return                          # already published / dup hash
        self._hash_of[page] = h
        self._page_of[h] = page

    def note_miss(self, n):
        self.stats["misses"] += n

    # ---- lifecycle ----
    def reset(self):
        """Forget everything (device pools were just dropped, so cached
        page contents are invalid).  Stats survive."""
        self._free = list(range(self.n_pages, 0, -1))
        self._ref.clear()
        self._hash_of.clear()
        self._page_of.clear()
        self._lru.clear()

    def check(self):
        """Conservation invariant; raises AssertionError on a leak."""
        live = {p for p, r in self._ref.items() if r > 0}
        cached = set(self._lru)
        free = set(self._free)
        assert not (live & free), f"pages both live and free: {live & free}"
        assert not (cached & free), \
            f"pages both cached and free: {cached & free}"
        assert cached <= set(self._ref), "cached page missing refcount"
        assert all(self._ref[p] == 0 for p in cached), \
            "cached page with nonzero refcount"
        union = live | cached | free
        assert union == set(range(1, self.n_pages + 1)), \
            f"page leak: missing {set(range(1, self.n_pages + 1)) - union}"
        assert len(self._free) + len(live) + len(cached) == self.n_pages
