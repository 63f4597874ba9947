"""Host-side page allocator and sequence (session) manager.

Copy of ``lmdeploy_tpu/kvcache/manager.py`` (numpy only; the port
imports nothing of the JAX package).  The per-sequence ``rng_key`` field
is kept as opaque host data.

The "cache of KV caches" of the reference (src/turbomind/models/llama/
LlamaCacheManager.cc) rebuilt around pages instead of per-sequence slabs:

- :class:`PageAllocator` — free-list over the device KV pool's P pages,
  chunked growth semantics replaced by page granularity.
- :class:`SequenceManager` — create/fetch/update/erase with LRU eviction
  of inactive sequences (evict:162-183).  Evicted sequences keep their
  token ids so a later fetch re-decodes the missing tokens (the reference's
  cache-miss path, LlamaBatch.cc:680-699).  Per-sequence RNG key data is
  snapshotted here exactly like the reference snapshots curand state
  (LlamaBatch.cc:363-377,1097-1108) — with JAX keys it is just two uint32s.
  Deliberate difference: ``cache_max_entry_count`` trims the oldest
  inactive sessions but never the one being created.  The JAX store
  erases it when every other session is active (a batch larger than the
  bound, or the prompt-logits scratch session beside a full batch of that
  size), and its first growth then fails; here the count stays over the
  bound until a session is released.

Beyond-reference: **cross-session prefix caching** (vLLM-style automatic
prefix caching; the reference only reuses KV within one interactive
session).  Full pages whose token *prefix* matches a previously
published page are shared read-only between sequences:

- KV page content is a pure function of (all tokens up to the page end,
  positions) — positions coincide for a shared prefix, so pages are
  content-addressable by a chain digest d_i = H(d_{i-1} || page tokens).
- Hits are verified EXACTLY (stored parent digest + page token span;
  induction over the chain), the digest is only a lookup key.
- Only FULL pages are shared, and a sequence never writes at a position
  below ``shared_pages * page_size`` (match caps at the last boundary
  strictly before the final prompt token; rewinds privatize via
  :meth:`SequenceManager.prepare_rewrite`), so shared pages are
  immutable while referenced.
- Published pages are reference-counted; sequences deref on erase /
  eviction, the index itself holds one reference, and index entries are
  LRU-reclaimed only when every other owner is gone and the allocator
  is under pressure (live sessions evict first — published prefixes,
  e.g. a common system prompt, are the most reusable bytes in the pool).
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


class NoFreePages(Exception):
    pass


class PageAllocator:
    """Free-list allocator over page ids [0, num_pages)."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._lock = threading.Lock()

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        with self._lock:
            if n > len(self._free):
                raise NoFreePages(f'need {n}, have {len(self._free)}')
            out = [self._free.pop() for _ in range(n)]
            return out

    def free(self, pages: List[int]) -> None:
        with self._lock:
            self._free.extend(pages)


@dataclasses.dataclass
class Sequence:
    """One interactive session's cached state (reference:
    LlamaCacheManager.h:47-62 — token_ids, cache_len, ptrs, rng, timestamp)."""
    seq_id: int
    token_ids: List[int] = dataclasses.field(default_factory=list)
    cache_len: int = 0                  # tokens with valid KV in pages
    pages: List[int] = dataclasses.field(default_factory=list)
    rng_key: Optional[np.ndarray] = None  # uint32 [2]
    timestamp: float = 0.0
    active: bool = False                # currently bound to a batch slot
    shared_pages: int = 0               # leading pages shared via the
    # prefix index (read-only; invariant: cache_len >= shared_pages * ps
    # and every KV write lands at a position >= shared_pages * ps)

    @property
    def history_len(self) -> int:
        return len(self.token_ids)


@dataclasses.dataclass
class _Published:
    """One prefix-index entry: a full, immutable KV page addressed by the
    chain digest of every token up to its end.  ``tokens`` (this page's
    span) is compared on every hit; combined with the walk-from-page-0
    chain structure that makes hits exact by induction — the digest is
    only a lookup key."""
    page: int
    tokens: Tuple[int, ...]       # this page's page_size token ids
    last_use: float


def _chain_digest(parent: bytes, tokens) -> bytes:
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


class SequenceManager:
    """Session store with LRU eviction and miss-recompute semantics."""

    def __init__(self, allocator: PageAllocator, page_size: int,
                 max_entries: int = 0, enable_prefix_cache: bool = True):
        self.allocator = allocator
        self.page_size = page_size
        self.max_entries = max_entries  # 0 = unbounded (pages still bound)
        self._seqs: Dict[int, Sequence] = {}
        self._lock = threading.Lock()
        self.enable_prefix_cache = enable_prefix_cache
        self._prefix: Dict[bytes, _Published] = {}
        self._page_refs: Dict[int, int] = {}  # shared pages: owner count
        self.prefix_hits = 0      # pages served from the index
        self.prefix_lookups = 0   # pages probed

    def __contains__(self, seq_id: int) -> bool:
        return seq_id in self._seqs

    @property
    def free_count(self) -> int:
        return self.allocator.free_count

    def get(self, seq_id: int) -> Optional[Sequence]:
        return self._seqs.get(seq_id)

    def create(self, seq_id: int) -> Sequence:
        """(Re)create a session; frees any previous state under this id
        (reference: LlamaCacheManager::create erases an existing entry)."""
        self.erase(seq_id)
        seq = Sequence(seq_id=seq_id, timestamp=time.monotonic())
        with self._lock:
            self._seqs[seq_id] = seq
        self._maybe_trim(keep=seq_id)
        return seq

    def fetch(self, seq_id: int) -> Optional[Sequence]:
        """Return an existing session (possibly evicted -> cache_len==0 and
        empty pages; caller must re-decode token_ids)."""
        seq = self._seqs.get(seq_id)
        if seq is not None:
            seq.timestamp = time.monotonic()
        return seq

    def erase(self, seq_id: int) -> None:
        with self._lock:
            seq = self._seqs.pop(seq_id, None)
            if seq is not None and seq.pages:
                self._drop_pages_locked(seq)

    def _drop_pages_locked(self, seq: Sequence) -> None:
        """Return a sequence's pages: shared ones deref (the prefix index
        keeps them alive), private ones go back to the allocator."""
        for i, p in enumerate(seq.pages):
            if i < seq.shared_pages:
                self._deref_locked(p)
            else:
                self.allocator.free([p])
        seq.pages = []
        seq.cache_len = 0
        seq.shared_pages = 0

    def _deref_locked(self, page: int) -> None:
        n = self._page_refs.get(page, 0) - 1
        if n <= 0:
            self._page_refs.pop(page, None)
            self.allocator.free([page])
        else:
            self._page_refs[page] = n

    def grow(self, seq: Sequence, new_total_tokens: int) -> List[int]:
        """Ensure the sequence has pages covering ``new_total_tokens``;
        evicts LRU inactive sequences (then unused prefix-index pages) on
        pressure.  Returns the page list.
        Raises NoFreePages when even full eviction cannot satisfy."""
        need = -(-new_total_tokens // self.page_size)  # ceil
        while len(seq.pages) < need:
            want = need - len(seq.pages)
            try:
                seq.pages.extend(self.allocator.alloc(want))
            except NoFreePages:
                if not self._evict_one(exclude=seq.seq_id):
                    raise
        return seq.pages

    def release(self, seq: Sequence) -> None:
        """Unbind from batch slot, keep cache for future turns."""
        seq.active = False
        seq.timestamp = time.monotonic()

    def _evict_one(self, exclude: int) -> bool:
        """Free the pages of the least-recently-used inactive sequence
        (reference: LlamaCacheManager::evict; keeps token ids), falling
        back to reclaiming LRU unreferenced prefix-index pages."""
        with self._lock:
            candidates = [s for s in self._seqs.values()
                          if not s.active and s.pages and s.seq_id != exclude]
            if candidates:
                victim = min(candidates, key=lambda s: s.timestamp)
                self._drop_pages_locked(victim)
                return True
            return self._evict_index_locked()

    def _evict_index_locked(self) -> bool:
        """Reclaim the LRU prefix-index entry no sequence references."""
        best = None
        for d, ent in self._prefix.items():
            if self._page_refs.get(ent.page, 0) == 1:  # index-only owner
                if best is None or ent.last_use < best[1].last_use:
                    best = (d, ent)
        if best is None:
            return False
        d, ent = best
        del self._prefix[d]
        self._deref_locked(ent.page)
        return True

    def _maybe_trim(self, keep: int) -> None:
        """Bound the number of cached sessions (cache_max_entry_count) by
        dropping the oldest inactive ones; never ``keep``, the session
        being created (when every other one is active, the count stays
        over the bound until some session is released)."""
        if not self.max_entries:
            return
        with self._lock:
            inactive = [s for s in self._seqs.values()
                        if not s.active and s.seq_id != keep]
            excess = len(self._seqs) - self.max_entries
            if excess <= 0:
                return
            for victim in sorted(inactive, key=lambda s: s.timestamp)[:excess]:
                if victim.pages:
                    self._drop_pages_locked(victim)
                del self._seqs[victim.seq_id]

    # -- prefix caching (beyond-reference; see module docstring) ------------

    def match_prefix(self, seq: Sequence, all_ids: List[int]) -> int:
        """Attach published pages covering the longest page-aligned prefix
        of ``all_ids`` to a pageless sequence; returns the token count now
        cached.  Caps at the last boundary STRICTLY before the final
        token so the first KV write (the last prompt token, decoded not
        prefilled) always lands in a private page."""
        ps = self.page_size
        if not self.enable_prefix_cache or seq.pages or len(all_ids) < 2:
            return 0
        max_pages = (len(all_ids) - 1) // ps
        matched: List[int] = []
        now = time.monotonic()
        with self._lock:
            d = b''
            for i in range(max_pages):
                span = tuple(all_ids[i * ps:(i + 1) * ps])
                d = _chain_digest(d, span)
                self.prefix_lookups += 1
                ent = self._prefix.get(d)
                if ent is None or ent.tokens != span:
                    break
                ent.last_use = now
                matched.append(ent.page)
            for p in matched:
                self._page_refs[p] = self._page_refs.get(p, 0) + 1
            self.prefix_hits += len(matched)
        seq.pages = matched
        seq.shared_pages = len(matched)
        seq.cache_len = len(matched) * ps
        return seq.cache_len

    def publish(self, seq: Sequence) -> None:
        """Publish every full cached page of ``seq`` into the prefix
        index.  Pages whose digest is already published are swapped for
        the existing copy (the duplicate goes back to the allocator) —
        adoption is only safe when the sequence is NOT bound to a batch
        slot (the device page-table row is rebuilt at next admission),
        so an ACTIVE sequence publishes in insert-only mode: new content
        becomes shareable immediately after its prefill (long-running
        generations expose their prompt to followers without waiting for
        retirement), duplicates are deduped at retirement."""
        ps = self.page_size
        if not self.enable_prefix_cache:
            return
        adopt = not seq.active
        full = min(seq.cache_len // ps, len(seq.pages))
        now = time.monotonic()
        shared_upto = seq.shared_pages
        with self._lock:
            d = b''
            for i in range(full):
                span = tuple(seq.token_ids[i * ps:(i + 1) * ps])
                d = _chain_digest(d, span)
                ent = self._prefix.get(d)
                if ent is not None and ent.tokens == span:
                    if ent.page != seq.pages[i]:
                        if not adopt:
                            # keep the private duplicate while the
                            # device page row points at it; dedupe at
                            # retirement.  shared_upto must NOT advance
                            # past this unpublished page.
                            ent.last_use = now
                            break
                        # adopt the published copy, drop the duplicate
                        if i < seq.shared_pages:
                            self._deref_locked(seq.pages[i])
                        else:
                            self.allocator.free([seq.pages[i]])
                        seq.pages[i] = ent.page
                        self._page_refs[ent.page] = \
                            self._page_refs.get(ent.page, 0) + 1
                    ent.last_use = now
                elif ent is None:
                    # publish this page; the index takes one ownership
                    # ref (already-shared pages keep the seq's existing
                    # ref, private ones gain the seq's ref too)
                    self._prefix[d] = _Published(
                        page=seq.pages[i], tokens=span, last_use=now)
                    add = 1 if i < seq.shared_pages else 2
                    self._page_refs[seq.pages[i]] = \
                        self._page_refs.get(seq.pages[i], 0) + add
                else:
                    # digest collision with different tokens: stop the
                    # chain (later pages would be unreachable anyway)
                    break
                shared_upto = max(shared_upto, i + 1)
            seq.shared_pages = shared_upto

    def prepare_rewrite(self, seq: Sequence, new_cache_len: int) -> int:
        """Make it safe to (re)write KV from ``new_cache_len`` onward:
        shared pages at/after the write point are replaced with fresh
        private pages (their content will be re-prefilled), and the
        cache length drops to the last still-shared boundary when the
        write point lands inside a shared page.  Returns the effective
        cache length (the engine re-decodes the rest — the same
        miss-recompute path as eviction, LlamaBatch.cc:680-699)."""
        ps = self.page_size
        j = new_cache_len // ps
        if seq.shared_pages <= j:
            return new_cache_len
        for i in range(j, min(seq.shared_pages, len(seq.pages))):
            fresh = None
            while fresh is None:
                try:
                    fresh = self.allocator.alloc(1)[0]
                except NoFreePages:
                    if not self._evict_one(exclude=seq.seq_id):
                        raise
            with self._lock:
                self._deref_locked(seq.pages[i])
            seq.pages[i] = fresh
        seq.shared_pages = j
        return min(new_cache_len, j * ps)

    def flush_prefix(self) -> None:
        """Drop the whole prefix index (device pool content invalidated,
        e.g. engine recovery after a backend error)."""
        with self._lock:
            for ent in self._prefix.values():
                self._deref_locked(ent.page)
            self._prefix.clear()


class GroupedSequenceManager:
    """dp-group façade over independent per-group sequence managers.

    Each dp group owns its own page pool (one shard of the device KV
    pool's page dim) with pool-LOCAL page ids, so a session is sticky to
    the group holding its pages.  This is the host half of the engine's
    dp scale-out (SURVEY.md §7 step 9) — the reference has no equivalent
    (single-node NCCL engine, turbomind.py:81-83 hard-codes node 0).
    Works over both the Python and native-C++ per-group backends.
    """

    def __init__(self, managers):
        self.managers = list(managers)
        self.page_size = self.managers[0].page_size
        self._group: Dict[int, int] = {}
        self._lock = threading.Lock()

    @property
    def num_groups(self) -> int:
        return len(self.managers)

    def __contains__(self, seq_id: int) -> bool:
        return seq_id in self._group

    def group_of(self, seq_id: int) -> Optional[int]:
        return self._group.get(seq_id)

    def free_count(self, group: int) -> int:
        return self.managers[group].free_count

    def create(self, seq_id: int, group: int = 0):
        self.erase(seq_id)
        with self._lock:
            self._group[seq_id] = group
        return self.managers[group].create(seq_id)

    def fetch(self, seq_id: int):
        g = self._group.get(seq_id)
        return None if g is None else self.managers[g].fetch(seq_id)

    def get(self, seq_id: int):
        g = self._group.get(seq_id)
        return None if g is None else self.managers[g].get(seq_id)

    def erase(self, seq_id: int) -> None:
        with self._lock:
            g = self._group.pop(seq_id, None)
        if g is not None:
            self.managers[g].erase(seq_id)

    def grow(self, seq, new_total_tokens: int):
        return self.managers[self._group[seq.seq_id]].grow(
            seq, new_total_tokens)

    def release(self, seq) -> None:
        self.managers[self._group[seq.seq_id]].release(seq)

    def match_prefix(self, seq, all_ids) -> int:
        """Per-group prefix caching (page ids are pool-local, so a
        prefix hit only ever matches pages of the session's own group)."""
        return self.managers[self._group[seq.seq_id]].match_prefix(
            seq, all_ids)

    def publish(self, seq) -> None:
        self.managers[self._group[seq.seq_id]].publish(seq)

    def prepare_rewrite(self, seq, new_cache_len: int) -> int:
        return self.managers[self._group[seq.seq_id]].prepare_rewrite(
            seq, new_cache_len)

    @property
    def prefix_hits(self) -> int:
        return sum(m.prefix_hits for m in self.managers)

    @property
    def prefix_lookups(self) -> int:
        return sum(m.prefix_lookups for m in self.managers)

    def clear(self) -> None:
        """Drop every session AND the prefix index (device-state reset
        after a backend error: cached KV content is gone, so neither
        sessions nor published pages can be trusted)."""
        with self._lock:
            ids = list(self._group.items())
            self._group.clear()
        for seq_id, g in ids:
            self.managers[g].erase(seq_id)
        for m in self.managers:
            m.flush_prefix()


__all__ = ['PageAllocator', 'Sequence', 'SequenceManager',
           'GroupedSequenceManager', 'NoFreePages']
