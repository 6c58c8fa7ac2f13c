"""Paged KV cache: one fixed block arena + per-slot block tables.

The counterpart of ``repro.serve.cache``: the same allocator, block for
block, over the port's ``models.transformer.PagedState``, whose tensors are
written in place (index copies from device index tensors, no host
synchronisation) where the reference donates them to jitted updates.

The arena carves ``n_blocks`` blocks of ``block_len`` token rows per layer
out of a single global token budget (``models.transformer.PagedState``), so
serving never re-allocates a cache per prompt-length bucket.  Each batch
slot owns an ordered *block table*; because a slot fills its blocks
strictly in order, the gathered table is a dense per-slot cache view in
which row ``p`` holds position ``p`` — ``attend_decode``'s ``pos == -1``
masking (the same path ragged cohort serving uses) does the rest.

This module is the HOST side: a free-list allocator with
``alloc / append / free`` lifecycle plus admission accounting.  A request
admitted with ``admit()`` reserves its full lifetime block count up front
(prefill blocks are allocated immediately, decode blocks lazily as the
sequence crosses block boundaries), so a mid-decode allocation can never
deadlock the arena: if the blocks aren't guaranteed, admission refuses.

Block id 0 is a scratch block: inactive slots' decode writes land there
and unused table entries gather it with positions forced to -1, so stale
rows are never attended.  Freed blocks get their position rows cleared on
``free_slot`` for the same reason.

Prefix sharing (``prefix_cache=True``) adds a content-address layer on
top: FULL blocks are registered under a chain hash of the token ids they
hold (hash of ``tokens[: (j+1)*block_len]``, so a match at block ``j``
implies all earlier blocks match too), and every block carries a
refcount.  ``admit_shared`` maps the longest registered prefix into a new
slot's table without copying — the slots literally share arena blocks.
``free_slot`` decrements refcounts; a registered block whose refcount
hits zero is *retained* in an evictable LRU pool (its content IS the
cache value) and only scrubbed when ``_alloc`` must evict it for fresh
storage.  A shared block is never mutated in place: ``append`` routes
through ``ensure_private`` which copy-on-writes the block when its
refcount is > 1 (the producer of that situation is ``fork_slot``;
scheduler-path sharing only ever maps full, finished blocks).
"""
from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.config import ArchConfig
from ..models import transformer as tfm

__all__ = ["PagedKVCache", "next_pow2", "scatter_prefill", "block_hashes"]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids, np.int64), device=device)


def _copy_block(state: tfm.PagedState, src: int, dst: int) -> None:
    """Copy-on-write: duplicate arena block ``src`` into ``dst`` (all
    layers + position rows), in place."""
    state.k[:, dst].copy_(state.k[:, src])
    state.v[:, dst].copy_(state.v[:, src])
    state.pos[dst].copy_(state.pos[src])


def block_hashes(tokens: np.ndarray, n_blocks: int, block_len: int
                 ) -> List[bytes]:
    """Chain hashes for the first ``n_blocks`` FULL blocks of ``tokens``.

    Entry ``j`` digests ``tokens[: (j+1)*block_len]`` (incrementally), so
    equal hashes at ``j`` imply the whole prefix matches — a block is
    only ever shared together with everything before it."""
    toks = np.ascontiguousarray(tokens, dtype=np.int32)
    if len(toks) < n_blocks * block_len:
        raise ValueError(f"{n_blocks} blocks of {block_len} need "
                         f"{n_blocks * block_len} tokens, got {len(toks)}")
    h = hashlib.blake2b(digest_size=16)
    out: List[bytes] = []
    for j in range(n_blocks):
        h.update(toks[j * block_len:(j + 1) * block_len].tobytes())
        out.append(h.copy().digest())
    return out


def scatter_prefill(paged: tfm.PagedState, k_dense, v_dense, pos_dense, ids
                    ) -> tfm.PagedState:
    """Scatter one request's dense prefill cache into its arena blocks, in
    place (index copies, no host synchronisation); returns ``paged``.
    k/v_dense: (L, 1, bucket, KV, hd); pos_dense: (bucket,) with pad rows
    already -1; ids: (nb,) target block ids on the arena's device, nb *
    block_len == bucket."""
    L, _, bucket, kv, hd = k_dense.shape
    nb = ids.shape[0]
    bl = bucket // nb
    paged.k.index_copy_(1, ids, k_dense[:, 0].reshape(L, nb, bl, kv, hd)
                        .to(paged.k.dtype))
    paged.v.index_copy_(1, ids, v_dense[:, 0].reshape(L, nb, bl, kv, hd)
                        .to(paged.v.dtype))
    paged.pos.index_copy_(0, ids, pos_dense.reshape(nb, bl)
                          .to(paged.pos.dtype))
    return paged


class PagedKVCache:
    """Block-arena KV cache for ``batch`` slots under one token budget.

    ``total_tokens`` is the global arena budget (rounded up to whole
    blocks); ``max_seq`` bounds any single slot's length and sizes the
    block table width.  The device arena lives in ``self.state``
    (a ``models.transformer.PagedState``)."""

    def __init__(self, cfg: ArchConfig, batch: int, *, total_tokens: int,
                 max_seq: int, block_len: int = 16, dtype=None,
                 prefix_cache: bool = False, device=None):
        if block_len < 1:
            raise ValueError("block_len must be >= 1")
        self.cfg = cfg
        self.batch = batch
        self.block_len = block_len
        self.prefix_cache = bool(prefix_cache)
        self.max_blocks_per_slot = max(
            1, math.ceil(max_seq / block_len))
        self.max_seq = self.max_blocks_per_slot * block_len
        # +1: block 0 is the reserved scratch block, never allocated
        self.n_blocks = 1 + max(self.blocks_for(total_tokens),
                                self.max_blocks_per_slot)
        self.device = torch.device(device or "cuda")
        self.state = tfm.init_paged_state(cfg, self.n_blocks, block_len,
                                          dtype=dtype, device=self.device)
        # LIFO free list: a just-freed block is re-used first
        self._free: List[int] = list(range(self.n_blocks - 1, 0, -1))
        self.tables = np.full((batch, self.max_blocks_per_slot), -1,
                              np.int32)
        self._slot_blocks: List[List[int]] = [[] for _ in range(batch)]
        # blocks promised to admitted slots but not yet allocated
        self._slot_reserved = np.zeros((batch,), np.int64)
        # device copy of self.tables, re-uploaded only when tables change
        # (most decode steps allocate nothing, so the upload is elided)
        self._dev_tables: Optional[torch.Tensor] = None
        # -- prefix sharing state (inert when prefix_cache is False) --------
        self._ref = np.zeros((self.n_blocks,), np.int32)
        self._block_hash: Dict[int, bytes] = {}     # block id -> chain hash
        self._hash_to_block: Dict[bytes, int] = {}  # chain hash -> block id
        # registered blocks with refcount 0, retained for future matches;
        # ordered oldest-freed first (eviction order)
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self.hit_tokens = 0   # prompt rows served from shared blocks
        self.miss_tokens = 0  # prompt rows computed fresh

    # -- accounting ---------------------------------------------------------

    def blocks_for(self, n_tokens: int) -> int:
        return math.ceil(max(int(n_tokens), 0) / self.block_len)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def reserved_blocks(self) -> int:
        return int(self._slot_reserved.sum())

    @property
    def used_blocks(self) -> int:
        return sum(len(b) for b in self._slot_blocks)

    @property
    def evictable_blocks(self) -> int:
        """Registered refcount-0 blocks retained for prefix matches;
        reclaimable by ``_alloc`` at any time, so admission counts them
        as available."""
        return len(self._cached)

    @property
    def cache_hit_ratio(self) -> float:
        total = self.hit_tokens + self.miss_tokens
        return self.hit_tokens / total if total else 0.0

    def can_admit(self, lifetime_tokens: int) -> bool:
        """Fit-by-free-blocks admission: the request's whole lifetime
        (prefill + planned decode) must fit in unreserved free blocks.
        Conservative under prefix sharing: assumes a zero-length match
        (shared blocks only ever reduce the real draw), so an admitted
        request can never deadlock the arena."""
        need = self.blocks_for(lifetime_tokens)
        return (need <= self.free_blocks + self.evictable_blocks
                - self.reserved_blocks
                and need <= self.max_blocks_per_slot)

    # -- lifecycle ----------------------------------------------------------

    def _unregister(self, bid: int) -> None:
        h = self._block_hash.pop(bid, None)
        if h is not None and self._hash_to_block.get(h) == bid:
            del self._hash_to_block[h]

    def _scrub(self, ids: List[int]) -> None:
        """Clear freed blocks' position rows on device, in place."""
        self.state.pos.index_fill_(0, _ids(ids, self.device), -1)

    def _alloc(self, n: int) -> List[int]:
        out: List[int] = []
        evicted: List[int] = []
        for _ in range(n):
            if self._free:
                out.append(self._free.pop())
            elif self._cached:
                # reclaim the least-recently-freed retained block: forget
                # its content address and scrub its rows before reuse
                bid, _ = self._cached.popitem(last=False)
                self._unregister(bid)
                evicted.append(bid)
                out.append(bid)
            else:
                if evicted:              # already unregistered: scrub them
                    self._scrub(evicted)
                self._free.extend(reversed(out))
                raise RuntimeError(
                    f"arena exhausted: need {n} blocks, {len(out)} "
                    f"available (admission accounting bug)")
        if evicted:
            self._scrub(evicted)
        for bid in out:
            self._ref[bid] = 1
        return out

    def admit(self, slot: int, prefill_tokens: int,
              lifetime_tokens: int) -> List[int]:
        """Reserve ``lifetime_tokens`` worth of blocks for ``slot`` and
        allocate the prefill prefix now.  Returns the prefill block ids."""
        if self._slot_blocks[slot] or self._slot_reserved[slot]:
            raise RuntimeError(f"slot {slot} already admitted")
        if not self.can_admit(lifetime_tokens):
            raise RuntimeError(f"slot {slot}: admission check not honored")
        n_now = self.blocks_for(prefill_tokens)
        total = max(self.blocks_for(lifetime_tokens), n_now)
        ids = self._alloc(n_now)
        self._slot_blocks[slot] = list(ids)
        self.tables[slot, :n_now] = ids
        self._dev_tables = None
        self._slot_reserved[slot] = total - n_now
        return ids

    def append(self, slot: int, pos: int) -> None:
        """Ensure the block holding row ``pos`` exists — and is safe to
        mutate — before a decode write.  Allocates the slot's next block
        (from its reservation) when ``pos`` crosses a block boundary;
        copy-on-writes the target when it is shared (refcount > 1)."""
        j = pos // self.block_len
        if j < len(self._slot_blocks[slot]):
            self.ensure_private(slot, j)
            return
        if j != len(self._slot_blocks[slot]) or j >= self.max_blocks_per_slot:
            raise RuntimeError(
                f"slot {slot}: non-contiguous append at pos {pos}")
        if self._slot_reserved[slot] <= 0:
            raise RuntimeError(
                f"slot {slot}: append beyond reserved lifetime at pos {pos}")
        (bid,) = self._alloc(1)
        self._slot_blocks[slot].append(bid)
        self.tables[slot, j] = bid
        self._dev_tables = None
        self._slot_reserved[slot] -= 1

    def ensure_private(self, slot: int, j: int) -> None:
        """Make the slot's ``j``-th block safe to mutate.

        refcount > 1: copy-on-write — allocate a fresh block (drawn from
        the slot's reservation, which ``fork_slot`` sized to include it),
        device-copy the shared content, and repoint this slot's table;
        the other holders keep the original.  refcount == 1 but still
        content-registered: unregister in place — the mutation is about
        to invalidate the hash (defensive: the chunked scheduler never
        mutates a registered block, see ``register_prefix``)."""
        bid = self._slot_blocks[slot][j]
        if self._ref[bid] > 1:
            if self._slot_reserved[slot] <= 0:
                raise RuntimeError(
                    f"slot {slot}: copy-on-write of block {bid} exceeds "
                    f"reserved lifetime")
            (new,) = self._alloc(1)
            self._slot_reserved[slot] -= 1
            _copy_block(self.state, bid, new)
            self._slot_blocks[slot][j] = new
            self.tables[slot, j] = new
            self._dev_tables = None
            self._ref[bid] -= 1
        elif bid in self._block_hash:
            self._unregister(bid)

    def extend_to(self, slot: int, n_rows: int) -> None:
        """Chunked prefill: allocate blocks (from the reservation) so the
        slot's table covers rows ``[0, n_rows)``.  Shared prefix blocks
        mapped by ``admit_shared`` already count as covered."""
        need = self.blocks_for(n_rows)
        if need > self.max_blocks_per_slot:
            raise RuntimeError(
                f"slot {slot}: {n_rows} rows exceed max_seq {self.max_seq}")
        blocks = self._slot_blocks[slot]
        while len(blocks) < need:
            if self._slot_reserved[slot] <= 0:
                raise RuntimeError(
                    f"slot {slot}: extend beyond reserved lifetime at "
                    f"{n_rows} rows")
            (bid,) = self._alloc(1)
            self.tables[slot, len(blocks)] = bid
            blocks.append(bid)
            self._dev_tables = None
            self._slot_reserved[slot] -= 1

    def free_slot(self, slot: int) -> List[int]:
        """Release the slot: drop its outstanding lifetime reservation
        (even mid-prefill — reserved-but-unallocated blocks return to the
        admission pool), decrement each mapped block's refcount, and
        retire refcount-0 blocks.  Private retirees go back to the free
        list (LIFO) with their position rows scrubbed so a future tenant
        never attends stale entries; content-registered retirees are
        retained in the evictable prefix pool instead (their rows ARE the
        cached value — ``_alloc`` scrubs them only on eviction)."""
        ids = self._slot_blocks[slot]
        self._slot_blocks[slot] = []
        self._slot_reserved[slot] = 0
        self.tables[slot, :] = -1
        self._dev_tables = None
        to_free: List[int] = []
        for bid in ids:
            self._ref[bid] -= 1
            if self._ref[bid] > 0:
                continue                 # another slot still maps it
            if self.prefix_cache and bid in self._block_hash:
                self._cached[bid] = None
                self._cached.move_to_end(bid)
            else:
                self._unregister(bid)
                to_free.append(bid)
        if to_free:
            self._scrub(to_free)
            self._free.extend(to_free)
        return ids

    # -- prefix sharing -----------------------------------------------------

    def match_prefix(self, tokens: np.ndarray, max_rows: int) -> List[int]:
        """Longest registered prefix of ``tokens`` in whole blocks, capped
        at ``max_rows`` rows (callers cap to keep prefill dispatch shapes
        identical across hit lengths).  Returns the matching block ids in
        order; does NOT take references — ``admit_shared`` does."""
        if not self.prefix_cache:
            return []
        limit = min(len(tokens), max_rows) // self.block_len
        ids: List[int] = []
        for j, h in enumerate(block_hashes(tokens[:limit * self.block_len],
                                           limit, self.block_len)):
            bid = self._hash_to_block.get(h)
            if bid is None:
                break
            ids.append(bid)
        return ids

    def admit_shared(self, slot: int, tokens: np.ndarray,
                     lifetime_tokens: int, *, max_match_rows: int,
                     granule_rows: int = 0) -> int:
        """Admit ``slot`` for chunked prefill with prefix sharing.

        Maps the longest registered prefix of ``tokens`` (≤
        ``max_match_rows`` rows, whole blocks, rounded down to a multiple
        of ``granule_rows`` when given — the scheduler passes its chunk
        size so prefill resumes on an absolute chunk boundary) into the
        slot's table by reference — no copy — and reserves the rest of
        the lifetime for lazy allocation by ``extend_to``/``append``.
        Returns the number of prompt rows served from shared blocks (the
        scheduler starts prefill at that row).  Requires a prior
        ``can_admit`` check, which deliberately assumes a zero-length
        match."""
        if self._slot_blocks[slot] or self._slot_reserved[slot]:
            raise RuntimeError(f"slot {slot} already admitted")
        if not self.can_admit(lifetime_tokens):
            raise RuntimeError(f"slot {slot}: admission check not honored")
        plen = len(tokens)
        shared = self.match_prefix(tokens, max_match_rows)
        if granule_rows:
            if granule_rows % self.block_len:
                raise ValueError(
                    f"granule_rows {granule_rows} must be a multiple of "
                    f"block_len {self.block_len}")
            keep = (len(shared) * self.block_len
                    // granule_rows) * granule_rows // self.block_len
            shared = shared[:keep]
        for bid in shared:
            if self._ref[bid] == 0:
                self._cached.pop(bid, None)
            self._ref[bid] += 1
        m = len(shared)
        self._slot_blocks[slot] = list(shared)
        if m:
            self.tables[slot, :m] = shared
            self._dev_tables = None
        total = max(self.blocks_for(lifetime_tokens), self.blocks_for(plen))
        self._slot_reserved[slot] = total - m
        matched_rows = m * self.block_len
        self.hit_tokens += matched_rows
        self.miss_tokens += plen - matched_rows
        return matched_rows

    def extend_match(self, slot: int, tokens: np.ndarray, *,
                     max_match_rows: int, granule_rows: int = 0) -> int:
        """Re-match a slot admitted before its prefix producer finished.

        Only valid while the slot has written NOTHING (no chunk
        dispatched): its blocks are then exactly the shared prefix mapped
        at admission, and any blocks registered since (e.g. by a producer
        mid-prefill) can be grafted on by reference.  Returns the new
        total matched row count.  The extension draws on the slot's
        existing reservation, which admission sized for a zero-length
        match — so it can only shrink the eventual allocation."""
        blocks = self._slot_blocks[slot]
        m = len(blocks)
        full = self.match_prefix(tokens, max_match_rows)
        if granule_rows:
            keep = (len(full) * self.block_len
                    // granule_rows) * granule_rows // self.block_len
            full = full[:keep]
        if len(full) <= m or full[:m] != blocks:
            return m * self.block_len
        extra = full[m:]
        for bid in extra:
            if self._ref[bid] == 0:
                self._cached.pop(bid, None)
            self._ref[bid] += 1
        self.tables[slot, m:len(full)] = extra
        self._dev_tables = None
        blocks.extend(extra)
        self._slot_reserved[slot] -= len(extra)
        gained = len(extra) * self.block_len
        self.hit_tokens += gained
        self.miss_tokens -= gained
        return len(full) * self.block_len

    def register_prefix(self, slot: int, tokens: np.ndarray,
                        upto_rows: int) -> int:
        """Content-register the slot's blocks fully inside rows
        ``[0, upto_rows)`` so later admissions can share them.

        Callers only pass rows whose values are final (the chunked
        scheduler registers after the chunk dispatch that wrote them, and
        never a block that prefill or decode will write again — so a
        registered block's content can't drift from its hash).  Returns
        the number of newly registered blocks."""
        if not self.prefix_cache:
            return 0
        nb = min(upto_rows // self.block_len,
                 len(self._slot_blocks[slot]))
        added = 0
        hashes = block_hashes(tokens[:nb * self.block_len], nb,
                              self.block_len)
        for j, h in enumerate(hashes):
            bid = self._slot_blocks[slot][j]
            if bid in self._block_hash:
                continue                 # already registered (e.g. shared)
            if h in self._hash_to_block:
                continue                 # another block is canonical
            self._block_hash[bid] = h
            self._hash_to_block[h] = bid
            added += 1
        return added

    def fork_slot(self, src: int, dst: int, src_len: int,
                  lifetime_tokens: int) -> None:
        """Map ALL of ``src``'s blocks (including a partial last block)
        into ``dst`` by reference — the parallel-sampling hook.  Reserves
        ``dst``'s remaining lifetime plus one extra block iff the last
        shared block is partial: ``dst``'s first append into it triggers
        the copy-on-write in ``ensure_private``, which draws from that
        reservation."""
        if self._slot_blocks[dst] or self._slot_reserved[dst]:
            raise RuntimeError(f"slot {dst} already admitted")
        src_blocks = self._slot_blocks[src]
        if self.blocks_for(src_len) != len(src_blocks):
            raise ValueError(
                f"src_len {src_len} does not cover slot {src}'s "
                f"{len(src_blocks)} blocks")
        cow_extra = 1 if src_len % self.block_len else 0
        total = max(self.blocks_for(lifetime_tokens), len(src_blocks))
        need = total - len(src_blocks) + cow_extra
        if need > (self.free_blocks + self.evictable_blocks
                   - self.reserved_blocks):
            raise RuntimeError(f"fork into slot {dst}: arena cannot "
                               f"guarantee {need} blocks")
        if total > self.max_blocks_per_slot:
            raise RuntimeError(f"fork into slot {dst}: lifetime exceeds "
                               f"max_seq {self.max_seq}")
        for bid in src_blocks:
            self._ref[bid] += 1
        self._slot_blocks[dst] = list(src_blocks)
        self.tables[dst, :len(src_blocks)] = src_blocks
        self._dev_tables = None
        self._slot_reserved[dst] = need

    def reset_prefix_cache(self) -> None:
        """Forget all content registrations, reclaim the evictable pool,
        and zero the hit/miss counters — benches call this between warmup
        and measured replays so hit ratios reflect a cold start."""
        retained = list(self._cached)
        self._cached.clear()
        self._block_hash.clear()
        self._hash_to_block.clear()
        if retained:
            self._scrub(retained)
            self._free.extend(retained)
        self.hit_tokens = 0
        self.miss_tokens = 0

    # -- device transfer ----------------------------------------------------

    def device_tables(self) -> torch.Tensor:
        if self._dev_tables is None:
            self._dev_tables = torch.as_tensor(self.tables,
                                               device=self.device)
        return self._dev_tables

    def write_prefill(self, slot: int, dense_state, pads: int = 0) -> None:
        """Copy a dense prefill cache (``models.transformer.State`` for a
        B=1 request, budget == whole blocks) into the slot's blocks.
        ``pads`` left-pad rows get their positions forced to -1."""
        ids = self._slot_blocks[slot]
        bucket = dense_state.k.shape[2]
        if bucket != len(ids) * self.block_len:
            raise ValueError(f"bucket {bucket} != {len(ids)} blocks of "
                             f"{self.block_len}")
        pos = dense_state.kpos[0, 0]
        if pads:
            pos = pos.masked_fill(torch.arange(bucket, device=pos.device)
                                  < pads, -1)
        scatter_prefill(self.state, dense_state.k, dense_state.v, pos,
                        _ids(ids, self.device))
