"""Paged KV-cache pool: block accounting + block- or slot-resident storage.

Counterpart of ``repro.serving.kvcache``.  Two physical layouts share one
ledger:

* **dense** (default) — the model's ``init_cache`` tree with a
  ``max_slots`` batch axis: every slot owns its worst-case
  ``max_seq_len`` stripe (bf16, or int8 codes plus per-token bf16 scales
  with ``kv_cache_dtype="int8"``), so the pool never runs dry and the
  block tables are accounting only.  ``write_prefill`` copies a
  prefilled batch-1 cache into a slot.
* **paged** (``paged=True``) — attention KV lives in *block* storage:
  every cache leaf is ``(L // pat, pat, num_blocks + 1, block_size, KV,
  D)`` bf16, and a ``(max_slots, blocks_per_slot)`` block-table tensor
  maps each slot's token positions to blocks, which the CUDA paged
  kernels gather through.  The pool may be sized **smaller than worst
  case** via ``num_blocks``, so ``OutOfBlocks`` is a real, schedulable
  event.  The extra physical block is the *trash block*: free slots'
  dummy decode rows and unbacked table entries point there, so stray
  writes and speculative reads never touch a live sequence's KV.  As in
  the reference, paged mode refuses the int8 cache.

Families whose cache holds recurrent state (ssm; hybrid, whose mamba
layers' state sits beside the shared block's K/V) run through the same
ledger in the dense layout: their state leaves have a batch axis and no
sequence axis, ``write_prefill`` copies a slot's whole state, and the
block table models the logical footprint the scheduler admits against.
As in the reference they report ``supports_prefix_cache = False``, and
paged mode and the prefix store refuse them with ``ValueError``; so does
encdec (whisper), whose decoder self-attention K/V (a dense stripe per
slot, ``(L, slots, max_seq_len, KV, D)``) depend on the encoder's frames
as well as on the tokens.

* ``KVBlockPool`` — a fixed budget of KV blocks handed out from a free
  ring (freed blocks go to the tail, recycled from the head), each with a
  reference count so the prefix cache can share one block between the
  radix tree and any number of in-flight requests.  Double-allocation,
  double-free, unref of a dead block and ``free`` of a shared block are
  hard errors.  (A verbatim copy of the reference's ledger.)
* ``PagedKVCache`` — per-slot block tables, grown one block at a time as
  a sequence decodes, plus the optional *prefix store*: a cache-shaped
  tree whose batch axis indexes ``prefix_blocks`` blocks and whose
  sequence axis is one block wide, holding KV snapshots of cached prompt
  prefixes in the live cache's dtypes (int8 leaves included), so a save
  and load round trip is bit-identical.

The batch and sequence axis of every leaf are found by diffing the
model's cache spec at two sizes, as the reference does.  Where the
reference donated the storage to a jitted copy program, the port copies in
place (``copy_`` into the storage tensors).  The engine's captured
programs (``serving/programs.py``) read and write the storage leaves and
the device block table at the addresses they were captured with, so
neither is ever rebound: ``check_storage`` raises if a leaf was, and the
block table is one static tensor refreshed in place.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.serving.programs import copy_from_host


class OutOfBlocks(RuntimeError):
    """KV pool exhausted — admission must wait for a sequence to finish."""


class KVBlockPool:
    """Fixed-size pool of KV blocks with free-list recycling + refcounts."""

    def __init__(self, num_blocks: int, block_size: int):
        assert num_blocks > 0 and block_size > 0
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free = deque(range(num_blocks))
        self._in_use: set = set()
        self._refs: Dict[int, int] = {}
        self.high_water = 0

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._in_use)

    def alloc(self) -> int:
        if not self._free:
            raise OutOfBlocks(
                f"all {self.num_blocks} KV blocks in use")
        b = self._free.popleft()
        assert b not in self._in_use, f"block {b} double-allocated"
        self._in_use.add(b)
        self._refs[b] = 1
        self.high_water = max(self.high_water, len(self._in_use))
        return b

    # -- reference counting (prefix sharing) ---------------------------------

    def refcount(self, b: int) -> int:
        return self._refs.get(b, 0)

    def ref(self, b: int) -> int:
        """Add a reference to a live block (radix node, running request)."""
        assert b in self._in_use, f"block {b} ref'd but not allocated"
        self._refs[b] += 1
        return self._refs[b]

    def unref(self, b: int) -> int:
        """Drop one reference; at zero the block returns to the free ring."""
        assert b in self._in_use, f"block {b} unref'd but not allocated"
        assert self._refs[b] > 0, f"block {b} refcount underflow"
        self._refs[b] -= 1
        left = self._refs[b]
        if left == 0:
            del self._refs[b]
            self._in_use.remove(b)
            self._free.append(b)
        return left

    def fork(self, src: int) -> int:
        """Copy-on-write ledger op: allocate a fresh block that will hold a
        private copy of ``src`` (the caller copies the data).  ``src`` must
        be live — forking a freed block is a hard error."""
        assert src in self._in_use, f"fork of dead block {src}"
        return self.alloc()

    def free(self, blocks: List[int]) -> None:
        """Exclusive-owner release.  Freeing a block somebody else still
        references is a hard error — shared blocks go through ``unref``."""
        for b in blocks:
            assert b in self._in_use, f"block {b} freed but not allocated"
            assert self._refs[b] == 1, \
                f"block {b} freed with refcount {self._refs[b]}"
            del self._refs[b]
            self._in_use.remove(b)
            self._free.append(b)          # ring: recycled oldest-freed first


def _leaves(tree, path: Tuple[str, ...] = ()):
    """``[(path, leaf)]`` of a nested dict, keys in sorted order (the
    reference's pytree order)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k],
                                                          path + (k,))]
    return [(path, tree)]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class PagedKVCache:
    """Pooled decode-cache storage + per-slot block tables.

    ``cache`` is the decode step's cache tree on ``device``.  Dense mode:
    the model's ``init_cache`` tree with a ``max_slots`` batch axis;
    ``write_prefill`` copies a batch-1 prefilled cache into one slot.
    Paged mode: ``{"layers": {"k": storage, "v": storage}}`` with storage
    ``(L // pat, pat, num_blocks + 1, block_size, KV, D)`` bf16; prefill
    chunks and decode steps write straight into it through the tables,
    and ``device_block_tables()`` feeds the paged kernels.

    With ``prefix_blocks > 0``, ``prefix_store`` holds block-granular KV
    snapshots of cached prompt prefixes (the cache's leaves with the
    batch axis indexing ``prefix_blocks`` blocks and the sequence axis one
    block wide), allocated from ``prefix_pool`` — a second
    ``KVBlockPool`` whose refcounts let the radix tree and in-flight
    requests share them.
    """

    def __init__(self, cfg, max_slots: int, max_seq_len: int,
                 block_size: int = 16, prefix_blocks: int = 0,
                 num_blocks: Optional[int] = None, paged: bool = False,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.block_size = block_size
        self.paged = paged
        self.blocks_per_slot = -(-max_seq_len // block_size)  # ceil
        worst_case = max_slots * self.blocks_per_slot
        if num_blocks is None:
            num_blocks = worst_case
        if not paged and num_blocks != worst_case:
            raise ValueError(
                "dense layout physically allocates the worst case; the "
                "num_blocks knob needs paged=True")
        if num_blocks <= 0:
            raise ValueError(f"num_blocks must be positive, got {num_blocks}")
        self.pool = KVBlockPool(num_blocks, block_size)
        # bound by the scheduler (tracing.Tracer); ledger events — block
        # alloc/grow/free and OutOfBlocks — land in the replica's trace
        self.tracer = None
        self._free_slots = deque(range(max_slots))
        self.block_table: Dict[int, List[int]] = {}
        self.seq_len_of: Dict[int, int] = {}
        self._axes = self._batch_axes(cfg, max_seq_len)
        self._seq_axes = self._seq_axis_per_leaf(cfg, max_slots)
        if paged:
            if not self.supports_prefix_cache:
                raise ValueError(
                    f"family {cfg.family!r} has a non-positional decode "
                    "cache; paged attention unsupported")
            if cfg.kv_cache_dtype == "int8":
                raise ValueError(
                    "paged attention does not support the int8 KV cache "
                    "yet — use kv_cache_dtype='bfloat16'")
            if max_seq_len % block_size != 0:
                raise ValueError(
                    f"paged mode needs max_seq_len ({max_seq_len}) to be "
                    f"a multiple of block_size ({block_size})")
            # +1 physical block: the trash block free/dummy rows write to
            self.trash_block = num_blocks
            self.cache = self._init_store(num_blocks + 1)
            self._tables = np.full((max_slots, self.blocks_per_slot),
                                   self.trash_block, np.int32)
            # the device copy: one static tensor, refreshed in place when
            # the ledger (its version) or the decode step's mask changes
            self.block_tables_dev = torch.from_numpy(self._tables.copy()).to(
                self.device)
            self._tables_version = 0
            self._dev_key = (0, ())
        else:
            self.cache = T.init_cache(cfg, max_slots, max_seq_len,
                                      device=self.device)
        self._leaf_ptrs = [t.data_ptr() for _, t in _leaves(self.cache)]

        # -- prefix store (optional) ----------------------------------------
        self.prefix_pool: Optional[KVBlockPool] = None
        self.prefix_store = None
        if prefix_blocks > 0:
            if not self.supports_prefix_cache:
                raise ValueError(
                    f"family {cfg.family!r} has a non-positional decode "
                    "cache; prefix caching unsupported")
            self.prefix_pool = KVBlockPool(prefix_blocks, block_size)
            self.prefix_store = self._init_store(prefix_blocks)

    # -- batch- and sequence-axis detection ----------------------------------

    @staticmethod
    def _struct_leaves(cfg, batch, seq_len):
        return [leaf for _, leaf in _leaves(T._cache_struct(cfg, batch,
                                                            seq_len))]

    @classmethod
    def _batch_axes(cls, cfg, seq_len: int) -> List[int]:
        """Per-leaf index of the batch axis, found by diffing the cache
        spec at batch=1 vs batch=2 (leaf order matches ``_leaves``)."""
        axes = []
        for (sh1, _), (sh2, _) in zip(cls._struct_leaves(cfg, 1, seq_len),
                                      cls._struct_leaves(cfg, 2, seq_len)):
            diff = [i for i, (a, b) in enumerate(zip(sh1, sh2)) if a != b]
            assert len(diff) == 1, (sh1, sh2)
            axes.append(diff[0])
        return axes

    @classmethod
    def _seq_axis_per_leaf(cls, cfg, batch: int) -> List[Optional[int]]:
        """Per-leaf index of the token-position axis, found by diffing the
        cache spec at two sequence lengths (``None`` for a leaf with no
        positional extent)."""
        axes: List[Optional[int]] = []
        for (sh1, _), (sh2, _) in zip(cls._struct_leaves(cfg, batch, 8),
                                      cls._struct_leaves(cfg, batch, 16)):
            diff = [i for i, (a, b) in enumerate(zip(sh1, sh2)) if a != b]
            assert len(diff) <= 1, (sh1, sh2)
            axes.append(diff[0] if diff else None)
        return axes

    @property
    def supports_prefix_cache(self) -> bool:
        """The KV depends on the token positions alone
        (``transformer.positional_cache``), so token-keyed reuse is sound,
        and paged storage too, which the same test refuses, as in the
        reference."""
        return T.positional_cache(self.cfg)

    def _init_store(self, n_blocks: int):
        """Cache-shaped tree whose batch axis indexes ``n_blocks`` blocks
        and whose sequence axis is one block wide, in the live cache's
        dtypes (so a save/load round trip is bit-identical)."""
        store: Dict = {}
        struct = _leaves(T._cache_struct(self.cfg, 1, self.max_seq_len))
        for ((path, (shape, dtype)), bax, sax) in zip(struct, self._axes,
                                                       self._seq_axes):
            shape = list(shape)
            shape[bax] = n_blocks
            shape[sax] = self.block_size
            node = store
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = torch.zeros(tuple(shape), dtype=dtype,
                                         device=self.device)
        return store

    def _copy_block(self, dst_tree, src_tree, src: int, dst: int) -> None:
        """dst_tree[.., dst, ..] <- src_tree[.., src, ..] along every
        leaf's batch axis (paged storage blocks or prefix blocks), in
        place (the reference's donated block-copy program)."""
        for (path, dst_leaf), ax in zip(_leaves(dst_tree), self._axes):
            dst_leaf.select(ax, dst).copy_(_get(src_tree, path).select(ax,
                                                                        src))

    # -- prefix-store operations ---------------------------------------------

    def save_prefix_block(self, slot: int, pos0: int,
                          into: Optional[int] = None) -> int:
        """Snapshot positions ``[pos0, pos0+block_size)`` of ``slot`` into
        a prefix block (freshly allocated unless ``into`` is given).  In
        the paged layout the window is exactly one pool block of the slot.
        Returns the block id."""
        assert self.prefix_pool is not None, "prefix store not enabled"
        assert pos0 + self.block_size <= self.max_seq_len, \
            f"prefix block [{pos0}, {pos0 + self.block_size}) overruns cache"
        # ownership transfers to the PrefixCache radix tree: its node
        # release/_remove paths unref this block, not this class
        bid = self.prefix_pool.alloc() if into is None else into  # repro-lint: disable=RL005
        if self.paged:
            assert pos0 % self.block_size == 0, pos0
            src = self.block_table[slot][pos0 // self.block_size]
            self._copy_block(self.prefix_store, self.cache, src, bid)
            return bid
        for (path, st), bax, sax in zip(_leaves(self.prefix_store),
                                        self._axes, self._seq_axes):
            piece = _get(self.cache, path).narrow(bax, slot, 1).narrow(
                sax, pos0, self.block_size)
            st.narrow(bax, bid, 1).copy_(piece)
        return bid

    def load_prefix_blocks(self, cache1, blocks: Sequence[int]):
        """Dense resume path: copy stored prefix blocks into a batch-1
        cache at their aligned positions (block k of the list covers
        ``[k*bs, (k+1)*bs)``), in place.  Returns ``cache1``."""
        assert self.prefix_pool is not None, "prefix store not enabled"
        bs = self.block_size
        for k, bid in enumerate(blocks):
            for (path, st), bax, sax in zip(_leaves(self.prefix_store),
                                            self._axes, self._seq_axes):
                _get(cache1, path).narrow(sax, k * bs, bs).copy_(
                    st.narrow(bax, bid, 1))
        return cache1

    def load_prefix_blocks_paged(self, slot: int,
                                 blocks: Sequence[int]) -> None:
        """Paged resume path: copy stored prefix blocks straight into
        ``slot``'s pool blocks (block k of the list covers positions
        ``[k*bs, (k+1)*bs)``).  The slot must already back those positions
        (``alloc_slot`` with the full prompt length does)."""
        assert self.paged, "block-to-block prefix load needs paged mode"
        assert self.prefix_pool is not None, "prefix store not enabled"
        table = self.block_table[slot]
        assert len(blocks) <= len(table), (len(blocks), len(table))
        for k, bid in enumerate(blocks):
            self._copy_block(self.cache, self.prefix_store, bid, table[k])

    def table_row(self, slot: int) -> np.ndarray:
        """The slot's padded block-table row (unbacked entries name the
        trash block) — what a batched-prefill program row gathers through."""
        assert self.paged, "block tables are device-resident in paged mode"
        return self._tables[slot]

    def fork_prefix_block(self, src: int) -> int:
        """Copy-on-write: a private copy of a shared prefix block, so a
        diverging branch never mutates data another reader still maps."""
        assert self.prefix_pool is not None, "prefix store not enabled"
        # ownership transfers to the PrefixCache branch that requested
        # the fork; its release/_remove paths unref the copy
        dst = self.prefix_pool.fork(src)  # repro-lint: disable=RL005
        self._copy_block(self.prefix_store, self.prefix_store, src, dst)
        return dst

    # -- slot lifecycle ------------------------------------------------------

    @property
    def free_slot_count(self) -> int:
        return len(self._free_slots)

    def _blocks_for(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.block_size))

    def alloc_slot(self, prompt_len: int) -> int:
        """Claim a slot and the blocks backing its prompt positions.
        On block exhaustion the slot is returned and any partially
        allocated blocks are released before ``OutOfBlocks`` propagates —
        the caller sees an all-or-nothing admission."""
        if prompt_len > self.max_seq_len:
            raise ValueError(
                f"prompt ({prompt_len}) exceeds max_seq_len "
                f"({self.max_seq_len})")
        tr = self.tracer
        if not self._free_slots:
            if tr is not None and tr.enabled:
                tr.out_of_blocks("alloc_slot:no_free_slot")
            raise OutOfBlocks("no free slot")
        slot = self._free_slots.popleft()
        blocks: List[int] = []
        try:
            for _ in range(self._blocks_for(prompt_len)):
                blocks.append(self.pool.alloc())
        except OutOfBlocks:
            self.pool.free(blocks)
            self._free_slots.appendleft(slot)
            if tr is not None and tr.enabled:
                tr.out_of_blocks("alloc_slot:pool_dry", slot)
            raise
        self.block_table[slot] = blocks
        self.seq_len_of[slot] = prompt_len
        if self.paged:
            self._tables[slot, :len(blocks)] = blocks
            self._tables_version += 1
        if tr is not None and tr.enabled:
            tr.block_alloc(slot, len(blocks), self.pool.available)
        return slot

    def ensure_capacity(self, slot: int, n_tokens: int) -> None:
        """Back token positions [0, n_tokens) with blocks, growing the
        slot's table from the shared pool as decode advances."""
        tr = self.tracer
        if n_tokens > self.max_seq_len:
            raise OutOfBlocks(
                f"slot {slot}: {n_tokens} tokens exceeds max_seq_len "
                f"({self.max_seq_len})")
        table = self.block_table[slot]
        while len(table) * self.block_size < n_tokens:
            try:
                table.append(self.pool.alloc())
            except OutOfBlocks:
                if tr is not None and tr.enabled:
                    tr.out_of_blocks("decode_grow", slot)
                raise
            if self.paged:
                self._tables[slot, len(table) - 1] = table[-1]
                self._tables_version += 1
            if tr is not None and tr.enabled:
                tr.block_grow(slot, self.pool.available)
        self.seq_len_of[slot] = max(self.seq_len_of[slot], n_tokens)

    def free_slot(self, slot: int) -> None:
        """Retire a sequence: its blocks go straight back on the ring."""
        blocks = self.block_table.pop(slot)
        self.pool.free(blocks)
        del self.seq_len_of[slot]
        self._free_slots.append(slot)
        if self.paged:
            self._tables[slot, :] = self.trash_block
            self._tables_version += 1
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.block_free(slot, len(blocks), self.pool.available)

    def device_block_tables(self, mask_slots: Sequence[int] = ()
                            ) -> torch.Tensor:
        """The (max_slots, blocks_per_slot) int32 block-table tensor the
        paged decode step gathers through: always the same tensor
        (``block_tables_dev``, which a captured decode program reads),
        refreshed in place lazily, when the ledger or the mask changed
        since the last call.  Unbacked entries name the trash block.

        ``mask_slots`` re-routes those slots' rows to the trash block —
        the decode step passes the mid-prefill slots here so their dummy
        decode rows can never touch KV the prefill already wrote.  Steady
        interleaved decode pays one host-to-device copy per ledger or
        mask change, not one per step."""
        assert self.paged, "block tables are device-resident in paged mode"
        mask = tuple(sorted(mask_slots))
        key = (self._tables_version, mask)
        if key != self._dev_key:
            tables = self._tables.copy()
            tables[list(mask), :] = self.trash_block
            copy_from_host(self.block_tables_dev, tables)
            self._dev_key = key
        return self.block_tables_dev

    def check_storage(self) -> None:
        """Raise unless every leaf of ``cache`` is still the storage made
        at construction: every path updates the leaves in place, and a
        captured program writes them at their first addresses."""
        if [t.data_ptr() for _, t in _leaves(self.cache)] != self._leaf_ptrs:
            raise RuntimeError("a KV storage leaf was rebound; the engine's "
                               "captured programs write the original one")

    def write_prefill(self, slot: int, single_cache) -> None:
        """Copy a batch-1 prefilled cache into ``slot``'s stripe of the
        dense storage, in place.  Paged prefill never stages a batch-1
        cache — chunks land straight in pool blocks."""
        assert not self.paged, (
            "paged prefill writes chunks straight into pool blocks; "
            "there is no batch-1 cache to scatter")
        for (path, leaf), ax in zip(_leaves(self.cache), self._axes):
            leaf.select(ax, slot).copy_(_get(single_cache, path).select(ax,
                                                                        0))

    # -- telemetry -----------------------------------------------------------

    def kv_bytes(self) -> int:
        """Physical bytes resident for the decode KV storage (codes and
        scales for the int8 cache)."""
        return sum(t.numel() * t.element_size()
                   for _, t in _leaves(self.cache))

    def occupancy(self) -> Dict[str, float]:
        occ = {
            "slots_in_use": self.max_slots - len(self._free_slots),
            "max_slots": self.max_slots,
            "blocks_in_use": self.pool.in_use,
            "blocks_total": self.pool.num_blocks,
            "block_high_water": self.pool.high_water,
            "block_utilization": self.pool.in_use / self.pool.num_blocks,
            "paged": self.paged,
            "kv_bytes_resident": self.kv_bytes(),
        }
        if self.prefix_pool is not None:
            occ["prefix_blocks_in_use"] = self.prefix_pool.in_use
            occ["prefix_blocks_total"] = self.prefix_pool.num_blocks
        return occ
