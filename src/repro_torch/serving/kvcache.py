"""Paged KV-cache pool: block accounting + block-resident storage.

Counterpart of ``repro.serving.kvcache`` in its paged layout: attention KV
lives in *block* storage — every cache leaf is
``(L // pat, pat, num_blocks + 1, block_size, KV, D)`` bf16 — and a
``(max_slots, blocks_per_slot)`` block-table tensor maps each slot's
token positions to blocks, which the CUDA paged kernels gather through.
The pool may be sized **smaller than worst case** via ``num_blocks``, so
``OutOfBlocks`` is a real, schedulable event.  The extra physical block
is the *trash block*: free slots' dummy decode rows and unbacked table
entries point there, so stray writes and speculative reads never touch a
live sequence's KV.

* ``KVBlockPool`` — a fixed budget of KV blocks handed out from a free
  ring (freed blocks go to the tail, recycled from the head), each with a
  reference count so the prefix cache can share one block between the
  radix tree and any number of in-flight requests.  Double-allocation,
  double-free, unref of a dead block and ``free`` of a shared block are
  hard errors.  (A verbatim copy of the reference's ledger.)
* ``PagedKVCache`` — per-slot block tables, grown one block at a time as
  a sequence decodes, plus the optional *prefix store*: a second block
  tensor of ``prefix_blocks`` blocks holding KV snapshots of cached prompt
  prefixes, copied block-to-block in both directions.

PyTorch runs eagerly: where the reference donated the storage to a jitted
copy program, the port copies blocks in place (``copy_`` into the
storage tensors).  The dense per-slot layout (``paged=False``) is ported
with the dense-mode serving slice.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models import transformer as T


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


class PagedKVCache:
    """Block storage + per-slot block tables (paged layout).

    ``cache`` is ``{"layers": {"k": storage, "v": storage}}`` with storage
    ``(L // pat, pat, num_blocks + 1, block_size, KV, D)`` bf16 on
    ``device``; prefill chunks and decode steps write straight into it
    through the tables.  ``device_block_tables()`` feeds the paged kernels.

    With ``prefix_blocks > 0``, ``prefix_store`` holds block-granular KV
    snapshots of cached prompt prefixes (same leaf layout with
    ``prefix_blocks`` blocks), allocated from ``prefix_pool`` — a second
    ``KVBlockPool`` whose refcounts let the radix tree and in-flight
    requests share them.
    """

    BLOCK_AXIS = 2              # (L // pat, pat, blocks, block_size, KV, D)

    def __init__(self, cfg, max_slots: int, max_seq_len: int,
                 block_size: int = 16, prefix_blocks: int = 0,
                 num_blocks: Optional[int] = None, paged: bool = True,
                 device="cuda"):
        if not paged:
            raise NotImplementedError(
                "the dense per-slot KV layout is ported with the dense-mode "
                "serving slice; use paged=True")
        self.cfg = cfg
        self.device = torch.device(device)
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.block_size = block_size
        self.paged = True
        self.blocks_per_slot = -(-max_seq_len // block_size)  # ceil
        if num_blocks is None:
            num_blocks = max_slots * self.blocks_per_slot
        if num_blocks <= 0:
            raise ValueError(f"num_blocks must be positive, got {num_blocks}")
        if cfg.kv_cache_dtype == "int8":
            raise ValueError(
                "paged attention does not support the int8 KV cache "
                "yet — use kv_cache_dtype='bfloat16'")
        if max_seq_len % block_size != 0:
            raise ValueError(
                f"paged mode needs max_seq_len ({max_seq_len}) to be "
                f"a multiple of block_size ({block_size})")
        self.pool = KVBlockPool(num_blocks, block_size)
        # bound by the scheduler (tracing.Tracer); ledger events — block
        # alloc/grow/free and OutOfBlocks — land in the replica's trace
        self.tracer = None
        self._free_slots = deque(range(max_slots))
        self.block_table: Dict[int, List[int]] = {}
        self.seq_len_of: Dict[int, int] = {}
        # +1 physical block: the trash block free/dummy rows write to
        self.trash_block = num_blocks
        self.cache = self._init_store(num_blocks + 1)
        self._tables = np.full((max_slots, self.blocks_per_slot),
                               self.trash_block, np.int32)
        self._tables_dev = None
        self._masked_dev = None           # masked-table upload cache
        self._masked_key = ()

        # -- prefix store (optional) ----------------------------------------
        self.prefix_pool: Optional[KVBlockPool] = None
        self.prefix_store = None
        if prefix_blocks > 0:
            self.prefix_pool = KVBlockPool(prefix_blocks, block_size)
            self.prefix_store = self._init_store(prefix_blocks)

    @property
    def supports_prefix_cache(self) -> bool:
        """Dense decoders' KV is positional and depends on the token ids
        alone, so token-keyed reuse is sound."""
        return self.cfg.family == "dense"

    def _init_store(self, n_blocks: int):
        """Cache-shaped tree whose batch axis indexes ``n_blocks`` blocks
        and whose sequence axis is one block wide."""
        (shape, dtype) = T._cache_struct(self.cfg, 1, 1)["layers"]["k"]
        shape = list(shape)
        shape[self.BLOCK_AXIS] = n_blocks
        shape[self.BLOCK_AXIS + 1] = self.block_size
        return {"layers": {
            name: torch.zeros(tuple(shape), dtype=dtype, device=self.device)
            for name in ("k", "v")}}

    def _copy_block(self, dst_tree, src_tree, src: int, dst: int) -> None:
        """dst_tree[.., dst, ..] <- src_tree[.., src, ..] for every leaf,
        in place (the reference's donated block-copy program)."""
        ax = self.BLOCK_AXIS
        for name, dst_leaf in dst_tree["layers"].items():
            src_leaf = src_tree["layers"][name]
            dst_leaf.select(ax, dst).copy_(src_leaf.select(ax, src))

    # -- prefix-store operations ---------------------------------------------

    def save_prefix_block(self, slot: int, pos0: int,
                          into: Optional[int] = None) -> int:
        """Snapshot positions ``[pos0, pos0+block_size)`` of ``slot`` — in
        the paged layout exactly one pool block — into a prefix block
        (freshly allocated unless ``into`` is given).  Returns its id."""
        assert self.prefix_pool is not None, "prefix store not enabled"
        assert pos0 + self.block_size <= self.max_seq_len, \
            f"prefix block [{pos0}, {pos0 + self.block_size}) overruns cache"
        assert pos0 % self.block_size == 0, pos0
        # ownership transfers to the PrefixCache radix tree: its node
        # release/_remove paths unref this block, not this class
        bid = self.prefix_pool.alloc() if into is None else into  # repro-lint: disable=RL005
        src = self.block_table[slot][pos0 // self.block_size]
        self._copy_block(self.prefix_store, self.cache, src, bid)
        return bid

    def load_prefix_blocks_paged(self, slot: int,
                                 blocks: Sequence[int]) -> None:
        """Resume path: copy stored prefix blocks straight into ``slot``'s
        pool blocks (block k of the list covers positions
        ``[k*bs, (k+1)*bs)``).  The slot must already back those positions
        (``alloc_slot`` with the full prompt length does)."""
        assert self.prefix_pool is not None, "prefix store not enabled"
        table = self.block_table[slot]
        assert len(blocks) <= len(table), (len(blocks), len(table))
        for k, bid in enumerate(blocks):
            self._copy_block(self.cache, self.prefix_store, bid, table[k])

    def table_row(self, slot: int) -> np.ndarray:
        """The slot's padded block-table row (unbacked entries name the
        trash block) — what a batched-prefill program row gathers through."""
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
        self._tables[slot, :len(blocks)] = blocks
        self._tables_dev = self._masked_dev = None
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
            self._tables[slot, len(table) - 1] = table[-1]
            self._tables_dev = self._masked_dev = None
            if tr is not None and tr.enabled:
                tr.block_grow(slot, self.pool.available)
        self.seq_len_of[slot] = max(self.seq_len_of[slot], n_tokens)

    def free_slot(self, slot: int) -> None:
        """Retire a sequence: its blocks go straight back on the ring."""
        blocks = self.block_table.pop(slot)
        self.pool.free(blocks)
        del self.seq_len_of[slot]
        self._free_slots.append(slot)
        self._tables[slot, :] = self.trash_block
        self._tables_dev = self._masked_dev = None
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.block_free(slot, len(blocks), self.pool.available)

    def device_block_tables(self, mask_slots: Sequence[int] = ()
                            ) -> torch.Tensor:
        """The (max_slots, blocks_per_slot) int32 block-table tensor the
        paged decode step gathers through; uploaded lazily after ledger
        mutations.  Unbacked entries name the trash block.

        ``mask_slots`` re-routes those slots' rows to the trash block —
        the decode step passes the mid-prefill slots here so their dummy
        decode rows can never touch KV the prefill already wrote.  The
        masked upload is cached too (keyed by the mask), so steady
        interleaved decode pays one host-to-device copy per ledger or
        mask change, not one per step."""
        key = tuple(sorted(mask_slots))
        if not key:
            if self._tables_dev is None:
                self._tables_dev = torch.from_numpy(
                    self._tables.copy()).to(self.device)
            return self._tables_dev
        if self._masked_dev is None or self._masked_key != key:
            masked = self._tables.copy()
            masked[list(key), :] = self.trash_block
            self._masked_dev = torch.from_numpy(masked).to(self.device)
            self._masked_key = key
        return self._masked_dev

    # -- telemetry -----------------------------------------------------------

    def kv_bytes(self) -> int:
        """Physical bytes resident for the decode KV storage."""
        return sum(t.numel() * t.element_size()
                   for t in self.cache["layers"].values())

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
