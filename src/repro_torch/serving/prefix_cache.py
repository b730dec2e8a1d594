"""Prefix cache: a refcounted radix tree over shared KV blocks.

Real capsule-fleet traffic is dominated by shared prefixes — system
prompts, few-shot templates, the growing history of a multi-turn chat.
The serving engine's prefill replays every prompt token through
``decode_step``, so two requests sharing a 500-token system prompt used
to pay that prefill twice.  This module keeps the KV values of previously
served prompts resident in the :class:`~repro_torch.serving.kvcache.PagedKVCache`
prefix store and indexes them with a radix tree over token ids, so
admission can skip straight to the first *uncached* token:

* **Radix index** — each edge is a run of token ids; a node's blocks are
  the prefix-store block ids holding the KV for the edge's positions.
  ``lookup`` walks the tree and returns the longest cached prefix plus
  the blocks backing it; ``insert`` extends the tree with a freshly
  prefilled prompt, snapshotting its KV out of the engine's pooled cache.
* **Reference counts** — a block is shared by the tree and by every
  in-flight request that loaded it; ``lookup`` pins the matched blocks
  (``KVBlockPool.ref``) until the request retires, so eviction can never
  reclaim KV a running sequence was served from.
* **Copy-on-write** — when a new branch diverges inside a block (a
  partially-filled tail, or a mid-block split), the shared block is
  forked (``PagedKVCache.fork_prefix_block``) so the diverging branch
  writes its own copy and never corrupts the positions other readers map.
  At a mid-edge split the spanning block is instead *shared* between the
  two halves with an extra reference — both sides agree on its common
  positions.
* **LRU eviction** — when the prefix pool runs dry, least-recently-used
  *unreferenced* leaf subtrees are unlinked and their exclusive blocks
  returned to the ring; pinned or shared blocks survive until their last
  reference drops.

Validity convention: a node's tokens define exactly which positions of
its blocks are meaningful (a tail block may be partial).  Matching never
reads past the matched token count, so no per-block length bookkeeping
is needed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.kvcache import PagedKVCache


def _common_len(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if len(neq) else n


class _Node:
    """One radix edge: token run [start, end) + the blocks backing it.

    ``blocks[k]`` covers block index ``start // block_size + k``.  When
    ``start`` is not block-aligned, ``blocks[0]`` *overlaps* the parent's
    tail block index: it is a forked (or split-shared) copy that also
    holds the common positions below ``start``, and it supersedes the
    parent's block during a match through this node.
    """
    __slots__ = ("start", "tokens", "blocks", "children", "parent",
                 "last_used")

    def __init__(self, start: int, tokens: np.ndarray, blocks: List[int],
                 parent: Optional["_Node"]):
        self.start = start
        self.tokens = tokens
        self.blocks = blocks
        self.children: Dict[int, "_Node"] = {}
        self.parent = parent
        self.last_used = 0

    @property
    def end(self) -> int:
        return self.start + len(self.tokens)


@dataclass
class PrefixCacheStats:
    hits: int = 0
    misses: int = 0
    cached_tokens_served: int = 0
    prompt_tokens_seen: int = 0
    inserted_blocks: int = 0
    forked_blocks: int = 0
    evicted_blocks: int = 0
    evicted_nodes: int = 0

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": self.hit_rate,
                "cached_tokens_served": self.cached_tokens_served,
                "prompt_tokens_seen": self.prompt_tokens_seen,
                "inserted_blocks": self.inserted_blocks,
                "forked_blocks": self.forked_blocks,
                "evicted_blocks": self.evicted_blocks,
                "evicted_nodes": self.evicted_nodes}


class PrefixCache:
    """Radix index over token-id prefixes backed by the KV prefix store."""

    def __init__(self, kv: PagedKVCache):
        assert kv.prefix_pool is not None, (
            "PagedKVCache built without prefix_blocks — pass "
            "prefix_blocks > 0 (and a family with a positional cache)")
        self.kv = kv
        self.pool = kv.prefix_pool
        self.block_size = kv.block_size
        self.root = _Node(0, np.empty(0, np.int32), [], None)
        self.stats = PrefixCacheStats()
        # bound by the scheduler (tracing.Tracer); insert/evict events
        self.tracer = None
        self._clock = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -- matching --------------------------------------------------------

    def _walk(self, tokens: np.ndarray
              ) -> Tuple[int, Dict[int, int], List[_Node]]:
        """Longest-prefix walk.  Returns (matched token count, block-index
        -> block-id map for every block touching the match, path nodes)."""
        bs = self.block_size
        node, pos = self.root, 0
        blockmap: Dict[int, int] = {}
        path: List[_Node] = []
        while pos < len(tokens):
            child = node.children.get(int(tokens[pos]))
            if child is None:
                break
            m = _common_len(child.tokens, tokens[pos:])
            end = child.start + m
            bi0 = child.start // bs
            for k, b in enumerate(child.blocks):
                if (bi0 + k) * bs < end:   # block holds >=1 matched position
                    blockmap[bi0 + k] = b  # supersedes parent's overlap
            pos = end
            path.append(child)
            if m < len(child.tokens):
                break
            node = child
        return pos, blockmap, path

    def peek(self, tokens: np.ndarray) -> int:
        """Longest cached prefix length, with no side effects (used by the
        gateway for prefix-affinity routing)."""
        tokens = np.asarray(tokens, np.int32)
        matched, _, _ = self._walk(tokens)
        return min(matched, max(len(tokens) - 1, 0))

    def lookup(self, tokens: np.ndarray) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``tokens`` usable for admission.

        Returns ``(cached_len, blocks)`` where ``blocks`` back positions
        ``[0, cached_len)`` in order.  The match is capped at
        ``len(tokens) - 1`` so at least one token always runs through
        prefill (the first sample needs its logits).  Matched blocks are
        pinned with one reference each — the caller must
        :meth:`release` them when the request retires.
        """
        tokens = np.asarray(tokens, np.int32)
        matched, blockmap, path = self._walk(tokens)
        matched = min(matched, len(tokens) - 1)
        self.stats.prompt_tokens_seen += len(tokens)
        if matched <= 0:
            self.stats.misses += 1
            return 0, []
        n_blocks = -(-matched // self.block_size)
        blocks = [blockmap[i] for i in range(n_blocks)]
        tick = self._tick()
        for node in path:
            node.last_used = tick
        for b in blocks:
            self.pool.ref(b)
        self.stats.hits += 1
        self.stats.cached_tokens_served += matched
        return matched, blocks

    def release(self, blocks: Sequence[int]) -> None:
        """Drop a request's pins; blocks evicted from the tree meanwhile
        return to the free ring here, at their last reference."""
        for b in blocks:
            self.pool.unref(b)

    # -- insertion -------------------------------------------------------

    def insert(self, tokens: np.ndarray, slot: int) -> int:
        """Index a freshly prefilled prompt sitting in pooled-cache
        ``slot`` (all positions ``[0, len(tokens))`` valid there).
        Snapshots the uncached suffix into newly allocated prefix blocks.
        Returns the number of new tokens cached (0 if already present or
        the pool is too pinned to make room)."""
        tokens = np.asarray(tokens, np.int32)
        bs = self.block_size
        node, pos = self.root, 0
        while pos < len(tokens):
            child = node.children.get(int(tokens[pos]))
            if child is None:
                return self._append_branch(node, tokens, pos, slot)
            m = _common_len(child.tokens, tokens[pos:])
            if m == len(child.tokens):
                pos += m
                node = child
                continue
            if pos + m == len(tokens):
                return 0                   # fully covered mid-edge
            top = self._split(child, m)
            return self._append_branch(top, tokens, top.end, slot)
        return 0                           # exact node boundary: covered

    def _split(self, child: _Node, m: int) -> _Node:
        """Split ``child``'s edge after ``m`` tokens; returns the new top
        half.  A block spanning the cut is shared by both halves (one
        extra reference) — its positions below the cut are their common
        prefix, those above belong to the bottom branch only."""
        bs = self.block_size
        p = child.start + m
        bi0 = child.start // bs
        n_top = -(-(p - bi0 * bs) // bs)   # blocks covering [start, p)
        top_blocks = child.blocks[:n_top]
        bottom_first = p // bs - bi0       # index of block covering p
        bottom_blocks = child.blocks[bottom_first:]
        if p % bs != 0:                    # spanning block shared
            self.pool.ref(child.blocks[bottom_first])
        bottom = _Node(p, child.tokens[m:], bottom_blocks, child)
        bottom.children = child.children
        for c in bottom.children.values():
            c.parent = bottom
        bottom.last_used = child.last_used
        child.tokens = child.tokens[:m]
        child.blocks = top_blocks
        child.children = {int(bottom.tokens[0]): bottom}
        return child

    def _append_branch(self, parent: _Node, tokens: np.ndarray, pos: int,
                       slot: int) -> int:
        """Hang a new leaf holding ``tokens[pos:]`` under ``parent``
        (``parent.end == pos``).  If ``pos`` falls inside a block, the
        parent's partial tail is copy-on-write forked so this branch owns
        every block it writes."""
        bs = self.block_size
        total = len(tokens)
        bi_first = pos // bs
        bi_last = (total - 1) // bs
        overlap = pos % bs != 0
        need = bi_last - bi_first + 1
        # never snapshot a window that would run past the cache extent
        while need and (bi_first + need) * bs > self.kv.max_seq_len:
            need -= 1
        if self.pool.available < need:
            # the branch point and its ancestors must survive the purge
            protect, n = set(), parent
            while n is not None:
                protect.add(id(n))
                n = n.parent
            self.evict(need - self.pool.available, protect=protect)
        # cache as many leading blocks as the pool can hold right now
        need = min(need, self.pool.available)
        if need <= 0:
            return 0
        blocks: List[int] = []
        for k in range(need):
            bi = bi_first + k
            if k == 0 and overlap:
                # COW: this branch gets its own block for the shared
                # partial tail.  Ledger fork only — the save below fills
                # the whole window from the slot (whose prefix positions
                # are bit-identical to the shared block), so the physical
                # copy of kv.fork_prefix_block would be dead work here.
                bid = self.pool.fork(parent.blocks[-1])
                self.stats.forked_blocks += 1
                self.kv.save_prefix_block(slot, bi * bs, into=bid)
            else:
                bid = self.kv.save_prefix_block(slot, bi * bs)
            blocks.append(bid)
        covered_end = min((bi_first + need) * bs, total)
        leaf = _Node(pos, tokens[pos:covered_end], blocks, parent)
        leaf.last_used = self._tick()
        parent.children[int(tokens[pos])] = leaf
        self.stats.inserted_blocks += len(blocks)
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.prefix_insert(slot, covered_end - pos, len(blocks))
        return covered_end - pos

    # -- eviction --------------------------------------------------------

    def _shared_with_parent(self, node: _Node, b: int) -> bool:
        return (node.parent is not None and node.parent.blocks
                and b == node.parent.blocks[-1])

    def _evictable(self, node: _Node) -> bool:
        """A leaf whose blocks nobody outside the tree references.  A
        block shared with the parent (split spanning block) carries the
        parent's reference too; anything above that is a running
        request's pin — the subtree is hot, leave it."""
        if node.children or node.parent is None:
            return False
        for b in node.blocks:
            expected = 2 if self._shared_with_parent(node, b) else 1
            if self.pool.refcount(b) > expected:
                return False
        return True

    def _leaves(self) -> List[_Node]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif n is not self.root:
                out.append(n)
        return out

    def evict(self, need_blocks: int, protect: frozenset = frozenset()
              ) -> int:
        """Unlink least-recently-used unreferenced leaves until
        ``need_blocks`` blocks have returned to the free ring (or nothing
        evictable remains).  ``protect`` names nodes (by id) an in-flight
        insert is extending.  Returns the number of blocks actually
        freed."""
        freed = 0
        nodes0 = self.stats.evicted_nodes
        while freed < need_blocks:
            candidates = [n for n in self._leaves()
                          if id(n) not in protect and self._evictable(n)]
            if not candidates:
                break
            victim = min(candidates, key=lambda n: n.last_used)
            freed += self._remove(victim)
        tr = self.tracer
        if freed and tr is not None and tr.enabled:
            tr.prefix_evict(freed, self.stats.evicted_nodes - nodes0)
        return freed

    def _remove(self, node: _Node) -> int:
        freed = 0
        for b in node.blocks:
            if self.pool.unref(b) == 0:
                freed += 1
        parent = node.parent
        del parent.children[int(node.tokens[0])]
        self.stats.evicted_nodes += 1
        self.stats.evicted_blocks += freed
        return freed

    # -- introspection ---------------------------------------------------

    def num_nodes(self) -> int:
        n, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            n += 1
            stack.extend(node.children.values())
        return n - 1                       # root doesn't count

    def cached_tokens(self) -> int:
        n, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            n += len(node.tokens)
            stack.extend(node.children.values())
        return n
