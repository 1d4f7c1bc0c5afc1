"""Paged KV-cache block manager with prefix caching.

Counterpart of the reference's BlockManagerPool/BlockManagerImpl + PrefixCache
(reference xllm/core/framework/block/block_manager_pool.h:27,
xllm/core/framework/block/block_manager_impl.*,
xllm/core/framework/prefix_cache/prefix_cache.h:44,68-91,
block hashing in prefix_cache/block_hasher.cpp). Design differences for TPU:

- Physical blocks are rows of one pre-allocated HBM array per layer; block 0
  is reserved as the *null block* that padded slot-mapping entries write into
  (the reference instead relies on VMM trash pages / masked scatter).
- Prefix cache and allocator are fused: a freed block keeps its content hash
  and sits in an LRU "free but cached" queue; allocation evicts from the LRU
  tail exactly like the reference's PrefixCache LRU eviction.
- Hashing is a chained 64-bit blake2b over (parent_hash, block token ids),
  the same chain structure as the reference's murmur3 block chains (the JAX
  package uses xxhash64; blake2b comes with the standard library).

Pure host logic — unit-tested without any device (SURVEY.md §4 fake-engine
pattern).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

from xllm_tpu_torch.framework.request import Sequence
from xllm_tpu_torch.utils import cdiv


def hash_block(parent_hash: int, token_ids: list[int], extra: bytes = b"") -> int:
    h = hashlib.blake2b(digest_size=8)
    h.update(parent_hash.to_bytes(8, "little", signed=False))
    h.update(b"".join(t.to_bytes(4, "little", signed=True) for t in token_ids))
    if extra:
        h.update(extra)
    return int.from_bytes(h.digest(), "little")


class BlockManager:
    """Allocator + prefix cache for one paged-KV pool (one DP rank)."""

    NULL_BLOCK = 0


    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        enable_prefix_cache: bool = True,
        hierarchy=None,  # HierarchyController for the host-DRAM tier
        base: int = 0,  # global id of this pool's first block (DP shard)
    ) -> None:
        self.hierarchy = hierarchy
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is reserved)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_cache = enable_prefix_cache
        # DP shards: this manager owns global ids [base, base + num_blocks);
        # internal state is local, seq.block_ids carry global ids
        # (reference per-rank BlockManagerPool, block_manager_pool.h:27)
        self.base = base

        self.ref_counts = [0] * num_blocks
        self.ref_counts[self.NULL_BLOCK] = 1  # never allocated
        # block_id -> content hash for blocks holding cached full content
        self.block_hash: dict[int, int] = {}
        # content hash -> block_id
        self.cached_blocks: dict[int, int] = {}
        # LRU of ref==0 blocks (front = oldest = next eviction victim)
        self.free_lru: OrderedDict[int, None] = OrderedDict(
            (i, None) for i in range(1, num_blocks)
        )
        # per-sequence block hashes already inserted (seq_id -> count)
        self._released: dict = {}
        self._seq_num_hashed: dict[int, int] = {}

    @property
    def null_block(self) -> int:
        """Global id of this pool's reserved null block (padded writes)."""
        return self.base

    # ---- capacity ----
    @property
    def num_free_blocks(self) -> int:
        return len(self.free_lru)

    @property
    def num_used_blocks(self) -> int:
        return self.num_blocks - 1 - len(self.free_lru)

    def has_capacity(self, n: int) -> bool:
        return len(self.free_lru) >= n

    # ---- low-level alloc/free ----
    def _pop_free_block(self) -> int:
        block_id, _ = self.free_lru.popitem(last=False)
        # evict any cached content living in this block — offloading it to
        # the host tier first when one is configured (reference
        # HierarchyBlockManagerPool offload path)
        h = self.block_hash.pop(block_id, None)
        if h is not None and self.cached_blocks.get(h) == block_id:
            del self.cached_blocks[h]
            if self.hierarchy is not None:
                self.hierarchy.on_device_evict(self.base + block_id, h)
        self.ref_counts[block_id] = 1
        return block_id

    def _ref_block(self, block_id: int) -> None:
        if self.ref_counts[block_id] == 0:
            self.free_lru.pop(block_id, None)
        self.ref_counts[block_id] += 1

    def _unref_block(self, block_id: int) -> None:
        assert self.ref_counts[block_id] > 0, f"double free of block {block_id}"
        self.ref_counts[block_id] -= 1
        if self.ref_counts[block_id] == 0:
            # most-recently-used end; keeps hash for future prefix hits
            self.free_lru[block_id] = None

    # ---- sequence-level API ----
    def match_prefix(self, seq: Sequence) -> int:
        """Prefix-cache lookup for a new/resumed sequence.

        Returns the number of prompt tokens whose KV can be reused. Only
        whole blocks match, and at least one token is always left to compute
        so the forward pass produces logits (same cap as the reference's
        prefill path, continuous_scheduler.cpp:390 prefix-match step).
        """
        if not self.enable_prefix_cache or seq.block_ids:
            return 0
        bs = self.block_size
        max_match = (seq.num_tokens - 1) // bs  # full blocks, leave >=1 token
        parent = 0
        matched: list[int] = []
        for i in range(max_match):
            h = hash_block(parent, seq.token_ids[i * bs : (i + 1) * bs])
            block_id = self.cached_blocks.get(h)
            if block_id is None and self.hierarchy is not None:
                # host-tier prefetch: pull the block into a fresh device
                # block and register it (reference hierarchy prefetch path)
                if self.free_lru and self.hierarchy.probe(h):
                    fresh = self._pop_free_block()
                    if self.hierarchy.try_fetch(h, self.base + fresh):
                        self.cached_blocks[h] = fresh
                        self.block_hash[fresh] = h
                        self.ref_counts[fresh] = 0
                        self.free_lru[fresh] = None
                        block_id = fresh
                    else:  # pragma: no cover - lookup raced
                        self.ref_counts[fresh] = 0
                        self.free_lru[fresh] = None
            if block_id is None:
                break
            # ref IMMEDIATELY: a later iteration's host-tier prefetch
            # pops from free_lru and could otherwise evict+overwrite a
            # block matched earlier in this very loop (the native backend
            # refs inside its match loop too — keep them equivalent)
            self._ref_block(block_id)
            matched.append(block_id)
            parent = h
        seq.block_ids = [self.base + b for b in matched]
        seq.num_cached_tokens = len(matched) * bs
        seq.num_computed_tokens = seq.num_cached_tokens
        return seq.num_cached_tokens

    def blocks_needed(self, seq: Sequence, num_new_tokens: int) -> int:
        """Blocks to allocate so the seq can hold current + new tokens."""
        total = seq.num_computed_tokens + num_new_tokens
        return max(0, cdiv(total, self.block_size) - len(seq.block_ids))

    def allocate(self, seq: Sequence, num_new_tokens: int) -> bool:
        """Ensure capacity for ``num_new_tokens`` beyond computed tokens."""
        need = self.blocks_needed(seq, num_new_tokens)
        if need > len(self.free_lru):
            return False
        for _ in range(need):
            seq.block_ids.append(self.base + self._pop_free_block())
        return True

    def free(self, seq: Sequence) -> None:
        """Release all blocks of a finished/preempted sequence."""
        null = self.null_block
        for b in reversed(seq.block_ids):
            if b != null:  # out-of-window entries already released
                self._unref_block(b - self.base)
        seq.reset_kv()
        self._seq_num_hashed.pop(seq.seq_id, None)
        self._released.pop(seq.seq_id, None)

    def release_out_of_window(self, seq: Sequence, window: int) -> int:
        """Free pages fully below the sliding-attention window, pointing
        their table entries at the null block (reference
        SlidingWindowBlockManager, kv_cache_manager.h:28-78 variant list).

        Every future decode position p attends only kv >= p+1-window, and
        p grows monotonically, so pages whose last token index is below
        ``num_tokens - window`` can never be read again — the window mask
        in the attention kernels already voids whatever the recycled (or
        null) pages hold. Returns the number of pages released."""
        if window <= 0:
            return 0
        bs = self.block_size
        dead = max(0, seq.num_tokens - window) // bs
        done = self._released.get(seq.seq_id, 0)
        if dead <= done:
            return 0
        null = self.null_block
        for i in range(done, dead):
            b = seq.block_ids[i]
            if b != null:
                self._unref_block(b - self.base)
                seq.block_ids[i] = null
        self._released[seq.seq_id] = dead
        # recycled pages make further prefix caching of this sequence
        # meaningless (and hashing freed blocks would corrupt the cache)
        self._seq_num_hashed[seq.seq_id] = 10**9
        return dead - done

    def cache_computed_blocks(self, seq: Sequence) -> None:
        """Insert full computed blocks into the prefix cache.

        Called after a forward step advances ``num_computed_tokens``
        (reference PrefixCache::insert, prefix_cache.h:75).
        """
        if not self.enable_prefix_cache:
            return
        bs = self.block_size
        # hash only tokens whose values are known on host (async overlap may
        # leave trailing placeholder ids that must not poison the cache)
        known = min(seq.num_computed_tokens, seq.num_fixed_tokens)
        num_full = known // bs
        start = self._seq_num_hashed.get(seq.seq_id, 0)
        if start >= num_full:
            return
        # recompute parent hash chain from stored per-block hashes
        parent = 0
        if start > 0:
            parent = self.block_hash.get(seq.block_ids[start - 1] - self.base, 0)
            if parent == 0:
                start = 0
                parent = 0
        for i in range(start, num_full):
            h = hash_block(parent, seq.token_ids[i * bs : (i + 1) * bs])
            block_id = seq.block_ids[i] - self.base
            existing = self.cached_blocks.get(h)
            if existing is None:
                self.cached_blocks[h] = block_id
                self.block_hash[block_id] = h
            self._seq_num_hashed[seq.seq_id] = i + 1
            parent = h

    def slot_for_token(self, seq: Sequence, token_idx: int) -> int:
        """Flat slot index (block_id * block_size + offset) for a position."""
        bs = self.block_size
        return seq.block_ids[token_idx // bs] * bs + token_idx % bs

    # ---- beam-search forking (reference beam_searcher.cpp:21) ----
    def ref_blocks(self, global_ids: list[int]) -> None:
        for b in global_ids:
            self._ref_block(b - self.base)

    def alloc_raw_block(self) -> int:
        return self.base + self._pop_free_block()

    def fork_blocks(self, parent: Sequence, child: Sequence):
        return _fork_blocks_impl(self, parent.block_ids, child)


class BlockManagerPool:
    """Per-DP-rank block pools behind the single-manager interface.

    Counterpart of the reference's BlockManagerPool
    (reference xllm/core/framework/block/block_manager_pool.h:27): the KV
    array's block dim is sharded over the mesh ``data`` axis, so each DP
    rank owns a contiguous global-id range [rank*per, (rank+1)*per) with
    its own allocator, prefix cache, and null block (the range's first
    block). A sequence is pinned to the least-loaded rank on first
    allocation; all its blocks — and its row in every forward batch — stay
    on that rank.
    """

    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        dp_size: int,
        enable_prefix_cache: bool = True,
        manager_cls=None,
        hierarchy=None,
    ) -> None:
        if num_blocks % dp_size != 0:
            raise ValueError("num_blocks must divide evenly over DP ranks")
        cls = manager_cls or BlockManager
        self.dp_size = dp_size
        self.block_size = block_size
        self.blocks_per_rank = num_blocks // dp_size
        self.enable_prefix_cache = enable_prefix_cache
        # ONE shared host tier below the per-rank device pools: hashes
        # are content-global and device ids carry the rank base, so a
        # block evicted on rank a can prefetch on rank b (reference
        # HierarchyBlockManagerPool wraps per-rank pools over the shared
        # store the same way, hierarchy_block_manager_pool.h:40,74)
        self.hierarchy = hierarchy
        self.managers = [
            cls(
                self.blocks_per_rank,
                block_size,
                enable_prefix_cache,
                base=r * self.blocks_per_rank,
                hierarchy=hierarchy,
            )
            for r in range(dp_size)
        ]

    # ---- rank assignment ----
    def _mgr(self, seq: Sequence):
        if seq.dp_rank < 0:
            # least-loaded rank (reference BatchFactory balance heuristic)
            seq.dp_rank = max(
                range(self.dp_size),
                key=lambda r: self.managers[r].num_free_blocks,
            )
        return self.managers[seq.dp_rank]

    def null_block_of(self, rank: int) -> int:
        return self.managers[rank].null_block

    # ---- aggregate capacity (zero-eviction admission etc.) ----
    @property
    def num_blocks(self) -> int:
        return self.blocks_per_rank * self.dp_size

    @property
    def num_free_blocks(self) -> int:
        return sum(m.num_free_blocks for m in self.managers)

    @property
    def num_used_blocks(self) -> int:
        return sum(m.num_used_blocks for m in self.managers)

    def has_capacity(self, n: int) -> bool:
        return max(m.num_free_blocks for m in self.managers) >= n

    # ---- sequence-level API (routed) ----
    def match_prefix(self, seq: Sequence) -> int:
        return self._mgr(seq).match_prefix(seq)

    def blocks_needed(self, seq: Sequence, num_new_tokens: int) -> int:
        return self._mgr(seq).blocks_needed(seq, num_new_tokens)

    def allocate(self, seq: Sequence, num_new_tokens: int) -> bool:
        return self._mgr(seq).allocate(seq, num_new_tokens)

    def free(self, seq: Sequence) -> None:
        if seq.dp_rank >= 0:
            self.managers[seq.dp_rank].free(seq)
            seq.dp_rank = -1

    def release_out_of_window(self, seq: Sequence, window: int) -> int:
        if seq.dp_rank < 0:
            return 0
        return self.managers[seq.dp_rank].release_out_of_window(seq, window)

    def cache_computed_blocks(self, seq: Sequence) -> None:
        if seq.dp_rank >= 0:
            self.managers[seq.dp_rank].cache_computed_blocks(seq)

    def slot_for_token(self, seq: Sequence, token_idx: int) -> int:
        bs = self.block_size
        return seq.block_ids[token_idx // bs] * bs + token_idx % bs

    def fork_blocks(self, parent: Sequence, child: Sequence):
        child.dp_rank = parent.dp_rank
        return self.managers[parent.dp_rank].fork_blocks(parent, child)


def _fork_blocks_impl(mgr, parent_ids: list[int], child) -> tuple[int, int] | None:
    """Shared fork logic: child shares the parent's blocks (ref++), except
    a partial tail block which is copied into a fresh block. Returns the
    (src, dst) GLOBAL block pair to copy on device, or None.

    Counterpart of the reference BeamSearcher's block-copy step
    (beam_searcher.cpp:21 + its device block-copy kernel): full blocks are
    immutable once written, so sharing them is safe; only the tail can
    still be written.
    """
    num_tokens = child.num_tokens
    bs = mgr.block_size
    # the NEXT decode writes position num_tokens-1 (sample-then-compute:
    # computed == num_tokens-1 at fork). The tail block must be private
    # whenever that position lands inside it — i.e. unless position
    # num_tokens-1 starts a fresh block. Keying on num_tokens % bs shared
    # a still-writable block at the num_tokens % bs == 0 boundary (both
    # beams then wrote different tokens into the same physical slot) and
    # copied a fully-immutable block at % bs == 1.
    tail_partial = (num_tokens - 1) % bs != 0
    shared = parent_ids[:-1] if tail_partial and parent_ids else parent_ids
    # out-of-window entries (sliding-window release) stay null: shared by
    # name only, never ref-counted
    null = mgr.null_block
    refable = [b for b in shared if b != null]
    copy_pair = None
    if tail_partial and parent_ids:
        if not mgr.has_capacity(1):
            return None
        mgr.ref_blocks(refable)
        fresh = mgr.alloc_raw_block()
        copy_pair = (parent_ids[-1], fresh)
        child.block_ids = list(shared) + [fresh]
    else:
        mgr.ref_blocks(refable)
        child.block_ids = list(shared)
    return copy_pair
