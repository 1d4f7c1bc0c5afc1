"""Host-DRAM KV tier: second-level prefix cache below HBM. A copy of
``xllm_tpu/framework/host_kv.py``.

Counterpart of the reference's HierarchyBlockManagerPool + KVCacheStore
(reference xllm/core/framework/block/hierarchy_block_manager_pool.h:40,74,
kv_cache_transfer/kv_cache_store.h:26,78 — the Mooncake-store host tier,
docs/en/features/global_kvcache.md). Host blocks live in pinned host
memory; offload/prefetch are device<->host copies of one block's
[L, Hkv, bs, D] K/V pair (``ModelRunner.swap_out_block`` /
``swap_in_block``), driven by prefix-cache evictions and misses.

Pure bookkeeping here; the actual copies go through a swapper callback so
host logic stays unit-testable (SURVEY.md §4 fake-engine pattern).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable


class HostKVPool:
    """Content-hash -> host block index, LRU-evicted fixed pool."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free: list[int] = list(range(num_blocks - 1, -1, -1))
        # hash -> host index, in LRU order (front = oldest)
        self._by_hash: OrderedDict[int, int] = OrderedDict()

    def __len__(self) -> int:
        return len(self._by_hash)

    def lookup(self, h: int) -> int | None:
        idx = self._by_hash.get(h)
        if idx is not None:
            self._by_hash.move_to_end(h)
        return idx

    def reserve(self, h: int) -> int | None:
        """Slot for hash h (evicting LRU if full); None if pool size 0."""
        if self.num_blocks == 0:
            return None
        existing = self._by_hash.get(h)
        if existing is not None:
            self._by_hash.move_to_end(h)
            return existing
        if self._free:
            idx = self._free.pop()
        else:
            _, idx = self._by_hash.popitem(last=False)  # evict oldest
        self._by_hash[h] = idx
        return idx

    def drop(self, h: int) -> None:
        idx = self._by_hash.pop(h, None)
        if idx is not None:
            self._free.append(idx)


class HierarchyController:
    """Wires BlockManager eviction/miss hooks to a host pool + swapper.

    swap_out(device_block_id, host_idx): copy HBM block -> host
    swap_in(host_idx, device_block_id): copy host block -> HBM
    """

    def __init__(
        self,
        pool: HostKVPool,
        swap_out: Callable[[int, int], None],
        swap_in: Callable[[int, int], None],
    ):
        self.pool = pool
        self.swap_out = swap_out
        self.swap_in = swap_in
        self.offloads = 0
        self.fetches = 0

    def probe(self, h: int) -> bool:
        """Cheap existence check the block managers gate try_fetch on
        (deeper tiers — e.g. the global store — extend this)."""
        return self.pool.lookup(h) is not None

    def on_device_evict(self, block_id: int, h: int) -> None:
        """Device prefix-cache entry is being recycled — offload it."""
        idx = self.pool.reserve(h)
        if idx is not None:
            self.swap_out(block_id, idx)
            self.offloads += 1

    def try_fetch(self, h: int, device_block_id: int) -> bool:
        """Prefix miss on device — pull from host tier if present."""
        idx = self.pool.lookup(h)
        if idx is None:
            return False
        self.swap_in(idx, device_block_id)
        self.fetches += 1
        return True
