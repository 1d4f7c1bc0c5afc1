"""Global (cross-instance) KV-cache block store — Mooncake-store analog. A
port of ``xllm_tpu/disagg/kv_store.py`` on the stdlib HTTP transport
(``server/http.py``) instead of aiohttp.

Counterpart of the reference's KVCacheStore over Mooncake
(reference xllm/core/framework/kv_cache_transfer/kv_cache_store.h:26-78:
batch_put/batch_get/batch_exist/batch_remove keyed by content hash, backed
by a distributed store cluster) and the global-KV design in
docs/en/features/global_kvcache.md. A bounded-LRU HTTP block store is the
cluster tier and instances talk to it with the same npz wire format the
PD handoff uses; a JAX node and a CUDA node share one store. The local
hierarchy (HBM prefix cache -> host tier, framework/host_kv.py) gains a
third level: host-tier evictions are pushed to the store and host-tier
misses are filled from it, so a prefix computed by ANY instance is
reusable by every other instance.

Keys are the chained prefix hashes the block managers already compute
(framework/block_manager.py; equal to the JAX package's), so store entries
compose with local prefix caching with no extra hashing.
"""

from __future__ import annotations

import io
import json
import threading
import urllib.request
from collections import OrderedDict

import numpy as np

from xllm_tpu_torch.framework.host_kv import HierarchyController, HostKVPool
from xllm_tpu_torch.server import http as web
from xllm_tpu_torch.utils import get_logger

logger = get_logger(__name__)


def _pack_blocks(blocks: dict[int, tuple[np.ndarray, np.ndarray]]) -> bytes:
    """{hash: (k_block, v_block)} -> npz bytes."""
    buf = io.BytesIO()
    arrays = {}
    keys = []
    for i, (h, (k, v)) in enumerate(blocks.items()):
        keys.append(int(h))
        arrays[f"k{i}"] = k
        arrays[f"v{i}"] = v
    meta = json.dumps({"keys": keys})
    np.savez(buf, meta=np.frombuffer(meta.encode(), np.uint8), **arrays)
    return buf.getvalue()


def _unpack_blocks(raw: bytes) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    z = np.load(io.BytesIO(raw))
    keys = json.loads(bytes(z["meta"]).decode())["keys"]
    return {
        int(h): (z[f"k{i}"], z[f"v{i}"]) for i, h in enumerate(keys)
    }


def make_kv_store_app(max_blocks: int = 4096) -> web.Application:
    """The store node: bounded LRU of KV blocks keyed by prefix hash.

    Endpoints mirror KVCacheStore's batch ops (kv_cache_store.h:33-52):
    put/get move block payloads as npz; exist/remove are JSON.
    """
    store: OrderedDict[int, bytes] = OrderedDict()  # hash -> npz of (k, v)
    lock = threading.Lock()
    stats = {"puts": 0, "gets": 0, "hits": 0, "evictions": 0}

    async def put(request: web.Request) -> web.Response:
        raw = await request.read()
        blocks = _unpack_blocks(raw)
        with lock:
            for h, (k, v) in blocks.items():
                buf = io.BytesIO()
                np.savez(buf, k=k, v=v)
                store[h] = buf.getvalue()
                store.move_to_end(h)
                stats["puts"] += 1
            while len(store) > max_blocks:
                store.popitem(last=False)
                stats["evictions"] += 1
        return web.json_response({"stored": len(blocks)})

    async def get(request: web.Request) -> web.Response:
        body = await request.json()
        out: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        with lock:
            for h in body["keys"]:
                raw = store.get(int(h))
                stats["gets"] += 1
                if raw is not None:
                    store.move_to_end(int(h))
                    stats["hits"] += 1
                    z = np.load(io.BytesIO(raw))
                    out[int(h)] = (z["k"], z["v"])
        return web.Response(body=_pack_blocks(out),
                            content_type="application/octet-stream")

    async def exist(request: web.Request) -> web.Response:
        body = await request.json()
        with lock:
            res = [int(h) in store for h in body["keys"]]
        return web.json_response({"exist": res})

    async def remove(request: web.Request) -> web.Response:
        body = await request.json()
        n = 0
        with lock:
            for h in body["keys"]:
                if store.pop(int(h), None) is not None:
                    n += 1
        return web.json_response({"removed": n})

    async def get_stats(request: web.Request) -> web.Response:
        with lock:
            return web.json_response(dict(stats, blocks=len(store)))

    app = web.Application(client_max_size=1 << 30)
    app.router.add_post("/kv/put", put)
    app.router.add_post("/kv/get", get)
    app.router.add_post("/kv/exist", exist)
    app.router.add_post("/kv/remove", remove)
    app.router.add_get("/kv/stats", get_stats)
    return app


class KVStoreClient:
    """Instance-side client for the store node (KVCacheStore batch API)."""

    def __init__(self, store_url: str, timeout_s: float = 10.0):
        self.url = store_url.rstrip("/")
        self.timeout_s = timeout_s

    def _post(self, path: str, data: bytes, content_type: str) -> bytes:
        req = urllib.request.Request(
            self.url + path, data=data,
            headers={"Content-Type": content_type}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return resp.read()

    def batch_put(
        self, blocks: dict[int, tuple[np.ndarray, np.ndarray]]
    ) -> int:
        out = self._post("/kv/put", _pack_blocks(blocks),
                         "application/octet-stream")
        return json.loads(out.decode())["stored"]

    def batch_get(
        self, keys: list[int]
    ) -> dict[int, tuple[np.ndarray, np.ndarray]]:
        raw = self._post("/kv/get", json.dumps({"keys": keys}).encode(),
                         "application/json")
        return _unpack_blocks(raw)

    def batch_exist(self, keys: list[int]) -> list[bool]:
        out = self._post("/kv/exist", json.dumps({"keys": keys}).encode(),
                         "application/json")
        return json.loads(out.decode())["exist"]

    def batch_remove(self, keys: list[int]) -> int:
        out = self._post("/kv/remove", json.dumps({"keys": keys}).encode(),
                         "application/json")
        return json.loads(out.decode())["removed"]


class GlobalKVController(HierarchyController):
    """Three-tier hierarchy: HBM prefix cache -> host DRAM -> global store.

    Host-tier evictions push the displaced block to the store (so it
    survives cluster-wide); host-tier misses fall through to a store
    batch_get. Mirrors HierarchyKVCacheTransfer's flow
    (hierarchy_kv_cache_transfer.h) without the RDMA legs.
    """

    def __init__(
        self,
        pool: HostKVPool,
        swap_out,
        swap_in,
        store: KVStoreClient,
        read_host,  # (host_idx) -> (np k_block, np v_block)
        write_host,  # (host_idx, k_block, v_block) -> None
    ):
        super().__init__(pool, swap_out, swap_in)
        self.store = store
        self.read_host = read_host
        self.write_host = write_host
        self.store_puts = 0
        self.store_fetches = 0

    def probe(self, h: int) -> bool:
        if self.pool.lookup(h) is not None:
            return True
        try:
            return self.store.batch_exist([h])[0]
        except Exception as e:
            logger.warning("kv-store exist failed: %s", e)
            return False

    def _reserve_push_evicted(self, h: int) -> int | None:
        """Host slot for h; if an entry gets displaced, push it upstream."""
        pool = self.pool
        if pool.num_blocks == 0:
            return None
        if pool.lookup(h) is None and not pool._free and pool._by_hash:
            evicted_h, evicted_idx = next(iter(pool._by_hash.items()))
            try:
                k, v = self.read_host(evicted_idx)
                self.store.batch_put({evicted_h: (k.copy(), v.copy())})
                self.store_puts += 1
            except Exception as e:  # store outage degrades, never fails
                logger.warning("kv-store put failed: %s", e)
        return pool.reserve(h)

    def on_device_evict(self, block_id: int, h: int) -> None:
        idx = self._reserve_push_evicted(h)
        if idx is not None:
            self.swap_out(block_id, idx)
            self.offloads += 1

    def try_fetch(self, h: int, device_block_id: int) -> bool:
        if super().try_fetch(h, device_block_id):
            return True
        try:
            found = self.store.batch_get([h])
        except Exception as e:
            logger.warning("kv-store get failed: %s", e)
            return False
        if h not in found:
            return False
        k, v = found[h]
        idx = self._reserve_push_evicted(h)
        if idx is None:
            return False
        self.write_host(idx, k, v)
        self.swap_in(idx, device_block_id)
        self.store_fetches += 1
        self.fetches += 1
        return True
