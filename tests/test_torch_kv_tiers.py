"""The host and global KV tiers of ``xllm_tpu_torch`` on the CPU vs ``xllm_tpu``.

Every case of ``tests/test_host_kv.py`` and ``tests/test_kv_store.py``
runs on both packages, on the same seeded tiny f32 models (weights carried
by ``weights.random_param_tree``): greedy tokens and the tiers' counters
equal JAX's. Besides:

- the runner's block moves against JAX's on the same caches (bf16 with an
  entry above 65504 and a bf16 subnormal, f32, int8, fp8; split,
  interleaved and MLA): after ``swap_out_block`` / ``swap_in_block`` the
  cache bytes equal JAX's (both stage through float16, which is not
  exact for bf16 outside f16's normal range), and ``extract_blocks`` /
  ``inject_blocks`` move the same bytes, in every block but the null block
  0 (JAX's power-of-two padding scatters into it);
- the store's wire both ways: the port's client against JAX's store app
  and JAX's client against the port's;
- the host slots' ordering on a deferred model of the card's stream
  (``DeferredStream``): a CPU write to a slot waits for the swap-in still
  reading it and for the swap-out still writing it, and a CPU read for
  the swap-out;
- ``DecodeStepCache`` is off with the host tier, as in JAX.
"""

import asyncio
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xllm_tpu.config as jcfg
import xllm_tpu_torch.config as tcfg
from xllm_tpu.disagg import kv_store as jstore
from xllm_tpu.engine import LLMEngine as JEngine
from xllm_tpu.framework import host_kv as jhost
from xllm_tpu.framework.block_manager import BlockManager as JBlockManager
from xllm_tpu.framework.request import Request as JRequest
from xllm_tpu.framework.sampling_params import SamplingParams as JSP
from xllm_tpu.runtime.model_runner import ModelRunner as JRunner
from xllm_tpu_torch.disagg import kv_store as tstore
from xllm_tpu_torch.engine import LLMEngine as TEngine
from xllm_tpu_torch.framework import host_kv as thost
from xllm_tpu_torch.framework.block_manager import BlockManager as TBlockManager
from xllm_tpu_torch.framework.request import Request as TRequest
from xllm_tpu_torch.framework.sampling_params import SamplingParams as TSP
from xllm_tpu_torch.runtime.model_runner import ModelRunner as TRunner
from xllm_tpu_torch.server import http as tweb
from xllm_tpu_torch.weights import random_param_tree
from torch_threads import one_torch_thread  # noqa: F401

PKGS = {"jax": (jcfg, JEngine, JSP), "port": (tcfg, TEngine, TSP)}


def tiny_config(c, **cache_kw):
    """``tests/test_engine.py``'s tiny qwen3 (block_size 4, chunks of 16)."""
    return c.EngineConfig(
        model=c.ModelConfig(
            model_type="qwen3", dtype="float32", vocab_size=97, hidden_size=64,
            intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, qk_norm=True,
            max_position_embeddings=128, eos_token_ids=[0],
        ),
        cache=c.CacheConfig(block_size=4, num_blocks=64, **cache_kw),
        scheduler=c.SchedulerConfig(
            max_seqs_per_batch=8, max_tokens_per_chunk_for_prefill=16,
            max_model_len=128, decode_batch_buckets=[2, 4, 8],
            prefill_token_buckets=[4, 8, 16],
        ),
    )


def mla_config(c, **cache_kw):
    """``tests/test_disagg_pd.py``'s deepseek_v2 (block_size 8)."""
    return c.EngineConfig(
        model=c.ModelConfig(
            model_type="deepseek_v2", dtype="float32", vocab_size=256, hidden_size=128,
            intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=4, q_lora_rank=96, kv_lora_rank=64,
            qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
            max_position_embeddings=256, eos_token_ids=[0]),
        cache=c.CacheConfig(block_size=8, num_blocks=32, **cache_kw),
        scheduler=c.SchedulerConfig(
            max_seqs_per_batch=2, decode_batch_buckets=[2],
            prefill_token_buckets=[32], max_model_len=128),
    )


TREES = {}


def tree_of(make):
    if make not in TREES:
        TREES[make] = random_param_tree(make(tcfg).model, seed=3)
    return TREES[make]


def engine(pkg: str, cfg, make=tiny_config):
    """An engine of ``pkg`` on ``make``'s seeded tree (the port's on the CPU)."""
    tree = tree_of(make)
    if pkg == "jax":
        runner = JRunner(cfg)
        runner.load_model(params=jax.tree.map(jnp.asarray, tree))
        return JEngine(cfg, runner=runner)
    runner = TRunner(cfg, device="cpu")
    runner.load_model(params=tree)
    return TEngine(cfg, runner=runner)


def generate(eng, sp_cls, prompt, max_tokens=4):
    eng.add_request(prompt_token_ids=list(prompt),
                    sampling_params=sp_cls(temperature=0.0, max_tokens=max_tokens,
                                           ignore_eos=True))
    return eng.generate_all()[0].outputs[0].token_ids


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


# ---------------------------------------------------------------------------
# pool and controller (tests/test_host_kv.py)
# ---------------------------------------------------------------------------
def test_host_pool_lru():
    """The same reserve / lookup / drop walk gives the same slots."""
    rng = np.random.default_rng(0)
    pools = (jhost.HostKVPool(3), thost.HostKVPool(3))
    for _ in range(200):
        op, h = int(rng.integers(0, 3)), int(rng.integers(0, 6))
        outs = [getattr(p, ("reserve", "lookup", "drop")[op])(h) for p in pools]
        assert outs[0] == outs[1]
        assert len(pools[0]) == len(pools[1])
    assert thost.HostKVPool(0).reserve(1) is None


def offload_walk(pkg):
    """tests/test_host_kv.py's walk on one package's block manager -> the
    swaps it made, in order."""
    host, bm_cls, req_cls, sp_cls = (
        (jhost, JBlockManager, JRequest, JSP) if pkg == "jax"
        else (thost, TBlockManager, TRequest, TSP))
    swaps = []
    ctrl = host.HierarchyController(host.HostKVPool(4),
                                    lambda d, h: swaps.append(("out", d, h)),
                                    lambda h, d: swaps.append(("in", h, d)))
    bm = bm_cls(num_blocks=4, block_size=4, hierarchy=ctrl)

    def seq(tokens):
        return req_cls("r", list(tokens), sp_cls(max_tokens=4), max_model_len=256).sequences[0]

    s1 = seq(range(1, 10))  # 8 tokens -> 2 full cached blocks
    assert bm.allocate(s1, 9)
    s1.num_computed_tokens = 9
    bm.cache_computed_blocks(s1)
    bm.free(s1)
    s2 = seq(range(50, 62))  # exhaust the pool: the cached blocks go to host
    assert bm.allocate(s2, 12)
    assert ctrl.offloads == 2
    bm.free(s2)
    s3 = seq(range(1, 10))  # seq1's prefix comes back from the host tier
    assert bm.match_prefix(s3) == 8
    assert ctrl.fetches == 2 and len(s3.block_ids) == 2
    bm.free(s3)
    return swaps


def test_offload_then_prefetch_roundtrip():
    """The same walk makes the same swaps, in the same order, on both."""
    assert offload_walk("port") == offload_walk("jax")


# ---------------------------------------------------------------------------
# engines with the host tier
# ---------------------------------------------------------------------------
def host_tier_run(pkg, make, num_blocks, vocab_hi):
    c, _, sp_cls = PKGS[pkg]
    cfg = make(c, num_host_blocks=32)
    cfg.cache.num_blocks = num_blocks  # a tiny device pool forces eviction
    eng = engine(pkg, cfg, make)
    prompt = list(range(1, 30))
    out1 = generate(eng, sp_cls, prompt)
    rng = np.random.default_rng(1)
    for _ in range(3):  # churn the pool to evict the cached prefix
        generate(eng, sp_cls, [int(x) for x in rng.integers(30, vocab_hi, 40)])
    hier = eng.block_manager.hierarchy
    offloads = hier.offloads
    out2 = generate(eng, sp_cls, prompt)
    assert eng.block_manager.num_used_blocks == 0
    return out1, out2, offloads, hier.fetches


@pytest.mark.parametrize("make,num_blocks,vocab_hi", [(tiny_config, 16, 90),
                                                       (mla_config, 12, 250)],
                         ids=["qwen3", "deepseek_v2"])
def test_e2e_engine_with_host_tier(make, num_blocks, vocab_hi):
    """tests/test_host_kv.py's engine runs (the MLA one rides its 1-d dummy
    v slot): the prefix is offloaded, fetched back, and the tokens and
    counters equal JAX's."""
    want = host_tier_run("jax", make, num_blocks, vocab_hi)
    got = host_tier_run("port", make, num_blocks, vocab_hi)
    assert got == want
    assert got[0] == got[1] and got[2] > 0 and got[3] > 0


@pytest.mark.parametrize("blocks", [0, 8])
def test_decode_step_cache_off_with_host_tier(blocks):
    """The runner's incremental decode-input build is off with the host
    tier, as the JAX runner's is."""
    j = JRunner(tiny_config(jcfg, num_host_blocks=blocks))
    t = TRunner(tiny_config(tcfg, num_host_blocks=blocks), device="cpu")
    assert (t._decode_cache is None) == (j._decode_cache is None) == (blocks > 0)


# ---------------------------------------------------------------------------
# the runner's block moves against JAX's
# ---------------------------------------------------------------------------
MOVE_CASES = {
    "bf16": dict(dtype="bfloat16"),
    "f32": dict(dtype="float32"),
    "int8": dict(dtype="bfloat16", kv_cache_dtype="int8"),
    "fp8": dict(dtype="bfloat16", kv_cache_dtype="fp8_e4m3"),
    "bf16-interleaved": dict(dtype="bfloat16", kv_layout="interleaved"),
    "mla-bf16": dict(dtype="bfloat16", mla=True),
    "mla-fp8": dict(dtype="bfloat16", kv_cache_dtype="fp8_e4m3", mla=True),
}
_JNP = {"bfloat16": jnp.bfloat16, "float32": jnp.float32, "int8": jnp.int8,
        "float8_e4m3fn": jnp.float8_e4m3fn}


def move_runners(case):
    """A JAX runner and a port runner of ``case`` with equal caches of 8
    blocks: seeded values, and in a bf16 cache, at the head of block 2,
    entries above f16's largest (65504), one within its range, and three
    below its smallest normal, the last a bf16 subnormal."""
    kw = dict(MOVE_CASES[case])
    mla = kw.pop("mla", False)
    dtype = kw.pop("dtype")
    runners = []
    for c in (jcfg, tcfg):
        cfg = mla_config(c, **kw) if mla else tiny_config(c, **kw)
        cfg.model.dtype = dtype
        cfg.cache.num_blocks = 8
        r = JRunner(cfg) if c is jcfg else TRunner(cfg, device="cpu")
        r.initialize_kv_cache(8)
        runners.append(r)
    jr, tr = runners
    rng = np.random.default_rng(list(MOVE_CASES).index(case))
    for name in ("k_cache", "v_cache"):
        cache = getattr(tr, name)
        if cache.ndim < 5:
            continue
        vals = rng.standard_normal(cache.shape).astype(np.float32) * 4
        if cache.dtype == torch.int8:
            t = torch.from_numpy(np.clip(np.round(vals * 20), -127, 127).astype(np.int8))
        else:
            t = torch.from_numpy(vals).to(cache.dtype)
        if cache.dtype == torch.bfloat16:
            head = t[0, 2].reshape(-1)
            head[:6] = torch.tensor(SPECIAL)
            assert 0 < abs(head[5].item()) < 2.0 ** -126  # a bf16 subnormal
            t[0, 2] = head.view(t[0, 2].shape)
        cache.copy_(t)
        host = t.numpy() if t.dtype == torch.int8 else t.float().numpy()
        setattr(jr, name, jnp.asarray(host).astype(_JNP[str(cache.dtype)[6:]]))
    return jr, tr


# bf16 entries at the head of block 2: above f16's largest (two), within
# its range, below its smallest normal (a f16 subnormal, below its smallest
# subnormal), and a bf16 subnormal
SPECIAL = [70000.0, -1.0e5, 60000.0, 3.0e-6, -2.0e-8, 1.0e-40]


def as_bytes(a) -> np.ndarray:
    """An array's bytes, the last axis widened by the itemsize."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(a).view(np.uint8)


def assert_same_caches(jr, tr, what):
    """Cache bytes equal in every block but the null block 0 (a rank-1
    dummy v slot whole)."""
    for name in ("k_cache", "v_cache"):
        j, t = as_bytes(getattr(jr, name)), as_bytes(getattr(tr, name))
        if t.ndim >= 5:
            j, t = j[:, 1:], t[:, 1:]
        np.testing.assert_array_equal(t, j, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("case", list(MOVE_CASES))
def test_swap_out_in_bytes_equal_jax(case):
    """Blocks 2 and 5 go out to host slots 1 and 0 and come back into
    blocks 6 and 3: the host slots hold JAX's bytes and the caches end
    with JAX's (f16 staging: a bf16 entry above 65504 comes back inf, one
    below f16's smallest subnormal comes back zero, in both packages)."""
    jr, tr = move_runners(case)
    for r in (jr, tr):
        r.init_host_kv(2)
    assert tr.host_k.dtype == (torch.float32 if case == "f32" else torch.float16)
    assert tuple(tr.host_k.shape) == jr.host_k.shape
    assert tuple(tr.host_v.shape) == jr.host_v.shape
    for dev, host in ((2, 1), (5, 0)):
        jr.swap_out_block(dev, host)
        tr.swap_out_block(dev, host)
    for host in (0, 1):
        tk, tv = tr.read_host_block(host)
        np.testing.assert_array_equal(as_bytes(tk), as_bytes(jr.host_k[host]))
        np.testing.assert_array_equal(as_bytes(tv), as_bytes(jr.host_v[host]))
    for host, dev in ((1, 6), (0, 3)):
        jr.swap_in_block(host, dev)
        tr.swap_in_block(host, dev)
    assert_same_caches(jr, tr, case)
    if tr.k_cache.dtype == torch.bfloat16:  # the shared f16 staging, pinned
        back = tr.k_cache[0, 6].reshape(-1)[:6].float()
        sent = torch.tensor(SPECIAL).to(torch.bfloat16).float()
        assert torch.isinf(back[:2]).all() and back[2] == sent[2]
        assert back[3] != sent[3] and back[4] == 0 and back[5] == 0


@pytest.mark.parametrize("case", list(MOVE_CASES))
def test_extract_inject_bytes_equal_jax(case):
    """``extract_blocks`` gives JAX's blocks; ``inject_blocks`` of them into
    other blocks leaves JAX's cache bytes in every block but 0."""
    jr, tr = move_runners(case)
    ids = [5, 2, 7]
    jk, jv = jr.extract_blocks(ids)
    tk, tv = tr.extract_blocks(ids)
    assert tuple(tk.shape) == jk.shape and tuple(tv.shape) == jv.shape
    np.testing.assert_array_equal(as_bytes(tk), as_bytes(jk))
    np.testing.assert_array_equal(as_bytes(tv), as_bytes(jv))
    dst = [1, 6, 3]
    jr.inject_blocks(jk, jv, dst)
    tr.inject_blocks(tk, tv, dst)
    assert_same_caches(jr, tr, case)
    np.testing.assert_array_equal(as_bytes(tr.k_cache[:, dst].transpose(0, 1)),
                                  as_bytes(tk))


# ---------------------------------------------------------------------------
# ordering of the host slots' copies
# ---------------------------------------------------------------------------
class DeferredStream:
    """A model of the card's stream for the host tier: ``run`` queues a
    copy instead of running it (as a copy on the card lands later, in
    queue order), and an event's ``synchronize`` runs the queue up to the
    point where the event was recorded."""

    def __init__(self):
        self.queue = []
        self.done = 0

    def run(self, fn):
        self.queue.append(fn)

    def event(self):
        stream, mark = self, len(self.queue)

        class Event:
            def synchronize(self):
                while stream.done < mark:
                    stream.queue[stream.done]()
                    stream.done += 1
        return Event()

    def drain(self):
        self.event().synchronize()


def deferred_runner():
    cfg = tiny_config(tcfg)
    r = TRunner(cfg, device="cpu")
    r.initialize_kv_cache(8)
    r.init_host_kv(2)
    r.host_stream = DeferredStream()
    for b in range(8):
        r.k_cache[:, b] = float(b)
        r.v_cache[:, b] = -float(b)
    return r


def test_host_slot_write_waits_for_swap_in():
    """A store fetch rewrites a slot whose swap-in to the card has not run:
    the swap-in must still read the slot's old content."""
    r = deferred_runner()
    r.swap_out_block(3, 1)
    r.swap_in_block(1, 5)  # queued: still reading slot 1
    k_new = np.full(r.host_k.shape[1:], 9.0, np.float32)
    r.write_host_block(1, k_new, -k_new)
    r.host_stream.drain()
    assert torch.all(r.k_cache[:, 5] == 3.0) and torch.all(r.v_cache[:, 5] == -3.0)
    assert torch.all(r.host_k[1] == 9.0)


def test_host_slot_write_waits_for_swap_out():
    """An LRU reuse rewrites a slot whose swap-out from the card has not
    landed: the host's write must not be overwritten by it."""
    r = deferred_runner()
    r.swap_out_block(4, 0)  # queued: still writing slot 0
    k_new = np.full(r.host_k.shape[1:], 7.0, np.float32)
    r.write_host_block(0, k_new, k_new)
    r.host_stream.drain()
    assert torch.all(r.host_k[0] == 7.0) and torch.all(r.host_v[0] == 7.0)


def test_host_slot_read_waits_for_swap_out():
    """A push to the store reads a slot whose swap-out has not landed: the
    read must see the block."""
    r = deferred_runner()
    r.swap_out_block(6, 1)
    k, v = r.read_host_block(1)
    assert np.all(k == 6.0) and np.all(v == -6.0)


# ---------------------------------------------------------------------------
# the global store (tests/test_kv_store.py)
# ---------------------------------------------------------------------------
class StoreNode:
    """A store app on a real port, served by a loop in a thread: JAX's on
    aiohttp or the port's on ``server/http.py``."""

    def __init__(self, pkg: str, max_blocks: int = 64):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        if pkg == "jax":
            from aiohttp import web
            app = jstore.make_kv_store_app(max_blocks)
        else:
            web, app = tweb, tstore.make_kv_store_app(max_blocks)
        self.url = asyncio.run_coroutine_threadsafe(self._start(web, app),
                                                    self.loop).result(timeout=10)

    async def _start(self, web, app):
        self.runner = web.AppRunner(app)
        await self.runner.setup()
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        await site.start()
        return f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"

    def stop(self):
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(), self.loop).result(timeout=10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=5)


@pytest.mark.parametrize("client,app", [("port", "port"), ("port", "jax"),
                                        ("jax", "port")])
def test_store_service_crud(client, app):
    """put / exist / get / LRU bound / remove, with either package's client
    against either's app: the payloads come back equal (bf16 as its bits)."""
    node = StoreNode(app, max_blocks=2)
    try:
        c = (tstore if client == "port" else jstore).KVStoreClient(node.url)
        k1 = np.arange(12, dtype=np.float32).reshape(3, 4)
        v1 = (k1 * 2).astype(np.float16)
        assert c.batch_put({101: (k1, v1)}) == 1
        assert c.batch_exist([101, 202]) == [True, False]
        got = c.batch_get([101, 202])
        assert set(got) == {101}
        np.testing.assert_array_equal(got[101][0], k1)
        assert got[101][1].dtype == np.float16
        np.testing.assert_array_equal(got[101][1], v1)
        c.batch_put({202: (k1, v1)})
        c.batch_put({303: (k1, v1)})
        assert c.batch_exist([101, 202, 303]) == [False, True, True]
        assert c.batch_remove([202, 999]) == 1
        assert c.batch_exist([202]) == [False]
        # the packed payload is byte-identical across the packages
        blocks = {7: (k1, v1), 1 << 63: (v1, k1)}
        assert tstore._pack_blocks(blocks) == jstore._pack_blocks(blocks)
    finally:
        node.stop()


def test_three_tier_offload_and_store_fetch():
    """tests/test_kv_store.py's walk on the port's controller and store:
    host-tier displacement pushes to the store; a host miss falls through
    to a store get and restores the block."""
    node = StoreNode("port")
    try:
        host_k = np.zeros((1, 8), np.float32)  # one host slot forces the push
        host_v = np.zeros((1, 8), np.float32)
        device = {7: (np.full(8, 1.0, np.float32), np.full(8, 2.0, np.float32)),
                  8: (np.full(8, 3.0, np.float32), np.full(8, 4.0, np.float32))}
        restored = []

        def swap_out(dev, host):
            host_k[host], host_v[host] = device[dev]

        def swap_in(host, dev):
            restored.append((host_k[host].copy(), host_v[host].copy(), dev))

        ctrl = tstore.GlobalKVController(
            thost.HostKVPool(1), swap_out, swap_in, store=tstore.KVStoreClient(node.url),
            read_host=lambda i: (host_k[i], host_v[i]),
            write_host=lambda i, k, v: (host_k.__setitem__(i, k), host_v.__setitem__(i, v)),
        )
        ctrl.on_device_evict(7, 111)
        ctrl.on_device_evict(8, 222)
        assert ctrl.store_puts == 1 and ctrl.pool.lookup(111) is None
        assert ctrl.probe(111) and not ctrl.probe(999)
        assert ctrl.try_fetch(111, device_block_id=5)
        assert ctrl.store_fetches == 1
        k, v, dev = restored[-1]
        np.testing.assert_array_equal(k, np.full(8, 1.0))
        np.testing.assert_array_equal(v, np.full(8, 2.0))
        assert dev == 5
        assert ctrl.store.batch_exist([111, 222]) == [True, True]
        assert not ctrl.try_fetch(999, device_block_id=6)
    finally:
        node.stop()


def store_engine(pkg, url, host_blocks, backend="auto"):
    c, _, _ = PKGS[pkg]
    cfg = tiny_config(c, num_host_blocks=host_blocks, kv_store_url=url)
    cfg.cache.num_blocks = 16
    cfg.cache.block_backend = backend
    return engine(pkg, cfg)


def churn(eng, sp_cls):
    rng = np.random.default_rng(1)
    for _ in range(3):  # the prefix cascades device -> host -> store
        generate(eng, sp_cls, [int(x) for x in rng.integers(30, 90, 40)])


@pytest.mark.parametrize("a,b", [("jax", "jax"), ("port", "port"), ("jax", "port"),
                                 ("port", "jax")])
def test_cross_engine_prefix_reuse_via_store(a, b):
    """Engine A's computed prefix reaches engine B through a store (the
    port's app): the same greedy tokens, with B recording store fetches,
    within a package and across the two (the prefix hashes and the f16
    host arrays are the same on both sides). Across the packages the JAX
    engine runs its Python block manager: its native one (the default where
    its library builds) chains other hashes."""
    node = StoreNode("port", max_blocks=256)
    backend = "python" if a != b else "auto"
    try:
        prompt = list(range(1, 30))
        eng_a = store_engine(a, node.url, 1, backend)
        out_a = generate(eng_a, PKGS[a][2], prompt)
        churn(eng_a, PKGS[a][2])
        assert eng_a.block_manager.hierarchy.store_puts > 0
        eng_b = store_engine(b, node.url, 4, backend)
        out_b = generate(eng_b, PKGS[b][2], prompt)
        assert out_b == out_a
        assert eng_b.block_manager.hierarchy.store_fetches > 0
        assert eng_b.block_manager.num_used_blocks == 0
    finally:
        node.stop()
