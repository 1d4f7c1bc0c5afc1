"""PD disaggregation in ``xllm_tpu_torch`` on the CPU vs ``xllm_tpu``.

Every case of ``tests/test_disagg_pd.py`` runs on both packages, on the
same seeded tiny f32 models (weights carried by
``weights.random_param_tree``): greedy tokens identical, every KV block
given back. Besides:

- the wire both ways: the port's ``to_bytes`` read by JAX's
  ``from_bytes`` and JAX's read by the port's, in f32, bf16 and e4m3, the
  bytes themselves equal; handoffs made by one package's prefill node
  decoded by the other's decode node;
- ``_rechunk_blocks`` equal to JAX's on the 5-d and 6-d page shapes;
- chunk-overlapped extraction over a prompt of several chunks: pages are
  pushed before the first token lands, and the handoff equals the
  blocking path's;
- the decode node's gates (layout, page size, capacity) and the decode
  app's body limit on the port's transport.

The JAX engines are shared by a module-scoped fixture.
"""

import asyncio
import dataclasses
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import xllm_tpu.config as jcfg
import xllm_tpu.disagg.ooc as jooc
import xllm_tpu.disagg.pd as jpd
import xllm_tpu_torch.config as tcfg
import xllm_tpu_torch.disagg.ooc as tooc
import xllm_tpu_torch.disagg.pd as tpd
from test_torch_kv_tiers import mla_config, tiny_config
from xllm_tpu.engine import LLMEngine as JEngine
from xllm_tpu.framework.sampling_params import SamplingParams as JSP
from xllm_tpu.runtime.model_runner import ModelRunner as JRunner
from xllm_tpu.scheduler.profile import ProfileManager as JProfile
from xllm_tpu_torch.disagg import service as tservice
from xllm_tpu_torch.engine import LLMEngine as TEngine
from xllm_tpu_torch.framework.sampling_params import SamplingParams as TSP
from xllm_tpu_torch.runtime.model_runner import ModelRunner as TRunner
from xllm_tpu_torch.scheduler.profile import ProfileManager as TProfile
from xllm_tpu_torch.server import http as tweb
from xllm_tpu_torch.weights import random_param_tree
from torch_threads import one_torch_thread  # noqa: F401

J = SimpleNamespace(name="jax", cfg=jcfg, pd=jpd, ooc=jooc, SP=JSP, Profile=JProfile)
T = SimpleNamespace(name="port", cfg=tcfg, pd=tpd, ooc=tooc, SP=TSP, Profile=TProfile)
TREES = {make: random_param_tree(make(tcfg).model, seed=3)
         for make in (tiny_config, mla_config)}


def big_page_config(c):
    """A prefill node on pages of 8 (2x the decode node's)."""
    cfg = tiny_config(c)
    cfg.cache.block_size = 8
    cfg.scheduler.prefill_token_buckets = [8, 16]
    return cfg


def build(pkg, make=tiny_config, cfg=None):
    """An engine of ``pkg`` (the port's on the CPU) on ``make``'s tree."""
    cfg = cfg or make(pkg.cfg)
    tree = TREES[mla_config if make is mla_config else tiny_config]
    if pkg is J:
        runner = JRunner(cfg)
        runner.load_model(params=jax.tree.map(jnp.asarray, tree))
        return JEngine(cfg, runner=runner)
    runner = TRunner(cfg, device="cpu")
    runner.load_model(params=tree)
    return TEngine(cfg, runner=runner)


class Engines:
    """A package's engines: the port's built anew for each use, JAX's built
    once (``jax_engines``) and drained between uses."""

    def __init__(self, pkg, shared=None):
        self.pkg, self.shared = pkg, shared

    def __call__(self, role: str):
        if self.shared is None:
            make = mla_config if role.startswith("mla") else tiny_config
            return build(self.pkg, make, big_page_config(tcfg) if role == "big" else None)
        eng = self.shared[role]
        assert not eng.has_unfinished() and eng.block_manager.num_used_blocks == 0
        return eng


@pytest.fixture(scope="module")
def jax_engines():
    """JAX's engines, by role: ``dense`` serves single-engine runs and
    decodes; ``prefill`` and ``big`` (pages of 8) prefill; ``mla`` and
    ``mla_prefill`` likewise for the latent cache."""
    with jax.default_matmul_precision("highest"):
        yield {
            "dense": build(J), "prefill": build(J),
            "big": build(J, cfg=big_page_config(jcfg)),
            "mla": build(J, mla_config), "mla_prefill": build(J, mla_config),
        }


@pytest.fixture
def both(jax_engines):
    """(JAX's engines, the port's)."""
    with jax.default_matmul_precision("highest"):
        yield Engines(J, jax_engines), Engines(T)


def greedy(pkg, max_tokens):
    return pkg.SP(temperature=0.0, max_tokens=max_tokens, ignore_eos=True)


def single(pkg, eng, prompt, max_tokens):
    eng.add_request(prompt_token_ids=list(prompt), sampling_params=greedy(pkg, max_tokens))
    return eng.generate_all()[0].outputs[0].token_ids


def prompt_of(seed, n, hi=90):
    return [int(x) for x in np.random.default_rng(seed).integers(1, hi, n)]


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------
def test_handoff_wire_roundtrip():
    h = tpd.PrefillHandoff(
        request_id="r1", prompt_token_ids=[1, 2, 3], first_token=42,
        sampling_params=TSP(temperature=0.5, max_tokens=9),
        k_blocks=torch.arange(24, dtype=torch.float32).reshape(1, 2, 1, 4, 3),
        v_blocks=torch.zeros((1, 2, 1, 4, 3)),
    )
    h2 = tpd.PrefillHandoff.from_bytes(h.to_bytes())
    assert (h2.request_id, h2.prompt_token_ids, h2.first_token) == ("r1", [1, 2, 3], 42)
    assert h2.sampling_params == h.sampling_params
    assert torch.equal(h2.k_blocks, h.k_blocks) and h2.kv_layout == "split"


WIRE_DTYPES = {"float32": (torch.float32, np.float32),
               "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16),
               "float8_e4m3fn": (torch.float8_e4m3fn, ml_dtypes.float8_e4m3fn)}


def same_bits(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A torch tensor of ``dtype`` holding ``a``'s bits."""
    signed = {1: np.int8, 2: np.int16, 4: np.int32}[a.dtype.itemsize]
    return torch.from_numpy(a.view(signed)).view(dtype)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("dtype", list(WIRE_DTYPES))
def test_handoff_wire_interop(dtype, direction):
    """The same handoff written by either package: the bytes are equal, and
    the other package reads back the arrays' bits, the dtype and every
    sampling parameter."""
    t_dt, np_dt = WIRE_DTYPES[dtype]
    rng = np.random.default_rng(1)
    vals = (rng.standard_normal((3, 2, 2, 4, 8)) * 8).astype(np.float32)
    vals.reshape(-1)[:3] = (np.nan, np.inf, -0.0) if dtype != "float8_e4m3fn" else (
        np.nan, 448.0, -0.0)
    k_np = vals.astype(np_dt)
    v_np = (vals * 0.5).astype(np_dt)
    kw = dict(request_id="x", prompt_token_ids=[5, 6, 7, 8], first_token=3,
              kv_layout="interleaved")
    sp = dict(temperature=0.7, top_p=0.9, top_k=5, max_tokens=11, stop=["a"],
              stop_token_ids=[4], seed=9, logprobs=2, repetition_penalty=1.1)
    th = tpd.PrefillHandoff(sampling_params=TSP(**sp), **kw,
                            k_blocks=same_bits(k_np, t_dt), v_blocks=same_bits(v_np, t_dt))
    jh = jpd.PrefillHandoff(sampling_params=JSP(**sp), **kw, k_blocks=k_np, v_blocks=v_np)
    raw = th.to_bytes()
    assert raw == jh.to_bytes()
    if direction == "port_to_jax":
        got = jpd.PrefillHandoff.from_bytes(raw)
        assert got.k_blocks.dtype == np.dtype(np_dt)
        k_bits, v_bits = got.k_blocks.view(np.uint8), got.v_blocks.view(np.uint8)
        assert vars(got.sampling_params) == vars(JSP(**sp))
    else:
        got = tpd.PrefillHandoff.from_bytes(jh.to_bytes())
        assert got.k_blocks.dtype == t_dt
        k_bits = got.k_blocks.view(torch.uint8).numpy()
        v_bits = got.v_blocks.view(torch.uint8).numpy()
        assert got.sampling_params == TSP(**sp)
    np.testing.assert_array_equal(k_bits, k_np.view(np.uint8))
    np.testing.assert_array_equal(v_bits, v_np.view(np.uint8))
    assert (got.request_id, got.prompt_token_ids, got.first_token, got.kv_layout) == (
        "x", [5, 6, 7, 8], 3, "interleaved")


@pytest.mark.parametrize("shape", [(2, 3, 2, 8, 4), (1, 2, 2, 2, 8, 4), (3, 2, 1, 16, 8)],
                         ids=["split", "interleaved", "latent-x4"])
def test_rechunk_blocks_layouts(shape):
    """The port's re-paging equals JAX's on the split (5-d) and interleaved
    (6-d) page shapes."""
    blocks = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    for dbs in (4, shape[-2]):
        want = jpd.DecodeInstance._rechunk_blocks(blocks, dbs)
        got = tpd.DecodeInstance._rechunk_blocks(torch.from_numpy(blocks), dbs)
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="multiple"):
        tpd.DecodeInstance._rechunk_blocks(torch.from_numpy(blocks), 3)


# ---------------------------------------------------------------------------
# PD on each package
# ---------------------------------------------------------------------------
def pd_generate(pkg, eng, prompt, max_tokens, prefill="prefill", decode="dense"):
    orch = pkg.pd.PDOrchestrator(pkg.pd.PrefillInstance(eng(prefill)),
                                 pkg.pd.DecodeInstance(eng(decode)))
    out = orch.generate(list(prompt), greedy(pkg, max_tokens)).outputs[0].token_ids
    assert orch.prefill.engine.block_manager.num_used_blocks == 0
    assert orch.decode.engine.block_manager.num_used_blocks == 0
    return out


def test_pd_matches_single_engine_greedy(both):
    """Prefill on one engine, decode on another == one engine, and the
    port's tokens equal JAX's."""
    prompt = prompt_of(0, 23)
    outs = {}
    for pkg, eng in zip((J, T), both):
        outs[pkg.name] = (single(pkg, eng("dense"), prompt, 12),
                          pd_generate(pkg, eng, prompt, 12))
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == outs["port"][1]


def test_pd_multiple_requests_interleaved(both):
    prompts = [prompt_of(10 + i, 11) for i in range(3)]
    outs = {}
    for pkg, eng in zip((J, T), both):
        orch = pkg.pd.PDOrchestrator(pkg.pd.PrefillInstance(eng("prefill")),
                                     pkg.pd.DecodeInstance(eng("dense")))
        outs[pkg.name] = [orch.generate(p, greedy(pkg, 6)).outputs[0].token_ids
                          for p in prompts]
        assert orch.decode.engine.block_manager.num_used_blocks == 0
    assert outs["port"] == outs["jax"]
    assert all(len(t) == 6 for t in outs["port"])


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_pd_across_packages(both, src, dst):
    """A handoff made by one package's prefill node and decoded by the
    other's decode node gives the single engine's tokens."""
    pkgs = {"jax": (J, both[0]), "port": (T, both[1])}
    prompt = prompt_of(20, 27)
    want = single(J, both[0]("dense"), prompt, 10)
    spkg, seng = pkgs[src]
    dpkg, deng = pkgs[dst]
    h = spkg.pd.PrefillInstance(seng("prefill")).prefill(prompt, greedy(spkg, 10))
    dec = dpkg.pd.DecodeInstance(deng("dense"))
    req = dec.accept(dpkg.pd.PrefillHandoff.from_bytes(h.to_bytes()))
    while dec.engine.has_unfinished():
        dec.engine.step()
    seq = req.sequences[0]
    assert seq.token_ids[seq.num_prompt_tokens:] == want
    assert dec.engine.block_manager.num_used_blocks == 0


def test_pd_cross_page_size_handoff(both):
    """A prefill node on pages of 8 hands off to a decode node on pages of
    4: the single engine's tokens (at 4), on both packages."""
    prompt = prompt_of(4, 23)
    outs = {}
    for pkg, eng in zip((J, T), both):
        outs[pkg.name] = pd_generate(pkg, eng, prompt, 12, prefill="big")
    assert outs["port"] == outs["jax"] == single(T, both[1]("dense"), prompt, 12)


def test_pd_mla_latent_cache(both):
    """MLA's dummy v slot rides extract -> wire -> inject: the single
    engine's tokens, equal to JAX's (DSA's indexer slot is not ported)."""
    prompt = prompt_of(4, 29, 250)
    outs = {}
    for pkg, eng in zip((J, T), both):
        outs[pkg.name] = (single(pkg, eng("mla"), prompt, 8),
                          pd_generate(pkg, eng, prompt, 8, "mla_prefill", "mla"))
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == outs["port"][1]


# ---------------------------------------------------------------------------
# the asynchronous prefill node
# ---------------------------------------------------------------------------
def drain(pre, limit=500):
    guard = 0
    while pre.busy:
        pre.pump()
        guard += 1
        assert guard < limit


def decode_all(pkg, eng, handoffs):
    dec = pkg.pd.DecodeInstance(eng)
    reqs = [dec.accept(pkg.pd.PrefillHandoff.from_bytes(h.to_bytes())) for h in handoffs]
    while eng.has_unfinished():
        eng.step()
    assert eng.block_manager.num_used_blocks == 0
    return [r.sequences[0].token_ids for r in reqs]


def test_async_prefill_concurrent_handoffs(both):
    """Three prompts in flight on one prefill engine, each handed off when
    its first token lands; the decode node finishes them all, with JAX's
    tokens."""
    outs = {}
    for pkg, eng in zip((J, T), both):
        p_eng = eng("prefill")
        pre = pkg.pd.AsyncPrefillInstance(p_eng)
        rng = np.random.default_rng(0)
        ready = {}
        rids = [pre.submit(rng.integers(1, 96, size=10 + 7 * i).tolist(), greedy(pkg, 6),
                           lambda h: ready.__setitem__(h.request_id, h),
                           request_id=f"apd-{i}") for i in range(3)]
        drain(pre)
        assert set(ready) == set(rids)
        assert p_eng.block_manager.num_used_blocks == 0
        outs[pkg.name] = decode_all(pkg, eng("dense"), [ready[r] for r in rids])
    assert outs["port"] == outs["jax"]


def test_async_prefill_chunk_overlapped_extraction(both):
    """A 50-token prompt prefills in 4 chunks of 16 (pages of 4): pages are
    pushed while later chunks compute, in several extractions, and the
    assembled handoff equals the blocking path's (and JAX's within f32
    rounding); the decode side continues identically."""
    prompt = np.random.default_rng(7).integers(1, 96, size=50).tolist()
    jeng, teng = both
    h_jax = J.pd.PrefillInstance(jeng("prefill")).prefill(prompt, greedy(J, 8),
                                                          request_id="x")
    h_sync = T.pd.PrefillInstance(teng("prefill")).prefill(prompt, greedy(T, 8),
                                                           request_id="x")
    p2 = teng("prefill")
    pre = T.pd.AsyncPrefillInstance(p2)
    calls, frontiers = [], []
    orig = p2.runner.extract_blocks_async

    def counting(block_ids):
        calls.append(list(block_ids))
        return orig(block_ids)

    p2.runner.extract_blocks_async = counting
    got = {}
    pre.submit(prompt, greedy(T, 8), lambda h: got.update(h=h), request_id="x")
    seq = pre._inflight["x"][0].sequences[0]
    saw_midprefill = False
    while pre.busy:
        pre.pump()
        frontiers.append(seq.num_computed_tokens)
        if pre._partial and "h" not in got:
            saw_midprefill = True
    assert saw_midprefill, "no extraction overlapped the prefill"
    assert len(calls) >= 3, calls  # pages of chunks 1-3, then the tail
    assert sorted(set(frontiers) - {0})[:3] == [16, 32, 48]  # 0: freed at the handoff
    h = got["h"]
    assert torch.equal(h.k_blocks, h_sync.k_blocks)
    assert torch.equal(h.v_blocks, h_sync.v_blocks)
    np.testing.assert_allclose(h.k_blocks.numpy(), h_jax.k_blocks, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h.v_blocks.numpy(), h_jax.v_blocks, atol=1e-5, rtol=1e-5)
    assert h.first_token == h_sync.first_token == h_jax.first_token
    assert p2.block_manager.num_used_blocks == 0
    toks = [decode_all(T, teng("dense"), [hh])[0] for hh in (h_sync, h)]
    assert toks[0] == toks[1] == decode_all(J, jeng("dense"), [h_jax])[0]


def test_async_prefill_matches_blocking_path(both):
    prompt = np.random.default_rng(3).integers(1, 96, size=13).tolist()
    outs = {}
    for pkg, eng in zip((J, T), both):
        h_sync = pkg.pd.PrefillInstance(eng("prefill")).prefill(prompt, greedy(pkg, 8),
                                                                 request_id="x")
        pre = pkg.pd.AsyncPrefillInstance(eng("prefill"))
        got = {}
        pre.submit(prompt, greedy(pkg, 8), lambda h: got.update(h=h), request_id="x")
        drain(pre)
        outs[pkg.name] = (decode_all(pkg, eng("dense"), [h_sync]),
                          decode_all(pkg, eng("dense"), [got["h"]]))
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == outs["port"][1]


# ---------------------------------------------------------------------------
# PD-OOC
# ---------------------------------------------------------------------------
def ooc_walk(pkg, eng):
    """tests/test_disagg_pd.py's online / offline colocation -> (prefill
    statuses, tokens by request id)."""
    rng = np.random.default_rng(5)
    pre = pkg.ooc.OOCPrefillNode(pkg.pd.AsyncPrefillInstance(eng("prefill")))
    dec = pkg.ooc.OOCDecodeNode(pkg.pd.DecodeInstance(eng("dense")), tpot_budget_s=10.0)
    online_ready = []
    for i in range(2):
        pre.submit_online([int(x) for x in rng.integers(1, 90, 17 + i)], greedy(pkg, 6),
                          online_ready.append, request_id=f"on-{i}")
    for i in range(3):
        pre.submit_offline([int(x) for x in rng.integers(1, 90, 11 + i)], greedy(pkg, 6),
                           request_id=f"off-{i}")
    statuses = []
    for _ in range(200):
        pre.pump()
        statuses.append(pre.last_status.value)
        if len(online_ready) == 2 and len(pre.offline_backlog) == 3:
            break
    assert len(online_ready) == 2 and len(pre.offline_backlog) == 3
    first_off = statuses.index("offline_prefill")
    assert "online_prefill" not in statuses[first_off:]
    reqs = [dec.accept(h, offline=False) for h in online_ready]
    eng_d = dec.decode.engine
    accept = dec.accept

    def tracked(h, offline=False):
        reqs.append(accept(h, offline))
        return reqs[-1]

    dec.accept = tracked
    for _ in range(400):
        dec.pump(pre)
        if not eng_d.has_unfinished() and not pre.offline_backlog:
            break
    while eng_d.has_unfinished():
        dec.pump(pre)
    assert dec.pulls == 3
    assert eng_d.block_manager.num_used_blocks == 0
    assert [r.offline for r in reqs] == [False, False, True, True, True]
    return statuses, {r.request_id: r.sequences[0].token_ids for r in reqs}


def test_pd_ooc_online_offline_colocation(both):
    """All-online steps first, then all-offline; the decode node pulls the
    offline backlog under TPOT slack; the same steps and tokens as JAX."""
    assert ooc_walk(T, both[1]) == ooc_walk(J, both[0])


def quota_walk(pkg, eng):
    """tests/test_disagg_pd.py's pull-quota walk -> the quotas and pulls
    seen along it."""
    prof = pkg.Profile(refit_every=1)
    for b in range(1, 20):  # a known linear model: tpot(batch) = (1 + batch) ms
        prof.observe_decode(b, (1 + b) * 1e-3)
    prof.refit_every = 10 ** 9
    seen = [prof.max_decode_batch_for_tpot(10e-3)]
    dec = pkg.ooc.OOCDecodeNode(pkg.pd.DecodeInstance(eng("dense")), tpot_budget_s=10e-3,
                                headroom=1.0, profile=prof, max_pull=100)
    seen.append(dec.pull_quota())
    rng = np.random.default_rng(9)
    pre = pkg.ooc.OOCPrefillNode(pkg.pd.AsyncPrefillInstance(eng("prefill")))
    ready = []
    for i in range(4):
        pre.submit_online([int(x) for x in rng.integers(1, 90, 9 + i)], greedy(pkg, 4),
                          ready.append, request_id=f"on-{i}")
    for _ in range(200):
        pre.pump()
        if len(ready) == 4:
            break
    for h in ready:
        dec.accept(h, offline=False)
    seen.append(dec.pull_quota())
    dec.tpot_budget_s = 2e-3
    seen += [dec.pull_quota(), dec.able_to_pull()]
    for i in range(3):
        pre.submit_offline([int(x) for x in rng.integers(1, 90, 7)], greedy(pkg, 4),
                           request_id=f"off-{i}")
    for _ in range(200):
        pre.pump()
        if len(pre.offline_backlog) == 3:
            break
    eng_d = dec.decode.engine
    while eng_d.has_unfinished():
        dec.pump(pre)
        assert dec.pulls == 0
    dec.tpot_budget_s = 10e-3
    for _ in range(400):
        dec.pump(pre)
        if not eng_d.has_unfinished() and not pre.offline_backlog:
            break
    seen.append(dec.pulls)
    assert eng_d.block_manager.num_used_blocks == 0
    return seen


def test_pd_ooc_perfmodel_pull_quota(both):
    """The offline pull quota solved against the fitted step-time model:
    9 admissible, 9 - 4 online, none under a tight budget, then the three
    offline requests, on both packages."""
    assert quota_walk(T, both[1]) == quota_walk(J, both[0]) == [9, 9, 5, 0, False, 3]


# ---------------------------------------------------------------------------
# the decode node's gates and the HTTP services
# ---------------------------------------------------------------------------
def test_decode_gates():
    """A layout mismatch, a page-size change on interleaved_rm and a full
    decode node are refused before any state changes."""
    h = tpd.PrefillInstance(build(T)).prefill(prompt_of(30, 9), greedy(T, 4))
    page8 = torch.zeros((1, 2, 2, 8, 16))
    dec = tpd.DecodeInstance(build(T, cfg=tiny_config(tcfg, kv_layout="interleaved_rm")))
    for bad, match in ((dataclasses.replace(h, kv_layout="interleaved"), "kv_layout"),
                       (dataclasses.replace(h, kv_layout="interleaved_rm", k_blocks=page8,
                                            v_blocks=page8), "canonical")):
        with pytest.raises(ValueError, match=match):
            dec.accept(bad)
    assert dec.engine.block_manager.num_used_blocks == 0
    cfg = tiny_config(tcfg)
    cfg.scheduler.max_seqs_per_batch = 1
    dec = tpd.DecodeInstance(build(T, cfg=cfg))
    dec.accept(tpd.PrefillHandoff.from_bytes(h.to_bytes()))
    used = dec.engine.block_manager.num_used_blocks
    with pytest.raises(RuntimeError, match="capacity"):
        dec.accept(tpd.PrefillHandoff.from_bytes(h.to_bytes()))
    assert dec.engine.block_manager.num_used_blocks == used


class Served:
    """Port apps on real ports, served by one loop in a thread."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.runners = []

    def start(self, app) -> str:
        async def go():
            runner = tweb.AppRunner(app)
            await runner.setup()
            site = tweb.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            self.runners.append(runner)
            return f"http://127.0.0.1:{site.port}"
        return asyncio.run_coroutine_threadsafe(go(), self.loop).result(timeout=10)

    def stop(self):
        for r in self.runners:
            asyncio.run_coroutine_threadsafe(r.cleanup(), self.loop).result(timeout=10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=5)


def post(url, body: bytes, ctype="application/json") -> tuple[int, bytes]:
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_pd_over_http(both):
    """The prefill front relays through the decode service, both on the
    port's transport: JAX's single-engine tokens."""
    import json
    prompt = prompt_of(2, 9)
    want = single(J, both[0]("dense"), prompt, 5)
    pre = tpd.PrefillInstance(build(T))
    dec = tpd.DecodeInstance(build(T))
    srv = Served()
    try:
        decode_url = srv.start(tservice.make_decode_app(dec))
        front = srv.start(tservice.make_prefill_app(pre, decode_url))
        status, raw = post(front + "/v1/completions", json.dumps(
            {"prompt": prompt, "max_tokens": 5, "temperature": 0, "ignore_eos": True}).encode())
        assert status == 200, raw
        data = json.loads(raw)
        assert data["choices"][0]["token_ids"] == want
        assert data["object"] == "text_completion"
        status, raw = post(front + "/v1/completions", b'{"prompt": "text"}')
        assert status == 400
    finally:
        srv.stop()
    assert dec.engine.block_manager.num_used_blocks == 0


def test_app_body_limit():
    """``Application(client_max_size=...)`` sets the limit per app: the
    decode app takes a 3 MiB handoff that an app at the default 1 MiB
    refuses with 413."""
    async def echo(request):
        return tweb.json_response({"n": len(await request.read())})

    small, big = tweb.Application(), tweb.Application(client_max_size=4 << 20)
    for app in (small, big):
        app.router.add_post("/echo", echo)
    assert tservice.make_decode_app(None).client_max_size == 1 << 30
    srv = Served()
    try:
        body = bytes(3 << 20)
        assert post(srv.start(small) + "/echo", body)[0] == 413
        status, raw = post(srv.start(big) + "/echo", body)
        assert status == 200 and raw == b'{"n": 3145728}'
    finally:
        srv.stop()
