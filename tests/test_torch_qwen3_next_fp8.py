"""The hybrid family (qwen3-next) quantized: an fp8 (e4m3) KV cache at
head_dim 256 and int8 / fp8 weights, the port against the JAX package on
the CPU, from numpy seeds.

- the plain versions of K1 and K3 at head_dim 256 on an e4m3 cache (Hq 4 /
  Hkv 2, block_size 16), bf16 and f32 queries, against the Pallas kernels
  in interpret mode: within ``1e-5 + 2^-7 (|ref| + sum_j p_j |v_j|)`` on
  random inputs (both round P to bf16 against the same running maximum,
  where an ulp of a score can still flip a rounding; PERF.md section 2),
  within ``1e-5 + 2^-7 |ref|`` (bf16 q) or 1e-5 (f32 q) on grid inputs;
  K1's written rows byte-equal;
- the plain K2 / K4 at head_dim 256 into an e4m3 cache byte-equal to the
  Pallas writers, JAX's NaN bytes and RMW rows across a page included;
- the launch plans at head_dim 256 on an e4m3 cache (pure Python; the
  head_dim rule's cases are in ``test_torch_qwen3_next.py``), and fake
  CUDA tensors that reach the build and never the plain version (an int8
  cache at 256 raises first);
- JAX's int8- and fp8-quantized hybrid trees carried by ``weights.py``
  byte for byte;
- a tiny qwen3-next with fp8 weights and an fp8 KV cache at head_dim 256:
  greedy tokens equal to the JAX engine's, its attention and cache writers
  run as Pallas kernels in interpret mode (``_use_pallas`` and the
  kernels' ``interpret`` argument patched in this process).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xllm_tpu.config as jcfg
import xllm_tpu.ops.attention as jattention
import xllm_tpu.ops.pallas.decode_attention as jdecode
import xllm_tpu.ops.pallas.kv_write as jkv_write
import xllm_tpu.ops.pallas.prefill_attention as jprefill
import xllm_tpu_torch.config as tcfg
from test_torch_mla import _fake_cuda
from test_torch_quant import _bytes, _owned, _t, _tables, _torch_like
from xllm_tpu.engine import LLMEngine as JEngine
from xllm_tpu.framework.sampling_params import SamplingParams as JSP
from xllm_tpu.runtime.model_runner import ModelRunner as JRunner
from xllm_tpu_torch.engine import LLMEngine as TEngine
from xllm_tpu_torch.framework.sampling_params import SamplingParams as TSP
from xllm_tpu_torch.models.registry import create_model as tcreate
from xllm_tpu_torch.ops.cuda import _build
from xllm_tpu_torch.ops.cuda import decode_attention as tdecode
from xllm_tpu_torch.ops.cuda import kv_write as tkv
from xllm_tpu_torch.ops.cuda import prefill_attention as tprefill
from xllm_tpu_torch.runtime.model_runner import ModelRunner as TRunner
from xllm_tpu_torch.weights import load_param_tree, random_param_tree
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platforms", "cpu")

F8 = jnp.float8_e4m3fn
E4M3 = torch.float8_e4m3fn
L, D, HQ, HKV, BS = 2, 256, 4, 2, 16  # BS: test_torch_quant's, which _tables and _owned page by
ATOL, RTOL = 1e-5, 2.0 ** -7  # PERF.md section 2
# D^-0.5, a power of two: exact on the grid, and one static argument for the
# random and grid cases, so that they share the Pallas kernels' compiles
SCALE = D ** -0.5


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _cache(rng, shape, grid: bool):
    """An e4m3 cache: random N(0, 4) values, or integers in [-8, 8] (grid)
    -> (JAX array, the same bytes in torch)."""
    x = rng.integers(-8, 9, shape) if grid else rng.standard_normal(shape) * 2.0
    j = jnp.asarray(x, jnp.float32).astype(F8)
    return j, _t(np.asarray(j))


def _query(rng, shape, q_dtype, grid: bool):
    """q (or new K rows): N(0, 1), or multiples of 2^-4 in [-1.5, 1.5]
    (grid: every score exact in f32), in ``q_dtype``."""
    x = rng.integers(-24, 25, shape) * 0.0625 if grid else rng.standard_normal(shape)
    return jnp.asarray(x, jnp.float32).astype(getattr(jnp, q_dtype))


def _within(got, want, pv, rtol, grid: bool):
    """|got - want| <= atol + rtol (|want| + pv) on random inputs, atol +
    rtol |want| on grid inputs (rtol 2^-7 for bf16 q, 1e-5 for f32 q on
    the grid, where both sides round every P alike)."""
    lim = ATOL + rtol * (np.abs(want) + (0.0 if grid else pv))
    excess = np.abs(got - want) - lim
    assert (excess <= 0).all(), (np.abs(got - want).max(), excess.max())


def _pv(q, k, v, mask, scale):
    """sum_j p_j |v_j| with an f64 softmax: q [..., G, D] against k / v
    [..., S, D] under mask [..., G, S]."""
    sc = np.einsum("...gd,...sd->...gs", q, k) * scale
    sc = np.where(mask, sc, -np.inf)
    p = np.nan_to_num(np.exp(sc - sc.max(-1, keepdims=True)))
    p = np.nan_to_num(p / p.sum(-1, keepdims=True))
    return np.einsum("...gs,...sd->...gd", p, np.abs(v))


# ---------------------------------------------------------------------------
# K1, K3, K2, K4 at head_dim 256 on an e4m3 cache: plain vs Pallas
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grid", [False, True], ids=["random", "grid"])
@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
def test_fp8_decode_plain_matches_v9_at_head_dim_256(q_dtype, grid):
    """K1: a first token, a token that opens a page, one at the end of four
    pages (a whole rounding tile of v9), a padded row; the new rows cast to
    e4m3 with JAX's bytes."""
    rng = np.random.default_rng(31 + grid)
    lens = [1, 17, 64, 0, 33]
    b, nbmax = len(lens), 4
    bt = _tables(lens, nbmax)
    nb = 1 + int(bt.max()) + 2
    kc, kt = _cache(rng, (L, nb, HKV, BS, D), grid)
    vc, vt = _cache(rng, (L, nb, HKV, BS, D), False)
    q = _query(rng, (b, HQ, D), q_dtype, grid)
    kn = _query(rng, (b, HKV, D), q_dtype, grid)
    vn = jnp.asarray(rng.standard_normal((b, HKV, D)) * 2.0, jnp.float32).astype(
        getattr(jnp, q_dtype))
    sl = np.asarray(lens, np.int32)
    sm = np.asarray([bt[i, (n - 1) // BS] * BS + (n - 1) % BS if n else 0
                     for i, n in enumerate(lens)], np.int32)
    scale = SCALE
    out_j, k_j, v_j = jdecode.paged_decode_attention_write_v9_tpu(
        q, kn, vn, kc, vc, jnp.int32(1), jnp.asarray(sm), jnp.asarray(bt), jnp.asarray(sl),
        scale, interpret=True)
    td = getattr(torch, q_dtype)
    kk, vk = kt.clone(), vt.clone()
    tq = _torch_like(q, td)
    got = tdecode.paged_decode_attention_write_plain(
        tq, _torch_like(kn, td), _torch_like(vn, td), kk, vk, 1, _t(sm), _t(bt), _t(sl),
        scale).float().numpy()
    for mine, theirs in ((kk, k_j), (vk, v_j)):  # the written rows: JAX's bytes
        gb, wb = _bytes(mine), _bytes(theirs)
        for blk, off in _owned(bt, lens):
            np.testing.assert_array_equal(gb[:, blk, :, off], wb[:, blk, :, off])
    kf = np.asarray(kk.float())[1][bt].transpose(0, 2, 1, 3, 4).reshape(b, HKV, -1, D)
    vf = np.asarray(vk.float())[1][bt].transpose(0, 2, 1, 3, 4).reshape(b, HKV, -1, D)
    mask = np.arange(kf.shape[2])[None, None, None] < sl[:, None, None, None]
    pv = _pv(np.asarray(tq.float()).reshape(b, HKV, HQ // HKV, D), kf, vf, mask,
             scale).reshape(b, HQ, D)
    live = [i for i, n in enumerate(lens) if n]
    rtol = RTOL if q_dtype == "bfloat16" or not grid else 1e-5
    _within(got[live], np.asarray(out_j.astype(jnp.float32))[live], pv[live], rtol, grid)
    assert not got[[3]].any()  # the padded row: zeros


@pytest.mark.parametrize("grid", [False, True], ids=["random", "grid"])
@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
def test_fp8_prefill_plain_matches_pallas_at_head_dim_256(q_dtype, grid):
    """K3: a fresh chunk, one resuming on its third page, a short one, a
    padded row."""
    rng = np.random.default_rng(41 + grid)
    s, specs = 16, [(0, 16), (32, 45), (0, 9), (0, 0)]  # (q_offset, kv_len)
    p = len(specs)
    bt = _tables([kl for _, kl in specs], 3)
    nb = 1 + int(bt.max()) + 2
    kc, kt = _cache(rng, (L, nb, HKV, BS, D), grid)
    vc, vt = _cache(rng, (L, nb, HKV, BS, D), False)
    q = _query(rng, (p, s, HQ, D), q_dtype, grid)
    qo = np.asarray([a for a, _ in specs], np.int32)
    kvl = np.asarray([kl for _, kl in specs], np.int32)
    scale = SCALE
    want = np.asarray(jprefill.paged_attention_prefill_batched_tpu(
        q, kc, vc, jnp.int32(1), jnp.asarray(bt), jnp.asarray(qo), jnp.asarray(kvl), scale,
        interpret=True).astype(jnp.float32))
    tq = _torch_like(q, getattr(torch, q_dtype))
    got = tprefill.paged_attention_prefill_batched_plain(
        tq, kt, vt, 1, _t(bt), _t(qo), _t(kvl), scale).float().numpy()
    kf = np.asarray(kt.float())[1][bt].transpose(0, 2, 1, 3, 4).reshape(p, HKV, -1, D)
    vf = np.asarray(vt.float())[1][bt].transpose(0, 2, 1, 3, 4).reshape(p, HKV, -1, D)
    qf = np.asarray(tq.float()).reshape(p, s, HKV, HQ // HKV, D).transpose(0, 2, 1, 3, 4)
    qpos = qo[:, None] + np.arange(s)[None]
    idx = np.arange(kf.shape[2])
    mask = (idx[None, None] <= qpos[:, :, None]) & (idx[None, None] < kvl[:, None, None])
    pv = np.stack([_pv(qf[:, :, :, g], kf, vf, mask[:, None], scale)
                   for g in range(HQ // HKV)], 3).transpose(0, 2, 1, 3, 4).reshape(p, s, HQ, D)
    rtol = RTOL if q_dtype == "bfloat16" or not grid else 1e-5
    for i, (a, kl) in enumerate(specs):
        n = max(min(s, kl - a), 0)
        if n:  # real rows only: the TPU kernel attends padding too
            _within(got[i, :n], want[i, :n], pv[i, :n], rtol, grid)
        assert not got[i, n:].any()


@pytest.mark.parametrize("src", ["bfloat16", "float32"])
@pytest.mark.parametrize("writer", ["full_page", "rmw"])
def test_fp8_writers_match_pallas_at_head_dim_256(writer, src):
    """K2 (head-major, page-aligned chunks) and K4 (token-major, from
    mid-page, one chunk across a page boundary) cast bf16 / f32 rows into an
    e4m3 cache: the bytes of the TPU writers fed rows cast the JAX way,
    JAX's NaN bytes above 464 included."""
    rng = np.random.default_rng(51)
    if writer == "full_page":
        s, specs = 32, [(0, 32), (16, 20), (0, 0)]
        shape = lambda p: (p, HKV, s, D)  # noqa: E731 (head-major)
        jfn, tfn = jkv_write.kv_write_prefill_batched_tpu, tkv.kv_write_prefill_batched
    else:
        s, specs = 6, [(13, 6), (3, 4), (0, 0)]  # 13..18 spans pages 0 and 1
        shape = lambda p: (p, s, HKV, D)  # noqa: E731 (token-major)
        jfn, tfn = jkv_write.kv_write_rmw_batched_tpu, tkv.kv_write_rmw_batched
    p = len(specs)
    lens = [a + n for a, n in specs]
    bt = _tables(lens, 3)
    nb = 1 + int(bt.max()) + 2
    kc, kt = _cache(rng, (L, nb, HKV, BS, D), False)
    vc, vt = _cache(rng, (L, nb, HKV, BS, D), False)
    kn, vn = ((rng.standard_normal(shape(p)) * 60).astype(np.float32) for _ in range(2))
    kn.reshape(-1)[:4] = [1000.0, -600.0, 465.0, 448.0]
    kn, vn = (np.asarray(jnp.asarray(x).astype(getattr(jnp, src)).astype(jnp.float32))
              for x in (kn, vn))
    qo = np.asarray([a for a, _ in specs], np.int32)
    nt = np.asarray([n for _, n in specs], np.int32)
    k_j, v_j = jfn(jnp.asarray(kn).astype(F8), jnp.asarray(vn).astype(F8), kc, vc,
                   jnp.int32(1), jnp.asarray(bt), jnp.asarray(qo), jnp.asarray(nt),
                   interpret=True)
    kk, vk = kt.clone(), vt.clone()
    td = getattr(torch, src)
    tfn(_t(kn).to(td), _t(vn).to(td), kk, vk, 1, _t(bt), _t(qo), _t(nt))
    for mine, theirs in ((kk, k_j), (vk, v_j)):
        gb, wb = _bytes(mine), _bytes(theirs)
        for blk, off in _owned(bt, lens):
            np.testing.assert_array_equal(gb[:, blk, :, off], wb[:, blk, :, off])
        written = {(blk, off) for blk, off in _owned(bt, lens)}
        for blk in range(nb):  # nothing else changed
            for off in range(BS):
                if (blk, off) not in written:
                    np.testing.assert_array_equal(gb[1, blk, :, off],
                                                  _bytes(kt if mine is kk else vt)[1, blk, :, off])
    assert 0x7F in _bytes(kk)[1, bt[0, 0], 0, 0 if writer == "full_page" else 13]


# ---------------------------------------------------------------------------
# the plans, no fallback (pure Python)
# ---------------------------------------------------------------------------
def test_head_dim_256_plans_on_e4m3():
    # K1: an e4m3 ring at head_dim 256 is two 16 KB stages; a block's ring
    # and q fill under half an SM, so the cluster may take 16 (its
    # registers let two or three blocks share an SM)
    assert tdecode.ring_stages(256, 1) == 2
    for heads in (1, 2, 8, 32):
        f8 = tdecode.plan(64, 64, 8, 256, E4M3, heads=heads)
        bf = tdecode.plan(64, 64, 8, 256, torch.bfloat16, heads=heads)
        assert f8.smem < bf.smem and 2 * f8.smem <= 233472
        assert f8.cluster == bf.cluster and f8.chunk == bf.chunk and f8.gran == bf.gran
    assert tdecode.plan(64, 64, 8, 256, E4M3, heads=1).cluster == 16
    # K3: bf16 q on an e4m3 cache takes the tensor cores at 256, f32 q the
    # CUDA cores; 64-key tiles (pages of 128 take the first pass)
    assert tprefill.tensor_cores(torch.bfloat16, E4M3, 256)
    assert not tprefill.tensor_cores(torch.float32, E4M3, 256)
    assert not tprefill.tensor_cores(torch.bfloat16, torch.int8, 256)
    assert tprefill.key_tile(128, 256) == tprefill.key_tile(64, 256) == 64
    # the split plan reads shapes only: the same on any cache dtype
    assert tprefill.split_plan(1, 2048, 16, 2, 4096, 64, 256) == (4096, 1)
    for bs in (16, 64, 128):
        chunk, nsplit = tprefill.split_plan(1, 64, 16, 2, 4096, bs, 256)
        assert nsplit > 1 and chunk % max(64, bs) == 0 and chunk * nsplit >= 4096


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["K1", "K3", "K2", "K4"])
def test_fp8_head_dim_256_on_cuda_tensors_reaches_the_build(kernel, q_dtype, monkeypatch):
    """On fake CUDA tensors at head_dim 256 with an e4m3 cache, each wrapper
    passes its checks and reaches the kernel build (which fails here): no
    plain version runs, no launch is counted. An int8 cache raises first."""
    def failed_build(stem):
        raise RuntimeError(f"CUDA kernel build failed: csrc/{stem}.cu")

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(_build, "load", failed_build)
    for mod in (tkv, tprefill, tdecode):
        monkeypatch.setattr(mod, "_lib", None)
    monkeypatch.setattr(tkv, "kv_write_rows_plain", no_plain)
    monkeypatch.setattr(tprefill, "paged_attention_prefill_batched_plain", no_plain)
    monkeypatch.setattr(tdecode, "_split_plain", no_plain)
    f = _fake_cuda
    bt = f(torch.ones(1, 2, dtype=torch.int32))
    one = f(torch.tensor([14], dtype=torch.int32))

    def call(cache):
        c = f(torch.zeros(1, 4, 2, 16, 256, dtype=cache))
        if kernel == "K1":
            q = f(torch.zeros(1, 4, 256, dtype=q_dtype))
            kv = f(torch.zeros(1, 2, 256, dtype=q_dtype))
            tdecode.paged_decode_attention_write(q, kv, kv, c, c, 0, one, bt,
                                                 f(torch.tensor([15], dtype=torch.int32)), 0.1)
        elif kernel == "K3":
            q = f(torch.zeros(1, 4, 4, 256, dtype=q_dtype))
            tprefill.paged_attention_prefill_batched(
                q, c, c, 0, bt, one, f(torch.tensor([18], dtype=torch.int32)), 0.1)
        elif kernel == "K2":
            rows = f(torch.zeros(1, 2, 32, 256, dtype=q_dtype))
            tkv.kv_write_prefill_batched(rows, rows, c, c, 0, bt,
                                         f(torch.tensor([0], dtype=torch.int32)),
                                         f(torch.tensor([20], dtype=torch.int32)))
        else:
            rows = f(torch.zeros(1, 4, 2, 256, dtype=q_dtype))
            tkv.kv_write_rmw_batched(rows, rows, c, c, 0, bt, one,
                                     f(torch.tensor([4], dtype=torch.int32)))

    before = dict(_build.launch_counts)
    with pytest.raises(RuntimeError, match="build failed"):
        call(E4M3)
    with pytest.raises(NotImplementedError, match="head_dim"):
        call(torch.int8)
    assert _build.launch_counts == before


# ---------------------------------------------------------------------------
# quantized hybrid trees and the fp8 engine against JAX
# ---------------------------------------------------------------------------
MODEL = dict(
    model_type="qwen3_next", dtype="float32", vocab_size=128, hidden_size=32,
    intermediate_size=64, num_hidden_layers=4, num_attention_heads=4,
    num_key_value_heads=2, head_dim=16, partial_rotary_factor=0.25,
    max_position_embeddings=128, full_attention_interval=2, linear_conv_kernel_dim=3,
    linear_key_head_dim=8, linear_num_key_heads=2, linear_value_head_dim=8,
    linear_num_value_heads=4, num_experts=4, num_experts_per_tok=2,
    moe_intermediate_size=16, shared_expert_intermediate_size=32, norm_topk_prob=True,
)


def _cfg(c, method="", kv="auto", **model):
    cfg = c.EngineConfig(
        model=c.ModelConfig(**dict(MODEL, **model)),
        cache=c.CacheConfig(num_blocks=24, block_size=BS, kv_cache_dtype=kv),
        scheduler=c.SchedulerConfig(
            max_seqs_per_batch=2, max_tokens_per_chunk_for_prefill=32, max_model_len=96,
            decode_batch_buckets=[2], prefill_token_buckets=[32]),
    )
    cfg.quant.method = method
    return cfg


@pytest.mark.parametrize("method", ["int8", "fp8_e4m3"])
def test_quantized_hybrid_tree_carries_through_weights(method):
    """The JAX runner's quantized hybrid tree (``*_proj_w`` stacks, under
    fp8 also the routed expert stacks, each with its ``*_scale``) loads
    into a port model built with the same method byte for byte, and equals
    the port runner's own quantization of the float tree."""
    tree = random_param_tree(_cfg(tcfg).model, seed=9)
    jr = JRunner(_cfg(jcfg, method))
    jr.load_model(params=jax.tree.map(jnp.asarray, tree))
    jtree = jax.tree.map(np.asarray, jr.params)
    quantized = {n for n in jtree["groups"] if n + "_scale" in jtree["groups"]}
    want = {"shared_gate_proj_w", "shared_up_proj_w", "shared_down_proj_w"}
    if method == "fp8_e4m3":
        want |= {"experts_gate_up", "experts_down"}
    assert quantized == want
    model = tcreate(_cfg(tcfg, method).model, device="cpu", quant=method)
    load_param_tree(model, jtree)
    own = TRunner(_cfg(tcfg, method), device="cpu")
    own.load_model(params=tree)
    for name, stack in jtree["groups"].items():
        got = getattr(model.groups, name).detach()
        np.testing.assert_array_equal(_bytes(got), _bytes(stack))
        np.testing.assert_array_equal(_bytes(getattr(own.model.groups, name).detach()),
                                      _bytes(stack))
    assert model.groups.experts_gate_up.dtype == (
        E4M3 if method == "fp8_e4m3" else torch.float32)


def _serve(eng, sp_cls, prompts, n):
    ids = [eng.add_request(prompt_token_ids=p, sampling_params=sp_cls(
        temperature=0.0, max_tokens=n, ignore_eos=True)).request_id for p in prompts]
    outs = {o.request_id: list(o.outputs[0].token_ids) for o in eng.generate_all()}
    assert eng.block_manager.num_used_blocks == 0
    return [outs[i] for i in ids]


def test_fp8_hybrid_engine_matches_jax_kernels(monkeypatch):
    """fp8 weights + an fp8 KV cache at head_dim 256: the port's engine (the
    plain K1 / K3 / K2 / K4 on the e4m3 cache, f32 queries) gives the
    greedy tokens of the JAX engine run through its Pallas kernels in
    interpret mode; a prompt past two pages takes K2 and K3 over pages
    written earlier, its decode steps K1 across a page boundary."""
    monkeypatch.setattr(jattention, "_use_pallas", lambda *a, **k: True)
    traced = {}
    for mod, name in ((jdecode, "paged_decode_attention_write_v9_tpu"),
                      (jkv_write, "kv_write_prefill_batched_tpu"),
                      (jkv_write, "kv_write_rmw_batched_tpu"),
                      (jprefill, "paged_attention_prefill_batched_tpu")):
        def interpreted(*a, _fn=getattr(mod, name), _name=name, **k):
            traced[_name] = traced.get(_name, 0) + 1
            return _fn(*a, interpret=True, **k)

        monkeypatch.setattr(mod, name, interpreted)
    kw = dict(head_dim=D, hidden_size=64)
    tree = random_param_tree(_cfg(tcfg, **kw).model, seed=13)
    prompts = [np.random.default_rng(3).integers(1, 127, n).tolist() for n in (40, 9)]
    jr = JRunner(_cfg(jcfg, "fp8_e4m3", "fp8_e4m3", **kw))
    jr.load_model(params=jax.tree.map(jnp.asarray, tree))
    want = _serve(JEngine(_cfg(jcfg, "fp8_e4m3", "fp8_e4m3", **kw), runner=jr), JSP,
                  prompts, 6)
    cfg = _cfg(tcfg, "fp8_e4m3", "fp8_e4m3", **kw)
    runner = TRunner(cfg, device="cpu")
    runner.load_model(params=tree)
    assert runner.k_cache is None or runner.k_cache.dtype == E4M3
    eng = TEngine(cfg, runner=runner)
    assert runner.k_cache.dtype == E4M3 and runner.model.groups.experts_down.dtype == E4M3
    assert _serve(eng, TSP, prompts, 6) == want
    assert {"paged_decode_attention_write_v9_tpu", "paged_attention_prefill_batched_tpu",
            "kv_write_prefill_batched_tpu"} <= set(traced)
