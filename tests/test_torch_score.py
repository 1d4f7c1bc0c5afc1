"""Prompt scoring and embeddings: the port's single-chunk path vs the JAX
package's, on the CPU, from numpy seeds.

- the plain versions of K2b, K4b (KV writers), K11f, K11g (latent writers)
  against the Pallas kernels in interpret mode: byte-equal rows (f32, int8
  and fp8 caches; the TPU's full-page writers also fill the never-read tail
  of the last page, which is not compared);
- K3b, K3, K11e and K11b's plain versions against the Pallas kernels in
  interpret mode: equal valid rows. Bucket-padding rows differ by design:
  the TPU kernels' mask ``(kv <= row_pos) & (kv < kv_len)`` attends them to
  all of ``[0, kv_len)`` (as the oracles do), the port's kernels give zeros;
- ``DenseDecoderModel.prefill`` and ``MlaDecoderModel.prefill`` against the
  JAX models at ``num_logits`` 1, 3 and ``S_pad`` (where JAX's
  ``dynamic_slice`` clamps its start to 0);
- ``score_prompt`` / ``LLM.score`` and embed requests against the JAX
  engine on tiny f32 qwen3, qwen3-moe and deepseek_v2 models (chunks in
  both writer buckets), logprobs within 1e-4, embeddings within 1e-5 with
  unit norm; int8 KV against the JAX engine run through its single-chunk
  Pallas kernels in interpret mode;
- an embed request beside generate requests in one step, and
  ``AsyncLLMEngine`` with concurrent generate, embed and score calls, equal
  to the same requests run alone; CUDA tensors with a failed build raise
  instead of taking a plain version;
- on a quantized cache, K1's plain version rounds P against the running
  maximum of the TPU kernel's walk (tiles of 4 pages, opened at the new
  token), held against that walk written out step by step.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xllm_tpu.config as jcfg
import xllm_tpu.ops.attention as jattention
import xllm_tpu.ops.pallas.kv_write as jkv_write
import xllm_tpu.ops.pallas.prefill_attention as jprefill
import xllm_tpu_torch.config as tcfg
from test_torch_mla import _fake_cuda
from xllm_tpu.engine import LLMEngine as JEngine
from xllm_tpu.models.registry import create_model as jcreate
from xllm_tpu.ops.pallas.mla_attention import (
    mla_prefill_attention_batched_tpu,
    mla_prefill_attention_tpu,
)
from xllm_tpu.runtime import forward_params as jfp
from xllm_tpu.runtime.input_builder import build_prefill_input as jbuild_prefill_input
from xllm_tpu.runtime.model_runner import ModelRunner as JRunner
from xllm_tpu_torch.engine import LLMEngine as TEngine
from xllm_tpu_torch.framework.request import Sequence, StoppingChecker
from xllm_tpu_torch.framework.sampling_params import SamplingParams as TSP
from xllm_tpu_torch.llm import LLM
from xllm_tpu_torch.models.registry import create_model as tcreate
from xllm_tpu_torch.ops import attention as tattention
from xllm_tpu_torch.ops import attention_ref, mla_ref
from xllm_tpu_torch.ops.cuda import _build
from xllm_tpu_torch.ops.cuda import kv_write as kw
from xllm_tpu_torch.ops.cuda import mla_attention as ka
from xllm_tpu_torch.ops.cuda import prefill_attention as kp
from xllm_tpu_torch.runtime import forward_params as tfp
from xllm_tpu_torch.runtime.input_builder import build_prefill_input
from xllm_tpu_torch.runtime.model_runner import ModelRunner as TRunner
from xllm_tpu_torch.server.async_engine import AsyncLLMEngine
from xllm_tpu_torch.weights import as_tensor, load_param_tree, random_param_tree
from torch_threads import one_torch_thread  # noqa: F401

F8 = jnp.float8_e4m3fn


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _t(a) -> torch.Tensor:
    return as_tensor(np.ascontiguousarray(np.asarray(a)))


def _bytes(a) -> np.ndarray:
    """Raw bytes of a JAX / numpy / torch array (float8 included)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _i32(v):
    return np.asarray(v, np.int32)


def _pages(lens, bs, nbmax):
    """Consecutive pages from block 1 for each row's length -> [N, nbmax]."""
    bt = np.zeros((len(lens), nbmax), np.int32)
    nxt = 1
    for i, n in enumerate(lens):
        for j in range(-(-n // bs)):
            bt[i, j] = nxt
            nxt += 1
    return bt


# ---------------------------------------------------------------------------
# K2b, K4b, K11f, K11g: the single-chunk writers, byte for byte
# ---------------------------------------------------------------------------
WL, WBS, WD, WHKV = 2, 16, 128, 2


def _cache(rng, kind, shape):
    """-> (JAX cache, torch tensor of the same bytes)."""
    if kind == "int8":
        j = jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)
    elif kind == "fp8_e4m3":
        j = jnp.asarray(rng.standard_normal(shape) * 2.0, jnp.float32).astype(F8)
    else:
        j = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    return j, _t(np.asarray(j)).clone()


def _rows(rng, kind, shape):
    """New rows -> (as JAX's dispatch hands them to its writers: cast to the
    cache dtype; as the port hands them to its writers: int8 codes, or f32
    values that an fp8 writer casts itself)."""
    if kind == "int8":
        r = rng.integers(-127, 128, shape).astype(np.int8)
        return jnp.asarray(r), _t(r)
    r = (rng.standard_normal(shape) * 60).astype(np.float32)
    if kind == "fp8_e4m3":
        r.reshape(-1)[:3] = [1000.0, -600.0, 465.0]  # NaN in JAX's cast
        return jnp.asarray(r).astype(F8), _t(r)
    return jnp.asarray(r), _t(r)


@pytest.mark.parametrize("kind", ["float32", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("writer", ["K2b", "K4b"])
def test_single_chunk_writers_match_pallas(writer, kind):
    """K2b: a chunk of 2.5 pages from page-aligned q_offset 32 (S_pad 48);
    K4b: 6 rows from mid-page offset 13, across a page boundary (S 8)."""
    rng = np.random.default_rng(31)
    nb, nbmax = 24, 6
    if writer == "K2b":
        s, qo, ntok = 48, 32, 40
        shape = (WHKV, s, WD)  # head-major
        jfn, tfn = jkv_write.kv_write_prefill_tpu, kw.kv_write_prefill
    else:
        s, qo, ntok = 8, 13, 6
        shape = (s, WHKV, WD)  # token-major
        jfn, tfn = jkv_write.kv_write_rmw_tpu, kw.kv_write_rmw
    kc, kt = _cache(rng, kind, (WL, nb, WHKV, WBS, WD))
    vc, vt = _cache(rng, kind, (WL, nb, WHKV, WBS, WD))
    (jk, tk), (jv, tv) = _rows(rng, kind, shape), _rows(rng, kind, shape)
    bt = _pages([qo + ntok], WBS, nbmax)[0]
    k_j, v_j = jfn(jk, jv, kc, vc, jnp.int32(1), jnp.asarray(bt), jnp.int32(qo),
                   jnp.int32(ntok), interpret=True)
    before = kt.clone()
    before_counts = dict(_build.launch_counts)
    tfn(tk, tv, kt, vt, 1, _t(bt), _t(_i32(qo)), _t(_i32(ntok)))
    assert _build.launch_counts == before_counts  # plain versions count nothing
    written = {(int(bt[p // WBS]), p % WBS) for p in range(qo, qo + ntok)}
    for got, want in ((kt, k_j), (vt, v_j)):
        gb, wb = _bytes(got), _bytes(want)
        if writer == "K4b":  # the RMW kernel writes exactly the chunk's rows
            np.testing.assert_array_equal(gb, wb)
        for blk, off in written:
            np.testing.assert_array_equal(gb[:, blk, :, off], wb[:, blk, :, off])
    # the port wrote the chunk's valid rows and nothing else
    gb, b0 = _bytes(kt).copy(), _bytes(before)
    for blk, off in written:
        gb[1, blk, :, off] = b0[1, blk, :, off]
    np.testing.assert_array_equal(gb, b0)


@pytest.mark.parametrize("writer", ["K11f", "K11g"])
def test_single_chunk_latent_writers_match_pallas(writer):
    """K11f: 40 rows from q_offset 16 (S_pad 48); K11g: 5 rows from offset
    14, across a page boundary (S 8)."""
    rng = np.random.default_rng(32)
    nb, nbmax, dk = 16, 6, 96
    s, qo, ntok = (48, 16, 40) if writer == "K11f" else (8, 14, 5)
    cache = rng.standard_normal((WL, nb, 1, WBS, dk)).astype(np.float32)
    rows = rng.standard_normal((s, dk)).astype(np.float32)
    bt = _pages([qo + ntok], WBS, nbmax)[0]
    jfn, tfn = ((jkv_write.latent_write_prefill_tpu, kw.latent_write_prefill)
                if writer == "K11f" else (jkv_write.latent_write_rmw_tpu, kw.latent_write_rmw))
    want = np.asarray(jfn(jnp.asarray(rows), jnp.asarray(cache), jnp.int32(1),
                          jnp.asarray(bt), jnp.int32(qo), jnp.int32(ntok), interpret=True))
    got = _t(cache).clone()
    tfn(_t(rows), got, 1, _t(bt), _t(_i32(qo)), _t(_i32(ntok)))
    got = got.numpy()
    written = {(int(bt[p // WBS]), p % WBS) for p in range(qo, qo + ntok)}
    if writer == "K11g":
        np.testing.assert_array_equal(got, want)
    for blk, off in written:
        np.testing.assert_array_equal(got[:, blk, 0, off], want[:, blk, 0, off])
        cache[1, blk, 0, off] = got[1, blk, 0, off]
    np.testing.assert_array_equal(got, cache)  # nothing else was written


# ---------------------------------------------------------------------------
# K3b, K3, K11e, K11b: valid rows equal; padding rows differ by design
# ---------------------------------------------------------------------------
# one chunk of S 16 at q_offset 16 with kv_len 21: rows 5-15 are bucket
# padding
PS, PQO, PKV = 16, 16, 21


@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("kernel", ["K3b", "K3"])
def test_padding_rows_tpu_attends_port_zeros(kernel, window):
    """The TPU kernels attend a bucket-padding row to all of [0, kv_len)
    (as the oracle does); the port's kernels and plain versions give zeros
    there. Valid rows agree within 1e-5 (f32, summation order)."""
    rng = np.random.default_rng(33)
    hq, hkv, d, bs, nbmax, nb = 4, 2, 64, 8, 4, 12
    k = rng.standard_normal((2, nb, hkv, bs, d)).astype(np.float32)
    v = rng.standard_normal((2, nb, hkv, bs, d)).astype(np.float32)
    q = rng.standard_normal((PS, hq, d)).astype(np.float32)
    bt = _pages([PKV], bs, nbmax)[0]
    scale = d ** -0.5
    jargs = (jnp.asarray(k), jnp.asarray(v), jnp.int32(1))
    if kernel == "K3b":
        want = jprefill.paged_attention_prefill_tpu(
            jnp.asarray(q), *jargs, jnp.asarray(bt), jnp.int32(PQO), jnp.int32(PKV),
            scale, interpret=True, window=window)
        got = kp.paged_attention_prefill(_t(q), _t(k), _t(v), 1, _t(bt), _t(_i32(PQO)),
                                         _t(_i32(PKV)), scale, window)
    else:
        want = jprefill.paged_attention_prefill_batched_tpu(
            jnp.asarray(q[None]), *jargs, jnp.asarray(bt[None]), jnp.asarray(_i32([PQO])),
            jnp.asarray(_i32([PKV])), scale, interpret=True, window=window)[0]
        got = kp.paged_attention_prefill_batched(
            _t(q[None]), _t(k), _t(v), 1, _t(bt[None]), _t(_i32([PQO])), _t(_i32([PKV])),
            scale, window)[0]
    want, got = np.asarray(want), got.numpy()
    n = PKV - PQO
    np.testing.assert_allclose(got[:n], want[:n], rtol=1e-5, atol=1e-5)
    assert not got[n:].any(), "the port's padding rows are zeros"
    if window == 0:  # each TPU padding row: attention over all of [0, kv_len)
        oracle = attention_ref.paged_attention_prefill_ref(
            _t(q), _t(k), _t(v), 1, _t(bt), PQO, PKV, scale).numpy()
        np.testing.assert_allclose(want, oracle, rtol=1e-5, atol=1e-5)
        assert (np.abs(want[n:]).max(axis=(1, 2)) > 1e-3).all()


@pytest.mark.parametrize("kernel", ["K11e", "K11b"])
def test_mla_padding_rows_tpu_attends_port_zeros(kernel):
    """The latent twins: the same chunk at H 4, Dk 96, dv 64."""
    rng = np.random.default_rng(34)
    h, dk, dv, bs, nbmax, nb = 4, 96, 64, 8, 4, 12
    cache = rng.standard_normal((2, nb, 1, bs, dk)).astype(np.float32)
    q = rng.standard_normal((PS, h, dk)).astype(np.float32)
    bt = _pages([PKV], bs, nbmax)[0]
    scale = dk ** -0.5
    if kernel == "K11e":
        want = mla_prefill_attention_tpu(
            jnp.asarray(q), jnp.asarray(cache), jnp.int32(1), jnp.asarray(bt),
            jnp.int32(PQO), jnp.int32(PKV), scale, dv, interpret=True)
        got = ka.mla_prefill_attention(_t(q), _t(cache), 1, _t(bt), _t(_i32(PQO)),
                                       _t(_i32(PKV)), scale, dv)
    else:
        want = mla_prefill_attention_batched_tpu(
            jnp.asarray(q[None]), jnp.asarray(cache), jnp.int32(1), jnp.asarray(bt[None]),
            jnp.asarray(_i32([PQO])), jnp.asarray(_i32([PKV])), scale, dv,
            interpret=True)[0]
        got = ka.mla_prefill_attention_batched(
            _t(q[None]), _t(cache), 1, _t(bt[None]), _t(_i32([PQO])), _t(_i32([PKV])),
            scale, dv)[0]
    want, got = np.asarray(want), got.numpy()
    n = PKV - PQO
    np.testing.assert_allclose(got[:n], want[:n], rtol=2e-5, atol=2e-5)
    oracle = mla_ref.mla_prefill_ref(_t(q), _t(cache), 1, _t(bt), PQO, PKV, scale,
                                     dv).numpy()
    np.testing.assert_allclose(want, oracle, rtol=2e-5, atol=2e-5)
    assert (np.abs(want[n:]).max(axis=(1, 2)) > 1e-3).all()
    assert not got[n:].any(), "the port's padding rows are zeros"


@pytest.mark.parametrize("kind", ["int8", "fp8_e4m3"])
def test_quantized_single_chunk_attention_matches_pallas(kind):
    """K3b on an int8 / fp8 cache (f32 q, P rounded to bf16 before P.V in
    both): a 40-token chunk at q_offset 16 in the 48 bucket."""
    rng = np.random.default_rng(35)
    hq, s, qo, kv_len, nbmax, nb = 4, 48, 16, 56, 6, 12
    kc, kt = _cache(rng, kind, (WL, nb, WHKV, WBS, WD))
    vc, vt = _cache(rng, kind, (WL, nb, WHKV, WBS, WD))
    q = rng.standard_normal((s, hq, WD)).astype(np.float32) * (4 / 127 if kind == "int8" else 1)
    bt = _pages([kv_len], WBS, nbmax)[0]
    scale = WD ** -0.5
    want = np.asarray(jprefill.paged_attention_prefill_tpu(
        jnp.asarray(q), kc, vc, jnp.int32(1), jnp.asarray(bt), jnp.int32(qo),
        jnp.int32(kv_len), scale, interpret=True))
    got = kp.paged_attention_prefill(_t(q), kt, vt, 1, _t(bt), _t(_i32(qo)),
                                     _t(_i32(kv_len)), scale).numpy()
    # P rounds to bf16 at another point of the softmax in the two: within
    # 2^-7 (|ref| + sum_j p_j |v_j|), the bound test_torch_quant.py holds K3 to
    ref = kp.paged_attention_prefill_plain(_t(q), kt.float(), vt.float().abs(), 1, _t(bt),
                                           _t(_i32(qo)), _t(_i32(kv_len)), scale).numpy()
    n = kv_len - qo
    lim = 1e-5 + 2.0 ** -7 * (np.abs(want[:n]) + ref[:n])
    assert (np.abs(got[:n] - want[:n]) <= lim).all()
    assert not got[n:].any()


# ---------------------------------------------------------------------------
# the CUDA path: no fallback, counters untouched on failure
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", ["K2b", "K4b", "K3b", "K11e", "K11f", "K11g"])
def test_cuda_tensor_with_failed_build_raises(kernel, monkeypatch):
    """A CUDA tensor goes to the kernel: a failed build raises before any
    launch is counted, and no plain version runs."""
    def failed_build(stem):
        raise RuntimeError(f"CUDA kernel build failed: csrc/{stem}.cu")

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(_build, "load", failed_build)
    for mod in (kw, kp, ka):
        monkeypatch.setattr(mod, "_lib", None)
    for mod, name in ((kw, "kv_write_rows_plain"), (kw, "latent_write_rows_plain"),
                      (kp, "paged_attention_prefill_batched_plain"),
                      (ka, "mla_prefill_attention_batched_plain")):
        monkeypatch.setattr(mod, name, no_plain)
    f = _fake_cuda
    bt, qo, n = f(torch.ones(2, dtype=torch.int32)), f(torch.tensor(0, dtype=torch.int32)), \
        f(torch.tensor(8, dtype=torch.int32))
    cache = f(torch.zeros(2, 4, 2, 16, 128, dtype=torch.bfloat16))
    latent = f(torch.zeros(2, 4, 1, 16, 128, dtype=torch.bfloat16))
    rows = f(torch.zeros(8, 2, 128, dtype=torch.bfloat16))
    before = dict(_build.launch_counts)
    with pytest.raises(RuntimeError, match="build failed"):
        if kernel == "K2b":
            kw.kv_write_prefill(f(torch.zeros(2, 8, 128, dtype=torch.bfloat16)),
                                f(torch.zeros(2, 8, 128, dtype=torch.bfloat16)),
                                cache, cache, 0, bt, qo, n)
        elif kernel == "K4b":
            kw.kv_write_rmw(rows, rows, cache, cache, 0, bt, qo, n)
        elif kernel == "K3b":
            kp.paged_attention_prefill(f(torch.zeros(8, 4, 128, dtype=torch.bfloat16)),
                                       cache, cache, 0, bt, qo, n, 0.1)
        elif kernel == "K11e":
            ka.mla_prefill_attention(f(torch.zeros(8, 16, 128, dtype=torch.bfloat16)),
                                     latent, 0, bt, qo, n, 0.1, 128)
        else:
            fn = kw.latent_write_prefill if kernel == "K11f" else kw.latent_write_rmw
            fn(f(torch.zeros(8, 128, dtype=torch.bfloat16)), latent, 0, bt, qo, n)
    assert _build.launch_counts == before


def test_interleaved_cache_raises():
    """The interleaved layouts serve (K8, K9): a single-chunk pass on an
    interleaved cache rides the batched kernels with P = 1, as in JAX, on
    both layouts; what still raises is a layout that does not exist."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((4, 16, 128)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((4, 8, 128)).astype(np.float32))
            for _ in range(2))
    ilv = torch.from_numpy(rng.standard_normal((1, 4, 2, 8, 16, 128)).astype(np.float32))
    bt = torch.tensor([1, 2, 0, 0], dtype=torch.int32)
    qo, kvl = torch.tensor(16, dtype=torch.int32), torch.tensor(20, dtype=torch.int32)
    sm = torch.arange(2 * 16, 2 * 16 + 4, dtype=torch.int32)
    for rm in (False, True):
        one, batched = ilv.clone(), ilv.clone()
        out, _, _ = tattention.prefill_attention_write(
            q, k, v, one, torch.zeros(1), 0, sm, bt, qo, kvl, 0.125, rowmajor_tail=rm)
        want, _, _ = tattention.prefill_attention_write_batched(
            q[None], k[None], v[None], batched, torch.zeros(1), 0, sm[None], bt[None],
            qo.reshape(1), kvl.reshape(1), 0.125, rowmajor_tail=rm)
        assert torch.equal(out, want[0]) and torch.equal(one, batched)
        assert not torch.equal(one, ilv)
    cfg = tcfg.EngineConfig(model=tcfg.ModelConfig(model_type="qwen3", dtype="float32"),
                            cache=tcfg.CacheConfig(kv_layout="paged"))
    with pytest.raises(ValueError, match="interleaved"):
        TEngine(cfg, device="cpu")


# ---------------------------------------------------------------------------
# input builder and models
# ---------------------------------------------------------------------------
def _seq(tokens, computed, block_ids):
    seq = Sequence(list(tokens), TSP(max_tokens=1),
                   StoppingChecker(max_new_tokens=1, max_model_len=256))
    seq.num_computed_tokens = computed
    seq.block_ids = list(block_ids)
    return seq


def test_build_prefill_input_matches_jax():
    """A mid-prompt chunk: padding positions repeat the last position,
    padding slots map to the null block, logits_idx = ntok - 1."""
    seq = _seq(range(1, 31), 8, [5, 2, 9, 4])
    got, done = build_prefill_input(seq, 13, 8, [4, 16], 6)
    want, jdone = jbuild_prefill_input(seq, 13, 8, [4, 16], 6)
    assert done == jdone is False
    for name in vars(want):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)
        assert np.shape(getattr(got, name)) == np.shape(getattr(want, name))
    assert got.positions[-1] == 20 and got.slot_mapping[-1] == 0 and got.logits_idx == 12


_TINY = dict(dtype="float32", vocab_size=97, hidden_size=64, intermediate_size=96,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16, max_position_embeddings=128, eos_token_ids=[0])
_EXPERTS = dict(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
                norm_topk_prob=True)
FAMILIES = {
    "qwen3": dict(_TINY, model_type="qwen3", qk_norm=True),
    "qwen3_moe": dict(_TINY, model_type="qwen3_moe", qk_norm=True, **_EXPERTS),
    # MLA: q_lora_rank 0, YaRN, latent 64 + 16 lanes, two shared experts
    "deepseek_v2": dict(_TINY, model_type="deepseek_v2", num_key_value_heads=4,
                        kv_lora_rank=64, qk_nope_head_dim=16, qk_rope_head_dim=16,
                        v_head_dim=16, first_k_dense_replace=1, n_shared_experts=2,
                        rope_scaling={"type": "yarn", "factor": 40,
                                      "original_max_position_embeddings": 4096,
                                      "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                                      "mscale_all_dim": 0.707},
                        **dict(_EXPERTS, norm_topk_prob=False)),
}


_PBS, _PNB, _PNBMAX, _PS = 4, 16, 8, 16  # block_size, blocks, table width, bucket


@pytest.fixture(scope="module")
def prefilled_models():
    """{family: (JAX model, its params, port model, JAX caches, port caches,
    sequence)} after a first chunk of 12 tokens at q_offset 0, built once."""
    cache = {}

    def get(family):
        if family not in cache:
            kw_ = FAMILIES[family]
            jm = jcreate(jcfg.ModelConfig(**kw_))
            params = random_param_tree(tcfg.ModelConfig(**kw_), seed=1)
            tm = tcreate(tcfg.ModelConfig(**kw_), device="cpu")
            load_param_tree(tm, params)
            jp = jax.tree.map(jnp.asarray, params)
            seq = _seq(np.random.default_rng(36).integers(1, 97, 19), 0, range(1, 6))
            arrays, _ = build_prefill_input(seq, 12, _PBS, [_PS], _PNBMAX)
            jcache, tcache = jm.new_kv_cache(_PNB, _PBS), tm.new_kv_cache(_PNB, _PBS)
            with jax.default_matmul_precision("highest"):
                _, kj, vj = jm.prefill(jp, *jcache, jfp.PrefillInput(
                    **{k: jnp.asarray(v) for k, v in vars(arrays).items()}))
            tm.prefill(*tcache, tfp.PrefillInput(**{k: _t(v) for k, v in vars(arrays).items()}))
            cache[family] = (jm, jp, tm, (kj, vj), tcache, seq)
        return cache[family]

    return get


@pytest.mark.parametrize("num_logits", [1, 3, "S_pad"])
@pytest.mark.parametrize("family", ["qwen3", "deepseek_v2"])
def test_model_prefill_matches_jax(family, num_logits, prefilled_models):
    """The second chunk of a sequence (7 tokens at q_offset 12 in the 16
    bucket, block_size 4, after a first chunk of 12): the last num_logits
    rows' logits within 1e-4 (valid rows only: JAX's portable path attends
    padding rows, the port zeros them), every cache row within 1e-5."""
    jm, jp, tm, (kj, vj), tcache, seq = prefilled_models(family)
    kt, vt = (c.clone() for c in tcache)
    seq.num_computed_tokens = 12
    arrays, _ = build_prefill_input(seq, 7, _PBS, [_PS], _PNBMAX)
    m = _PS if num_logits == "S_pad" else num_logits
    ij = jfp.PrefillInput(**{k: jnp.asarray(v) for k, v in vars(arrays).items()})
    it = tfp.PrefillInput(**{k: _t(v) for k, v in vars(arrays).items()})
    hj, kj, vj = jm.prefill(jp, kj, vj, ij, num_logits=m)
    ht, _, _ = tm.prefill(kt, vt, it, num_logits=m)
    assert tuple(ht.shape) == tuple(hj.shape) == (m, FAMILIES[family]["hidden_size"])
    valid = slice(0, 7 - max(7 - m, 0))  # the window's first row clamps to 0
    np.testing.assert_allclose(tm.compute_logits(ht).numpy()[valid],
                               np.asarray(jm.compute_logits(jp, hj))[valid],
                               rtol=1e-4, atol=1e-4)
    got, want = kt.numpy(), np.asarray(kj)
    for p in range(19):
        blk, off = 1 + p // _PBS, p % _PBS
        np.testing.assert_allclose(got[:, blk, :, off], want[:, blk, :, off],
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# engines: scoring and embeddings against the JAX engine
# ---------------------------------------------------------------------------
def _engine_config(c, model_kw, **cache):
    return c.EngineConfig(
        model=c.ModelConfig(**model_kw),
        cache=c.CacheConfig(block_size=16, num_blocks=48, **cache),
        scheduler=c.SchedulerConfig(max_seqs_per_batch=4, decode_batch_buckets=[4],
                                    max_tokens_per_chunk_for_prefill=32,
                                    prefill_token_buckets=[16, 32], max_model_len=128),
    )


# 40 tokens: chunks of 32 (the 32 bucket: K2b / K11f) and 8 at q_offset 32
# (the 16 bucket: K4b / K11g); 10 tokens: one chunk in the 16 bucket; 70
# tokens: 32 + 32 + 6
_PROMPTS = [np.random.default_rng(37).integers(1, 97, n).tolist() for n in (40, 10, 70)]


def _jax_results(cfg, tree):
    runner = JRunner(cfg)
    runner.load_model(params=jax.tree.map(jnp.asarray, tree))
    eng = JEngine(cfg, runner=runner)
    scores = [eng.score_prompt(p) for p in _PROMPTS]
    ids = [eng.add_request(prompt_token_ids=p, embed=True).request_id for p in _PROMPTS]
    outs = {ro.request_id: ro for ro in eng.generate_all(timeout_s=600)}
    assert eng.block_manager.num_used_blocks == 0
    return scores, [outs[i].embedding for i in ids]


@pytest.fixture(scope="module")
def jax_family_results():
    """{family: (JAX scores, JAX embeddings, tree)}, built once."""
    cache = {}

    def get(family):
        if family not in cache:
            tree = random_param_tree(_engine_config(tcfg, FAMILIES[family]).model, seed=9)
            with jax.default_matmul_precision("highest"):
                cache[family] = (*_jax_results(_engine_config(jcfg, FAMILIES[family]), tree),
                                 tree)
        return cache[family]

    return get


def _port_engine(cfg, tree):
    runner = TRunner(cfg, device="cpu")
    runner.load_model(params=tree)
    return TEngine(cfg, runner=runner)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_score_prompt_matches_jax(family, jax_family_results):
    want, _, tree = jax_family_results(family)
    llm = LLM(config=_engine_config(tcfg, FAMILIES[family]), device="cpu")
    llm.engine.runner.load_model(params=tree)
    for p, w in zip(_PROMPTS, want):
        got = llm.score(p)
        assert got.shape == (len(p) - 1,) and got.dtype == np.float32
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-4)
    assert llm.engine.block_manager.num_used_blocks == 0


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_embeddings_match_jax(family, jax_family_results):
    _, want, tree = jax_family_results(family)
    eng = _port_engine(_engine_config(tcfg, FAMILIES[family]), tree)
    ids = [eng.add_request(prompt_token_ids=p, embed=True).request_id for p in _PROMPTS]
    outs = {ro.request_id: ro for ro in eng.generate_all()}
    for i, w in zip(ids, want):
        ro = outs[i]
        assert ro.finished and ro.outputs[0].token_ids == []
        got = np.asarray(ro.embedding)
        assert got.shape == (FAMILIES[family]["hidden_size"],)
        np.testing.assert_allclose(np.linalg.norm(got), 1.0, rtol=1e-6)
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5)
    assert eng.block_manager.num_used_blocks == 0


@pytest.fixture
def jax_single_chunk_interpret(monkeypatch):
    """The JAX engine through its single-chunk Pallas kernels in interpret
    mode (``_use_pallas`` says yes; each kernel gets interpret=True).
    -> {kernel name: calls traced}."""
    monkeypatch.setattr(jattention, "_use_pallas", lambda *a, **k: True)
    traced = {}
    for mod, name in ((jkv_write, "kv_write_prefill_tpu"), (jkv_write, "kv_write_rmw_tpu"),
                      (jprefill, "paged_attention_prefill_tpu")):
        def interpreted(*a, _fn=getattr(mod, name), _name=name, **k):
            traced[_name] = traced.get(_name, 0) + 1
            return _fn(*a, interpret=True, **k)

        monkeypatch.setattr(mod, name, interpreted)
    return traced


def test_int8_kv_score_matches_jax_kernels(jax_single_chunk_interpret):
    """int8 KV (head_dim 128): the port's scores vs the JAX engine through
    K2b, K4b and K3b in interpret mode, which round P to bf16 as the port
    does. A 40-token prompt: one chunk in each writer's bucket."""
    model = dict(FAMILIES["qwen3"], head_dim=128)
    tree = random_param_tree(_engine_config(tcfg, model).model, seed=12)
    jc = _engine_config(jcfg, model, kv_cache_dtype="int8")
    runner = JRunner(jc)
    runner.load_model(params=jax.tree.map(jnp.asarray, tree))
    want = JEngine(jc, runner=runner).score_prompt(_PROMPTS[0])
    assert set(jax_single_chunk_interpret) == {
        "kv_write_prefill_tpu", "kv_write_rmw_tpu", "paged_attention_prefill_tpu"}
    eng = _port_engine(_engine_config(tcfg, model, kv_cache_dtype="int8"), tree)
    assert eng.runner.k_cache.dtype == torch.int8
    np.testing.assert_allclose(eng.score_prompt(_PROMPTS[0]), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# engine behaviour: embed beside generate, scoring between steps, async
# ---------------------------------------------------------------------------
_GREEDY = dict(temperature=0.0, max_tokens=5, ignore_eos=True)


@pytest.fixture(scope="module")
def qwen3_tree():
    return random_param_tree(_engine_config(tcfg, FAMILIES["qwen3"]).model, seed=9)


def _alone(tree):
    """Each request of the mixed tests run alone on a fresh engine."""
    eng = _port_engine(_engine_config(tcfg, FAMILIES["qwen3"]), tree)
    gen = []
    for p in _PROMPTS[1:]:
        eng.add_request(prompt_token_ids=p, sampling_params=TSP(**_GREEDY))
        gen.append(eng.generate_all()[0].outputs[0].token_ids)
    eng.add_request(prompt_token_ids=_PROMPTS[0], embed=True)
    emb = eng.generate_all()[0].embedding
    return gen, emb, eng.score_prompt(_PROMPTS[2])


def test_embed_beside_generate_in_one_step(qwen3_tree):
    """An embed request and two generate requests admitted together: the
    first step runs the embed request's first chunk in the batched prefill
    beside the others; a later step finishes it with the single-chunk pass
    while the others decode. A score between steps, with decode steps in
    flight, changes nothing."""
    gen_alone, emb_alone, score_alone = _alone(qwen3_tree)
    eng = _port_engine(_engine_config(tcfg, FAMILIES["qwen3"]), qwen3_tree)
    assert eng.overlap_depth > 0
    emb_id = eng.add_request(prompt_token_ids=_PROMPTS[0], embed=True).request_id
    ids = [eng.add_request(prompt_token_ids=p, sampling_params=TSP(**_GREEDY)).request_id
           for p in _PROMPTS[1:]]
    passes = []
    run_embed = eng.runner.run_prefill_embed
    eng.runner.run_prefill_embed = lambda *a: passes.append(eng._step_no) or run_embed(*a)
    outs, scored = {}, None
    while eng.has_unfinished():
        for ro in eng.step():
            outs[ro.request_id] = ro
        if scored is None and eng._pending:
            scored = eng.score_prompt(_PROMPTS[2])
    assert len(passes) == 1 and passes[0] >= 1  # not the first step: chunk 2
    np.testing.assert_array_equal(outs[emb_id].embedding, emb_alone)
    assert [outs[i].outputs[0].token_ids for i in ids] == gen_alone
    np.testing.assert_array_equal(scored, score_alone)
    assert eng.block_manager.num_used_blocks == 0


def test_async_engine_generate_embed_and_score(qwen3_tree):
    """``AsyncLLMEngine`` on the CPU: concurrent generate, embed and
    ``call("score_prompt")`` give what each gives alone."""
    gen_alone, emb_alone, score_alone = _alone(qwen3_tree)
    cfg = _engine_config(tcfg, FAMILIES["qwen3"])
    aeng = AsyncLLMEngine(cfg, engine=_port_engine(cfg, qwen3_tree))
    aeng.start()

    async def last(agen):
        out = None
        async for out in agen:
            pass
        return out

    async def main():
        return await asyncio.gather(
            *(last(aeng.generate(prompt_token_ids=p, sampling_params=TSP(**_GREEDY)))
              for p in _PROMPTS[1:]),
            last(aeng.generate(prompt_token_ids=_PROMPTS[0], embed=True)),
            aeng.call("score_prompt", _PROMPTS[2]),
        )

    try:
        *gens, emb, score = asyncio.run(main())
    finally:
        aeng.stop()
    assert [g.outputs[0].token_ids for g in gens] == gen_alone
    assert all(g.finished for g in gens) and emb.finished
    np.testing.assert_array_equal(emb.embedding, emb_alone)
    np.testing.assert_array_equal(score, score_alone)
    assert aeng.engine.block_manager.num_used_blocks == 0


def test_embed_and_score_requests_serve():
    """The requests that raised before this slice: an embed request gives a
    unit vector and no token; scoring gives n - 1 finite logprobs; scoring
    refuses a single token and an overlong prompt."""
    cfg = _engine_config(tcfg, FAMILIES["qwen3"])
    eng = TEngine(cfg, device="cpu")
    eng.add_request(prompt_token_ids=[1, 2, 3], embed=True)
    (ro,) = eng.generate_all()
    assert ro.finished and ro.outputs[0].token_ids == [] and ro.usage["completion_tokens"] == 0
    np.testing.assert_allclose(np.linalg.norm(ro.embedding), 1.0, rtol=1e-6)
    lp = eng.score_prompt([1, 2, 3])
    assert lp.shape == (2,) and np.isfinite(lp).all() and (lp < 0).all()
    with pytest.raises(ValueError, match="at least 2"):
        eng.score_prompt([1])
    with pytest.raises(ValueError, match="max_model_len"):
        eng.score_prompt([1] * 129)
    assert eng.block_manager.num_used_blocks == 0


# ---------------------------------------------------------------------------
# where P is rounded on a quantized cache: as the TPU kernel walks
# ---------------------------------------------------------------------------
def _decode_walk(q, k_new, v_new, k_all, v_all, block_tables, seq_lens, scale, window):
    """K1's walk on a quantized cache, written as the TPU kernel (v9) runs
    it, one sequence at a time: the softmax opens at the new token (m = its
    score, l = 1, acc = v_new), then the cached positions in tiles of 4
    pages from position 0 (masked below the window's edge), P rounded to
    bf16 against the running maximum after each tile."""
    b, hq, d = q.shape
    hkv, bs = k_all.shape[2], k_all.shape[3]
    bt = block_tables.long()
    k = k_all[1][bt].float().permute(0, 2, 1, 3, 4).reshape(b, hkv, -1, d)
    v = v_all[1][bt].float().permute(0, 2, 1, 3, 4).reshape(b, hkv, -1, d)
    qg = q.float().reshape(b, hkv, hq // hkv, d)
    sc = torch.einsum("bkgd,bksd->bkgs", qg, k) * scale
    out = torch.zeros(b, hkv, hq // hkv, d)
    for i, n in enumerate(seq_lens.tolist()):
        if n <= 0:
            continue
        lo = max(n - window, 0) if window else 0
        m = (qg[i] * k_new[i].float()[:, None, :]).sum(-1) * scale
        l = torch.ones_like(m)
        acc = v_new[i].float()[:, None, :].expand(-1, hq // hkv, -1).clone()
        for t0 in range(0, n - 1, 4 * bs):
            lo_j, hi_j = max(lo, t0), min(n - 1, t0 + 4 * bs)
            if lo_j >= hi_j:
                continue
            st = sc[i, :, :, lo_j:hi_j]
            m_new = torch.maximum(m, st.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(st - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "kgs,ksd->kgd", p.bfloat16().float(), v[i, :, lo_j:hi_j])
            m = m_new
        out[i] = acc / l[..., None]
    return out.reshape(b, hq, d)


@pytest.mark.parametrize("bs,nbmax,window", [(16, 16, 0), (16, 40, 37), (64, 64, 0),
                                             (64, 64, 100)])
def test_quantized_decode_plain_rounds_as_the_kernel_walks(bs, nbmax, window):
    """K1's plain version on an int8 cache rounds P against the running
    maximum of the TPU kernel's walk (tiles of 4 pages, windows; the CUDA
    kernel reaches the same maxima across its context splits), so that the
    card, the CPU and the TPU round the same P: equal to the walk within
    f32 summation order."""
    from xllm_tpu_torch.ops.cuda.decode_attention import paged_decode_attention_write_plain

    g = torch.Generator().manual_seed(3)
    lens = [1, 17, 100, nbmax * bs, 0, 65, nbmax * bs // 2 + 3]
    b, hkv, hq, d = len(lens), 2, 4, 64
    nb = 1 + sum(-(-n // bs) for n in lens)
    bt = torch.as_tensor(_pages(lens, bs, nbmax))
    kc, vc = (torch.randint(-127, 128, (2, nb, hkv, bs, d), generator=g, dtype=torch.int8)
              for _ in range(2))
    q = torch.randn(b, hq, d, generator=g) * 0.05
    kn, vn = (torch.randint(-127, 128, (b, hkv, d), generator=g, dtype=torch.int8)
              for _ in range(2))
    sl = torch.tensor(lens, dtype=torch.int32)
    sm = torch.tensor([int(bt[i, (n - 1) // bs]) * bs + (n - 1) % bs if n else 0
                       for i, n in enumerate(lens)], dtype=torch.int32)
    got = paged_decode_attention_write_plain(q, kn, vn, kc, vc, 1, sm, bt, sl, 0.125, window)
    want = _decode_walk(q, kn, vn, kc, vc, bt, sl, 0.125, window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-4)
    assert not got[4].any()
