"""The port's quantization slice vs the JAX package, on the CPU.

Same numpy inputs into both packages:

- ``quantize_int8`` / ``quantize_fp8`` byte-equal to the JAX quantizers as
  the JAX runner calls them (under ``jax.jit``), and the e4m3 cast to JAX's
  bytes, overflow included;
- K5, K6 and K7's plain versions (stacked ones too) against the nine Pallas
  functions of ``quant_matmul.py`` in interpret mode: K5 equal, K6 / K7
  within ``K 2^-24 (|x| @ |w|) |s| + 1e-6`` (exact products, f32 sums in
  another order);
- the quantized-cache plain versions of K1-K4 against the Pallas kernels in
  interpret mode, int8 and fp8, f32 and bf16 queries: writers byte-equal,
  attention within ``1e-5 + 2^-7 (|ref| + sum_j p_j |v_j|)`` (both round P
  to bf16, the kernel against its running maximum, the plain version
  against the final one);
- the default ``quant_matmul``, ``calibrate_kv_scales`` and a quantized
  JAX tree carried through ``weights.py``;
- greedy tokens of the port's engine identical to the JAX engine's on a
  tiny f32 qwen3: int8 / fp8 weights against the default JAX engine, int8 /
  fp8 KV against the JAX engine run through its Pallas kernels in
  interpret mode (``_use_pallas`` and the kernels' ``interpret`` argument
  patched in this process; nothing under ``xllm_tpu/`` changes).
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
import xllm_tpu.ops.pallas.quant_matmul as jqmm
import xllm_tpu_torch.config as tcfg
from xllm_tpu.engine import LLMEngine as JEngine
from xllm_tpu.framework.sampling_params import SamplingParams as JSP
from xllm_tpu.ops import quant as jquant
from xllm_tpu.runtime.model_runner import ModelRunner as JRunner
from xllm_tpu_torch.engine import LLMEngine as TEngine
from xllm_tpu_torch.framework.sampling_params import SamplingParams as TSP
from xllm_tpu_torch.ops import quant as tquant
from xllm_tpu_torch.ops.cuda import quant_matmul as tqmm
from xllm_tpu_torch.ops.cuda.decode_attention import paged_decode_attention_write_plain
from xllm_tpu_torch.ops.cuda.kv_write import kv_write_prefill_batched, kv_write_rmw_batched
from xllm_tpu_torch.ops.cuda.prefill_attention import paged_attention_prefill_batched_plain
from xllm_tpu_torch.runtime.model_runner import ModelRunner as TRunner
from xllm_tpu_torch.weights import as_tensor, random_param_tree
from torch_threads import one_torch_thread  # noqa: F401

F8 = jnp.float8_e4m3fn
JQUANT = {"int8": jax.jit(jquant.quantize_int8), "fp8_e4m3": jax.jit(jquant.quantize_fp8)}


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _t(a) -> torch.Tensor:
    return as_tensor(np.ascontiguousarray(a))


def _bytes(a) -> np.ndarray:
    """Raw bytes of a JAX / numpy / torch array (float8 included)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _torch_like(a, dtype: torch.dtype) -> torch.Tensor:
    """A JAX array's values as a torch tensor of ``dtype`` (exact: the
    values are representable in it)."""
    return _t(np.asarray(a.astype(jnp.float32))).to(dtype)


# ---------------------------------------------------------------------------
# quantizers and the e4m3 cast
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", ["int8", "fp8_e4m3"])
def test_quantize_bytes_match_jax(method):
    rng = np.random.default_rng(0)
    for scale in (1e-3, 0.05, 3.0):
        w = (rng.standard_normal((3, 96, 160)) * scale).astype(np.float32)
        w[0, :, 5] = 0.0  # an all-zero column: the 1e-8 scale floor
        jq, js = JQUANT[method](jnp.asarray(w))
        tq, ts = tquant.QUANTIZERS[method](torch.from_numpy(w))
        np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_e4m3_cast_matches_jax(dtype):
    """PyTorch saturates above 464 in magnitude, JAX gives NaN (bytes 127 /
    255); ``to_e4m3`` gives JAX's bytes everywhere, ties and subnormals
    included."""
    special = [1000.0, -500.0, 464.0, 465.0, -464.0, 448.0, 480.0, -1e30,
               float("inf"), -float("inf"), 0.0, -0.0, 2.0 ** -10, 3 * 2.0 ** -10,
               17.0, 18.0, 0.0013]
    rng = np.random.default_rng(1)
    x = np.concatenate([np.asarray(special, np.float32),
                        (rng.standard_normal(20000) * 40).astype(np.float32),
                        (rng.standard_normal(20000) * 0.01).astype(np.float32)])
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = _bytes(jx.astype(F8))
    np.testing.assert_array_equal(_bytes(tquant.to_e4m3(tx)), want)
    assert list(want[:3]) == [127, 255, 126]
    assert want[3] == (127 if dtype == "float32" else 126)  # 465 is 464 in bf16
    # PyTorch's own cast differs only where JAX gives NaN
    torch_own = _bytes(tx.to(torch.float8_e4m3fn))
    assert set(np.nonzero(torch_own != want)[0]) <= set(np.nonzero(np.abs(x) > 464)[0])


# ---------------------------------------------------------------------------
# K5, K6, K7 plain versions vs the Pallas functions (interpret mode)
# ---------------------------------------------------------------------------
M, K, N, NL = 16, 256, 384, 3


def _qmm_inputs(x_dtype, method):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((M, K)) * 0.5).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(getattr(jnp, x_dtype)).astype(jnp.float32))
    w = (rng.standard_normal((NL, K, N)) * 0.05).astype(np.float32)
    if method == "bf16":
        wq = jnp.asarray(w).astype(jnp.bfloat16)
        s = jnp.ones((NL, N), jnp.float32)
    else:
        wq, s = JQUANT[method](jnp.asarray(w))
    return x, wq, s


# (Pallas function, stacked, weight kind, port plain, exact)
QMM_CASES = {
    "quant_matmul_int8": (jqmm.quant_matmul_int8, False, "int8", True),
    "quant_matmul_int8_v2": (jqmm.quant_matmul_int8_v2, False, "int8", True),
    "quant_matmul_int8_v2_stacked": (jqmm.quant_matmul_int8_v2_stacked, True, "int8", True),
    "quant_matmul_fp8": (jqmm.quant_matmul_fp8, False, "fp8_e4m3", False),
    "quant_matmul_fp8_v2": (jqmm.quant_matmul_fp8_v2, False, "fp8_e4m3", False),
    "quant_matmul_fp8_v2_stacked": (jqmm.quant_matmul_fp8_v2_stacked, True, "fp8_e4m3", False),
    "quant_matmul_fp8_stacked": (jqmm.quant_matmul_fp8_stacked, True, "fp8_e4m3", False),
    "matmul_bf16_v2": (jqmm.matmul_bf16_v2, False, "bf16", False),
    "matmul_bf16_stacked": (jqmm.matmul_bf16_stacked, True, "bf16", False),
}
_PORT = {  # kind -> (unstacked, stacked) wrappers; on CPU tensors the plain versions
    "int8": (tqmm.quant_matmul_int8, tqmm.quant_matmul_int8_stacked),
    "fp8_e4m3": (tqmm.quant_matmul_fp8, tqmm.quant_matmul_fp8_stacked),
    "bf16": (lambda x, w, s: tqmm.matmul_bf16(x, w),
             lambda x, w, s, li: tqmm.matmul_bf16_stacked(x, w, li)),
}


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(QMM_CASES))
def test_qmm_plain_matches_pallas(case, x_dtype):
    fn, stacked, kind, exact = QMM_CASES[case]
    x, wq, s = _qmm_inputs(x_dtype, kind)
    jx = jnp.asarray(x).astype(getattr(jnp, x_dtype))
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    unstacked, stacked_fn = _PORT[kind]
    for li in (NL - 1,):  # the last layer: a stacked call's pointer offset
        if stacked:
            args = (wq,) if kind == "bf16" else (wq, s)
            want = fn(jx, *args, jnp.int32(li), interpret=True)
            got = stacked_fn(tx, _t(wq), _t(s), li)
        else:
            args = (wq[li],) if kind == "bf16" else (wq[li], s[li])
            want = fn(jx, *args, interpret=True)
            got = unstacked(tx, _t(wq[li]), _t(s[li]))
        want = np.asarray(want)
        if exact:
            np.testing.assert_array_equal(got.numpy(), want)
            continue
        w_abs = np.abs(np.asarray(wq[li].astype(jnp.float32)))
        lim = K * 2.0 ** -24 * (np.abs(x.astype(np.float32)) @ w_abs) \
            * np.abs(np.asarray(s[li])) + 1e-6
        assert (np.abs(got.numpy() - want) <= lim).all(), np.abs(got.numpy() - want).max()


@pytest.mark.parametrize("method", ["int8", "fp8_e4m3"])
def test_default_quant_matmul_matches_jax(method, monkeypatch):
    """The dequant default (both packages off the TPU), and the kernel
    switch, which the port honours on the CPU through the plain versions."""
    monkeypatch.delenv("XLLM_QMM_KERNEL", raising=False)
    x, wq, s = _qmm_inputs("float32", method)
    want = np.asarray(jquant.quant_matmul(jnp.asarray(x), wq[1], s[1]))
    want_st = np.asarray(jquant.quant_matmul_stacked(jnp.asarray(x), wq, s, jnp.int32(2)))
    tx, twq, ts = torch.from_numpy(x), _t(wq), _t(s)
    np.testing.assert_allclose(tquant.quant_matmul(tx, twq[1], ts[1]).numpy(), want,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tquant.quant_matmul_stacked(tx, twq, ts, 2).numpy(), want_st,
                               rtol=1e-5, atol=1e-6)
    monkeypatch.setenv("XLLM_QMM_KERNEL", "pallas")
    plain = tqmm.quant_matmul_int8_plain if method == "int8" else tqmm.quant_matmul_fp8_plain
    np.testing.assert_array_equal(tquant.quant_matmul(tx, twq[1], ts[1]).numpy(),
                                  plain(tx, twq[1], ts[1]).numpy())
    np.testing.assert_array_equal(tquant.quant_matmul_stacked(tx, twq, ts, 2).numpy(),
                                  plain(tx, twq[2], ts[2]).numpy())


# ---------------------------------------------------------------------------
# quantized-cache K1-K4 plain versions vs the Pallas kernels (interpret)
# ---------------------------------------------------------------------------
L, BS, D = 2, 16, 128


def _tables(lens, nbmax):
    bt = np.zeros((len(lens), nbmax), np.int32)
    nxt = 1
    for i, n in enumerate(lens):
        for j in range(-(-n // BS)):
            bt[i, j] = nxt
            nxt += 1
    return bt


def _owned(bt, lens):
    return [(int(bt[i, p // BS]), p % BS) for i, n in enumerate(lens) for p in range(n)]


def _quant_cache(rng, kind, shape):
    """-> (JAX cache, the same bytes as a torch tensor)."""
    if kind == "int8":
        j = jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)
    else:
        j = jnp.asarray(rng.standard_normal(shape) * 2.0, jnp.float32).astype(F8)
    return j, _t(np.asarray(j))


def _new_rows(rng, kind, shape, q_dtype):
    """New K/V rows as the model hands them to the kernels: int8 codes for
    an int8 cache, q's dtype for an fp8 cache."""
    if kind == "int8":
        return jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)
    return jnp.asarray(rng.standard_normal(shape) * 2.0, jnp.float32).astype(q_dtype)


def _attn_bound(got, want, probs_abs_v):
    lim = 1e-5 + 2.0 ** -7 * (np.abs(want) + probs_abs_v)
    excess = np.abs(got - want) - lim
    assert (excess <= 0).all(), (np.abs(got - want).max(), excess.max())


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["int8", "fp8_e4m3"])
def test_quantized_decode_plain_matches_pallas(kind, q_dtype):
    """K1 on an int8 / fp8 cache: padded rows, a first token, a token that
    opens a page; a sliding window with the bf16 query."""
    rng = np.random.default_rng(3)
    hq, hkv, nbmax = 4, 2, 6
    lens = [18, 0, 16, 70, 1, 33, 17]
    b, nb = len(lens), 48
    jqd = getattr(jnp, q_dtype)
    kc, kt = _quant_cache(rng, kind, (L, nb, hkv, BS, D))
    vc, vt = _quant_cache(rng, kind, (L, nb, hkv, BS, D))
    q = jnp.asarray(rng.standard_normal((b, hq, D)), jnp.float32).astype(jqd)
    kn = _new_rows(rng, kind, (b, hkv, D), jqd)
    vn = _new_rows(rng, kind, (b, hkv, D), jqd)
    bt = _tables(lens, nbmax)
    slots = np.asarray([bt[i, (n - 1) // BS] * BS + (n - 1) % BS if n else 0
                        for i, n in enumerate(lens)], np.int32)
    sl = np.asarray(lens, np.int32)
    scale = D ** -0.5
    for window in (0,) if q_dtype == "float32" else (20,):
        out_j, k_j, v_j = jdecode.paged_decode_attention_write_v9_tpu(
            q, kn, vn, kc, vc, jnp.int32(1), jnp.asarray(slots), jnp.asarray(bt),
            jnp.asarray(sl), scale, interpret=True, window=window,
        )
        kk, vk = kt.clone(), vt.clone()
        tq = _torch_like(q, getattr(torch, q_dtype))
        new_dtype = torch.int8 if kind == "int8" else tq.dtype
        out_t = paged_decode_attention_write_plain(
            tq, _torch_like(kn, new_dtype), _torch_like(vn, new_dtype),
            kk, vk, 1, _t(slots), _t(bt), _t(sl), scale, window=window,
        )
        for got, want in ((kk, k_j), (vk, v_j)):  # the written rows: same bytes
            gb, wb = _bytes(got), _bytes(want)
            for blk, off in _owned(bt, lens):
                np.testing.assert_array_equal(gb[:, blk, :, off], wb[:, blk, :, off])
        live = [i for i, n in enumerate(lens) if n]
        # sum_j p_j |v_j| over the positions each row attends (float64)
        vf = np.asarray(vk.float())[1][bt].transpose(0, 2, 1, 3, 4).reshape(b, hkv, -1, D)
        kf = np.asarray(kk.float())[1][bt].transpose(0, 2, 1, 3, 4).reshape(b, hkv, -1, D)
        qf = np.asarray(tq.float()).reshape(b, hkv, hq // hkv, D)
        sc = np.einsum("bkgd,bksd->bkgs", qf, kf) * scale
        idx = np.arange(kf.shape[2])[None, None, None]
        lim = sl[:, None, None, None]
        mask = (idx < lim) & ((idx >= lim - window) if window else True)
        sc = np.where(mask, sc, -np.inf)
        p = np.exp(sc - sc.max(-1, keepdims=True))
        p = np.nan_to_num(p / p.sum(-1, keepdims=True))
        pv = np.einsum("bkgs,bksd->bkgd", p, np.abs(vf)).reshape(b, hq, D)
        got = out_t.float().numpy()
        _attn_bound(got[live], np.asarray(out_j.astype(jnp.float32))[live], pv[live])
        assert not got[[1]].any()  # the padded row: zeros


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["int8", "fp8_e4m3"])
def test_quantized_prefill_plain_matches_pallas(kind, q_dtype):
    """K3 on an int8 / fp8 cache: fresh chunk, continuation, short row,
    padded row."""
    rng = np.random.default_rng(4)
    hq, hkv, s, nbmax, nb = 4, 2, 32, 8, 64
    specs = [(0, 32), (32, 64), (0, 18), (0, 0)]  # (q_offset, kv_len)
    p = len(specs)
    kc, kt = _quant_cache(rng, kind, (L, nb, hkv, BS, D))
    vc, vt = _quant_cache(rng, kind, (L, nb, hkv, BS, D))
    q = jnp.asarray(rng.standard_normal((p, s, hq, D)), jnp.float32).astype(getattr(jnp, q_dtype))
    bt = _tables([kl for _, kl in specs], nbmax)
    qo = np.asarray([a for a, _ in specs], np.int32)
    kvl = np.asarray([b for _, b in specs], np.int32)
    scale = D ** -0.5
    out_j = np.asarray(jprefill.paged_attention_prefill_batched_tpu(
        q, kc, vc, jnp.int32(1), jnp.asarray(bt), jnp.asarray(qo), jnp.asarray(kvl),
        scale, interpret=True,
    ).astype(jnp.float32))
    tq = _torch_like(q, getattr(torch, q_dtype))
    out_t = paged_attention_prefill_batched_plain(
        tq, kt, vt, 1, _t(bt), _t(qo), _t(kvl), scale).float().numpy()
    kf = np.asarray(kt.float())[1][bt].transpose(0, 2, 1, 3, 4).reshape(p, hkv, -1, D)
    vf = np.asarray(vt.float())[1][bt].transpose(0, 2, 1, 3, 4).reshape(p, hkv, -1, D)
    qf = np.asarray(tq.float()).reshape(p, s, hkv, hq // hkv, D)
    sc = np.einsum("pqkgd,pksd->pkgqs", qf, kf) * scale
    qpos = qo[:, None] + np.arange(s)[None]
    idx = np.arange(kf.shape[2])
    mask = (idx[None, None] <= qpos[:, :, None]) & (idx[None, None] < kvl[:, None, None])
    sc = np.where(mask[:, None, None], sc, -np.inf)
    pr = np.nan_to_num(np.exp(sc - sc.max(-1, keepdims=True)))
    pr = np.nan_to_num(pr / pr.sum(-1, keepdims=True))
    pv = np.einsum("pkgqs,pksd->pqkgd", pr, np.abs(vf)).reshape(p, s, hq, D)
    for i, (a, kl) in enumerate(specs):
        n = min(s, kl - a)
        if n > 0:
            _attn_bound(out_t[i, :n], out_j[i, :n], pv[i, :n])
        assert not out_t[i, max(n, 0):].any()


@pytest.mark.parametrize("kind", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("writer", ["full_page", "rmw"])
def test_quantized_writers_match_pallas(writer, kind):
    """K2 / K4 into an int8 / fp8 cache: the same bytes as the TPU writers
    fed rows cast the JAX way (the port casts f32 rows itself)."""
    rng = np.random.default_rng(5)
    hkv, nb, nbmax = 2, 64, 8
    if writer == "full_page":
        s, specs = 48, [(0, 48), (32, 33), (16, 16), (0, 0)]
        shape = lambda p: (p, hkv, s, D)  # noqa: E731 (head-major)
        jfn, tfn = jkv_write.kv_write_prefill_batched_tpu, kv_write_prefill_batched
    else:
        s, specs = 5, [(17, 5), (14, 5), (0, 3), (0, 0)]
        shape = lambda p: (p, s, hkv, D)  # noqa: E731 (token-major)
        jfn, tfn = jkv_write.kv_write_rmw_batched_tpu, kv_write_rmw_batched
    p = len(specs)
    kc, kt = _quant_cache(rng, kind, (L, nb, hkv, BS, D))
    vc, vt = _quant_cache(rng, kind, (L, nb, hkv, BS, D))
    if kind == "int8":
        kn, vn = (rng.integers(-127, 128, shape(p)).astype(np.int8) for _ in range(2))
        jk, jv = jnp.asarray(kn), jnp.asarray(vn)
        tk, tv = _t(kn), _t(vn)
    else:
        kn, vn = ((rng.standard_normal(shape(p)) * 60).astype(np.float32) for _ in range(2))
        kn.reshape(-1)[:3] = [1000.0, -600.0, 465.0]  # JAX's NaN bytes
        jk, jv = jnp.asarray(kn).astype(F8), jnp.asarray(vn).astype(F8)
        tk, tv = _t(kn), _t(vn)
    lens = [a + n for a, n in specs]
    bt = _tables(lens, nbmax)
    qo = np.asarray([a for a, _ in specs], np.int32)
    nt = np.asarray([n for _, n in specs], np.int32)
    k_j, v_j = jfn(jk, jv, kc, vc, jnp.int32(1), jnp.asarray(bt), jnp.asarray(qo),
                   jnp.asarray(nt), interpret=True)
    kk, vk = kt.clone(), vt.clone()
    tfn(tk, tv, kk, vk, 1, _t(bt), _t(qo), _t(nt))
    for got, want in ((kk, k_j), (vk, v_j)):
        gb, wb = _bytes(got), _bytes(want)
        for blk, off in _owned(bt, lens):
            np.testing.assert_array_equal(gb[:, blk, :, off], wb[:, blk, :, off])


# ---------------------------------------------------------------------------
# weights, calibration, engines
# ---------------------------------------------------------------------------
def tiny_config(c, head_dim=16, **cache):
    hd = head_dim
    return c.EngineConfig(
        model=c.ModelConfig(
            model_type="qwen3", dtype="float32", vocab_size=97, hidden_size=64,
            intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=hd, qk_norm=True,
            max_position_embeddings=128, eos_token_ids=[13],
        ),
        cache=c.CacheConfig(block_size=16 if hd == 128 else 4, num_blocks=64, **cache),
        scheduler=c.SchedulerConfig(
            max_seqs_per_batch=4, max_tokens_per_chunk_for_prefill=32,
            max_model_len=128, decode_batch_buckets=[4],
            prefill_token_buckets=[32],
        ),
    )


def _prompts(n=6):
    rng = np.random.default_rng(0)
    return [rng.integers(1, 97, k).tolist() for k in (5, 13, 3, 29, 40, 7)[:n]]


def _jax_tokens(cfg, tree, prompts, max_tokens):
    runner = JRunner(cfg)
    runner.load_model(params=jax.tree.map(jnp.asarray, tree))
    eng = JEngine(cfg, runner=runner)
    ids = [eng.add_request(prompt_token_ids=p, sampling_params=JSP(
        temperature=0.0, max_tokens=max_tokens, ignore_eos=True)).request_id for p in prompts]
    outs = {ro.request_id: ro.outputs[0].token_ids for ro in eng.generate_all(timeout_s=600)}
    assert eng.block_manager.num_used_blocks == 0
    return [outs[i] for i in ids]


def _port_engine(cfg, tree):
    runner = TRunner(cfg, device="cpu")
    runner.load_model(params=tree)
    return TEngine(cfg, runner=runner)


def _port_tokens(cfg, tree, prompts, max_tokens):
    eng = _port_engine(cfg, tree)
    ids = [eng.add_request(prompt_token_ids=p, sampling_params=TSP(
        temperature=0.0, max_tokens=max_tokens, ignore_eos=True)).request_id for p in prompts]
    outs = {ro.request_id: ro.outputs[0].token_ids for ro in eng.generate_all()}
    assert eng.block_manager.num_used_blocks == 0
    return [outs[i] for i in ids]


@pytest.mark.parametrize("method", ["int8", "fp8_e4m3"])
def test_quantized_tree_carries_through_weights(method):
    """A tree quantized by the JAX runner's quantizer loads byte for byte
    (float8 through its bytes), and a float tree is quantized on load."""
    cfg = tiny_config(tcfg)
    cfg.quant.method = method
    tree = random_param_tree(cfg.model, seed=3)
    jtree = dict(tree, layers=dict(tree["layers"]))
    for name in ("qkv_proj_w", "o_proj_w", "gate_proj_w", "up_proj_w", "down_proj_w"):
        wq, s = JQUANT[method](jnp.asarray(tree["layers"][name]))
        jtree["layers"][name] = np.asarray(wq)  # an ml_dtypes array for fp8
        jtree["layers"][name + "_scale"] = np.asarray(s)
    carried = TRunner(cfg, device="cpu")
    carried.load_model(params=jtree)
    requantized = TRunner(cfg, device="cpu")
    requantized.load_model(params=tree)
    for i in range(cfg.model.num_hidden_layers):
        for name, got in carried.model.layers[i].named_parameters():
            want = jtree["layers"][name][i]
            np.testing.assert_array_equal(_bytes(got.detach()), _bytes(np.asarray(want)))
            other = getattr(requantized.model.layers[i], name).detach()
            assert torch.equal(got.view(torch.uint8) if got.element_size() == 1 else got,
                               other.view(torch.uint8) if other.element_size() == 1 else other)
    with pytest.raises(ValueError, match="cannot load"):
        bad = dict(jtree, layers=dict(jtree["layers"], o_proj_w=tree["layers"]["o_proj_w"]))
        from xllm_tpu_torch.weights import load_param_tree
        load_param_tree(carried.model, bad)


def test_calibrate_kv_scales_matches_jax():
    prompts = _prompts(4)
    tree = random_param_tree(tiny_config(tcfg).model, seed=5)
    jcfg_ = tiny_config(jcfg)
    runner = JRunner(jcfg_)
    runner.load_model(params=jax.tree.map(jnp.asarray, tree))
    want = jquant.calibrate_kv_scales(JEngine(jcfg_, runner=runner), prompts)
    got = tquant.calibrate_kv_scales(_port_engine(tiny_config(tcfg), tree), prompts)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 2) and g.dtype == np.float32
        # the caches hold the same K/V up to f32 summation order
        np.testing.assert_allclose(g, w, rtol=1e-5)


@pytest.mark.parametrize("method", ["int8", "fp8_e4m3"])
def test_quantized_weights_greedy_match_jax(method):
    """int8 / fp8 weights: the port's engine (dequant default) gives the
    default JAX engine's greedy tokens; the kernel switch changes the
    function (K5 quantizes activations), so it is held to the engine's
    own invariants only."""
    prompts = _prompts(4)
    tree = random_param_tree(tiny_config(tcfg).model, seed=3)
    jc, tc = tiny_config(jcfg), tiny_config(tcfg)
    jc.quant.method = tc.quant.method = method
    assert _port_tokens(tc, tree, prompts, 6) == _jax_tokens(jc, tree, prompts, 6)


@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    """The JAX engine through its split-layout Pallas kernels in interpret
    mode: ``_use_pallas`` says yes and each kernel gets interpret=True.
    -> {kernel name: calls traced}."""
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
    return traced


@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
def test_quantized_kv_greedy_matches_jax_kernels(kv, jax_pallas_interpret):
    """int8 / fp8 KV (head_dim 128, block 16): the port's engine vs the JAX
    engine through its Pallas kernels (interpret mode), which attend to a
    decode step's new row as given and round P to bf16, as the port does."""
    prompts = _prompts(4)
    tree = random_param_tree(tiny_config(tcfg, 128).model, seed=11)
    jc, tc = tiny_config(jcfg, 128, kv_cache_dtype=kv), tiny_config(tcfg, 128, kv_cache_dtype=kv)
    assert _port_tokens(tc, tree, prompts, 6) == _jax_tokens(jc, tree, prompts, 6)
    assert {"paged_decode_attention_write_v9_tpu",
            "paged_attention_prefill_batched_tpu"} <= set(jax_pallas_interpret)


def test_set_kv_scales_int8_only():
    cfg = tiny_config(tcfg, kv_cache_dtype="int8")
    eng = _port_engine(cfg, random_param_tree(cfg.model, seed=1))
    s = np.full((2, 2), 0.05, np.float32)
    eng.runner.set_kv_scales(s, s * 2)
    assert torch.equal(eng.runner.model.kv_scales[1], torch.full((2, 2), 0.1))
    eng.add_request(prompt_token_ids=[1, 2, 3], sampling_params=TSP(max_tokens=3,
                                                                   ignore_eos=True))
    assert len(eng.generate_all()[0].outputs[0].token_ids) == 3
    plain = _port_engine(tiny_config(tcfg), random_param_tree(cfg.model, seed=1))
    with pytest.raises(ValueError, match="int8-KV"):
        plain.runner.set_kv_scales(s, s)


@pytest.fixture
def jax_qmm_interpret(monkeypatch):
    """The JAX decoder's quantized products (its layer scan takes the
    stacked form) through the Pallas kernels the switch selects on a TPU
    (int8: ``quant_matmul_int8_v2_stacked``, fp8:
    ``quant_matmul_fp8_stacked``), in interpret mode. -> traced calls."""
    traced = []

    def pallas(x, w_q, scale, layer_idx):
        traced.append(w_q.dtype)
        fn = (jqmm.quant_matmul_int8_v2_stacked if w_q.dtype == jnp.int8
              else jqmm.quant_matmul_fp8_stacked)
        return fn(x, w_q, scale, layer_idx, interpret=True)

    monkeypatch.setattr(jquant, "quant_matmul_stacked", pallas)
    return traced


@pytest.mark.parametrize("method", ["int8", "fp8_e4m3"])
def test_kernel_switch_greedy_matches_jax_kernels(method, jax_qmm_interpret, monkeypatch):
    """``XLLM_QMM_KERNEL=pallas`` on the CPU (the K5 / K6 plain versions)
    against the JAX engine through the Pallas kernels it selects."""
    monkeypatch.setenv("XLLM_QMM_KERNEL", "pallas")
    prompts = _prompts(3)
    tree = random_param_tree(tiny_config(tcfg).model, seed=4)
    jc, tc = tiny_config(jcfg), tiny_config(tcfg)
    jc.quant.method = tc.quant.method = method
    assert _port_tokens(tc, tree, prompts, 5) == _jax_tokens(jc, tree, prompts, 5)
    assert jax_qmm_interpret, "the JAX engine did not reach the Pallas kernels"


@pytest.mark.parametrize("switch", ["pallas", "stacked"])
def test_bf16_switch_routes_to_k7(switch, monkeypatch):
    """``XLLM_BF16_MM`` sends bf16 products of at most 256 rows to K7 (its
    plain version here) and leaves longer ones to PyTorch's product."""
    from xllm_tpu_torch.models.decoder import DenseDecoderModel

    cfg = tiny_config(tcfg).model
    cfg.dtype = "bfloat16"
    model = DenseDecoderModel(cfg)
    model.init_random_(0)
    lp = model.layers[0]
    calls = []
    monkeypatch.setattr(tqmm, "_PLAIN", dict(
        tqmm._PLAIN, **{tqmm.BF16_NAME: lambda x, w, s: calls.append(x.shape[0])
                        or tqmm.matmul_bf16_plain(x, w)}))
    monkeypatch.setenv("XLLM_BF16_MM", switch)
    for rows in (16, 256, 257):
        x = torch.randn(rows, cfg.hidden_size).bfloat16()
        got = model._linear(lp, "gate_proj_w", x)
        want = torch.mm(x.float(), lp.gate_proj_w.float())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert calls == [16, 256]
