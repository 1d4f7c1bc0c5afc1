"""K5 (w8a8) on s8 wgmma: its plan, its split arithmetic and its activation
quantizer, on the CPU.

``xllm_tpu_torch/ops/cuda/quant_matmul.int8_plan`` picks the tokens a tile
and the split of K of ``csrc/quant_matmul.cu`` ``qmm_s8_kernel``; a split
launch sums int32 partials in split order, then scales. Here:

- the plan at Qwen3-8B's, qwen3-1.7B's and DeepSeek-V2-Lite's projections
  at 1-4,096 rows: ranges that cover [0, K) in order in whole stages, a
  grid of at most the SMs, a split of down at a decode step;
- the split model (``int8_split_model``) equal to ``quant_matmul_int8_plain``
  bit for bit under forced plans at small shapes;
- the port's K5 (the plain versions on the CPU) and its quantizer against
  JAX's Pallas K5 in interpret mode and its quantization, bit for bit, on x
  made of ties (x / sx at half integers), zero rows, signed zeros and the
  row maximum, bf16 and f32, a stacked call on the last layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xllm_tpu.ops.pallas.quant_matmul as jqmm
from xllm_tpu.ops import quant as jquant
from xllm_tpu_torch.ops.cuda import quant_matmul as tqmm
from xllm_tpu_torch.weights import as_tensor
from torch_threads import one_torch_thread  # noqa: F401

# (projection, K, N) of each model's int8 linear layers
PROJ = {
    "Qwen3-8B": [("qkv", 4096, 6144), ("o", 4096, 4096), ("gate", 4096, 12288),
                 ("up", 4096, 12288), ("down", 12288, 4096)],
    "qwen3-1.7B": [("qkv", 2048, 4096), ("o", 2048, 2048), ("gate", 2048, 6144),
                   ("up", 2048, 6144), ("down", 6144, 2048)],
    "DeepSeek-V2-Lite": [("q", 2048, 3072), ("kv_a", 2048, 576), ("o", 2048, 2048),
                         ("gate", 2048, 10944), ("down", 10944, 2048),
                         ("shared_gate", 2048, 2816), ("shared_down", 2816, 2048)],
}
ROWS = (1, 5, 16, 17, 52, 64, 65, 192, 512, 2048, 4096)


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", list(PROJ))
def test_int8_plan_covers_k_in_stages(model):
    for proj, k, n in PROJ[model]:
        for m in ROWS:
            p = tqmm.int8_plan(m, k, n)
            what = f"{model} {proj} M {m}: {p}"
            assert p.bk == tqmm.S8_BK and p.bn == tqmm.S8_BN and p.bm in tqmm.S8_ROWS, what
            assert p.bm == 16 if m <= 16 else p.bm == 64 if m <= 64 else p.bm > 64, what
            assert p.path == ("decode" if p.bm <= 64 else "prefill"), what
            assert len(p.ranges) == p.splits >= 1, what
            assert p.ranges[0][0] == 0 and p.ranges[-1][1] == k, what
            for (_, a1), (b0, _) in zip(p.ranges, p.ranges[1:]):
                assert a1 == b0, what
            for a0, a1 in p.ranges:
                assert a0 < a1 and a0 % p.bk == 0 and (a1 % p.bk == 0 or a1 == k), what
                if p.splits > 1:
                    assert -(-(a1 - a0) // p.bk) >= tqmm.S8_MIN_SPLIT_STAGES, what
            assert p.tiles == -(-m // p.bm) * -(-n // p.bn), what
            assert p.units == p.tiles * p.splits and p.grid == min(p.units, tqmm.SMS), what
            # a split only where the tiles fill less than half the SMs
            assert p.splits == 1 or 2 * p.units <= tqmm.SMS, what


@pytest.mark.parametrize("m,k,n,bt,splits", [
    # Qwen3-8B at a decode step: down and o (32 tiles of 128 columns)
    # split two ways, qkv (48 tiles) and gate / up (96) not at all
    (16, 12288, 4096, 16, 2), (16, 4096, 4096, 16, 2), (16, 4096, 6144, 16, 1),
    (16, 4096, 12288, 16, 1),
    # the 64-token bucket keeps the decode splits on 64-token tiles;
    # qwen3-1.7B's o (16 tiles, 16 stages) splits as far as 4 stages a split
    (64, 12288, 4096, 64, 2), (16, 2048, 2048, 16, 4),
    # prefill chunks fill the card without a split
    (2048, 4096, 6144, 256, 1), (2048, 12288, 4096, 256, 1), (512, 4096, 12288, 128, 1),
])
def test_int8_plan_picks(m, k, n, bt, splits):
    p = tqmm.int8_plan(m, k, n)
    assert (p.bm, p.splits) == (bt, splits)


def test_int8_plan_rejects():
    with pytest.raises(ValueError):
        tqmm.int8_plan(16, 4100, 4096)
    with pytest.raises(ValueError):
        tqmm.int8_plan(0, 4096, 4096)
    with pytest.raises(ValueError):
        tqmm.int8_layout(16, 400, 144, 5, 16)  # 5 splits of 4 stages
    with pytest.raises(ValueError):
        tqmm.int8_layout(16, 400, 144, 1, 32)


# ---------------------------------------------------------------------------
# edge inputs: ties, zero rows, signed zeros, the row maximum
# ---------------------------------------------------------------------------
def edge_x(m, k, x_dtype, seed):
    """Rows cycling through four kinds (as ``chip_smoke.int8_edge_x``):
    row maximum 127 2^e (sx = 2^e exactly) with (j + 1/2) 2^e elsewhere,
    exact ties, and -127 2^e; random values with +0 and -0 among them;
    zeros; random values scaled by 2^(i % 7 - 3). Exact in bf16."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    for i in range(m):
        e = np.float32(2.0 ** (i % 5 - 2))
        kind = i % 4
        if kind == 0:
            x[i] = (rng.integers(-127, 127, k) + 0.5).astype(np.float32) * e
            x[i, 0], x[i, -1] = 127 * e, -127 * e
        elif kind == 1:
            zero = rng.random(k) < 0.3
            x[i, zero] = np.where(x[i, zero] > 0, np.float32(0.0), np.float32(-0.0))
        elif kind == 2:
            x[i] = 0.0
        else:
            x[i] *= np.float32(2.0 ** (i % 7 - 3))
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return x, torch.from_numpy(x).to(getattr(torch, x_dtype)), jnp.asarray(x).astype(
        getattr(jnp, x_dtype))


@jax.jit
def jax_quantize(x):
    """The JAX package's per-token quantization of K5's x, as its three
    Pallas functions run it before ``pallas_call`` (under jit)."""
    sx = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=1, keepdims=True) / 127.0
    sx = jnp.maximum(sx, 1e-10)
    return jnp.clip(jnp.round(x.astype(jnp.float32) / sx), -127, 127).astype(jnp.int8), sx


def test_edge_x_holds_every_case():
    x, tx, _ = edge_x(8, 256, "float32", 0)
    xq, sx = tqmm.quantize_activations(tx)
    assert (xq[0, 0], xq[0, -1]) == (127, -127)  # the row maximum
    assert ((x[0] / sx[0].item()) % 1 == 0.5).sum() >= 250  # ties
    assert (np.signbit(x[1]) & (x[1] == 0)).any() and (~np.signbit(x[1]) & (x[1] == 0)).any()
    assert (xq[2] == 0).all() and sx[2].item() == np.float32(1e-10)  # a zero row


# ---------------------------------------------------------------------------
# (b) the split model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,bt,splits", [
    (5, 400, 144, 16, 3), (24, 2064, 272, 64, 5), (130, 400, 384, 128, 2),
    (300, 1040, 256, 256, 4),
])
def test_int8_split_model_matches_plain(m, k, n, bt, splits, x_dtype):
    """Forced plans: part-filled token and column tiles, a last stage
    shorter than 128, 2-5 splits."""
    rng = np.random.default_rng(m)
    _, tx, _ = edge_x(m, k, x_dtype, m)
    w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    s = torch.from_numpy((rng.random(n) + 0.5).astype(np.float32) * 1e-3)
    p = tqmm.int8_layout(m, k, n, splits, bt)
    assert p.splits == splits and p.ranges[-1][1] == k and p.tiles == -(-m // bt) * -(-n // 128)
    got = tqmm.int8_split_model(tx, w, s, p)
    want = tqmm.quant_matmul_int8_plain(tx, w, s)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert torch.equal(got, want)


def test_int8_split_model_sums_int32_in_split_order():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(7, 640, generator=g)
    w = torch.randint(-127, 128, (640, 32), generator=g, dtype=torch.int8)
    s = torch.rand(32, generator=g) + 0.5
    p = tqmm.int8_layout(7, 640, 32, 3, 16)
    assert p.ranges == ((0, 128), (128, 384), (384, 640))  # stages i 5 // 3
    xq, sx = tqmm.quantize_activations(x)
    parts = [torch.mm(xq[:, a:b].int(), w[a:b].int()) for a, b in p.ranges]
    assert all(pt.dtype == torch.int32 for pt in parts)
    want = (((parts[0] + parts[1]) + parts[2]).float() * sx) * s[None, :]
    assert torch.equal(tqmm.int8_split_model(x, w, s, p), want)


# ---------------------------------------------------------------------------
# (c) against JAX's Pallas K5 (interpret mode) and its quantization
# ---------------------------------------------------------------------------
M, K, N, NL = 12, 256, 384, 3
JAX_K5 = {
    "quant_matmul_int8": lambda jx, wq, s, li: jqmm.quant_matmul_int8(
        jx, wq[li], s[li], interpret=True),
    "quant_matmul_int8_v2": lambda jx, wq, s, li: jqmm.quant_matmul_int8_v2(
        jx, wq[li], s[li], interpret=True),
    "quant_matmul_int8_v2_stacked": lambda jx, wq, s, li: jqmm.quant_matmul_int8_v2_stacked(
        jx, wq, s, jnp.int32(li), interpret=True),
}


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", list(JAX_K5))
def test_k5_matches_pallas_on_edges(fn, x_dtype):
    rng = np.random.default_rng(3)
    _, tx, jx = edge_x(M, K, x_dtype, 5)
    w = (rng.standard_normal((NL, K, N)) * 0.05).astype(np.float32)
    wq, s = jax.jit(jquant.quantize_int8)(jnp.asarray(w))
    li = NL - 1  # the last layer: a stacked call's offset
    want = np.asarray(JAX_K5[fn](jx, wq, s, li))
    twq, ts = as_tensor(np.asarray(wq)), as_tensor(np.asarray(s))
    got = (tqmm.quant_matmul_int8_stacked(tx, twq, ts, li) if fn.endswith("stacked")
           else tqmm.quant_matmul_int8(tx, twq[li], ts[li]))
    np.testing.assert_array_equal(got.numpy(), want)
    for p in (tqmm.int8_plan(M, K, N), tqmm.int8_layout(M, K, N, 2, 16),
              tqmm.int8_layout(M, K, N, 1, 64)):
        np.testing.assert_array_equal(tqmm.int8_split_model(tx, twq[li], ts[li], p).numpy(),
                                      want)
    # the quantizer's codes and scales byte-equal to JAX's
    jq, js = jax_quantize(jx)
    xq, sx = tqmm.quantize_rows(tx)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sx.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
