"""K6 / K7's launch plan and split arithmetic, on the CPU.

``xllm_tpu_torch/ops/cuda/quant_matmul.plan`` picks the row tile and the
split of K of the warp-specialised kernel (``csrc/quant_matmul.cu``); the
kernel sums each split's f32 partial in split order and scales once.
Here:

- the plan at every engine and timed shape of K6 (Qwen3-8B fp8 under
  ``XLLM_QMM_KERNEL=pallas``: 16, 64, 512 and 2048 rows) and K7 (qwen3-1.7B
  under ``XLLM_BF16_MM=pallas``: 16, 64 and 256 rows; Qwen3-8B at 16 and
  2048): ranges that cover [0, K) in order in whole stages;
- the split model (``split_model``: per-split f32 products summed in the
  kernel's order, then scaled) against the plain versions and the Pallas
  functions in interpret mode, within ``QMM_TOL``, at small shapes that
  split, with part-filled row tiles and bf16 and f32 x;
- the routes to K6 and K7 in the dense decoder.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xllm_tpu.ops.pallas.quant_matmul as jqmm
import xllm_tpu_torch.config as tcfg
from xllm_tpu.ops import quant as jquant
from xllm_tpu_torch.ops import quant as tquant
from xllm_tpu_torch.ops.cuda import quant_matmul as tqmm
from xllm_tpu_torch.weights import as_tensor
from torch_threads import one_torch_thread  # noqa: F401

KINDS = ("bf16", "fp8_e4m3")
PROJ_1P7B = [("qkv", 2048, 4096), ("o", 2048, 2048), ("gate_up", 2048, 6144),
             ("down", 6144, 2048)]
PROJ_8B = [("qkv", 4096, 6144), ("o", 4096, 4096), ("gate_up", 4096, 12288),
           ("down", 12288, 4096)]
# (model, projection, K, N, rows): every engine and timed shape of K6 / K7
SHAPES = ([("qwen3-1.7B", p, k, n, m) for m in (16, 64, 256) for p, k, n in PROJ_1P7B]
          + [("Qwen3-8B", p, k, n, m) for m in (16, 64, 512, 2048) for p, k, n in PROJ_8B])


def _ids(shape):
    return f"{shape[0]}-{shape[1]}-M{shape[4]}"


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_plan_covers_k_in_stages(shape):
    _, _, k, n, m = shape
    plans = {kind: tqmm.plan(m, k, n, kind) for kind in KINDS}
    for kind, p in plans.items():
        assert p.bk == tqmm.WS_BK and p.bn == tqmm.WS_BN and p.bm in tqmm.WS_ROWS
        assert p.path == ("decode" if p.bm == 64 else "prefill")
        assert m > 64 or p.bm == 64
        assert len(p.ranges) == p.splits >= 1
        # in order, contiguous, from 0 to K, every boundary a whole stage
        assert p.ranges[0][0] == 0 and p.ranges[-1][1] == k
        for (a0, a1), (b0, _) in zip(p.ranges, p.ranges[1:]):
            assert a1 == b0
        for a0, a1 in p.ranges:
            assert a0 < a1 and a0 % p.bk == 0 and (a1 % p.bk == 0 or a1 == k)
            if p.splits > 1:
                assert -(-(a1 - a0) // p.bk) >= tqmm.MIN_SPLIT_STAGES
        assert p.tiles == -(-m // p.bm) * -(-n // p.bn)
        assert p.units == p.tiles * p.splits
        assert p.grid == min(p.units, tqmm.SMS)
    # both kinds pick the same row tile, except that e4m3 weights take
    # 64-row tiles only up to 64 rows (each tile upcasts its own copy of
    # the weight); the e4m3 stream splits its decode tiles (the upcast
    # bounds a block), and splits wherever the bf16 one does at one tile
    bf, f8 = plans["bf16"], plans["fp8_e4m3"]
    assert bf.bm == f8.bm or (m > 64 and bf.bm == 64 and f8.bm > 64)
    if bf.bm == f8.bm:
        assert (bf.path, bf.tiles) == (f8.path, f8.tiles) and f8.splits >= bf.splits
    if m <= 64:
        assert f8.splits == min(tqmm.SPLITS, -(-k // tqmm.WS_BK) // tqmm.MIN_SPLIT_STAGES)


@pytest.mark.parametrize("m,k,n,want", [
    # few tiles: split (qwen3-1.7B o and down at decode: 16 tiles)
    (16, 2048, 2048, 4), (16, 6144, 2048, 4),
    # enough tiles, short K: one unit a tile (qkv, gate_up)
    (16, 2048, 4096, 1), (16, 2048, 6144, 1), (256, 2048, 4096, 1),
    # up to 32 tiles with a long K: split (Qwen3-8B o / down at decode)
    (16, 4096, 4096, 4), (16, 12288, 4096, 4),
    # qwen3-1.7B down at 256 rows: 64 tiles of 64 rows, unsplit
    (256, 6144, 2048, 1),
    # prefill chunks fill the card without a split
    (2048, 4096, 6144, 1), (512, 12288, 4096, 1),
])
def test_plan_splits_bf16(m, k, n, want):
    assert tqmm.plan(m, k, n, "bf16").splits == want


@pytest.mark.parametrize("m,n,bm,bm_e4m3", [
    (16, 4096, 64, 64), (64, 4096, 64, 64),
    # the row tile whose (weighted) waves over the SMs cost least: one wave
    # of 64-row tiles at qwen3-1.7B's qkv / o / down at 256 rows, 128 for
    # its gate / up, 256 where its waves are few enough; e4m3 weights keep
    # 128 rows above 64 (each 64-row tile would upcast its own copy)
    (65, 4096, 64, 128), (256, 4096, 64, 128), (256, 2048, 64, 128), (256, 6144, 128, 128),
    (2048, 6144, 256, 256), (2048, 4096, 256, 256), (512, 6144, 256, 256),
    (512, 4096, 128, 128), (512, 12288, 128, 128),
])
def test_plan_row_tile(m, n, bm, bm_e4m3):
    assert tqmm.plan(m, 4096, n, "bf16").bm == bm
    assert tqmm.plan(m, 4096, n, "fp8_e4m3").bm == bm_e4m3


def test_plan_rejects():
    with pytest.raises(ValueError):
        tqmm.plan(16, 4096, 4096, "int8")
    with pytest.raises(ValueError):
        tqmm.plan(16, 4100, 4096, "bf16")
    with pytest.raises(ValueError):
        tqmm.layout(16, 320, 144, 6, 64)  # 6 splits of 5 stages
    with pytest.raises(ValueError):
        tqmm.layout(16, 320, 144, 1, 32)


# ---------------------------------------------------------------------------
# (b) the split model against the plain versions and the Pallas functions
# ---------------------------------------------------------------------------
K, N, NL = 320, 144, 3  # five stages, a part-filled column tile


def _inputs(m, x_dtype, kind, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, K)) * 0.5).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(getattr(jnp, x_dtype)).astype(jnp.float32))
    w = (rng.standard_normal((NL, K, N)) * 0.05).astype(np.float32)
    if kind == "bf16":
        return x, jnp.asarray(w).astype(jnp.bfloat16), None
    wq, s = jquant.quantize_fp8(jnp.asarray(w))
    return x, wq, s


def _pallas(kind, jx, wq, s, li):
    """Every Pallas function of K6 / K7 at layer ``li`` (interpret mode)."""
    if kind == "bf16":
        return {
            "matmul_bf16_v2": jqmm.matmul_bf16_v2(jx, wq[li], interpret=True),
            "matmul_bf16_stacked": jqmm.matmul_bf16_stacked(jx, wq, jnp.int32(li),
                                                            interpret=True),
        }
    return {
        "quant_matmul_fp8": jqmm.quant_matmul_fp8(jx, wq[li], s[li], interpret=True),
        "quant_matmul_fp8_v2": jqmm.quant_matmul_fp8_v2(jx, wq[li], s[li], interpret=True),
        "quant_matmul_fp8_v2_stacked": jqmm.quant_matmul_fp8_v2_stacked(
            jx, wq, s, jnp.int32(li), interpret=True),
        "quant_matmul_fp8_stacked": jqmm.quant_matmul_fp8_stacked(
            jx, wq, s, jnp.int32(li), interpret=True),
    }


def _within_qmm_tol(got, want, x, w_abs, s):
    """QMM_TOL: |out - ref| <= K 2^-24 (|x| @ |w|) |s| + 1e-6."""
    lim = np.abs(x.astype(np.float32)) @ w_abs
    if s is not None:
        lim = lim * np.abs(s)
    lim = lim * K * 2.0 ** -24 + 1e-6
    err = np.abs(got - want)
    assert (err <= lim).all(), f"max err {err.max()}, {(err / lim).max():.3g} x the bound"


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [5, 16, 52, 64, 130])
@pytest.mark.parametrize("kind", KINDS)
def test_split_model_matches_plain_and_pallas(kind, m, x_dtype):
    x, wq, s = _inputs(m, x_dtype, kind, seed=m)
    li = NL - 1  # the last layer: a stacked call's offset
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    tw = as_tensor(np.ascontiguousarray(wq[li]))
    ts = None if s is None else as_tensor(np.ascontiguousarray(s[li]))
    plain = (tqmm.matmul_bf16_plain(tx, tw) if kind == "bf16"
             else tqmm.quant_matmul_fp8_plain(tx, tw, ts)).numpy()
    want = {name: np.asarray(v) for name, v in
            _pallas(kind, jnp.asarray(x).astype(getattr(jnp, x_dtype)), wq, s, li).items()}
    w_abs = np.abs(np.asarray(wq[li].astype(jnp.float32)))
    s_np = None if s is None else np.asarray(s[li])
    bm = 64 if m <= 64 else 128
    for splits in (1, 2, 3, 5):
        p = tqmm.layout(m, K, N, splits, bm)
        got = tqmm.split_model(tx, tw, ts, p).numpy()
        assert got.shape == (m, N) and got.dtype == np.float32
        _within_qmm_tol(got, plain, x, w_abs, s_np)
        for name, ref in want.items():
            _within_qmm_tol(got, ref, x, w_abs, s_np)
    # the wrapper's plan on these shapes is one of those
    assert tqmm.plan(m, K, N, kind).splits in (1, 2, 3, 5)


def test_split_model_sums_in_split_order():
    """Each split's partial product, summed first to last, then scaled:
    the kernel's order, whatever block finishes last."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(7, 448, generator=g).bfloat16()
    w = (torch.randn(448, 32, generator=g) * 0.05).bfloat16()
    s = torch.rand(32, generator=g) + 0.5
    p = tqmm.layout(7, 448, 32, 3, 64)
    assert p.ranges == ((0, 128), (128, 256), (256, 448))
    parts = [torch.mm(x[:, a:b].float(), w[a:b].float()) for a, b in p.ranges]
    want = ((parts[0] + parts[1]) + parts[2]) * s[None, :]
    assert torch.equal(tqmm.split_model(x, w, s, p), want)


# ---------------------------------------------------------------------------
# (c) the routes to K6 and K7
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("switch", ["pallas", "stacked"])
def test_k7_route_rows(switch, monkeypatch):
    """Under both ``XLLM_BF16_MM`` values the dense decoder sends bf16
    products of 16, 64 and 256 rows (decode, the 64 bucket, the ceiling) to
    K7 (its plain version on the CPU) and 257 or 512 rows to PyTorch."""
    from xllm_tpu_torch.models.decoder import DenseDecoderModel

    cfg = tcfg.ModelConfig(
        model_type="qwen3", dtype="bfloat16", vocab_size=97, hidden_size=64,
        intermediate_size=128, num_hidden_layers=1, num_attention_heads=4,
        num_key_value_heads=2, head_dim=16, qk_norm=True, max_position_embeddings=128)
    model = DenseDecoderModel(cfg)
    model.init_random_(0)
    lp = model.layers[0]
    calls = []
    monkeypatch.setattr(tqmm, "_PLAIN", dict(
        tqmm._PLAIN, **{tqmm.BF16_NAME: lambda x, w, s: calls.append(x.shape[0])
                        or tqmm.matmul_bf16_plain(x, w)}))
    monkeypatch.setenv("XLLM_BF16_MM", switch)
    for rows in (16, 64, 256, 257, 512):
        x = torch.randn(rows, cfg.hidden_size).bfloat16()
        for name in ("o_proj_w", "down_proj_w"):
            w = getattr(lp, name)
            if w.shape[0] != cfg.hidden_size:
                continue
            got = model._linear(lp, name, x)
            torch.testing.assert_close(got, torch.mm(x.float(), w.float()),
                                       rtol=1e-5, atol=1e-5)
    assert sorted(set(calls)) == [16, 64, 256]


@pytest.mark.parametrize("rows", [16, 64, 512, 2048])
def test_k6_route_every_pass_size(rows, monkeypatch):
    """``XLLM_QMM_KERNEL=pallas`` sends every fp8 product to K6 (the plain
    version on the CPU), stacked or not; without it the dequant default
    runs and K6 is not called."""
    rng = np.random.default_rng(rows)
    w = jnp.asarray((rng.standard_normal((2, 64, 48)) * 0.05).astype(np.float32))
    wq, s = jquant.quantize_fp8(w)
    twq, ts = as_tensor(np.asarray(wq)), as_tensor(np.asarray(s))
    x = torch.from_numpy(rng.standard_normal((rows, 64)).astype(np.float32))
    calls = []
    monkeypatch.setattr(tqmm, "_PLAIN", dict(
        tqmm._PLAIN, **{tqmm.FP8_NAME: lambda x, w, s: calls.append(x.shape[0])
                        or tqmm.quant_matmul_fp8_plain(x, w, s)}))
    monkeypatch.delenv("XLLM_QMM_KERNEL", raising=False)
    tquant.quant_matmul(x, twq[1], ts[1])
    assert calls == []
    monkeypatch.setenv("XLLM_QMM_KERNEL", "pallas")
    got = tquant.quant_matmul(x, twq[1], ts[1])
    got_st = tquant.quant_matmul_stacked(x, twq, ts, 1)
    assert calls == [rows, rows]
    assert torch.equal(got, got_st)
    assert torch.equal(got, tqmm.quant_matmul_fp8_plain(x, twq[1], ts[1]))
