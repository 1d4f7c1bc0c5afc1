"""Where the attention kernels round P: the port's plain versions against the
JAX package's Pallas kernels in interpret mode.

The TPU kernels cast the unnormalised probabilities P of each step of their
walk to the dtype of the V tile (bf16 for bf16, int8 and fp8 caches) against
the running maximum at that point: after each page for the prefill kernels
(K3, K3b) and the latent kernels (K11a, K11b, K11e), after each tile of 4
pages for the decode kernel (K1, v9), whose softmax opens at the new token.
Each case below was a fault of the port (ROADMAP faults F1-F4):

- F1: K1, K3 and K3b kept P in f32 on a bf16 cache;
- F2: the K11 plain versions rounded the normalised P;
- F3: K1 on an int8 / fp8 cache rounded against its own context splits'
  maxima;
- F4: K3 / K3b on an int8 / fp8 cache took a maximum every 64 positions, not
  every page, at block_size 128.

A rounding of P to bf16 is discontinuous, so an ulp of difference in a score
can move a P by one bf16 ulp. XLA's CPU dot and PyTorch's sum in different
orders, so the inputs here make every score exact in f32 whatever the order
(q and K on a grid of 2^-6 or 2^-3, integer int8 / fp8 values): the tests
pin the maximum that P is rounded against, not the order of a dot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_tpu.ops.pallas import decode_attention as jdecode
from xllm_tpu.ops.pallas import mla_attention as jmla
from xllm_tpu.ops.pallas import prefill_attention as jprefill
from xllm_tpu_torch.ops.cuda.decode_attention import paged_decode_attention_write_plain
from xllm_tpu_torch.ops.cuda.mla_attention import (
    mla_decode_attention_write_plain,
    mla_prefill_attention_batched_plain,
    mla_prefill_attention_plain,
)
from xllm_tpu_torch.ops.cuda.prefill_attention import (
    paged_attention_prefill_batched_plain,
    paged_attention_prefill_plain,
)
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platforms", "cpu")

D = 128
BF16_RTOL = 2.0 ** -7  # one bf16 ulp of the result
ATOL = 1e-5
QUANT_ATOL = 1e-4  # int8 / fp8 caches, f32 q


def _grid(rng, shape, step, lim):
    """Values on a grid of ``step`` within [-lim, lim] (exact in bf16)."""
    n = int(lim / step)
    return (rng.integers(-n, n + 1, shape) * step).astype(np.float32)


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    return jx, tx


def _cache(rng, kind: str, shape):
    """A cache of ``kind`` (bf16, int8 or fp8_e4m3) with values on a grid:
    (jax array, torch tensor)."""
    if kind == "bf16":
        return _pair(_grid(rng, shape, 2.0 ** -3, 3.0), "bfloat16")
    x = rng.integers(-16, 17, shape)  # integers up to 16 are exact in e4m3
    if kind == "int8":
        return jnp.asarray(x, jnp.int8), torch.from_numpy(x.astype(np.int8))
    jx = jnp.asarray(x, jnp.float8_e4m3fn)
    raw = np.asarray(jx).view(np.uint8)
    return jx, torch.from_numpy(raw.copy()).view(torch.float8_e4m3fn)


def _tables(lens, bs, nbmax):
    """Disjoint pages per sequence (block 0 is the null block)."""
    bt = np.zeros((len(lens), nbmax), np.int32)
    nxt = 1
    for i, n in enumerate(lens):
        for j in range(-(-n // bs)):
            bt[i, j] = nxt
            nxt += 1
    return bt, nxt


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_within(got, want, atol, rtol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    excess = np.abs(got - want) - (atol + rtol * np.abs(want))
    assert (excess <= 0).all(), (np.abs(got - want).max(), (excess > 0).mean())


# ---------------------------------------------------------------------------
# K1 (v9): F1 on a bf16 cache, F3 on int8 / fp8 caches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,bs,window", [
    ("bf16", 16, 0),  # F1
    ("int8", 16, 0), ("int8", 64, 0), ("fp8_e4m3", 16, 0), ("fp8_e4m3", 64, 0),  # F3
    ("int8", 16, 37),  # F3, a sliding window: v9's tiles do not move
])
def test_decode_rounds_p_as_v9(kind, bs, window):
    rng = np.random.default_rng(11)
    if kind == "bf16":
        hq, hkv, lens = 8, 2, [30, 45, 60, 75, 90, 100, 110, 120]
    else:  # f32 q; 2-9 pages plus a tail
        hq, hkv = 4, 2
        lens = [2 * bs + 5, 5 * bs + 1, 9 * bs + bs // 2, 3 * bs]
    nbmax = max(-(-n // bs) for n in lens) + 1
    bt, nb = _tables(lens, bs, nbmax)
    kc, kt = _cache(rng, kind, (2, nb, hkv, bs, D))
    vc, vt = _cache(rng, kind, (2, nb, hkv, bs, D))
    b = len(lens)
    if kind == "bf16":
        jq, tq = _pair(_grid(rng, (b, hq, D), 2.0 ** -3, 3.0), "bfloat16")
        jkn, tkn = _pair(_grid(rng, (b, hkv, D), 2.0 ** -3, 3.0), "bfloat16")
        jvn, tvn = _pair(rng.standard_normal((b, hkv, D)).astype(np.float32), "bfloat16")
    else:
        jq, tq = _pair(_grid(rng, (b, hq, D), 2.0 ** -6, 0.25), "float32")
        new = rng.integers(-16, 17, (2, b, hkv, D))
        if kind == "int8":
            (jkn, jvn), (tkn, tvn) = zip(*[(jnp.asarray(x, jnp.int8),
                                            torch.from_numpy(x.astype(np.int8))) for x in new])
        else:
            (jkn, jvn), (tkn, tvn) = zip(*[_pair(x.astype(np.float32), "float32") for x in new])
    sl = np.asarray(lens, np.int32)
    sm = np.asarray([bt[i, (n - 1) // bs] * bs + (n - 1) % bs for i, n in enumerate(lens)],
                    np.int32)
    scale = D ** -0.5
    want, _, _ = jdecode.paged_decode_attention_write_v9_tpu(
        jq, jkn, jvn, kc, vc, jnp.int32(1), jnp.asarray(sm), jnp.asarray(bt),
        jnp.asarray(sl), scale, interpret=True, window=window)
    got = paged_decode_attention_write_plain(tq, tkn, tvn, kt.clone(), vt.clone(), 1, _t(sm),
                                             _t(bt), _t(sl), scale, window)
    want = np.asarray(want.astype(jnp.float32))
    if kind == "bf16":
        _assert_within(got.float().numpy(), want, ATOL, BF16_RTOL)
    else:
        _assert_within(got.numpy(), want, QUANT_ATOL, 0.0)


# ---------------------------------------------------------------------------
# K3 / K3b: F1 on a bf16 cache, F4 on int8 / fp8 caches at block_size 128
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,bs,single", [
    ("bf16", 16, False), ("bf16", 16, True),  # F1
    ("int8", 128, False), ("int8", 128, True), ("fp8_e4m3", 128, False),  # F4
])
def test_prefill_rounds_p_per_page(kind, bs, single):
    rng = np.random.default_rng(12)
    hq, hkv, s = 8, 2, 64
    # bf16: one 64-token chunk at q_offset 64; quantized: one 64-row chunk
    # ending at kv_len 3 * bs
    q_offset = 64 if kind == "bf16" else 3 * bs - s
    kv_len = q_offset + s
    nbmax = -(-kv_len // bs) + 1
    bt, nb = _tables([kv_len], bs, nbmax)
    kc, kt = _cache(rng, kind, (2, nb, hkv, bs, D))
    vc, vt = _cache(rng, kind, (2, nb, hkv, bs, D))
    if kind == "bf16":
        jq, tq = _pair(_grid(rng, (1, s, hq, D), 2.0 ** -3, 3.0), "bfloat16")
    else:
        jq, tq = _pair(_grid(rng, (1, s, hq, D), 2.0 ** -6, 0.5), "float32")
    scale = D ** -0.5
    if single:
        want = jprefill.paged_attention_prefill_tpu(
            jq[0], kc, vc, jnp.int32(1), jnp.asarray(bt[0]), jnp.int32(q_offset),
            jnp.int32(kv_len), scale, interpret=True)
        got = paged_attention_prefill_plain(tq[0], kt, vt, 1, _t(bt[0]),
                                            torch.tensor(q_offset, dtype=torch.int32),
                                            torch.tensor(kv_len, dtype=torch.int32), scale)
    else:
        want = jprefill.paged_attention_prefill_batched_tpu(
            jq, kc, vc, jnp.int32(1), jnp.asarray(bt), jnp.asarray([q_offset], jnp.int32),
            jnp.asarray([kv_len], jnp.int32), scale, interpret=True)
        got = paged_attention_prefill_batched_plain(
            tq, kt, vt, 1, _t(bt), torch.tensor([q_offset], dtype=torch.int32),
            torch.tensor([kv_len], dtype=torch.int32), scale)
    want = np.asarray(want.astype(jnp.float32))
    if kind == "bf16":
        _assert_within(got.float().numpy(), want, ATOL, BF16_RTOL)
    else:
        _assert_within(got.numpy(), want, QUANT_ATOL, 0.0)


# ---------------------------------------------------------------------------
# K11a / K11b / K11e on a bf16 latent cache: F2
# ---------------------------------------------------------------------------
MLA_H, MLA_DK, MLA_DV, MLA_BS = 8, 128, 64, 16
MLA_LENS = [30, 50, 70, 90, 110, 120]


def _mla_inputs(rng, lens):
    nbmax = max(-(-n // MLA_BS) for n in lens) + 1
    bt, nb = _tables(lens, MLA_BS, nbmax)
    cache = _cache(rng, "bf16", (2, nb, 1, MLA_BS, MLA_DK))
    return bt, cache


@pytest.mark.parametrize("which", ["decode", "prefill_batched", "prefill"])
def test_mla_rounds_p_per_page(which):
    rng = np.random.default_rng(13)
    scale = MLA_DK ** -0.5
    if which == "decode":
        bt, (jc, tc) = _mla_inputs(rng, MLA_LENS)
        b = len(MLA_LENS)
        jq, tq = _pair(_grid(rng, (b, MLA_H, MLA_DK), 2.0 ** -3, 3.0), "bfloat16")
        jl, tl = _pair(_grid(rng, (b, MLA_DK), 2.0 ** -3, 3.0), "bfloat16")
        sl = np.asarray(MLA_LENS, np.int32)
        sm = np.asarray([bt[i, (n - 1) // MLA_BS] * MLA_BS + (n - 1) % MLA_BS
                         for i, n in enumerate(MLA_LENS)], np.int32)
        want, _ = jmla.mla_decode_attention_write_tpu(
            jq, jl, jc, jnp.int32(1), jnp.asarray(sm), jnp.asarray(bt), jnp.asarray(sl),
            scale, MLA_DV, interpret=True)
        got = mla_decode_attention_write_plain(tq, tl, tc.clone(), 1, _t(sm), _t(bt),
                                               _t(sl), scale, MLA_DV)
        valid = np.s_[:]
    else:
        # chunks at q_offset > 0 (the second ends mid-page)
        rows = [(48, 64), (32, 50)]
        bt, (jc, tc) = _mla_inputs(rng, [a + n for a, n in rows])
        s = 64
        jq, tq = _pair(_grid(rng, (len(rows), s, MLA_H, MLA_DK), 2.0 ** -3, 3.0), "bfloat16")
        qo = np.asarray([a for a, _ in rows], np.int32)
        kl = np.asarray([a + n for a, n in rows], np.int32)
        if which == "prefill_batched":
            want = jmla.mla_prefill_attention_batched_tpu(
                jq, jc, jnp.int32(1), jnp.asarray(bt), jnp.asarray(qo), jnp.asarray(kl),
                scale, MLA_DV, interpret=True)
            got = mla_prefill_attention_batched_plain(tq, tc, 1, _t(bt), _t(qo), _t(kl),
                                                      scale, MLA_DV)
            valid = np.s_[1, :rows[1][1]]  # the chunk with bucket padding
            want, got = np.asarray(want.astype(jnp.float32)), got.float().numpy()
            _assert_within(got[0], want[0], ATOL, BF16_RTOL)
        else:
            want = jmla.mla_prefill_attention_tpu(
                jq[1], jc, jnp.int32(1), jnp.asarray(bt[1]), jnp.int32(qo[1]),
                jnp.int32(kl[1]), scale, MLA_DV, interpret=True)
            got = mla_prefill_attention_plain(tq[1], tc, 1, _t(bt[1]),
                                              torch.tensor(qo[1], dtype=torch.int32),
                                              torch.tensor(kl[1], dtype=torch.int32),
                                              scale, MLA_DV)
            valid = np.s_[:rows[1][1]]
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = torch.as_tensor(got).float().numpy()
    _assert_within(got[valid], want[valid], ATOL, BF16_RTOL)
