"""The port's plain ops (``xllm_tpu_torch.ops``) vs ``xllm_tpu.ops`` on the
CPU, on the same numpy inputs made from a seed.

Both sides compute in f32 at full matmul precision, so results agree to
1e-5 (summation order only; the trig of the rope tables to 1e-6). At this
head_dim (64) both packages run their portable attention path: padded rows
give the mean of V on both sides. Caches are compared outside block 0,
where the portable path scatters padded tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_tpu.ops import attention as jattn
from xllm_tpu.ops import attention_ref as jref
from xllm_tpu.ops import kv_cache_ops as jkv
from xllm_tpu.ops import norms as jnorms
from xllm_tpu.ops import rope as jrope
from xllm_tpu_torch.ops import attention as tattn
from xllm_tpu_torch.ops import attention_ref as tref
from xllm_tpu_torch.ops import kv_cache_ops as tkv
from xllm_tpu_torch.ops import norms as tnorms
from xllm_tpu_torch.ops import rope as trope
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
L, BS, D = 2, 16, 64


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        _np(tnorms.rms_norm(_t(x), _t(w), 1e-6)),
        _np(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        rtol=TOL, atol=TOL,
    )


@pytest.mark.parametrize(
    "scaling",
    [
        None,
        {"rope_type": "linear", "factor": 4.0},
        {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
         "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
        {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 64},
    ],
)
def test_rope(scaling):
    rng = np.random.default_rng(1)
    inv_t = trope.rope_inv_freq(64, 10000.0, scaling)
    inv_j = jrope.rope_inv_freq(64, 10000.0, scaling)
    np.testing.assert_allclose(_np(inv_t), _np(inv_j), rtol=1e-6)
    assert trope.rope_mscale(scaling) == pytest.approx(jrope.rope_mscale(scaling))
    q = rng.standard_normal((9, 4, 64)).astype(np.float32)
    k = rng.standard_normal((9, 2, 64)).astype(np.float32)
    pos = rng.integers(0, 4000, 9).astype(np.int32)
    qt, kt = trope.apply_rope(_t(q), _t(k), _t(pos), inv_t)
    qj, kj = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), inv_j)
    # angles up to 4000 rad: f32 sin/cos of two libraries agree to ~1e-6 x |angle|
    np.testing.assert_allclose(_np(qt), _np(qj), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(_np(kt), _np(kj), rtol=1e-3, atol=1e-3)
    # small positions: tight agreement
    pos = np.arange(9, dtype=np.int32)
    qt, _ = trope.apply_rope(_t(q), _t(k), _t(pos), inv_t)
    qj, _ = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), inv_j)
    np.testing.assert_allclose(_np(qt), _np(qj), rtol=TOL, atol=TOL)


def _cache(rng, nb, hkv):
    return (rng.standard_normal((L, nb, hkv, BS, D)).astype(np.float32),
            rng.standard_normal((L, nb, hkv, BS, D)).astype(np.float32))


def test_write_kv():
    rng = np.random.default_rng(2)
    k_all, v_all = _cache(rng, 8, 2)
    kn = rng.standard_normal((6, 2, D)).astype(np.float32)
    vn = rng.standard_normal((6, 2, D)).astype(np.float32)
    slots = np.asarray([17, 18, 0, 40, 100, 0], np.int32)  # 0: padded tokens
    kj, vj = jkv.write_kv(jnp.asarray(k_all), jnp.asarray(v_all), jnp.int32(1),
                          jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(slots))
    kt, vt = tkv.write_kv(_t(k_all.copy()), _t(v_all.copy()), 1, _t(kn), _t(vn), _t(slots))
    np.testing.assert_array_equal(_np(kt)[:, 1:], _np(kj)[:, 1:])
    np.testing.assert_array_equal(_np(vt)[:, 1:], _np(vj)[:, 1:])


def _tables(lens, nbmax):
    bt = np.zeros((len(lens), nbmax), np.int32)
    nxt = 1
    for i, n in enumerate(lens):
        for j in range(-(-max(n, 1) // BS)):
            bt[i, j] = nxt
            nxt += 1
    return bt


@pytest.mark.parametrize("window", [0, 20])
def test_decode_oracle_and_entry_point(window):
    rng = np.random.default_rng(3)
    hq, hkv, nbmax = 8, 2, 6
    lens = [18, 0, 16, 70, 1, 33]
    b = len(lens)
    k_all, v_all = _cache(rng, 40, hkv)
    q = rng.standard_normal((b, hq, D)).astype(np.float32)
    kn = rng.standard_normal((b, hkv, D)).astype(np.float32)
    vn = rng.standard_normal((b, hkv, D)).astype(np.float32)
    bt = _tables(lens, nbmax)
    slots = np.asarray(
        [bt[i, (n - 1) // BS] * BS + (n - 1) % BS if n else 0 for i, n in enumerate(lens)],
        np.int32)
    sl = np.asarray(lens, np.int32)
    scale = D**-0.5
    live = [i for i, n in enumerate(lens) if n]

    # the oracle alone: every row, padded ones included (mean of V there)
    np.testing.assert_allclose(
        _np(tref.paged_attention_decode_ref(_t(q), _t(k_all), _t(v_all), 1, _t(bt),
                                            _t(sl), scale, window)),
        _np(jref.paged_attention_decode_ref(jnp.asarray(q), jnp.asarray(k_all),
                                            jnp.asarray(v_all), jnp.int32(1),
                                            jnp.asarray(bt), jnp.asarray(sl), scale,
                                            window)),
        rtol=TOL, atol=TOL,
    )
    # the fused write + attend entry point
    oj, kj, vj = jattn.decode_attention_write(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(k_all),
        jnp.asarray(v_all), jnp.int32(1), jnp.asarray(slots), jnp.asarray(bt),
        jnp.asarray(sl), scale, window=window)
    ot, kt, vt = tattn.decode_attention_write(
        _t(q), _t(kn), _t(vn), _t(k_all.copy()), _t(v_all.copy()), 1, _t(slots),
        _t(bt), _t(sl), scale, window=window)
    assert lens[1] == 0 and 1 not in live
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=TOL, atol=TOL)  # padded rows too
    np.testing.assert_array_equal(_np(kt)[:, 1:], _np(kj)[:, 1:])
    np.testing.assert_array_equal(_np(vt)[:, 1:], _np(vj)[:, 1:])


@pytest.mark.parametrize(
    "s,specs,window",
    [
        # S > bs: the full-page writer (page-aligned chunk starts)
        (32, [(0, 32), (32, 64), (0, 18), (0, 0)], 0),
        (32, [(0, 32), (32, 64), (0, 18), (0, 0)], 24),
        # S <= bs: the RMW writer, chunks starting mid-page
        (8, [(17, 22), (14, 19), (0, 3), (0, 0)], 0),
    ],
)
def test_prefill_oracle_and_entry_point(s, specs, window):
    rng = np.random.default_rng(4)
    hq, hkv, nbmax = 4, 2, 8
    p = len(specs)
    k_all, v_all = _cache(rng, 48, hkv)
    q = rng.standard_normal((p, s, hq, D)).astype(np.float32)
    kn = rng.standard_normal((p, s, hkv, D)).astype(np.float32)
    vn = rng.standard_normal((p, s, hkv, D)).astype(np.float32)
    bt = _tables([kl for _, kl in specs], nbmax)
    qo = np.asarray([a for a, _ in specs], np.int32)
    kvl = np.asarray([b for _, b in specs], np.int32)
    slots = np.zeros((p, s), np.int32)  # padded tokens -> the null block
    for i, (a, b) in enumerate(specs):
        for r in range(b - a):
            slots[i, r] = bt[i, (a + r) // BS] * BS + (a + r) % BS
    scale = D**-0.5

    for i, (a, b) in enumerate(specs):  # the single-chunk oracle
        np.testing.assert_allclose(
            _np(tref.paged_attention_prefill_ref(_t(q[i]), _t(k_all), _t(v_all), 1,
                                                 _t(bt[i]), a, b, scale, window)),
            _np(jref.paged_attention_prefill_ref(
                jnp.asarray(q[i]), jnp.asarray(k_all), jnp.asarray(v_all),
                jnp.int32(1), jnp.asarray(bt[i]), jnp.int32(a), jnp.int32(b),
                scale, window)),
            rtol=TOL, atol=TOL)

    oj, kj, vj = jattn.prefill_attention_write_batched(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(k_all),
        jnp.asarray(v_all), jnp.int32(1), jnp.asarray(slots), jnp.asarray(bt),
        jnp.asarray(qo), jnp.asarray(kvl), scale, window=window)
    ot, kt, vt = tattn.prefill_attention_write_batched(
        _t(q), _t(kn), _t(vn), _t(k_all.copy()), _t(v_all.copy()), 1, _t(slots),
        _t(bt), _t(qo), _t(kvl), scale, window=window)
    # every row of the live chunks, bucket padding too (the portable path);
    # the padded chunk averages V over the null block, whose row 0 holds
    # whichever padded token either scatter wrote last
    live = kvl > 0
    np.testing.assert_allclose(_np(ot)[live], _np(oj)[live], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(_np(kt)[:, 1:], _np(kj)[:, 1:])
    np.testing.assert_array_equal(_np(vt)[:, 1:], _np(vj)[:, 1:])
