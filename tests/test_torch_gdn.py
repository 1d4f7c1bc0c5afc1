"""The port's GatedDeltaNet ops (``xllm_tpu_torch/ops/gdn.py``) against the
JAX package's (``xllm_tpu/ops/gdn.py``), on the CPU, from numpy seeds.

- ``gdn_scan``: the JAX scan vmapped over the rows, with carried-in conv
  tails and states and ``valid`` masks that are a prefix, empty, full, or
  holed (the recurrence must freeze both carries on every invalid token);
  outputs at every token (invalid ones too), the carried-out tail and state
  within 1e-5 abs + 1e-5 rel;
- ``gdn_gate_params``, ``gated_rms_norm`` and ``l2norm`` within the same.

f32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_tpu.ops import gdn as jgdn
from xllm_tpu_torch.ops import gdn as tgdn
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platforms", "cpu")

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


# (key heads, value heads, Dk, Dv, conv kernel, rows, tokens)
SCAN_CASES = {
    "r2-k4": (2, 4, 8, 8, 4, 3, 9),
    "r1-k3": (2, 2, 16, 8, 3, 2, 7),
    "r4-k2": (1, 4, 8, 16, 2, 2, 5),
    "decode": (2, 4, 8, 8, 4, 4, 1),
}


def _masks(rows, t, rng):
    """A full row, a prefix, an empty row, and holed rows."""
    valid = np.zeros((rows, t), bool)
    valid[0] = True
    for i in range(1, rows):
        if i == 1:
            valid[i, : t // 2 + 1] = True
        elif i == 2:
            pass
        else:
            valid[i] = rng.random(t) < 0.5
    return valid


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_gdn_scan_matches_jax(case):
    hk, hv, dk, dv, kk, p, t = SCAN_CASES[case]
    rng = np.random.default_rng(sorted(SCAN_CASES).index(case))
    cd = 2 * hk * dk + hv * dv
    x = rng.standard_normal((p, t, cd)).astype(np.float32)
    g = (-np.abs(rng.standard_normal((p, t, hv))) * 0.5).astype(np.float32)
    beta = rng.random((p, t, hv)).astype(np.float32)
    valid = _masks(p, t, rng)
    if case == "decode":
        valid[:, 0] = [True, False, True, True]
    w = (rng.standard_normal((cd, kk)) * 0.3).astype(np.float32)
    tail = rng.standard_normal((p, cd, kk - 1)).astype(np.float32)
    state = (rng.standard_normal((p, hv, dk, dv)) * 0.1).astype(np.float32)
    kw = dict(num_k_heads=hk, num_v_heads=hv, head_k_dim=dk, head_v_dim=dv)
    want = jax.vmap(lambda a, b, c, d, e, f: jgdn.gdn_scan(a, b, c, d, jnp.asarray(w), e, f,
                                                           **kw))(x, g, beta, valid, tail,
                                                                  state)
    got = tgdn.gdn_scan(_t(x), _t(g), _t(beta), _t(valid), _t(w), _t(tail), _t(state), **kw)
    for name, a, b in zip(("out", "tail", "state"), got, want):
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)
    # a row with no valid token keeps its carries bit for bit
    np.testing.assert_array_equal(got[1][~valid.any(1)], tail[~valid.any(1)])
    np.testing.assert_array_equal(got[2][~valid.any(1)], state[~valid.any(1)])


def test_gdn_gate_params_match_jax():
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((5, 7, 8)) * 4).astype(np.float32)  # softplus far from 0 too
    b = rng.standard_normal((5, 7, 8)).astype(np.float32)
    a_log = rng.standard_normal(8).astype(np.float32)
    dt_bias = rng.standard_normal(8).astype(np.float32)
    want = jgdn.gdn_gate_params(a, b, a_log, dt_bias)
    got = tgdn.gdn_gate_params(_t(a), _t(b), _t(a_log), _t(dt_bias))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)


@pytest.mark.parametrize("z_dtype", ["float32", "bfloat16"])
def test_gated_rms_norm_matches_jax(z_dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
    z = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
    w = (1 + rng.standard_normal(16) * 0.1).astype(np.float32)
    jz = jnp.asarray(z, getattr(jnp, z_dtype))
    tz = _t(np.asarray(jz.astype(jnp.float32))).to(getattr(torch, z_dtype))
    want = jgdn.gated_rms_norm(x, jz, w, 1e-6)
    got = tgdn.gated_rms_norm(_t(x), tz, _t(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_l2norm_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 4, 32)).astype(np.float32)
    x[0, 0] = 0.0  # eps keeps a zero vector finite
    x[1, 0] *= 1e-4
    want = jgdn.l2norm(x)
    got = tgdn.l2norm(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.isfinite(got).all()
