"""Where the port runs its attention kernels (fault F5): as the JAX package
(``xllm_tpu/ops/attention.py`` ``_use_pallas``), only at a head_dim that is
a multiple of 128 and not under ``XLLM_ATTENTION_BACKEND=ref``; elsewhere
both compute the portable function (the scatter, then the oracle, which
rounds the normalised P to V's dtype).

On the CPU the JAX package always runs that portable path, so the port's
entry points equal JAX's here at head_dim 64 (whatever the backend) and at
head_dim 128 under ``ref``, the caches byte-equal outside the null block
(where both scatter padding rows):

- decode on a bf16 cache with inputs whose scores are exact in f32
  (``test_torch_p_rounding.py``), within 1e-5 + 2^-7 |ref| at every output
  of a live row. Before the repair the port ran K1's TPU walk at head_dim
  64: 7.9% of the outputs were outside;
- prefill on an f32 cache within 1e-4 at every row of a live chunk, bucket
  padding included, which the portable path attends and the kernels give
  as zeros (XLA's CPU dot takes no bf16 x bf16 -> f32 product of the
  prefill oracle's ranks, so JAX cannot run its bf16 prefill here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mla import _fake_cuda
from test_torch_p_rounding import (
    ATOL,
    BF16_RTOL,
    QUANT_ATOL,
    _assert_within,
    _grid,
    _pair,
    _t,
    _tables,
)
from xllm_tpu.ops import attention as jattention
from xllm_tpu.ops import mla as jmla
from xllm_tpu_torch.ops import attention as tattention
from xllm_tpu_torch.ops import mla as tmla
from xllm_tpu_torch.ops.cuda import _build
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platforms", "cpu")

BS, HQ, HKV = 16, 8, 2
LENS = [30, 1, 45, 60, 17, 0, 75, 100, 120]  # seq_len 1, a padded row, a page opened


def _bits(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def _assert_caches(got, want) -> None:
    np.testing.assert_array_equal(_bits(got)[:, 1:], _bits(want)[:, 1:])


def _decode_inputs(d: int, interleaved: bool = False, seed: int = 21):
    rng = np.random.default_rng(seed)
    b = len(LENS)
    nbmax = max(-(-n // BS) for n in LENS) + 1
    bt, nb = _tables(LENS, BS, nbmax)
    shape = (2, nb, 2, HKV, BS, d) if interleaved else (2, nb, HKV, BS, d)
    kc = _pair(_grid(rng, shape, 2.0 ** -3, 3.0), "bfloat16")
    vc = _pair(rng.standard_normal(shape).astype(np.float32), "bfloat16")
    q = _pair(_grid(rng, (b, HQ, d), 2.0 ** -3, 3.0), "bfloat16")
    kn = _pair(_grid(rng, (b, HKV, d), 2.0 ** -3, 3.0), "bfloat16")
    vn = _pair(rng.standard_normal((b, HKV, d)).astype(np.float32), "bfloat16")
    sm = np.asarray([bt[i, (n - 1) // BS] * BS + (n - 1) % BS if n else 0
                     for i, n in enumerate(LENS)], np.int32)
    return q, kn, vn, kc, vc, sm, bt


@pytest.mark.parametrize("d,env", [(64, "auto"), (64, "interpret"), (128, "ref")])
@pytest.mark.parametrize("layout", ["split", "interleaved_rm"])
def test_decode_dispatch_matches_jax(d, env, layout, monkeypatch):
    monkeypatch.setenv("XLLM_ATTENTION_BACKEND", env)
    ilv = layout != "split"
    (jq, tq), (jkn, tkn), (jvn, tvn), (jk, tk), (jv, tv), sm, bt = _decode_inputs(d, ilv)
    sl = np.asarray(LENS, np.int32)
    scale = 2.0 ** -4
    jargs = (jnp.int32(1), jnp.asarray(sm), jnp.asarray(bt), jnp.asarray(sl), scale)
    targs = (1, _t(sm), _t(bt), _t(sl), scale)
    if ilv:  # the placeholder v cache; the rm tails stay canonical on this path
        want, jcache, _ = jattention.decode_attention_write(
            jq, jkn, jvn, jk, jnp.zeros(1), *jargs, rowmajor_tail=True)
        got, tcache, _ = tattention.decode_attention_write(
            tq, tkn, tvn, tk, torch.zeros(1), *targs, rowmajor_tail=True)
    else:
        want, jcache, jvc = jattention.decode_attention_write(jq, jkn, jvn, jk, jv, *jargs)
        got, tcache, tvc = tattention.decode_attention_write(tq, tkn, tvn, tk, tv, *targs)
        _assert_caches(tvc, jvc)
    _assert_caches(tcache, jcache)
    live = sl > 0  # a padded row averages the null block's rows
    _assert_within(got.float().numpy()[live], np.asarray(want.astype(jnp.float32))[live],
                   ATOL, BF16_RTOL)


# prefill chunks (q_offset, ntok) in a bucket of 32 (> block_size: the
# full-page writer on the kernel path) and of 8 (mid-page starts)
PREFILL = {32: [(0, 32), (16, 20), (0, 0)], 8: [(17, 5), (0, 8)]}


@pytest.mark.parametrize("d,env", [(64, "auto"), (128, "ref")])
@pytest.mark.parametrize("s", [32, 8])
@pytest.mark.parametrize("single", [False, True])
def test_prefill_dispatch_matches_jax(d, env, s, single, monkeypatch):
    monkeypatch.setenv("XLLM_ATTENTION_BACKEND", env)
    rng = np.random.default_rng(22)
    rows = PREFILL[s][:1] if single else PREFILL[s]
    p = len(rows)
    lens = [a + n for a, n in rows]
    bt, nb = _tables(lens, BS, max(-(-n // BS) for n in lens) + 1)
    shape = (2, nb, HKV, BS, d)
    jk, tk = _pair(_grid(rng, shape, 2.0 ** -3, 3.0), "float32")
    jv, tv = _pair(rng.standard_normal(shape).astype(np.float32), "float32")
    jq, tq = _pair(_grid(rng, (p, s, HQ, d), 2.0 ** -3, 3.0), "float32")
    jkn, tkn = _pair(_grid(rng, (p, s, HKV, d), 2.0 ** -3, 3.0), "float32")
    jvn, tvn = _pair(rng.standard_normal((p, s, HKV, d)).astype(np.float32), "float32")
    sm = np.zeros((p, s), np.int32)  # padded tokens -> the null block
    for i, (a, n) in enumerate(rows):
        for r in range(n):
            sm[i, r] = bt[i, (a + r) // BS] * BS + (a + r) % BS
    qo = np.asarray([a for a, _ in rows], np.int32)
    kvl = np.asarray([a + n if n else 0 for a, n in rows], np.int32)
    scale = 2.0 ** -4
    if single:
        want, jk2, jv2 = jattention.prefill_attention_write(
            jq[0], jkn[0], jvn[0], jk, jv, jnp.int32(1), jnp.asarray(sm[0]), jnp.asarray(bt[0]),
            jnp.int32(qo[0]), jnp.int32(kvl[0]), scale)
        got, tk2, tv2 = tattention.prefill_attention_write(
            tq[0], tkn[0], tvn[0], tk, tv, 1, _t(sm[0]), _t(bt[0]), torch.tensor(qo[0]),
            torch.tensor(kvl[0]), scale)
        want, got = want[None], got[None]
    else:
        want, jk2, jv2 = jattention.prefill_attention_write_batched(
            jq, jkn, jvn, jk, jv, jnp.int32(1), jnp.asarray(sm), jnp.asarray(bt),
            jnp.asarray(qo), jnp.asarray(kvl), scale)
        got, tk2, tv2 = tattention.prefill_attention_write_batched(
            tq, tkn, tvn, tk, tv, 1, _t(sm), _t(bt), _t(qo), _t(kvl), scale)
    _assert_caches(tk2, jk2)
    _assert_caches(tv2, jv2)
    live = kvl > 0  # every row of a live chunk, bucket padding too
    _assert_within(got.numpy()[live], np.asarray(want)[live], QUANT_ATOL, 0.0)


@pytest.mark.parametrize("which", ["decode", "prefill_batched", "prefill"])
def test_mla_ref_backend_matches_jax(which, monkeypatch):
    """Under ``ref`` the MLA entry points take ``mla_ref`` after the latent
    scatter, as JAX's MLA dispatch does: a latent cache of 128 lanes, dv
    64, bf16 for decode and f32 for prefill (as the GQA tests above)."""
    monkeypatch.setenv("XLLM_ATTENTION_BACKEND", "ref")
    rng = np.random.default_rng(23)
    h, dk, dv = 8, 128, 64
    lens = [30, 1, 50, 0]
    bt, nb = _tables(lens, BS, 5)
    dt = "bfloat16" if which == "decode" else "float32"
    jc, tc = _pair(_grid(rng, (2, nb, 1, BS, dk), 2.0 ** -3, 3.0), dt)
    scale = 2.0 ** -4
    if which == "decode":
        b = len(lens)
        jq, tq = _pair(_grid(rng, (b, h, dk), 2.0 ** -3, 3.0), "bfloat16")
        jl, tl = _pair(_grid(rng, (b, dk), 2.0 ** -3, 3.0), "bfloat16")
        sm = np.asarray([bt[i, (n - 1) // BS] * BS + (n - 1) % BS if n else 0
                         for i, n in enumerate(lens)], np.int32)
        sl = np.asarray(lens, np.int32)
        want, jc2 = jmla.mla_decode_attention_write(jq, jl, jc, jnp.int32(1), jnp.asarray(sm),
                                                    jnp.asarray(bt), jnp.asarray(sl), scale, dv)
        got, tc2 = tmla.mla_decode_attention_write(tq, tl, tc, 1, _t(sm), _t(bt), _t(sl),
                                                   scale, dv)
        live = sl > 0
    else:
        rows, s = [(16, 14), (0, 1)], 16  # the first two sequences' pages
        p = len(rows)
        bt = bt[:p]
        jq, tq = _pair(_grid(rng, (p, s, h, dk), 2.0 ** -3, 3.0), dt)
        jl, tl = _pair(_grid(rng, (p, s, dk), 2.0 ** -3, 3.0), dt)
        sm = np.zeros((p, s), np.int32)
        for i, (a, n) in enumerate(rows):
            for r in range(n):
                sm[i, r] = bt[i, (a + r) // BS] * BS + (a + r) % BS
        qo = np.asarray([a for a, _ in rows], np.int32)
        kvl = np.asarray([a + n for a, n in rows], np.int32)
        if which == "prefill":
            want, jc2 = jmla.mla_prefill_attention_write(
                jq[0], jl[0], jc, jnp.int32(1), jnp.asarray(sm[0]), jnp.asarray(bt[0]),
                jnp.int32(qo[0]), jnp.int32(kvl[0]), scale, dv)
            got, tc2 = tmla.mla_prefill_attention_write(
                tq[0], tl[0], tc, 1, _t(sm[0]), _t(bt[0]), torch.tensor(qo[0]),
                torch.tensor(kvl[0]), scale, dv)
            want, got, live = want[None], got[None], np.ones(1, bool)
        else:
            want, jc2 = jmla.mla_prefill_attention_write_batched(
                jq, jl, jc, jnp.int32(1), jnp.asarray(sm), jnp.asarray(bt), jnp.asarray(qo),
                jnp.asarray(kvl), scale, dv)
            got, tc2 = tmla.mla_prefill_attention_write_batched(
                tq, tl, tc, 1, _t(sm), _t(bt), _t(qo), _t(kvl), scale, dv)
            live = kvl > 0
    _assert_caches(tc2, jc2)
    atol, rtol = (ATOL, BF16_RTOL) if dt == "bfloat16" else (QUANT_ATOL, 0.0)
    _assert_within(got.float().numpy()[live], np.asarray(want.astype(jnp.float32))[live],
                   atol, rtol)


def test_kernels_run_at_128_by_default(monkeypatch):
    """Unset (or any other value), head_dim 128 takes the kernels' plain
    versions on the CPU: the TPU walk, which attends the new token as given
    and writes nothing for a padded row (its output zeros)."""
    for env in (None, "auto", "pallas"):
        if env is None:
            monkeypatch.delenv("XLLM_ATTENTION_BACKEND", raising=False)
        else:
            monkeypatch.setenv("XLLM_ATTENTION_BACKEND", env)
        assert tattention._use_kernels(128, torch.device("cpu"))
        assert not tattention._use_kernels(64, torch.device("cpu"))
    (_, tq), (_, tkn), (_, tvn), (_, tk), (_, tv), sm, bt = _decode_inputs(128)
    got, _, _ = tattention.decode_attention_write(tq, tkn, tvn, tk, tv, 1, _t(sm), _t(bt),
                                                  _t(np.asarray(LENS, np.int32)), 2.0 ** -4)
    assert not got[LENS.index(0)].float().abs().any()


def test_interpret_on_a_cuda_tensor_raises(monkeypatch):
    """``interpret`` is JAX's CPU hook for its Pallas kernels; on a CUDA
    tensor the port raises, naming the setting, before any kernel runs."""
    monkeypatch.setenv("XLLM_ATTENTION_BACKEND", "interpret")
    before = dict(_build.launch_counts)
    f = _fake_cuda
    q = f(torch.zeros(1, 2, 128, dtype=torch.bfloat16))
    cache = f(torch.zeros(1, 2, 1, 16, 128, dtype=torch.bfloat16))
    i = f(torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="XLLM_ATTENTION_BACKEND=interpret"):
        tattention.decode_attention_write(q, q[:, :1], q[:, :1], cache, cache, 0, i,
                                          f(torch.zeros(1, 2, dtype=torch.int32)), i, 0.1)
    with pytest.raises(ValueError, match="XLLM_ATTENTION_BACKEND=interpret"):
        tmla.mla_decode_attention_write(q, q[:, 0], cache, 0, i,
                                        f(torch.zeros(1, 2, dtype=torch.int32)), i, 0.1, 64)
    assert _build.launch_counts == before
