"""The plain PyTorch versions of the port's four kernels vs the JAX
package's Pallas kernels, run in interpret mode on the CPU.

The CUDA kernels themselves run only on a card (``chip_smoke.py`` holds
each against the plain version tested here). Inputs come from numpy with a
seed; both sides compute in f32, so outputs agree to atol/rtol 1e-5 (only
the summation order differs). Caches are compared on every slot a
sequence owns below its length: block 0 (where the JAX portable path drops
padded tokens) and the tail-page slots past a chunk (which the TPU's
full-page writer fills with padding) are not part of the contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_tpu.ops.pallas.decode_attention import paged_decode_attention_write_v9_tpu
from xllm_tpu.ops.pallas.kv_write import (
    kv_write_prefill_batched_tpu,
    kv_write_rmw_batched_tpu,
)
from xllm_tpu.ops.pallas.prefill_attention import paged_attention_prefill_batched_tpu
from xllm_tpu_torch.ops.cuda.decode_attention import (
    _split_plan,
    paged_decode_attention_write_plain,
)
from xllm_tpu_torch.ops.cuda.kv_write import (
    kv_write_prefill_batched,
    kv_write_rmw_batched,
)
from xllm_tpu_torch.ops.cuda.prefill_attention import (
    paged_attention_prefill_batched_plain,
)
from torch_threads import one_torch_thread  # noqa: F401

L, BS, D = 2, 16, 64
TOL = 1e-5  # f32 on both sides; summation order only


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _cache(rng, nb, hkv):
    k = rng.standard_normal((L, nb, hkv, BS, D)).astype(np.float32)
    v = rng.standard_normal((L, nb, hkv, BS, D)).astype(np.float32)
    return k, v


def _tables(lens, nbmax):
    """Consecutive pages from block 1, a ring across sequences."""
    bt = np.zeros((len(lens), nbmax), np.int32)
    nxt = 1
    for i, n in enumerate(lens):
        for j in range(-(-n // BS)):
            bt[i, j] = nxt
            nxt += 1
    return bt


def _owned_slots(bt, lens):
    """(block, offset) of every position below each sequence's length."""
    return [(int(bt[i, p // BS]), p % BS) for i, n in enumerate(lens) for p in range(n)]


def _assert_caches_equal(got, want, bt, lens):
    for blk, off in _owned_slots(bt, lens):
        np.testing.assert_array_equal(got[:, blk, :, off], want[:, blk, :, off])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize(
    "hq,hkv,window", [(4, 2, 0), (8, 2, 0), (4, 4, 20)]
)
def test_decode_plain_matches_pallas(hq, hkv, window):
    """K1: padded rows mid-batch, tails shorter than a page, window."""
    rng = np.random.default_rng(61)
    nb, nbmax = 48, 6
    lens = [18, 0, 16, 70, 1, 33, 0]
    b = len(lens)
    k_all, v_all = _cache(rng, nb, hkv)
    q = rng.standard_normal((b, hq, D)).astype(np.float32)
    kn = rng.standard_normal((b, hkv, D)).astype(np.float32)
    vn = rng.standard_normal((b, hkv, D)).astype(np.float32)
    bt = _tables(lens, nbmax)
    slots = np.asarray(
        [bt[i, (n - 1) // BS] * BS + (n - 1) % BS if n else 0 for i, n in enumerate(lens)],
        np.int32,
    )
    sl = np.asarray(lens, np.int32)
    scale = D**-0.5

    out_j, k_j, v_j = paged_decode_attention_write_v9_tpu(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(k_all),
        jnp.asarray(v_all), jnp.int32(1), jnp.asarray(slots), jnp.asarray(bt),
        jnp.asarray(sl), scale, interpret=True, window=window,
    )
    kt, vt = _t(k_all.copy()), _t(v_all.copy())
    out_t = paged_decode_attention_write_plain(
        _t(q), _t(kn), _t(vn), kt, vt, 1, _t(slots), _t(bt), _t(sl), scale,
        window=window,
    )
    live = [i for i, n in enumerate(lens) if n]
    np.testing.assert_allclose(
        out_t.numpy()[live], np.asarray(out_j)[live], rtol=TOL, atol=TOL
    )
    assert not out_t.numpy()[[1, 6]].any()  # padded rows: zeros
    _assert_caches_equal(kt.numpy(), np.asarray(k_j), bt, lens)
    _assert_caches_equal(vt.numpy(), np.asarray(v_j), bt, lens)


@pytest.mark.parametrize("window", [0, 24])
def test_prefill_plain_matches_pallas(window):
    """K3: fresh chunk, continuation at q_offset > 0, short row, padded row."""
    rng = np.random.default_rng(7)
    nb, nbmax, hkv, hq, s = 64, 8, 2, 4, 32
    specs = [(0, 32), (32, 64), (0, 18), (0, 0)]  # (q_offset, kv_len)
    p = len(specs)
    k_all, v_all = _cache(rng, nb, hkv)
    q = rng.standard_normal((p, s, hq, D)).astype(np.float32)
    bt = _tables([kl for _, kl in specs], nbmax)
    qo = np.asarray([a for a, _ in specs], np.int32)
    kvl = np.asarray([b for _, b in specs], np.int32)
    scale = D**-0.5

    out_j = paged_attention_prefill_batched_tpu(
        jnp.asarray(q), jnp.asarray(k_all), jnp.asarray(v_all), jnp.int32(1),
        jnp.asarray(bt), jnp.asarray(qo), jnp.asarray(kvl), scale,
        interpret=True, window=window,
    )
    out_t = paged_attention_prefill_batched_plain(
        _t(q), _t(k_all), _t(v_all), 1, _t(bt), _t(qo), _t(kvl), scale,
        window=window,
    ).numpy()
    for i, (a, b) in enumerate(specs):
        n = min(s, b - a)
        np.testing.assert_allclose(
            out_t[i, :n], np.asarray(out_j)[i, :n], rtol=TOL, atol=TOL,
            err_msg=f"row {i}",
        )
        assert not out_t[i, max(n, 0):].any()  # bucket padding: zeros


def test_full_page_writer_plain_matches_pallas():
    """K2: full pages, a partial tail page, a page-aligned continuation,
    a padded row."""
    rng = np.random.default_rng(8)
    nb, nbmax, hkv, s = 64, 8, 2, 48
    specs = [(0, 48), (32, 33), (16, 16), (0, 0)]  # (q_offset, ntok)
    p = len(specs)
    k_all, v_all = _cache(rng, nb, hkv)
    kn = rng.standard_normal((p, hkv, s, D)).astype(np.float32)  # head-major
    vn = rng.standard_normal((p, hkv, s, D)).astype(np.float32)
    lens = [a + n for a, n in specs]
    bt = _tables(lens, nbmax)
    qo = np.asarray([a for a, _ in specs], np.int32)
    nt = np.asarray([n for _, n in specs], np.int32)

    k_j, v_j = kv_write_prefill_batched_tpu(
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(k_all), jnp.asarray(v_all),
        jnp.int32(1), jnp.asarray(bt), jnp.asarray(qo), jnp.asarray(nt),
        interpret=True,
    )
    kt, vt = _t(k_all.copy()), _t(v_all.copy())
    kv_write_prefill_batched(_t(kn), _t(vn), kt, vt, 1, _t(bt), _t(qo), _t(nt))
    _assert_caches_equal(kt.numpy(), np.asarray(k_j), bt, lens)
    _assert_caches_equal(vt.numpy(), np.asarray(v_j), bt, lens)
    # and the plain writer touched nothing but the chunks' rows
    owned = set(_owned_slots(bt, lens)) - {
        (int(bt[i, (a + r) // BS]), (a + r) % BS)
        for i, (a, n) in enumerate(specs) for r in range(n)
    }
    for blk, off in owned:
        np.testing.assert_array_equal(kt.numpy()[:, blk, :, off], k_all[:, blk, :, off])


def test_rmw_writer_plain_matches_pallas():
    """K4: unaligned starts, a chunk crossing a page boundary, a padded row."""
    rng = np.random.default_rng(9)
    nb, nbmax, hkv, s = 48, 6, 2, 5
    specs = [(17, 5), (14, 5), (0, 3), (0, 0)]
    p = len(specs)
    k_all, v_all = _cache(rng, nb, hkv)
    kn = rng.standard_normal((p, s, hkv, D)).astype(np.float32)  # token-major
    vn = rng.standard_normal((p, s, hkv, D)).astype(np.float32)
    lens = [a + n for a, n in specs]
    bt = _tables(lens, nbmax)
    qo = np.asarray([a for a, _ in specs], np.int32)
    nt = np.asarray([n for _, n in specs], np.int32)

    k_j, v_j = kv_write_rmw_batched_tpu(
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(k_all), jnp.asarray(v_all),
        jnp.int32(0), jnp.asarray(bt), jnp.asarray(qo), jnp.asarray(nt),
        interpret=True,
    )
    kt, vt = _t(k_all.copy()), _t(v_all.copy())
    kv_write_rmw_batched(_t(kn), _t(vn), kt, vt, 0, _t(bt), _t(qo), _t(nt))
    # the RMW kernel writes exactly the chunks' rows: whole caches agree
    np.testing.assert_array_equal(kt.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(v_j))


@pytest.mark.parametrize("max_ctx", [1, 64, 100, 1024, 4096, 8192, 131072])
def test_decode_split_plan_covers_the_context(max_ctx):
    """K1's launch cuts the context into splits of whole 64-row tiles, at
    most 16 of them, that together cover every position and none of them
    lies wholly past the context."""
    chunk, nsplit = _split_plan(max_ctx)
    assert chunk % 64 == 0 and 1 <= nsplit <= 16
    assert (nsplit - 1) * chunk < max_ctx <= nsplit * chunk
