"""The prefill kernel's context split (K3, K3b, K8 / K9 prefill): its plain
model against the JAX package's Pallas kernels in interpret mode, and the
wrapper's split plan as a pure function.

The tensor-core kernel splits the key range of a launch with few blocks
into page- and tile-aligned splits. On every cache but f32 a first pass
writes each split's score maxima, each split starts its running maximum at
the maximum of the earlier splits' (the TPU walk's running maximum at its
first page, so every page rounds P to bf16 as the TPU kernel does), and the
splits' (m, l, acc) merge with weights exp(m_i - max m). The plain
versions model that with ``chunk``; here the model, at 1, 2 and 3 splits,
is held to the Pallas kernels (whose one walk it must reproduce) on inputs
whose scores are exact in f32 (q and K on a grid, integer int8 / fp8
values), within the tolerances of ``test_torch_p_rounding.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mla import _fake_cuda
from test_torch_p_rounding import _assert_within, _grid, _pair
from xllm_tpu.ops.pallas import prefill_attention as jprefill
from xllm_tpu_torch.ops.cuda import _build
from xllm_tpu_torch.ops.cuda import prefill_attention as tprefill
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platforms", "cpu")

D = 128
HQ, HKV = 8, 2
BF16_RTOL = 2.0 ** -7  # one bf16 ulp of the result
ATOL = 1e-5
QUANT_ATOL = 1e-4  # f32 q (f32, int8 and fp8 caches)
SCALE = 2.0 ** -4  # a power of two keeps the scores exact


def _values(rng, kind: str, shape, keys: bool) -> np.ndarray:
    """Cache values of ``kind`` (bf16, f32, int8 or fp8_e4m3) as f32: K on
    the grid, V of unit size (integers on a 1-byte cache)."""
    if kind in ("bf16", "f32"):
        return (_grid(rng, shape, 2.0 ** -3, 3.0) if keys
                else rng.standard_normal(shape).astype(np.float32))
    return (rng.integers(-8, 9, shape) if keys else rng.integers(-2, 3, shape)).astype(
        np.float32)


def _as_cache(x: np.ndarray, kind: str):
    """The values ``x`` as a cache of ``kind`` -> (jax array, torch tensor)."""
    if kind in ("bf16", "f32"):
        return _pair(x, "bfloat16" if kind == "bf16" else "float32")
    if kind == "int8":
        return jnp.asarray(x, jnp.int8), torch.from_numpy(x.astype(np.int8))
    jx = jnp.asarray(x, jnp.float8_e4m3fn)
    raw = np.asarray(jx).view(np.uint8)
    return jx, torch.from_numpy(raw.copy()).view(torch.float8_e4m3fn)


def _tables(lens, bs, nbmax):
    """Disjoint pages per sequence in a shuffled order (block 0 is the null
    block)."""
    need = sum(-(-n // bs) for n in lens)
    free = list(np.random.default_rng(5).permutation(np.arange(1, need + 1)))
    bt = np.zeros((len(lens), nbmax), np.int32)
    for i, n in enumerate(lens):
        for j in range(-(-n // bs)):
            bt[i, j] = free.pop()
    return bt, need + 1


def _chunk(nsplit: int, width: int, bs: int) -> int:
    """The length of ``nsplit`` page- and tile-aligned splits over
    ``width`` positions."""
    unit = max(tprefill.key_tile(bs), bs)
    return unit * -(-(-(-width // unit)) // nsplit)


# (cache, block_size, q dtype): bf16 at bs 16 and 64, int8 at 128, fp8 at
# 32 (f32 q, as the f32 parity models run them), an f32 cache
KINDS = [("bf16", 16, "bfloat16"), ("bf16", 64, "bfloat16"), ("int8", 128, "bfloat16"),
         ("fp8_e4m3", 32, "float32"), ("f32", 16, "float32")]


def _case(kind, bs, qdt):
    """Chunks (q_offset, ntok) in a bucket of S rows: a chunk deep in its
    prompt ending mid-page, a padded row, a chunk from q_offset 0 with
    bucket padding; the table spans three key tiles."""
    rng = np.random.default_rng(17)
    s = 32
    rows = [(3 * max(bs, 64) - 40, 29), (0, 0), (0, 20)]
    lens = [a + n for a, n in rows]
    width = 3 * max(bs, 64)
    nbmax = width // bs
    bt, nb = _tables(lens, bs, nbmax)
    k = _values(rng, kind, (2, nb, HKV, bs, D), keys=True)
    v = _values(rng, kind, (2, nb, HKV, bs, D), keys=False)
    if qdt == "bfloat16":
        jq, tq = _pair(_grid(rng, (len(rows), s, HQ, D), 2.0 ** -3, 3.0), qdt)
    else:
        jq, tq = _pair(_grid(rng, (len(rows), s, HQ, D), 2.0 ** -6, 0.5), qdt)
    qo = np.asarray([a for a, _ in rows], np.int32)
    kvl = np.asarray([a + n if n else 0 for a, n in rows], np.int32)
    tol = (ATOL, BF16_RTOL) if qdt == "bfloat16" else (QUANT_ATOL, 0.0)
    return rows, width, bt, (jq, tq), k, v, qo, kvl, tol


def _check_rows(got, want, rows, tol):
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    for i, (_, n) in enumerate(rows):  # bucket padding: the port's zeros
        _assert_within(got[i, :n], want[i, :n], *tol)
        assert not np.abs(got[i, n:]).any()


@pytest.mark.parametrize("nsplit", [1, 2, 3])
@pytest.mark.parametrize("kind,bs,qdt", KINDS)
def test_split_model_matches_batched_pallas(kind, bs, qdt, nsplit):
    """K3: the split model at 1-3 splits against the TPU walk, with a
    window whose lower edge falls inside a split."""
    window = 2 * max(bs, 64) - 50
    rows, width, bt, (jq, tq), k, v, qo, kvl, tol = _case(kind, bs, qdt)
    (jk, tk), (jv, tv) = _as_cache(k, kind), _as_cache(v, kind)
    chunk = _chunk(nsplit, width, bs)
    assert -(-width // chunk) == nsplit
    for w in (0, window):
        want = jprefill.paged_attention_prefill_batched_tpu(
            jq, jk, jv, jnp.int32(1), jnp.asarray(bt), jnp.asarray(qo), jnp.asarray(kvl),
            SCALE, interpret=True, window=w)
        got = tprefill.paged_attention_prefill_batched_plain(
            tq, tk, tv, 1, torch.from_numpy(bt), torch.from_numpy(qo), torch.from_numpy(kvl),
            SCALE, w, chunk=chunk)
        _check_rows(got, want, rows, tol)


@pytest.mark.parametrize("nsplit", [2, 3])
@pytest.mark.parametrize("kind,bs,qdt", [KINDS[0], KINDS[2], KINDS[3]])
def test_split_model_matches_single_pallas(kind, bs, qdt, nsplit):
    """K3b: the chunk deep in its prompt, through the single-chunk
    functions (the launch the plan splits most: one chunk)."""
    rows, width, bt, (jq, tq), k, v, qo, kvl, tol = _case(kind, bs, qdt)
    (jk, tk), (jv, tv) = _as_cache(k, kind), _as_cache(v, kind)
    chunk = _chunk(nsplit, width, bs)
    want = jprefill.paged_attention_prefill_tpu(
        jq[0], jk, jv, jnp.int32(1), jnp.asarray(bt[0]), jnp.int32(qo[0]), jnp.int32(kvl[0]),
        SCALE, interpret=True)
    got = tprefill.paged_attention_prefill_plain(
        tq[0], tk, tv, 1, torch.from_numpy(bt[0]), torch.tensor(qo[0]),
        torch.tensor(kvl[0]), SCALE, chunk=chunk)
    _check_rows(got[None], want[None], rows[:1], tol)


@pytest.mark.parametrize("rm", [False, True])
@pytest.mark.parametrize("nsplit", [1, 3])
@pytest.mark.parametrize("kind,bs,qdt", [KINDS[0], KINDS[3]])
def test_split_model_matches_ilv_pallas(kind, bs, qdt, nsplit, rm):
    """K8's prefill (K9's with ``rowmajor_tail``): the same split over the
    interleaved cache, whose final incomplete pages are token-major under
    rm; a window across a split boundary."""
    rows, width, bt, (jq, tq), k, v, qo, kvl, tol = _case(kind, bs, qdt)
    kv = np.stack([k, v], axis=2)  # [L, NB, 2, Hkv, bs, D]
    if rm:  # each chunk's final incomplete page holds its content token-major
        for i, n in enumerate(kvl):
            if n % bs:
                blk = bt[i, n // bs]
                page = kv[:, blk].reshape(2, 2 * HKV, bs, D).transpose(0, 2, 1, 3)
                kv[:, blk] = page.reshape(2, 2, HKV, bs, D)
    jkv, tkv = _as_cache(kv, kind)
    chunk = _chunk(nsplit, width, bs)
    window = 2 * max(bs, 64) - 50
    want = jprefill.paged_attention_prefill_batched_ilv_tpu(
        jq, jkv, jnp.int32(1), jnp.asarray(bt), jnp.asarray(qo), jnp.asarray(kvl), SCALE,
        interpret=True, window=window, rowmajor_tail=rm)
    got = tprefill.paged_attention_prefill_batched_ilv_plain(
        tq, tkv, 1, torch.from_numpy(bt), torch.from_numpy(qo), torch.from_numpy(kvl), SCALE,
        window, rowmajor_tail=rm, chunk=chunk)
    _check_rows(got, want, rows, tol)


# ---------------------------------------------------------------------------
# the wrapper's split plan, a pure function of shapes
# ---------------------------------------------------------------------------
PLAN_SHAPES = [
    # (P, S, Hq, Hkv, width, block_size)
    (1, 64, 16, 8, 4096, 64),    # K3b: 52 tokens at q_offset 2048, the 64 bucket
    (3, 64, 16, 8, 4096, 64),    # K3: the 64 bucket with three chunks
    (1, 64, 32, 8, 4096, 16),    # Qwen3-8B's group, pages of 16
    (1, 64, 32, 4, 4096, 128),   # Qwen3-30B-A3B's group, pages of 128
    (1, 64, 16, 8, 4096, 256),   # pages longer than the tile
    (2, 100, 8, 2, 400, 16),     # a table width that is no multiple of the tile
    (1, 2048, 16, 8, 4096, 64),  # K3b at S 2048
    (3, 2048, 16, 8, 4096, 64),  # K3 at S 2048
    (1, 2048, 32, 8, 4096, 64),  # Qwen3-8B at S 2048
    (4, 512, 16, 8, 4096, 64),   # K3 in the 512 bucket
]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_split_plan_is_aligned_and_covers_the_table(shape):
    p, s, hq, hkv, width, bs = shape
    chunk, nsplit = tprefill.split_plan(*shape)
    assert chunk % bs == 0 and chunk % tprefill.key_tile(bs) == 0
    assert 1 <= nsplit <= tprefill._MAX_SPLITS
    assert (nsplit - 1) * chunk < width <= nsplit * chunk


def test_split_plan_splits_short_chunks_deep_in_a_prompt():
    # the 64-bucket chunk at q_offset 2048 walks 2,100 keys in one block a
    # kv head unsplit; split, at least eight splits a kv head have work
    chunk, nsplit = tprefill.split_plan(1, 64, 16, 8, 4096, 64)
    assert nsplit > 1
    assert -(-2100 // chunk) >= 8
    assert tprefill.split_plan(3, 64, 16, 8, 4096, 64)[1] > 1
    for shape in PLAN_SHAPES[6:]:  # S 2048 and the 512 bucket: 512+ blocks
        assert tprefill.split_plan(*shape) == (shape[4], 1)


# ---------------------------------------------------------------------------
# a CUDA tensor launches the kernel or raises
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["batched", "single", "ilv"])
def test_cuda_tensor_with_failed_build_raises(which, monkeypatch):
    """A failed build raises before any launch is counted, and no plain
    version (split or not) runs for a CUDA tensor."""
    def failed_build(stem):
        raise RuntimeError(f"CUDA kernel build failed: csrc/{stem}.cu")

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(_build, "load", failed_build)
    monkeypatch.setattr(tprefill, "_lib", None)
    monkeypatch.setattr(tprefill, "_prefill_plain", no_plain)
    before = dict(_build.launch_counts)
    f = _fake_cuda
    q = f(torch.zeros(1, 64, HQ, D, dtype=torch.bfloat16))
    bt = f(torch.ones(1, 64, dtype=torch.int32))
    qo, kvl = f(torch.tensor([2048], dtype=torch.int32)), f(torch.tensor([2100], dtype=torch.int32))
    with pytest.raises(RuntimeError, match="build failed"):
        if which == "ilv":
            kv = f(torch.zeros(1, 4, 2, HKV, 64, D, dtype=torch.bfloat16))
            tprefill.paged_attention_prefill_batched_ilv(q, kv, 0, bt, qo, kvl, 0.1)
        else:
            kc = f(torch.zeros(1, 4, HKV, 64, D, dtype=torch.bfloat16))
            if which == "batched":
                tprefill.paged_attention_prefill_batched(q, kc, kc, 0, bt, qo, kvl, 0.1)
            else:
                tprefill.paged_attention_prefill(q[0], kc, kc, 0, bt[0], qo[0], kvl[0], 0.1)
    assert _build.launch_counts == before
