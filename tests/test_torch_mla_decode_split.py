"""The MLA decode kernel's partition (K11a, bf16 q) and the row scatter's
16-byte units: the kernel's split arithmetic in PyTorch against the JAX
package's Pallas kernel in interpret mode, and the wrappers' plans as pure
functions.

``csrc/mla_attention.cu`` ``mla_decode_kernel`` cuts every (sequence, head
group) pair into splits of whole 64-position units, spread evenly over a
grid of resident blocks (``decode_partition``). Each split scores its latent
rows in stages of 16, publishes its granule maxima (min(bs, 64) positions)
and its maximum; once every split of the pair has, each stage takes the
running maximum M at the end of its page (the earlier splits' maximum, its
own prefix, and the next splits' granules where its last page runs past
the split), rounds P = bf16(exp(s - M)), and the accumulators move from
stage to stage by exp(M_prev - M); the splits' (l, acc) sum in split order.
``_split_model`` below does that split after split. It is held at 1, 2, 3
and 16 splits to the Pallas kernel on inputs whose scores are
exact in f32 (q and the latent on a grid, integer e4m3 values), within
``test_torch_p_rounding``'s tolerances, and two faults it must catch are
applied to it: ignoring the earlier splits' maxima, and rounding against
the split's own maximum.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_p_rounding import (ATOL, BF16_RTOL, QUANT_ATOL, _assert_within, _cache, _grid,
                                   _pair, _t, _tables)
from xllm_tpu.ops.pallas import mla_attention as jmla
from xllm_tpu_torch.ops.cuda import kv_write as tkv
from xllm_tpu_torch.ops.cuda import mla_attention as tmla
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platforms", "cpu")

DK, DV = 128, 64
SCALE = 2.0 ** -4  # a power of two keeps grid scores exact
ROWS = 16  # csrc kRows: latent rows a stage
# positions a split: the 1,000-token row in 1, 2, 3 and 16 splits (split
# edges inside pages of 128 at 384 and 64)
CHUNKS = (1024, 512, 384, 64)
# 65 / 577 / 513 put the new token at the start of a page, 0 is a padded row
LENS = [1000, 1, 0, 65, 577, 300, 129, 513]


def _split_model(scores, v, seq_lens, bs: int, chunk: int, round_p: bool = True,
                 fault: str = ""):
    """The kernel's arithmetic over splits of ``chunk`` positions: scores
    [B, R, KV] f32 (scaled), v [B, KV, dv] -> [B, R, dv] f32, rows with
    seq_len 0 zeros. ``fault``:
    "no_prefix" ignores the earlier splits' maxima, "split_max" rounds
    every position against its split's own maximum."""
    b, r, _ = scores.shape
    gran = tmla.decode_gran(bs)
    out = torch.zeros(b, r, v.shape[-1])
    for i in range(b):
        n = int(seq_lens[i])
        if n <= 0:
            continue
        nsp = -(-n // chunk)
        s = scores[i, :, :n].float()
        edges = [(k * chunk, min((k + 1) * chunk, n)) for k in range(nsp)]
        # each split's granule maxima [R, granules] and its maximum
        gmax = [torch.stack([s[:, g:min(g + gran, ce)].amax(-1) for g in range(cs, ce, gran)],
                            -1) for cs, ce in edges]
        smax = [gm.amax(-1) for gm in gmax]
        m_f = torch.stack(smax, -1).amax(-1)
        acc_all, l_all = torch.zeros(r, v.shape[-1]), torch.zeros(r)
        for k, (cs, ce) in enumerate(edges):  # the merge: split order
            pre = (torch.stack(smax[:k], -1).amax(-1) if k and fault != "no_prefix"
                   else torch.full((r,), float("-inf")))
            lp = torch.cummax(gmax[k], -1).values
            over = torch.maximum(pre, smax[k])  # the last page past the split
            for p in range(ce, min(((ce - 1) // bs + 1) * bs, n), gran):
                over = torch.maximum(over, gmax[p // chunk][:, (p % chunk) // gran])
            acc, m_prev = torch.zeros(r, v.shape[-1]), None
            for t0 in range(cs, ce, ROWS):  # stages of 16 rows, each inside one page
                t1 = min(t0 + ROWS, ce)
                e = min((t0 // bs + 1) * bs, n)
                m = torch.maximum(pre, lp[:, -(-(e - cs) // gran) - 1]) if e <= ce else over
                if fault == "split_max":
                    m = smax[k]
                pe = torch.exp(s[:, t0:t1] - m[:, None])
                l_all += (pe * torch.exp(m - m_f)[:, None]).sum(-1)
                if m_prev is not None:
                    acc = acc * torch.exp(m_prev - m)[:, None]
                acc = acc + (pe.bfloat16().float() if round_p else pe) @ v[i, t0:t1].float()
                m_prev = m
            acc_all += acc * torch.exp(m_prev - m_f)[:, None]
        out[i] = torch.where(l_all[:, None] > 0, acc_all / l_all[:, None], 0.0)
    return out


@functools.lru_cache(maxsize=None)
def _case(kind: str, bs: int, h: int, qdtype: str = "bfloat16", seed: int = 5):
    """Grid inputs over ``LENS`` on a latent cache of ``kind``, the Pallas
    kernel's output, and the model's scores and values -> (want [B, H, dv]
    f32, scores [B, H, KV], v [B, KV, dv], seq_lens, the plain version's
    output f32)."""
    rng = np.random.default_rng(seed)
    b = len(LENS)
    bt, nb = _tables(LENS, bs, max(-(-n // bs) for n in LENS) + 1)
    jc, tc = _cache(rng, kind, (2, nb, 1, bs, DK))
    jq, tq = _pair(_grid(rng, (b, h, DK), 2.0 ** -3, 3.0), qdtype)
    new = _grid(rng, (b, DK), 2.0 ** -3, 3.0) if kind == "bf16" else (
        rng.integers(-16, 17, (b, DK)).astype(np.float32))
    jl, tl = _pair(new, qdtype)
    sl = np.asarray(LENS, np.int32)
    sm = np.asarray([bt[i, (n - 1) // bs] * bs + (n - 1) % bs if n else 0
                     for i, n in enumerate(LENS)], np.int32)
    want, _ = jmla.mla_decode_attention_write_tpu(
        jq, jl, jc, jnp.int32(1), jnp.asarray(sm), jnp.asarray(bt), jnp.asarray(sl), SCALE, DV,
        interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    # the cache as the kernel leaves it (the new rows written), then gathered
    cache = tc.clone()
    plain = tmla.mla_decode_attention_write_plain(tq, tl, cache, 1, _t(sm), _t(bt), _t(sl),
                                                  SCALE, DV)
    lat = tmla._gather_latent(cache, 1, _t(bt)).float()
    scores = torch.einsum("bhd,bkd->bhk", tq.float(), lat) * SCALE
    return want, scores, lat[..., :DV], torch.from_numpy(sl), plain.float().numpy()


MODEL_CASES = [("bf16", 16, 16), ("bf16", 64, 16), ("bf16", 128, 16), ("bf16", 64, 20),
               ("fp8_e4m3", 16, 16), ("fp8_e4m3", 64, 20), ("fp8_e4m3", 128, 16)]


@pytest.mark.parametrize("kind,bs,h", MODEL_CASES)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_split_model_matches_pallas(kind, bs, h, chunk):
    """bf16 q on a bf16 or an fp8 latent cache: the output is bf16, held
    within one bf16 ulp."""
    want, scores, v, sl, _ = _case(kind, bs, h)
    got = _split_model(scores, v, sl, bs, chunk)
    _assert_within(got.numpy(), want, ATOL, BF16_RTOL)
    assert not got[LENS.index(0)].any()


@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_split_model_f32_q(bs, chunk):
    """f32 q on an fp8 cache (P rounded, f32 output): held to QUANT_ATOL,
    tight enough that a P rounded against another maximum shows."""
    want, scores, v, sl, _ = _case("fp8_e4m3", bs, 16, "float32")
    _assert_within(_split_model(scores, v, sl, bs, chunk).numpy(), want, QUANT_ATOL, 0.0)


@pytest.mark.parametrize("fault", ["no_prefix", "split_max"])
@pytest.mark.parametrize("chunk", [384, 64])
def test_split_model_faults_fail(fault, chunk):
    """Each fault moves the output past the tolerance the model meets."""
    want, scores, v, sl, _ = _case("fp8_e4m3", 16, 16, "float32")
    got = _split_model(scores, v, sl, 16, chunk, fault=fault).numpy()
    excess = np.abs(got - want) - QUANT_ATOL
    assert (excess > 0).any(), f"the {fault} fault went unnoticed"


@pytest.mark.parametrize("bs", [16, 64, 128])
def test_plain_version_matches_model(bs):
    """The plain version (one walk) and the model (16 splits) agree."""
    _, scores, v, sl, plain = _case("bf16", bs, 16)
    _assert_within(_split_model(scores, v, sl, bs, 64).numpy(), plain, ATOL, BF16_RTOL)


# ---------------------------------------------------------------------------
# decode_plan (shapes alone) and decode_partition (the kernel's cut)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("batch,h,width,bs", [
    (16, 16, 4096, 64), (16, 16, 4096, 16), (16, 16, 4096, 128), (16, 20, 4096, 64),
    (16, 128, 4096, 64), (1, 16, 4096, 64), (16, 16, 256, 64), (4, 16, 32768, 64),
    (16, 16, 576, 64), (256, 128, 4096, 64),
])
def test_decode_plan(dtype, batch, h, width, bs):
    p = tmla.decode_plan(batch, h, width, bs, 640, 512, dtype)
    assert p.gm == (16 if h <= 16 else 32) and p.groups == -(-h // p.gm)
    assert p.grid == 2 * 132 and p.chunk % 64 == 0 and p.gran == min(bs, 64)
    assert 2 <= p.stages <= 8 and p.nsp_max == min(-(-width // 64), p.grid)
    pairs, units = batch * p.groups, -(-width // 64)
    if pairs <= p.grid:  # every pair's splits fit the grid at full tables
        assert pairs * -(-units // (p.chunk // 64)) <= p.grid
        assert p.chunk == 64 or pairs * -(-units // (p.chunk // 64 - 1)) > p.grid  # the least
    else:  # one split a pair
        assert p.chunk == units * 64
    elem = torch.empty((), dtype=dtype).element_size()
    assert p.smem == tmla.decode_smem(640, elem, p.gm, p.chunk, p.gran, p.stages,
                                      p.smem_scores)
    assert p.smem_scores == (p.gm * (p.chunk + 8) * 4 <= 20 * 1024)
    assert p.smem <= 232448
    if (batch, h, width) == (16, 16, 4096):  # the engine's step: two blocks an SM
        assert (p.chunk, p.smem_scores) == (256, True)
        assert 2 * (p.smem + 1024 + 128) <= 233472


def test_decode_plan_per_sm():
    """Where an SM holds one block, the grid halves and splits grow."""
    p = tmla.decode_plan(16, 16, 4096, 64, 640, 512, torch.bfloat16,
                         per_sm=lambda gm, smem: 1)
    assert (p.grid, p.chunk) == (132, 512)


@pytest.mark.parametrize("lens,groups,grid", [
    ([72, 332, 732, 2132] * 3 + [4096, 577, 0, 0], 1, 264),
    ([72, 332, 732, 2132] * 3 + [4096, 577, 0, 0], 4, 264),
    ([1] * 16, 1, 264), ([0] * 8, 1, 264), ([4096] * 16, 1, 264),
    ([4096] * 300, 1, 264), ([5000] * 3, 2, 7),
])
def test_decode_partition(lens, groups, grid):
    """Every live pair's units covered once, in splits of upr units, the
    least upr whose splits fit the grid (else one split a pair)."""
    upr, splits = tmla.decode_partition(lens, groups, grid, 4096)
    units = [-(-min(n, 4096) // 64) if n > 0 else 0 for n in lens for _ in range(groups)]
    count = lambda u: sum(-(-x // u) for x in units)  # noqa: E731
    assert len(splits) == count(upr)
    if count(max(units, default=1) or 1) <= grid:
        assert count(upr) <= grid and (upr == 1 or count(upr - 1) > grid)
    else:
        assert upr == max(units)
    covered = {}
    for p, k, nsp in splits:
        assert nsp == -(-units[p] // upr) and 0 <= k < nsp
        covered.setdefault(p, set()).add(k)
    assert {p for p, u in enumerate(units) if u} == set(covered)
    assert all(len(ks) == -(-units[p] // upr) for p, ks in covered.items())


# ---------------------------------------------------------------------------
# the row scatter's 16-byte units
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("elem", [1, 2, 4])
@pytest.mark.parametrize("width", [64, 128, 80, 144, 640, 72, 20])
def test_unit_partition_covers_rows_once(width, elem):
    """Rows laid end to end (a page of 5 rows, each also at a V offset of
    3 rows): head values, whole 16-byte units and tail values cover every
    byte of each row once, every unit 16-byte aligned, nothing outside."""
    vec = 16 // elem
    for base in (0, 3 * width * elem):
        seen = np.zeros(base + 6 * width * elem, np.int32)
        for row in range(5):
            off = base + row * width * elem
            head, units, tail = tkv.unit_partition(off, width, elem)
            assert head < vec and tail < vec and head + units * vec + tail == width
            for e in range(head):
                seen[off + e * elem: off + (e + 1) * elem] += 1
            for u in range(units):
                a = off + (head + u * vec) * elem
                assert a % 16 == 0
                seen[a: a + 16] += 1
            for e in range(width - tail, width):
                seen[off + e * elem: off + (e + 1) * elem] += 1
        inside = seen[base: base + 5 * width * elem]
        assert (inside == 1).all() and seen.sum() == inside.sum()
        if width * elem % 16 == 0:  # whole rows: the kernel's fast path, no values one by one
            assert tkv.unit_partition(base, width, elem) == (0, width // vec, 0)
