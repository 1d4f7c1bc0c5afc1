"""The bf16 MLA prefill kernel's walk (K11b, K11e: ``csrc/mla_prefill.cu``):
its host plan (``ops/cuda/mla_attention.prefill_plan``) as a pure function,
and a PyTorch model of the walk (``_walk_model`` here) against the JAX
package's Pallas kernels in interpret mode and against the port's plain
version.

The kernel holds 64 (token, head) rows a block and walks the latent 64
keys at a time, as two 32-key stages (one a consumer warpgroup). P is
rounded to bf16 against the running maximum at the end of each key's page:
the prefix over the tile's pages at block_size 16 / 32, the tile at 64, a
first pass's page maximum at 128. A launch with few row tiles splits the
context; each split starts at the earlier splits' maximum (the first
pass's), so every page rounds as the TPU walk rounds it. The model
reproduces that walk, tile for tile and split for split; it must give the
TPU kernels' result on inputs whose scores are exact in f32 (q and the
latent on a grid, integer e4m3 values, a power-of-two scale), bf16 and fp8
latent caches, 16 and 20 heads, block_size 16-128, 1-4 splits, and a short
chunk deep in its prompt.

Tolerances:
- against Pallas (bf16 output): 1e-5 + 2^-7 |ref|, one bf16 ulp of the
  result, as ``test_torch_p_rounding.py`` (XLA and PyTorch take exp and the
  value sums in their own order);
- against the plain version, both in f32 (f32 q on the grid equals the bf16
  q): 1e-5 + 2^-12 |ref|. Both take PyTorch's exp of the same score minus
  the same maximum, so P rounds to the same bf16 wherever the maxima agree;
  only the order of the f32 sums differs. A page rounded against another
  maximum moves P by up to 2^-9 of itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_p_rounding import _assert_within, _grid, _pair
from xllm_tpu.ops.pallas import mla_attention as jmla
from xllm_tpu_torch.ops.cuda import mla_attention as ka
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platforms", "cpu")

DK, DV = 128, 64
SCALE = 2.0 ** -4  # a power of two keeps the scores exact
BF16_RTOL = 2.0 ** -7  # one bf16 ulp of the result
ATOL = 1e-5
F32_RTOL = 2.0 ** -12
ROWS_T, KEY_TILE = 64, 64  # (token, head) rows a block; keys a tile (two 32-key stages)


def _tile_order(plan):
    """Row tiles in launch order: block b holds row tile ``row_tiles - 1 -
    b``, the longest causal walk first."""
    return list(range(plan.row_tiles - 1, -1, -1))


# ---------------------------------------------------------------------------
# the host plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p,s,h,width,bs", [
    (3, 2048, 16, 4096, 64),  # K11b's 2048 bucket: 512 row tiles a chunk
    (4, 512, 16, 4096, 64),
    (3, 64, 16, 4096, 64),  # the 64 bucket: 16 row tiles a chunk
    (1, 64, 16, 4096, 64),  # K11e: 52 tokens at q_offset 2048
    (1, 64, 20, 4096, 16),
    (1, 64, 128, 4096, 128),
    (1, 512, 16, 4096, 128),
    (2, 32, 16, 384, 32),
])
def test_prefill_plan(p, s, h, width, bs):
    """Row tiles of 64 rows, longest walk first; no split while the row
    tiles give two blocks an SM, else at most 32 splits of whole pages and
    key tiles, each at least 256 keys (or one unit), that cover the table;
    a first pass exactly where a split or a page longer than the key tile
    needs maxima the walk cannot see, one per split (or page) a row."""
    plan = ka.prefill_plan(p, s, h, width, bs)
    assert plan.row_tiles == -(-s * h // 64)
    unit = max(64, bs)
    assert plan.chunk % unit == 0 and plan.chunk % 64 == 0
    assert 1 <= plan.nsplit <= 32 and plan.chunk * plan.nsplit >= width
    assert plan.chunk * (plan.nsplit - 1) < width  # no split starts past the table
    blocks = p * plan.row_tiles
    assert (plan.nsplit == 1) == (blocks >= 264 or width <= max(unit, 256))
    if plan.nsplit > 1:
        assert plan.chunk >= min(256, -(-width // unit) * unit)
        assert plan.nsplit <= -(-264 // blocks)
    assert plan.first_pass == (plan.nsplit > 1 or bs > 64)
    assert plan.seg == (bs if bs > 64 else plan.chunk)
    assert plan.ngran * plan.seg >= width
    # every split starts on a page and a key tile
    assert all((k * plan.chunk) % unit == 0 for k in range(plan.nsplit))


def test_prefill_tile_order_walks_longest_first():
    """In launch order the row tiles' causal walks never grow (the kernel's
    row tile ``row_tiles - 1 - blockIdx.x``)."""
    s, h, q_offset = 512, 20, 100
    plan = ka.prefill_plan(1, s, h, 1024, 64)
    walks = [min(s, q_offset + (min(rt * 64 + 64, s * h) - 1) // h + 1)
             for rt in _tile_order(plan)]
    assert walks == sorted(walks, reverse=True) and walks[0] > walks[-1]


# ---------------------------------------------------------------------------
# the walk model
# ---------------------------------------------------------------------------
def _tables(lens, bs, nbmax):
    """Disjoint pages per chunk in a shuffled order (block 0 unused)."""
    need = sum(-(-n // bs) for n in lens)
    free = list(np.random.default_rng(5).permutation(np.arange(1, need + 1)))
    bt = np.zeros((len(lens), nbmax), np.int32)
    for i, n in enumerate(lens):
        for j in range(-(-n // bs)):
            bt[i, j] = free.pop()
    return bt, need + 1


def _latent(rng, kind: str, shape):
    """(values as f32, jax cache, torch cache): bf16 on a grid of 2^-3, or
    e4m3 integers (exact)."""
    if kind == "bf16":
        x = _grid(rng, shape, 2.0 ** -3, 2.0)
        jx, tx = _pair(x, "bfloat16")
        return x, jx, tx
    x = rng.integers(-8, 9, shape).astype(np.float32)
    jx = jnp.asarray(x, jnp.float8_e4m3fn)
    raw = np.asarray(jx).view(np.uint8)
    return x, jx, torch.from_numpy(raw.copy()).view(torch.float8_e4m3fn)


def _plan(s, h, width, bs, nsplit):
    """The wrapper's plan forced to ``nsplit`` splits (no least split)."""
    return ka.plan_splits(-(-s * h // ROWS_T), width, bs, nsplit, min_keys=0)


def _rescale(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """exp(a - b) with b the larger maximum; 1 where neither has a value."""
    return torch.where(b == float("-inf"), 1.0, torch.exp(a - b))


def _walk_model(
    q: torch.Tensor,  # [P, S, H, Dk] bf16
    cache: torch.Tensor,  # [L, NB, 1, bs, Dk] bf16 or float8_e4m3fn
    layer_idx: int,
    block_tables: torch.Tensor,  # [P, NBmax] int32
    q_offsets: torch.Tensor,  # [P] int32
    kv_lens: torch.Tensor,  # [P] int32
    scale: float,
    dv: int,
    plan: ka.PrefillPlan | None = None,
) -> torch.Tensor:
    """The kernel's walk in PyTorch (f32, P rounded to bf16)
    -> [P, S, H, dv] f32, for the CPU tests: each 64-row tile in launch
    order, each context split of ``plan`` (by default the wrapper's), 64-key
    tiles of two 32-key stages, one a consumer warpgroup: the maxima of the
    tile's four 16-key units exchanged, the running maximum at the end of
    each unit's page (pages of 16 / 32 keys: the prefix over the tile's
    pages; 64: the tile; longer: the first pass's page maximum), P rounded
    against it, the accumulators rescaled at each page's first unit, l the
    unrounded P in the tile's frame; a split starts at the earlier splits'
    maximum (the first pass's), and the splits merge in split order."""
    p, s, h, dk = q.shape
    bs = cache.shape[3]
    ninf = float("-inf")
    lat = ka._gather_latent(cache, int(layer_idx), block_tables).float()  # [P, W, Dk]
    width = lat.shape[1]
    if plan is None:
        plan = ka.prefill_plan(p, s, h, width, bs)
    pad = -(-width // plan.chunk) * plan.chunk - width  # keys past the table: none
    lat = torch.nn.functional.pad(lat, (0, 0, 0, pad))
    rows = s * h
    limits = ka.prefill_row_limits(s, h, q_offsets, kv_lens)  # [P, R]
    qw = q.to(torch.bfloat16).float().reshape(p, rows, dk)
    out = torch.zeros(p, rows, dv)
    keys = torch.arange(lat.shape[1])
    for c in range(p):
        kv_len, q_offset = int(kv_lens[c]), int(q_offsets[c])
        live = (kv_len - q_offset) * h if kv_len > 0 else 0
        for rt in _tile_order(plan):
            r0, r1 = rt * ROWS_T, min(rt * ROWS_T + ROWS_T, rows)
            if r0 >= live:
                continue  # zeros
            kv_end = min(kv_len, q_offset + (min(r0 + ROWS_T, live) - 1) // h + 1)
            lim = limits[c, r0:r1].long()
            # the first pass: every score as the kernel computes it
            sc = (qw[c, r0:r1] @ lat[c].T) * scale  # [rows, W']
            sc = torch.where(keys[None, :] < torch.minimum(lim, torch.tensor(kv_end))[:, None],
                             sc, ninf)
            parts = []
            for split in range(-(-kv_end // plan.chunk)):
                t_begin = split * plan.chunk
                t_end = min(t_begin + plan.chunk, kv_end)
                m = sc[:, :t_begin].amax(-1) if t_begin else torch.full((r1 - r0,), ninf)
                l = torch.zeros(r1 - r0)
                acc = torch.zeros(r1 - r0, dv)
                for t0 in range(t_begin, t_end, KEY_TILE):
                    st = torch.where(keys[None, t0:t0 + KEY_TILE] < t_end,
                                     sc[:, t0:t0 + KEY_TILE], ninf)
                    v = torch.where((keys[t0:t0 + KEY_TILE] < t_end)[:, None],
                                    lat[c, t0:t0 + KEY_TILE, :dv], 0.0)  # rows past t_end zeroed
                    # [rows, stage (warpgroup), unit of the stage, 16 keys]
                    unit_max = st.unflatten(-1, (2, 2, 16)).amax(-1).flatten(1)  # [rows, 4]
                    mu = torch.empty(r1 - r0, 4)
                    if bs > KEY_TILE:
                        page = sc[:, t0 // bs * bs:(t0 // bs + 1) * bs].amax(-1)
                        mu[:] = torch.maximum(m, page)[:, None]
                        upg = 4
                    else:
                        upg = bs // 16
                        run = m
                        for u in range(4):
                            if u % upg == 0:
                                run = torch.maximum(run, unit_max[:, u:u + upg].amax(-1))
                            mu[:, u] = run
                    pe = torch.where(st == ninf, 0.0,
                                     torch.exp(st - mu.repeat_interleave(16, dim=1)))
                    mt = mu[:, 3]
                    l = l * _rescale(m, mt) + (pe.unflatten(-1, (4, 16)).sum(-1)
                                               * _rescale(mu, mt[:, None])).sum(-1)
                    pr = pe.bfloat16().float()
                    for u in range(4):
                        if u % upg == 0:
                            acc = acc * _rescale(m if u == 0 else mu[:, u - 1], mu[:, u])[:, None]
                        acc = acc + pr[:, 16 * u:16 * u + 16] @ v[16 * u:16 * u + 16]
                    m = mt
                parts.append((m, l, acc))
            mmax = torch.stack([x[0] for x in parts]).amax(0)
            tot_l = torch.zeros(r1 - r0)
            tot = torch.zeros(r1 - r0, dv)
            for m_k, l_k, acc_k in parts:  # split order
                w = torch.where(mmax == ninf, 0.0, torch.exp(m_k - mmax))
                tot_l = tot_l + l_k * w
                tot = tot + acc_k * w[:, None]
            out[c, r0:r1] = tot / tot_l.clamp_min(1e-30)[:, None]
    return out.reshape(p, s, h, dv)


# (cache, block_size, heads, splits, single): each page size on both caches,
# 16 and 20 heads, 1-4 splits; single = K11e's one chunk (the short one deep
# in its prompt), else K11b's chunks
CASES = [
    ("bf16", 16, 16, 2, False),
    ("bf16", 32, 20, 3, True),
    ("bf16", 64, 16, 3, False),
    ("bf16", 128, 20, 2, False),
    ("fp8_e4m3", 16, 20, 1, True),
    ("fp8_e4m3", 32, 16, 2, False),
    ("fp8_e4m3", 64, 20, 2, True),
    ("fp8_e4m3", 128, 16, 4, True),
]
# (q_offset, ntok) in the 32 bucket: a short chunk deep in its prompt, a
# fresh prompt, a padded row
ROWS, S = [(300, 20), (0, 32), (0, 0)], 32


@pytest.mark.parametrize("kind,bs,h,nsplit,single", CASES)
def test_walk_model_matches_pallas(kind, bs, h, nsplit, single):
    rng = np.random.default_rng(17 + bs + h)
    rows = ROWS[:1] if single else ROWS
    lens = [a + n for a, n in rows]
    nbmax = max(-(-n // bs) for n in lens) + 1
    bt, nb = _tables(lens, bs, nbmax)
    _, jc, tc = _latent(rng, kind, (2, nb, 1, bs, DK))
    q = _grid(rng, (len(rows), S, h, DK), 2.0 ** -3, 2.0)
    jq, tq = _pair(q, "bfloat16")
    qo = np.asarray([a for a, _ in rows], np.int32)
    kl = np.asarray([a + n if n else 0 for a, n in rows], np.int32)
    plan = _plan(S, h, nbmax * bs, bs, nsplit)
    assert plan.nsplit == nsplit
    t = torch.from_numpy
    got = _walk_model(tq, tc, 1, t(bt), t(qo), t(kl), SCALE, DV, plan)
    if single:
        want = jmla.mla_prefill_attention_tpu(
            jq[0], jc, jnp.int32(1), jnp.asarray(bt[0]), jnp.int32(qo[0]), jnp.int32(kl[0]),
            SCALE, DV, interpret=True)[None]
    else:
        want = jmla.mla_prefill_attention_batched_tpu(
            jq, jc, jnp.int32(1), jnp.asarray(bt), jnp.asarray(qo), jnp.asarray(kl), SCALE, DV,
            interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = got.numpy()
    for i, (_, n) in enumerate(rows):  # bucket padding: zeros here, anything on the TPU
        _assert_within(got[i, :n], want[i, :n], ATOL, BF16_RTOL)
        assert not got[i, n:].any()
    # the plain version with f32 q (the same grid values) and an f32 output
    ref = ka.mla_prefill_attention_batched_plain(tq.float(), tc, 1, t(bt), t(qo), t(kl),
                                                 SCALE, DV).numpy()
    _assert_within(got, ref, ATOL, F32_RTOL)
