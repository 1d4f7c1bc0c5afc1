"""The decode kernel's partition (K1, K1b, K8 / K9 decode, K12a-g): its
plain model against the walks and the JAX package's Pallas kernels in
interpret mode, and the wrapper's launch plan as a pure function.

The kernel runs one thread-block cluster per (sequence, kv head), its
blocks the context splits. Each split reads its K tiles once, keeps its
scores, and publishes its granule maxima; after a cluster barrier it takes
the running maximum before it from the earlier splits (and, where its last
rounding tile runs past it, the next splits' granules), rounds P to bf16 in
the row's final frame, and the splits' (l, acc) sum up.
``decode_attention.split_model`` does that split after split; here it is
held, at 1, 2, 3 and 16 splits, to the plain versions (the TPU walk in one
program: ``_v9_walk``, ``_tile_walk``) and on a few cases to the Pallas
kernels, on inputs whose scores are exact in f32 (q and K on a grid,
integer int8 / fp8 values), within ``test_torch_p_rounding``'s tolerances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kv_layouts import _cache_values, _decode_case, _pair, _q_kind, _tables
from test_torch_p_rounding import ATOL, BF16_RTOL, QUANT_ATOL, _assert_within, _t
from xllm_tpu.ops.pallas import decode_attention as jdecode
from xllm_tpu.ops.pallas.legacy import decode_attention as jlegacy
from xllm_tpu_torch.ops import attention as tattention
from xllm_tpu_torch.ops.cuda import decode_attention as tdecode
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platforms", "cpu")

D = 128
SCALE = 2.0 ** -4  # a power of two keeps grid scores exact
# clusters of 1, 2, 3 and 16 blocks: the bf16 cases take all four, the
# other caches 1 and 16 (16 crosses the most split edges)
CLUSTERS = (1, 2, 3, 16)
EDGES = (1, 16)
# a padded row, seq_len 1, a new token that opens a page, and contexts of
# up to 67 tiles, so that 16 splits each hold several and the rounding
# tiles (4 pages of 16, 3 pages, 4 pages of 64) run across split edges
LENS = {16: [700, 1, 0, 129, 1025, 48, 300], 64: [700, 1, 0, 4250, 65, 300]}


@functools.lru_cache(maxsize=None)
def _case(kind: str, bs: int, hq: int = 4, hkv: int = 2, rm: bool = False, seed: int = 3):
    """Grid inputs of a cache ``kind`` over ``LENS[bs]`` -> (jax args, torch
    args): q, the new rows, the caches (``rm``: one interleaved cache with
    token-major tails, as K9 reads it), slot mapping, tables, seq_lens.
    Made once a case and shared: no test writes to them (the plain
    versions take clones)."""
    rng = np.random.default_rng(seed)
    lens = LENS[bs]
    b = len(lens)
    bt, nb = _tables(lens, bs, max(-(-n // bs) for n in lens) + 1)
    shapes = [(2, nb, 2, hkv, bs, D)] if rm else [(2, nb, hkv, bs, D)] * 2
    caches = [_pair(_cache_values(rng, kind, s), kind) for s in shapes]
    qk = _q_kind(kind)
    grid = (rng.integers(-16, 17, (b, hq, D)) * 2.0 ** -6).astype(np.float32)
    jq, tq = _pair(grid if qk == "f32" else _cache_values(rng, "bf16", (b, hq, D)), qk)
    new_kind = "int8" if kind == "int8" else qk
    jkn, tkn = _pair(_cache_values(rng, kind, (b, hkv, D)), new_kind)
    jvn, tvn = _pair(_cache_values(rng, kind, (b, hkv, D)), new_kind)
    sl = np.asarray(lens, np.int32)
    sm = np.asarray([bt[i, (n - 1) // bs] * bs + (n - 1) % bs if n else 0
                     for i, n in enumerate(lens)], np.int32)
    jc = [c[0] for c in caches]
    tc = [c[1] for c in caches]
    return ((jq, jkn, jvn, *jc, jnp.asarray(sm), jnp.asarray(bt), jnp.asarray(sl)),
            (tq, tkn, tvn, *tc, _t(sm), _t(bt), _t(sl)))


def _close(kind: str, got: torch.Tensor, want) -> None:
    want = np.asarray(want.float() if isinstance(want, torch.Tensor)
                      else want.astype(jnp.float32))
    if kind == "bf16":
        _assert_within(got.float().numpy(), want, ATOL, BF16_RTOL)
    else:
        _assert_within(got.float().numpy(), want, QUANT_ATOL, 0.0)


# ---------------------------------------------------------------------------
# the model at 1, 2, 3 and 16 splits against the walks
# ---------------------------------------------------------------------------
# (XLLM_DECODE_KERNEL name, cache kind, block_size, window, cluster): open
# (K1, K1b, tile instances), last (v3), cache (v1); bf16, int8, fp8 and f32
# caches; windows
SPLIT_CASES = [
    *[(*c, k) for c in (("v9", "bf16", 16, 0), ("v9", "bf16", 64, 0), ("v9", "bf16", 16, 100),
                        ("v9t3", "bf16", 16, 0), ("v3", "bf16", 16, 37), ("v1", "bf16", 16, 0))
      for k in CLUSTERS],
    *[(*c, k) for c in (("v5", "int8", 16, 0), ("v9", "fp8_e4m3", 64, 0),
                        ("v1", "fp8_e4m3", 16, 0), ("v9", "f32", 16, 0))
      for k in EDGES],
]


@pytest.mark.parametrize("kver,kind,bs,window,cluster", SPLIT_CASES)
def test_split_model_matches_the_walk(kver, kind, bs, window, cluster):
    fn, tile = tattention.resolve_decode_kernel(kver, "split", window)
    _, (tq, tkn, tvn, kt, vt, sm, bt, sl) = _case(kind, bs)
    pages = fn._pages(tile, window)
    got = tdecode.split_reference(tq, tkn, tvn, kt, vt, 1, bt, sl, SCALE, window, pages,
                                  fn.mode, cluster)
    want = fn.plain(tq, tkn, tvn, kt.clone(), vt.clone(), 1, sm, bt, sl, SCALE, window, tile)
    _close(kind, got, want)


@pytest.mark.parametrize("kind,bs,tile,cluster", [
    *[(*c, k) for c in (("bf16", 16, 4), ("bf16", 64, 2)) for k in CLUSTERS],
    *[("fp8_e4m3", 16, 3, k) for k in EDGES],
])
def test_split_model_matches_the_rm_walk(kind, bs, tile, cluster):
    """K9: tiles of full pages, then the token-major tail page as a tile of
    its own (``nfull % tile != 0`` in most rows)."""
    _, (tq, tkn, tvn, kvt, sm, bt, sl) = _case(kind, bs, rm=True)
    got = tdecode.split_reference(tq, tkn, tvn, kvt, None, 1, bt, sl, SCALE, 0, tile,
                                  tdecode.OPEN, cluster, rm=True)
    want = tdecode.paged_decode_attention_write_rm_plain(tq, tkn, tvn, kvt.clone(), 1, sm, bt,
                                                         sl, SCALE, 0, tile)
    _close(kind, got, want)


# ---------------------------------------------------------------------------
# the model against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family,kind,bs,window,cluster", [
    ("v9", "bf16", 16, 0, 16), ("v9", "int8", 16, 37, 3),
    ("v1", "fp8_e4m3", 16, 0, 16), ("v3", "bf16", 16, 0, 2),
])
def test_split_model_matches_pallas(family, kind, bs, window, cluster):
    fn = tdecode.VARIANTS[family]
    name = {"v9": "paged_decode_attention_write_v9_tpu",
            "v1": "paged_decode_attention_write_tpu",
            "v3": "paged_decode_attention_write_v3_tpu"}[family]
    mod = jdecode if family == "v9" else jlegacy
    (jq, jkn, jvn, kc, vc, *jidx), (tq, tkn, tvn, kt, vt, sm, bt, sl) = _case(kind, bs)
    kw = {} if family == "v1" else {"window": window}
    want, _, _ = getattr(mod, name)(jq, jkn, jvn, kc, vc, jnp.int32(1), *jidx, SCALE,
                                    interpret=True, **kw)
    got = tdecode.split_reference(tq, tkn, tvn, kt, vt, 1, bt, sl, SCALE, window,
                                  fn._pages(None, window), fn.mode, cluster)
    _close(kind, got, want)


@pytest.mark.parametrize("kind,bs,cluster", [("bf16", 16, 16), ("fp8_e4m3", 64, 3)])
def test_split_model_matches_pallas_rm(kind, bs, cluster):
    """K9 against v12 on test_torch_kv_layouts' rows: pages opened and
    completed, tails after nfull % 4 != 0 full pages."""
    want, _, args = _decode_case(kind, bs, True)
    tq, tkn, tvn, kvt, _, sm, bt, sl, scale, window = args
    got = tdecode.split_reference(tq, tkn, tvn, kvt, None, 1, bt, sl, scale, window, 4,
                                  tdecode.OPEN, cluster, rm=True)
    _close(kind, got, want)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------
WIDTHS = [(1, 16), (4, 16), (40, 16), (64, 64), (128, 64), (512, 64), (2048, 64), (32, 128)]


@pytest.mark.parametrize("heads", [1, 128])
@pytest.mark.parametrize("nbmax,bs", WIDTHS)
def test_plan_clusters_cover_every_sequence(nbmax, bs, heads):
    """The cluster (at most 16 blocks) times the largest split covers the
    table, and every sequence's own cut, for every seq_len, window and
    mode, fits that split, covers its walk with non-empty splits, and uses
    no more blocks than the cluster has."""
    p = tdecode.plan(nbmax, bs, 2, D, torch.bfloat16, heads=heads)
    assert 1 <= p.cluster <= 16 and p.chunk % 64 == 0
    assert p.cluster * p.chunk >= nbmax * bs > (p.cluster - 1) * p.chunk
    width = nbmax * bs
    for n in sorted({1, 2, 63, 64, 65, width // 3 + 1, width - 1, width} - {0}):
        if n > width:
            continue
        for window, mode in ((0, tdecode.OPEN), (37, tdecode.OPEN), (0, tdecode.CACHE),
                             (1000, tdecode.LAST)):
            base, wend, chunk, nsp = tdecode.partition(n, window, mode, p.cluster)
            assert chunk % 64 == 0 and chunk <= p.chunk and 1 <= nsp <= p.cluster
            assert base % 64 == 0 and base <= max(n - window, 0) if window else base == 0
            walk = max(wend - base, 0)
            assert nsp * chunk >= walk and (walk == 0 or (nsp - 1) * chunk < walk)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8,
                                   torch.float8_e4m3fn])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_plan_shared_memory_fits(dtype, head_dim):
    """Every served shape's block fits the H100's 227 KB (the scores going
    to the global scratch where they would take more than 32 KB), and the
    served qwen3-1.7B / Qwen3-8B launches keep several blocks on an SM."""
    for group in (1, 2, 4, 7, 8, 16, 32):
        for nbmax, bs in WIDTHS:
            for rm, pages in ((False, 4), (False, 1), (True, 4)):
                p = tdecode.plan(nbmax, bs, group, head_dim, dtype, rm, pages)
                assert p.smem <= tdecode._SMEM_MAX
                assert p.smem_scores == (p.chunk * p.gmax * 4 <= tdecode._SCORE_SMEM)
                assert p.gmax >= group and p.gmax in (2, 4, 8, 16, 32)
                assert 64 % p.gran == 0
                span = bs if rm else pages * bs
                assert dtype == torch.float32 or span % p.gran == 0
    for group in (2, 4):
        assert tdecode.plan(64, 64, group, 128, dtype).smem * 3 <= tdecode._SMEM_MAX


def test_plan_takes_the_long_table_path_by_shape():
    """The scores of a split go to the global scratch exactly where they
    outgrow 32 KB of shared memory: Qwen3-30B-A3B's G 8 at 32,768
    positions, not at 8,192 or at the served 4,096."""
    assert tdecode.plan(64, 64, 8, 128, torch.bfloat16).smem_scores
    assert tdecode.plan(128, 64, 8, 128, torch.bfloat16).smem_scores
    assert not tdecode.plan(512, 64, 8, 128, torch.bfloat16).smem_scores
    assert not tdecode.plan(2048, 64, 2, 128, torch.int8).smem_scores
    with pytest.raises(NotImplementedError):
        tdecode.group_rows(33)


@pytest.mark.parametrize("heads,sms,cap", [(128, 132, 8), (64, 132, 16), (256, 132, 4),
                                          (1, 132, 16), (2048, 132, 1), (128, 0, 1)])
def test_cluster_cap_fills_the_card_about_once(heads, sms, cap):
    """A launch over 16 sequences x 8 kv heads takes clusters of at most 8
    on 132 SMs (~8 blocks an SM), Qwen3-30B-A3B's 4 kv heads 16, 32
    sequences x 8 heads 4, a single sequence 16; never fewer than one
    block."""
    assert tdecode.cluster_cap(heads, sms) == cap
    p = tdecode.plan(64, 64, 2, D, torch.bfloat16, heads=heads, sms=sms)
    assert p.cluster <= cap and p.cluster * p.chunk >= 64 * 64


@pytest.mark.parametrize("nbmax,heads,cluster", [
    (16, 128, 3),  # qwen3-1.7B's engine steps at ~550 tokens: 16 tiles, splits of 6
    (8, 128, 2),  # ~300 tokens
    (64, 128, 8),  # 4,096 positions: the cap (~8 blocks an SM), splits of 8
    (128, 128, 8),
    (16, 64, 3),  # Qwen3-30B-A3B's 4 kv heads
    (4, 64, 2),  # at least two blocks a head (about one an SM)
    (16, 8, 16),  # one sequence: a block an SM, one tile a split
    (16, 32, 4),  # four sequences: four blocks a head, whatever the splits hold
    (64, 32, 11),
])
def test_plan_keeps_splits_of_several_tiles_on_a_full_card(nbmax, heads, cluster):
    """Beyond about one block an SM (``cluster_floor``) the plan adds a
    block to a cluster only where each split of the table keeps
    ``_SPLIT_TILES`` (6) tiles: the engine's block table (bucketed by live
    context) at ~550 tokens over 16 x 8 heads takes clusters of 3, not 8
    blocks of one or two tiles; a launch over few heads splits as far as
    one tile a block."""
    assert tdecode._SPLIT_TILES == 6
    p = tdecode.plan(nbmax, 64, 2, D, torch.bfloat16, heads=heads, sms=132)
    assert p.cluster == cluster
    floor, cap = tdecode.cluster_floor(heads, 132), tdecode.cluster_cap(heads, 132)
    assert p.cluster <= max(floor, -(-nbmax // 6)) and p.cluster <= cap
    # splits of one tile where the least is one: the cap alone, as before
    assert tdecode._split_plan(nbmax * 64, cap, 1, floor)[1] == min(nbmax, cap)
