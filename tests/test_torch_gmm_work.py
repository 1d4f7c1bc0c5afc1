"""K10's work list (``xllm_tpu_torch/ops/cuda/gmm.py``) on the CPU.

The kernels cut the rows into segments (the rows before the first group,
each expert's rows, the rows after the last group), each segment into row
tiles from its first row, and each row tile by 128-column tiles; the TMA +
wgmma instance walks the units with the column tile fastest and multiplies
only the 64-row blocks of a tile that hold rows. ``work_list`` is that cut
and ``units_model`` its arithmetic. At both served MoE models' shapes (a
decode step of 16 tokens and a full chunk of each prefill bucket, 64 / 512
/ 2,048 tokens, routed top-k from a numpy seed) and at edge offsets, under
every instance:

- every (row, column) of a group is covered by exactly one unit, and so is
  every row outside the groups, as a unit that writes zeros;
- under the TMA + wgmma instance's 256-row tiles an expert with at most
  256 rows takes one row tile (its weights streamed once; 128 under its
  128-row tiles), and the units run column tile fastest;
- computed unit by unit in f32, the result equals the Pallas ``gmm`` in
  interpret mode (rows of a group; the others are zeros);
- ``plan`` picks the 16-row instance at decode and the 64-token bucket,
  the TMA + wgmma one at the 512- and 2,048-token chunks (128-row tiles
  for e4m3 weights at 512 tokens), the FMA one for an f32 lhs.

Small K and N (the cut depends on the rows alone); N 192 leaves a part
column tile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xllm_tpu.ops.pallas.gmm import gmm as pallas_gmm
from xllm_tpu_torch.ops.cuda import gmm as k10

K, N, TN = 32, 192, 64  # N 192: one full and one part 128-column tile
MODELS = {"Qwen3-30B-A3B": (128, 8), "DeepSeek-V2-Lite": (64, 6)}  # experts, top-k
TOKENS = (16, 64, 512, 2048)
# the build ``plan`` picks for a bf16 lhs, by rhs (bf16, e4m3) and tokens
PICKED = {16: ("mma16", "mma16"), 64: ("mma16", "mma16"), 512: ("ws256", "ws128"),
          2048: ("ws256", "ws256")}


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def routed_offsets(tokens: int, e: int, topk: int, seed: int) -> list[int]:
    """Each token sends one row to each of ``topk`` distinct experts drawn
    at random -> group offsets [e + 1] over tokens x topk rows."""
    rng = np.random.default_rng(seed)
    picks = np.argsort(rng.random((tokens, e)), axis=1)[:, :topk]
    counts = np.bincount(picks.ravel(), minlength=e)
    return [0] + np.cumsum(counts).tolist()


def _edges() -> dict:
    m = 1000
    sizes = [120, 0, 300, 5, 0, 64, 256, 255]  # empty experts, > 256, 256, 255 rows
    return {
        "empty-experts": (m, [0] + np.cumsum(sizes).tolist()),
        "one-expert-every-row": (m, [0, 0, 0] + [m] * 6),
        "over-256-rows": (m, [0, 10, 10, 700, 700, 800, 900, 950, m]),
        "outside-both-ends": (m, [3, 40, 40, 300, 301, 560, 800, 990, 995]),
        "m1000-ragged": (m, [0, 1, 65, 129, 193, 449, 450, 513, m]),
    }


EDGES = _edges()
CASES = ([(f"{model}-{t}", t) for model in MODELS for t in TOKENS]
         + [(name, None) for name in EDGES])


def case_offsets(name: str, tokens):
    if tokens is None:
        return EDGES[name]
    e, topk = MODELS[name.rsplit("-", 1)[0]]
    offs = routed_offsets(tokens, e, topk, seed=tokens + e)
    return tokens * topk, offs


def check_cover(units, offs: list[int], m: int, n: int) -> None:
    """Every output element is covered once; a unit's rows lie in one
    segment; the rows of no group only by zero units."""
    hits = np.zeros((m, n), np.int32)
    bounds = [0] + offs + [m]
    for u in units:
        hits[u.row0:u.row0 + u.rows, u.n0:u.n0 + u.cols] += 1
        assert u.rows > 0 and u.cols > 0
        if u.expert < 0:
            assert u.row0 + u.rows <= offs[0] or u.row0 >= offs[-1], u
            assert u.blocks == 0
        else:
            lo, hi = bounds[u.expert + 1], bounds[u.expert + 2]
            assert lo <= u.row0 and u.row0 + u.rows <= hi, u
            assert u.blocks == -(-u.rows // 64)
    assert (hits == 1).all(), "an element covered other than once"


@pytest.mark.parametrize("name, tokens", CASES, ids=[c[0] for c in CASES])
def test_gmm_work_list(name, tokens):
    m, offs = case_offsets(name, tokens)
    e = len(offs) - 1
    if tokens is not None:  # the wrapper's pick at a served shape
        for rhs, want in zip((torch.bfloat16, torch.float8_e4m3fn), PICKED[tokens]):
            assert k10.plan(m, 2048, 1536, e, torch.bfloat16, rhs).name == want
            assert k10.plan(m, 2048, 1536, e, torch.float32, rhs).name == "fma"
    plans = [k10.layout(kernel, m, N, e) for kernel in ("mma16", "fma")]
    plans += [k10.layout("ws", m, N, e, bm=bm) for bm in k10.WS_ROWS]
    for p in plans:
        units = k10.work_list(offs, m, N, p)
        check_cover(units, offs, m, N)
        row_tiles = {(u.expert, u.row0) for u in units}
        if p.kernel != "ws":  # one block a unit, within the launch's grid
            assert len(units) <= p.grid
        assert len(row_tiles) * -(-N // p.bn) == len(units)
        if p.kernel == "ws":
            # column tiles fastest: each row tile's units are consecutive
            firsts = [(u.expert, u.row0) for u in units[::-(-N // p.bn)]]
            assert len(set(firsts)) == len(firsts) == len(row_tiles)
            sizes = np.diff(offs)
            for ex, size in enumerate(sizes):
                tiles = {r0 for x, r0 in row_tiles if x == ex}
                assert len(tiles) == (0 if size == 0 else -(-size // p.bm)), (ex, size)

    rng = np.random.default_rng(len(name))
    lhs = rng.standard_normal((m, K)).astype(np.float32)
    rhs = rng.standard_normal((e, K, N)).astype(np.float32)
    p = k10.plan(m, 64, N, e) if tokens else k10.layout("ws", m, N, e)
    got = k10.units_model(torch.from_numpy(lhs), torch.from_numpy(rhs), offs, p).numpy()
    tm = min(128, m) if m % 128 == 0 or m < 128 else 8
    want = np.asarray(pallas_gmm(jnp.asarray(lhs), jnp.asarray(rhs),
                                 jnp.asarray(np.asarray(offs, np.int32)), tm=tm, tn=TN,
                                 interpret=True))
    lo, hi = offs[0], offs[-1]
    assert not got[:lo].any() and not got[hi:].any(), "rows of no group not zero"
    np.testing.assert_allclose(got[lo:hi], want[lo:hi], rtol=1e-5, atol=1e-5)
