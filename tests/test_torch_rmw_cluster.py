"""K9's RMW writer and its e4m3 cast, modelled on the CPU.

The writer (``csrc/kv_write.cu`` ``kv_write_rmw_rm_kernel``) rewrites a
completed page canonical in one launch: a cluster of blocks a page, each
staging the earlier token-major rows of its share in shared memory, a
cluster barrier, then each writing its share. ``cluster_share`` models
that partition; for block sizes 16-128, Hkv 2-8, head_dim 64 / 128, 1-,
2- and 4-byte caches and every first row w0 of the chunk in [0, bs):

- the blocks write every canonical unit of the page exactly once;
- every token-major unit of a row before w0 is staged exactly once, by
  the block that later reads it back (no unit is read from a block that
  did not stage it), and nothing else is staged;
- a block stages at most ``rmw_cluster_smem`` bytes, within an H100
  block's shared memory.

The cast (``to_e4m3x2`` in ``csrc/common.cuh``): the hardware's satfinite
e4m3 cast, then the NaN byte with the sign of x above 464 and on NaN
inputs. ``e4m3_pair_model`` (clamp to +-448, PyTorch's cast, the select)
gives the bytes of ``ops.quant.to_e4m3`` on every one of the 65,536 bf16
bit patterns and on ``chip_smoke.E4M3_EDGES`` (and their negatives) in
f32.
"""

import pytest
import torch

from chip_smoke import E4M3_EDGES
from xllm_tpu_torch.ops.cuda import kv_write as kvw
from xllm_tpu_torch.ops.quant import to_e4m3
from torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(bs, hkv, d) for bs in (16, 32, 64, 128) for hkv in (2, 4, 8) for d in (64, 128)]


def cluster_share(hkv: int, bs: int, head_dim: int, elem: int, w0s: torch.Tensor,
                  rank: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block ``rank``'s part in rewriting a completed page canonical whose
    first ``w0`` rows were written token-major before the chunk, in 16-byte
    units of an ``elem``-byte cache, for each w0 of ``w0s``: -> (the
    canonical units it writes, in order; the staging slots it fills; the
    token-major unit each slot holds), the last two for every w0 in turn.
    Canonical unit i is head c = i // (bs U), row w = i // U % bs, piece u =
    i % U (U units a head row); its token-major place is w (2 Hkv U) + c U
    + u. The block that writes i stages it in slot i - lo when w < w0."""
    per_head = head_dim * elem // 16
    total = 2 * hkv * bs * per_head
    per = -(-total // kvw.RMW_CLUSTER)
    i = torch.arange(rank * per, min(total, (rank + 1) * per))
    c, w, u = i // (bs * per_head), i // per_head % bs, i % per_head
    early = w[None, :] < w0s[:, None]
    token_major = w * (2 * hkv * per_head) + c * per_head + u
    return (i, (i - rank * per).expand_as(early)[early],
            token_major.expand_as(early)[early])


@pytest.mark.parametrize("bs, hkv, d", SHAPES)
def test_rmw_cluster_partition(bs, hkv, d):
    """Every w0 of a page at once: each block's share for all w0 in one
    call, checked as [w0, unit] tables."""
    w0s = torch.arange(bs)
    for elem in (1, 2, 4):
        per_head = d * elem // 16
        total = 2 * hkv * bs * per_head
        smem = kvw.rmw_cluster_smem(hkv, bs, d, elem)
        assert smem <= kvw.RMW_SMEM_MAX
        tok_w = torch.arange(total) // (2 * hkv * per_head)  # row of a token-major unit
        staged = torch.zeros(bs, total, dtype=torch.int32)  # times each unit is staged
        written = []
        for rank in range(kvw.RMW_CLUSTER):
            canon, slots, tm = cluster_share(hkv, bs, d, elem, w0s, rank)
            written.append(canon)
            c = canon // (bs * per_head)
            w, u = canon // per_head % bs, canon % per_head
            need = w[None, :] < w0s[:, None]  # [w0, unit]: staged before the chunk
            counts = need.sum(dim=1)
            assert int(counts.max()) * 16 <= smem
            rows = torch.repeat_interleave(w0s, counts)
            staged.index_put_((rows, tm), torch.ones_like(tm, dtype=torch.int32),
                              accumulate=True)
            # the reads of step 2: canonical i below w0 from this block's slot i - lo
            lo = int(canon[0]) if len(canon) else 0
            held = torch.full((bs, max(len(canon), 1)), -1)
            held[rows, slots] = tm
            want = (w * 2 * hkv * per_head + c * per_head + u).expand(bs, -1)[need]
            assert torch.equal(held[:, canon - lo][need], want), (elem, rank)
        written = torch.cat(written)
        assert torch.equal(written.sort().values, torch.arange(total)), elem
        # every token-major unit of a row before w0 staged exactly once, by
        # the block that reads it back, and nothing else
        assert torch.equal(staged, (tok_w[None, :] < w0s[:, None]).int()), elem


def test_e4m3_pair_model_matches_to_e4m3():
    x = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    assert torch.equal(kvw.e4m3_pair_model(x).view(torch.uint8), to_e4m3(x).view(torch.uint8))
    edges = torch.tensor(E4M3_EDGES + [-v for v in E4M3_EDGES] + [float("nan"), 463.99, 464.01],
                         dtype=torch.float32)
    assert torch.equal(kvw.e4m3_pair_model(edges).view(torch.uint8),
                       to_e4m3(edges).view(torch.uint8))
