"""K9's RMW writer and its e4m3 cast, modelled on the CPU.

The writer (``csrc/kv_write.cu`` ``kv_write_rmw_rm_kernel``) rewrites a
completed page canonical in one launch: a cluster of blocks a page, each
staging the earlier token-major rows of its share in shared memory, a
cluster barrier, then each writing its share. ``rmw_cluster_share`` is
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

SHAPES = [(bs, hkv, d) for bs in (16, 32, 64, 128) for hkv in (2, 4, 8) for d in (64, 128)]


@pytest.mark.parametrize("bs, hkv, d", SHAPES)
def test_rmw_cluster_partition(bs, hkv, d):
    for elem in (1, 2, 4):
        per_head = d * elem // 16
        total = 2 * hkv * bs * per_head
        assert kvw.rmw_cluster_smem(hkv, bs, d, elem) <= kvw.RMW_SMEM_MAX
        tok_w = torch.arange(total) // (2 * hkv * per_head)  # row of a token-major unit
        for w0 in range(bs):
            written, staged = [], []
            for rank in range(kvw.RMW_CLUSTER):
                canon, slots, tm = kvw.rmw_cluster_share(hkv, bs, d, elem, w0, rank)
                written.append(canon)
                staged.append(tm)
                assert len(slots) * 16 <= kvw.rmw_cluster_smem(hkv, bs, d, elem)
                # the reads of step 2: canonical i below w0 from this block's slot i - lo
                lo = int(canon[0]) if len(canon) else 0
                c = canon // (bs * per_head)
                w, u = canon // per_head % bs, canon % per_head
                need = w < w0
                held = torch.full((max(len(canon), 1),), -1)
                held[slots] = tm
                want = (w * 2 * hkv * per_head + c * per_head + u)[need]
                assert torch.equal(held[canon[need] - lo], want), (elem, w0, rank)
            written = torch.cat(written)
            assert torch.equal(written.sort().values, torch.arange(total)), (elem, w0)
            staged = torch.cat(staged)
            assert torch.equal(staged.sort().values,
                               torch.nonzero(tok_w < w0).flatten()), (elem, w0)


def test_e4m3_pair_model_matches_to_e4m3():
    x = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    assert torch.equal(kvw.e4m3_pair_model(x).view(torch.uint8), to_e4m3(x).view(torch.uint8))
    edges = torch.tensor(E4M3_EDGES + [-v for v in E4M3_EDGES] + [float("nan"), 463.99, 464.01],
                         dtype=torch.float32)
    assert torch.equal(kvw.e4m3_pair_model(edges).view(torch.uint8),
                       to_e4m3(edges).view(torch.uint8))
