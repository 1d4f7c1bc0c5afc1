"""Paged KV-cache scatter (counterpart of ``xllm_tpu/ops/kv_cache_ops.py``).

Split layout, all layers stacked:

    k_cache, v_cache: [L, num_blocks, num_kv_heads, block_size, head_dim]

and the interleaved one, a page's K and V together (``write_kv_interleaved``):

    kv_cache: [L, num_blocks, 2, num_kv_heads, block_size, head_dim]

``write_kv`` is the portable oracle for the cache writers: every token,
padded ones included, lands at ``slot_mapping`` (block_id * block_size +
offset; padded tokens carry slot 0 and land in the reserved null block 0).
The served path writes through the kernels in ``ops/cuda/`` instead, which
skip padded tokens; the caches are updated in place either way.
"""

from __future__ import annotations

import torch


def write_kv(
    k_all: torch.Tensor,  # [L, num_blocks, Hkv, bs, D]
    v_all: torch.Tensor,
    layer_idx: int,
    k_new: torch.Tensor,  # [T, Hkv, D]
    v_new: torch.Tensor,  # [T, Hkv, D]
    slot_mapping: torch.Tensor,  # [T] int, block*bs + off (0 = null)
) -> tuple[torch.Tensor, torch.Tensor]:
    block_size = k_all.shape[3]
    slot = slot_mapping.long()
    block_idx = slot // block_size
    offset = slot % block_size
    k_all[int(layer_idx), block_idx, :, offset, :] = k_new.to(k_all.dtype)
    v_all[int(layer_idx), block_idx, :, offset, :] = v_new.to(v_all.dtype)
    return k_all, v_all


def write_kv_interleaved(
    kv_all: torch.Tensor,  # [L, num_blocks, 2, Hkv, bs, D]
    layer_idx: int,
    k_new: torch.Tensor,  # [T, Hkv, D]
    v_new: torch.Tensor,  # [T, Hkv, D]
    slot_mapping: torch.Tensor,  # [T] int, block*bs + off (0 = null)
) -> torch.Tensor:
    """The scatter of ``write_kv`` into the interleaved cache, whose page
    holds its K and V contiguously (``kv_all[:, :, 0]`` and ``[:, :, 1]``),
    as canonical pages: the portable oracle of the interleaved writers
    (the row-major tails of ``interleaved_rm`` are the kernels' business,
    ``ops/cuda/kv_write.py``)."""
    bs = kv_all.shape[4]
    slot = slot_mapping.long()
    new = torch.stack([k_new, v_new], dim=1).to(kv_all.dtype)  # [T, 2, Hkv, D]
    kv_all[int(layer_idx), slot // bs, :, :, slot % bs, :] = new
    return kv_all
