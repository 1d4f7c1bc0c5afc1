"""Paged KV-cache scatter (counterpart of ``xllm_tpu/ops/kv_cache_ops.py``).

Split layout, all layers stacked:

    k_cache, v_cache: [L, num_blocks, num_kv_heads, block_size, head_dim]

and the interleaved one, a page's K and V together (``write_kv_interleaved``):

    kv_cache: [L, num_blocks, 2, num_kv_heads, block_size, head_dim]

``write_kv`` is JAX's portable scatter and the oracle for the cache
writers: every token, padded ones included, lands at ``slot_mapping``
(block_id * block_size + offset; padded tokens carry slot 0 and land in
the reserved null block 0), cast to the cache dtype. ``ops/attention.py``
runs it where the JAX package runs its portable path; elsewhere the
kernels in ``ops/cuda/`` write, skipping padded tokens. The caches are
updated in place either way.
"""

from __future__ import annotations

import torch

from xllm_tpu_torch.ops.quant import cast_to


def _put(cache: torch.Tensor, index: tuple, rows: torch.Tensor) -> None:
    """``cache[index] = rows`` cast to the cache dtype (fp8 with the JAX
    package's bytes), as bytes on a 1-byte cache."""
    rows = cast_to(rows, cache.dtype)
    if cache.element_size() == 1:
        cache, rows = cache.view(torch.uint8), rows.view(torch.uint8)
    cache[index] = rows


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
    _put(k_all, (int(layer_idx), block_idx, slice(None), offset), k_new)
    _put(v_all, (int(layer_idx), block_idx, slice(None), offset), v_new)
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
    new = torch.stack([k_new, v_new], dim=1)  # [T, 2, Hkv, D]
    _put(kv_all, (int(layer_idx), slot // bs, slice(None), slice(None), slot % bs), new)
    return kv_all
