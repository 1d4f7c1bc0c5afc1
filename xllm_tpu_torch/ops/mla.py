"""MLA latent-attention entry points (counterpart of ``xllm_tpu/ops/mla.py``).

The cache write is part of the op, as in the JAX package; here the latent
cache ``[L, NB, 1, bs, Dk]`` is updated in place (JAX donates it) and
returned for parity of signatures. Each call goes through the kernel
wrappers of ``ops/cuda/``: a CUDA tensor launches the hand-written kernel,
a CPU tensor takes its plain PyTorch version.

Under ``XLLM_ATTENTION_BACKEND=ref`` (``ops/attention._use_kernels``, which
JAX's MLA dispatch asks at head_dim 128) each entry point computes JAX's
portable function instead, in plain PyTorch on whatever device holds the
tensors: the latent scatter, then ``mla_ref``.

Kernel choice, as in the JAX dispatch:
- decode: K11a (``ops/cuda/mla_attention.mla_decode_attention_write``);
- batched prefill with chunk bucket ``S <= block_size``: K11d writer (chunks
  may start mid-page), else K11c (page-aligned chunks); then K11b;
- single-chunk prefill (prompt scoring, embeddings): K11g for a chunk
  bucket ``S_pad <= block_size``, else K11f; then K11e.
"""

from __future__ import annotations

import torch

from xllm_tpu_torch.ops import mla_ref
from xllm_tpu_torch.ops.attention import _use_kernels
from xllm_tpu_torch.ops.cuda.kv_write import (
    latent_write_prefill,
    latent_write_prefill_batched,
    latent_write_rmw,
    latent_write_rmw_batched,
)
from xllm_tpu_torch.ops.cuda.mla_attention import (
    mla_decode_attention_write as _decode_kernel,
)
from xllm_tpu_torch.ops.cuda.mla_attention import (
    mla_prefill_attention,
    mla_prefill_attention_batched,
)
from xllm_tpu_torch.ops.kv_cache_ops import _put


def _write_latent_scatter(cache, layer_idx, lat_new, slot_mapping) -> None:
    """JAX's portable latent write: every row (padded ones into the null
    block) into the single-head cache, cast to its dtype."""
    bs = cache.shape[3]
    slot = slot_mapping.long()
    _put(cache, (int(layer_idx), slot // bs, 0, slot % bs), lat_new)


def mla_decode_attention_write(
    q_eff: torch.Tensor,  # [B, H, Dk]
    lat_new: torch.Tensor,  # [B, Dk]
    cache: torch.Tensor,  # [L, NB, 1, bs, Dk]
    layer_idx: int,
    slot_mapping: torch.Tensor,  # [B] int32
    block_tables: torch.Tensor,  # [B, NBmax] int32
    seq_lens: torch.Tensor,  # [B] int32 (incl. the current token)
    scale: float,
    dv: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write each sequence's new latent row, then attend. -> (out, cache)."""
    if not _use_kernels(128, q_eff.device):
        _write_latent_scatter(cache, layer_idx, lat_new, slot_mapping)
        return mla_ref.mla_decode_ref(q_eff, cache, layer_idx, block_tables, seq_lens, scale,
                                      dv), cache
    out = _decode_kernel(q_eff, lat_new, cache, layer_idx, slot_mapping,
                         block_tables, seq_lens, scale, dv)
    return out, cache


def mla_prefill_attention_write_batched(
    q_eff: torch.Tensor,  # [P, S, H, Dk]
    lat_new: torch.Tensor,  # [P, S, Dk]
    cache: torch.Tensor,  # [L, NB, 1, bs, Dk]
    layer_idx: int,
    slot_mapping: torch.Tensor,  # [P, S] (the portable path's; the kernels'
    # writers place rows from block_tables + q_offsets)
    block_tables: torch.Tensor,  # [P, NBmax] int32
    q_offsets: torch.Tensor,  # [P] int32
    kv_lens: torch.Tensor,  # [P] int32 (0 = padded row)
    scale: float,
    dv: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """P latent chunks written + attended. -> (out [P, S, H, dv], cache)."""
    if not _use_kernels(128, q_eff.device):
        p, s = lat_new.shape[:2]
        _write_latent_scatter(cache, layer_idx, lat_new.reshape(p * s, -1),
                              slot_mapping.reshape(p * s))
        return torch.stack([
            mla_ref.mla_prefill_ref(q_eff[i], cache, layer_idx, block_tables[i], q_offsets[i],
                                    kv_lens[i], scale, dv) for i in range(p)]), cache
    ntoks = kv_lens - q_offsets
    writer = (latent_write_rmw_batched if lat_new.shape[1] <= cache.shape[3]
              else latent_write_prefill_batched)
    writer(lat_new, cache, layer_idx, block_tables, q_offsets, ntoks)
    out = mla_prefill_attention_batched(q_eff, cache, layer_idx, block_tables,
                                        q_offsets, kv_lens, scale, dv)
    return out, cache


def mla_prefill_attention_write(
    q_eff: torch.Tensor,  # [S, H, Dk]
    lat_new: torch.Tensor,  # [S, Dk]
    cache: torch.Tensor,  # [L, NB, 1, bs, Dk]
    layer_idx: int,
    slot_mapping: torch.Tensor,  # [S] (the portable path's)
    block_table: torch.Tensor,  # [NBmax] int32
    q_offset: torch.Tensor,  # [] int32
    kv_len: torch.Tensor,  # [] int32
    scale: float,
    dv: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One latent chunk written + attended. -> (out [S, H, dv], cache)."""
    if not _use_kernels(128, q_eff.device):
        _write_latent_scatter(cache, layer_idx, lat_new, slot_mapping)
        return mla_ref.mla_prefill_ref(q_eff, cache, layer_idx, block_table, q_offset, kv_len,
                                       scale, dv), cache
    ntok = kv_len - q_offset
    writer = latent_write_rmw if lat_new.shape[0] <= cache.shape[3] else latent_write_prefill
    writer(lat_new, cache, layer_idx, block_table, q_offset, ntok)
    out = mla_prefill_attention(q_eff, cache, layer_idx, block_table, q_offset, kv_len,
                                scale, dv)
    return out, cache
