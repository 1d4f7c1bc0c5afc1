"""Fused write+attend paged-attention entry points (split KV layout).

Counterpart of the split-layout half of ``xllm_tpu/ops/attention.py``. The
KV-cache write is part of the attention op, as in the JAX package; here the
caches are updated in place (JAX donates them) and returned for parity of
signatures. Each call goes through the kernel wrappers of ``ops/cuda/``:
a CUDA tensor launches the hand-written kernel, a CPU tensor takes its
plain PyTorch version. No environment variable swaps one for the other.

Kernel choice, as in the JAX dispatch:
- decode: K1 (``ops/cuda/decode_attention``);
- batched prefill with chunk bucket ``S > block_size``: K2 full-page writer
  then K3 flash prefill;
- batched prefill with ``S <= block_size``: K4 writer (chunks may start
  mid-page) then K3;
- single-chunk prefill (prompt scoring, embeddings): K4b when the chunk
  bucket ``S_pad <= block_size``, else K2b, then K3b. The interleaved
  layouts, which JAX routes through its batched kernels with P = 1, are
  not ported (K8, K9) and raise.
"""

from __future__ import annotations

import torch

from xllm_tpu_torch.ops.cuda.decode_attention import paged_decode_attention_write
from xllm_tpu_torch.ops.cuda.kv_write import (
    kv_write_prefill,
    kv_write_prefill_batched,
    kv_write_rmw,
    kv_write_rmw_batched,
)
from xllm_tpu_torch.ops.cuda.prefill_attention import (
    paged_attention_prefill,
    paged_attention_prefill_batched,
)


def decode_attention_write(
    q: torch.Tensor,  # [B, Hq, D]
    k_new: torch.Tensor,  # [B, Hkv, D]
    v_new: torch.Tensor,
    k_all: torch.Tensor,  # [L, NB, Hkv, bs, D]
    v_all: torch.Tensor,
    layer_idx: int,
    slot_mapping: torch.Tensor,  # [B] int32
    block_tables: torch.Tensor,  # [B, NBmax] int32
    seq_lens: torch.Tensor,  # [B] int32 (including current token)
    scale: float,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Write each sequence's new K/V row, then attend. -> (out, k, v)."""
    out = paged_decode_attention_write(
        q, k_new, v_new, k_all, v_all, layer_idx, slot_mapping, block_tables,
        seq_lens, scale, window,
    )
    return out, k_all, v_all


def prefill_attention_write_batched(
    q: torch.Tensor,  # [P, S, Hq, D]
    k_new: torch.Tensor,  # [P, S, Hkv, D]
    v_new: torch.Tensor,
    k_all: torch.Tensor,  # [L, NB, Hkv, bs, D]
    v_all: torch.Tensor,
    layer_idx: int,
    slot_mapping: torch.Tensor,  # [P, S] int32 (kept for the JAX signature;
    # the writers place rows from block_tables + q_offsets)
    block_tables: torch.Tensor,  # [P, NBmax] int32
    q_offsets: torch.Tensor,  # [P] int32
    kv_lens: torch.Tensor,  # [P] int32 (0 = padded row)
    scale: float,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """P prompt chunks (one per sequence) written + attended. -> (out, k, v)."""
    del slot_mapping
    s = q.shape[1]
    ntoks = kv_lens - q_offsets
    # the writers cast the new rows to the cache dtype (JAX casts them here;
    # an fp8 cache's cast runs inside the kernel, with the same bytes)
    if s <= k_all.shape[3]:
        # small chunks (the tail of a prompt, speculative verify rows) may
        # start mid-page: token-major row writer
        kv_write_rmw_batched(
            k_new, v_new, k_all, v_all, layer_idx, block_tables, q_offsets,
            ntoks,
        )
    else:
        kv_write_prefill_batched(
            k_new.transpose(1, 2), v_new.transpose(1, 2), k_all, v_all,
            layer_idx, block_tables, q_offsets, ntoks,
        )
    out = paged_attention_prefill_batched(
        q, k_all, v_all, layer_idx, block_tables, q_offsets, kv_lens, scale,
        window,
    )
    return out, k_all, v_all


def prefill_attention_write(
    q: torch.Tensor,  # [S, Hq, D]
    k_new: torch.Tensor,  # [S, Hkv, D]
    v_new: torch.Tensor,
    k_all: torch.Tensor,  # [L, NB, Hkv, bs, D]
    v_all: torch.Tensor,
    layer_idx: int,
    slot_mapping: torch.Tensor,  # [S] int32 (kept for the JAX signature)
    block_table: torch.Tensor,  # [NBmax] int32
    q_offset: torch.Tensor,  # [] int32
    kv_len: torch.Tensor,  # [] int32
    scale: float,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One sequence's prompt chunk written + attended. -> (out, k, v)."""
    del slot_mapping
    if k_all.dim() == 6:  # [L, NB, 2, Hkv, bs, D]
        raise NotImplementedError(
            "prefill_attention_write: the interleaved KV layouts (kernels K8, K9) "
            "are not ported yet"
        )
    ntok = kv_len - q_offset
    if k_new.shape[0] <= k_all.shape[3]:
        # a chunk of at most one page may start mid-page: token-major writer
        kv_write_rmw(k_new, v_new, k_all, v_all, layer_idx, block_table, q_offset, ntok)
    else:
        kv_write_prefill(k_new.transpose(0, 1), v_new.transpose(0, 1), k_all, v_all,
                         layer_idx, block_table, q_offset, ntok)
    out = paged_attention_prefill(q, k_all, v_all, layer_idx, block_table, q_offset,
                                  kv_len, scale, window)
    return out, k_all, v_all
