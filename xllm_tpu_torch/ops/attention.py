"""Fused write+attend paged-attention entry points.

Counterpart of ``xllm_tpu/ops/attention.py``'s dispatch. The
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
  bucket ``S_pad <= block_size``, else K2b, then K3b.

The interleaved layouts (``kv_layout="interleaved"`` / ``"interleaved_rm"``)
keep one cache ``k_all [L, NB, 2, Hkv, bs, D]``, a page's K and V
together; ``v_all`` is then a rank-1 placeholder that threads through:
- decode: K9 (``rowmajor_tail``: row-major tail pages) or K8;
- batched prefill: for ``S <= block_size`` K9's or K8's RMW writer, else
  K9's or K8's full-page writer, then K8's prefill (reading the row-major
  tail with ``rowmajor_tail``);
- single-chunk prefill: the batched kernels with P = 1, as in JAX.
As in JAX, ``rowmajor_tail`` holds only where the JAX package runs its
kernels, at a head_dim that is a multiple of 128; at another head_dim
(whose caches JAX writes in canonical pages) the interleaved_rm layout
runs K8 and keeps canonical pages.
"""

from __future__ import annotations

import torch

from xllm_tpu_torch.ops.cuda.decode_attention import (
    paged_decode_attention_write,
    paged_decode_attention_write_ilv,
    paged_decode_attention_write_rm,
)
from xllm_tpu_torch.ops.cuda.kv_write import (
    kv_write_prefill,
    kv_write_prefill_batched,
    kv_write_prefill_batched_ilv,
    kv_write_prefill_batched_rm,
    kv_write_rmw,
    kv_write_rmw_batched,
    kv_write_rmw_batched_ilv,
    kv_write_rmw_batched_rm,
)
from xllm_tpu_torch.ops.cuda.prefill_attention import (
    paged_attention_prefill,
    paged_attention_prefill_batched,
    paged_attention_prefill_batched_ilv,
)


def is_interleaved(k_all: torch.Tensor) -> bool:
    """True for the interleaved cache [L, NB, 2, Hkv, bs, D] (``v_all`` is a
    rank-1 placeholder)."""
    return k_all.dim() == 6


def _rowmajor(rowmajor_tail: bool, head_dim: int) -> bool:
    """Row-major tails where the JAX package keeps them: its kernels run at
    a head_dim that is a multiple of 128, its portable path writes
    canonical pages."""
    return rowmajor_tail and head_dim % 128 == 0


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
    rowmajor_tail: bool = False,  # interleaved_rm: row-major tail pages
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Write each sequence's new K/V row, then attend. -> (out, k, v)."""
    if is_interleaved(k_all):
        fn = (paged_decode_attention_write_rm if _rowmajor(rowmajor_tail, q.shape[-1])
              else paged_decode_attention_write_ilv)
        out = fn(q, k_new, v_new, k_all, layer_idx, slot_mapping, block_tables, seq_lens,
                 scale, window)
        return out, k_all, v_all
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
    rowmajor_tail: bool = False,  # interleaved_rm: row-major tail pages
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """P prompt chunks (one per sequence) written + attended. -> (out, k, v)."""
    del slot_mapping
    s = q.shape[1]
    ntoks = kv_lens - q_offsets
    if is_interleaved(k_all):
        rm = _rowmajor(rowmajor_tail, q.shape[-1])
        args = (k_all, layer_idx, block_tables, q_offsets, ntoks)
        if s <= k_all.shape[4]:
            if rm:
                kv_write_rmw_batched_rm(k_new, v_new, *args, kv_lens)
            else:
                kv_write_rmw_batched_ilv(k_new, v_new, *args)
        elif rm:
            kv_write_prefill_batched_rm(k_new.transpose(1, 2), v_new.transpose(1, 2), *args,
                                        kv_lens)
        else:
            kv_write_prefill_batched_ilv(k_new.transpose(1, 2), v_new.transpose(1, 2), *args)
        out = paged_attention_prefill_batched_ilv(
            q, k_all, layer_idx, block_tables, q_offsets, kv_lens, scale, window, rm,
        )
        return out, k_all, v_all
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
    rowmajor_tail: bool = False,  # interleaved_rm: row-major tail pages
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One sequence's prompt chunk written + attended. -> (out, k, v)."""
    if is_interleaved(k_all):  # the batched kernels with P = 1, as in JAX
        out, k_all, v_all = prefill_attention_write_batched(
            q[None], k_new[None], v_new[None], k_all, v_all, layer_idx, slot_mapping[None],
            block_table[None], q_offset.reshape(1), kv_len.reshape(1), scale,
            window=window, rowmajor_tail=rowmajor_tail,
        )
        return out[0], k_all, v_all
    del slot_mapping
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
