"""Fused write+attend paged-attention entry points.

Counterpart of ``xllm_tpu/ops/attention.py``'s dispatch. The
KV-cache write is part of the attention op, as in the JAX package; here the
caches are updated in place (JAX donates them) and returned for parity of
signatures.

Where the JAX package runs its Pallas kernels (``_use_kernels``: a head_dim
that is a multiple of 128, and ``XLLM_ATTENTION_BACKEND`` not ``ref``),
each call goes through the kernel wrappers of ``ops/cuda/``: a CUDA tensor
launches the hand-written kernel, a CPU tensor takes its plain PyTorch
version. Elsewhere the port computes JAX's portable function in plain
PyTorch on whatever device holds the tensors: the scatter of
``kv_cache_ops`` (every row, padded ones into the null block), then the
oracle of ``attention_ref`` (the normalised P rounded to V's dtype). That
is JAX's own routing, not a fallback: the kernels are never tried first.

Kernel choice, as in the JAX dispatch:
- decode: the function ``XLLM_DECODE_KERNEL`` names
  (``resolve_decode_kernel``; K1 by default);
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
JAX's portable path writes canonical pages whatever ``rowmajor_tail``
says, and so does the port's.
"""

from __future__ import annotations

import functools
import os
from typing import Callable

import torch

from xllm_tpu_torch.ops.attention_ref import (
    paged_attention_decode_ref,
    paged_attention_prefill_ref,
)
from xllm_tpu_torch.ops.cuda.decode_attention import (
    VARIANTS,
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
from xllm_tpu_torch.ops.kv_cache_ops import write_kv, write_kv_interleaved

# the decode function each layout runs when XLLM_DECODE_KERNEL is unset
DEFAULT_DECODE_KERNEL = {"split": "v9t4", "interleaved": "v11t4", "interleaved_rm": "v12t4"}


def is_interleaved(k_all: torch.Tensor) -> bool:
    """True for the interleaved cache [L, NB, 2, Hkv, bs, D] (``v_all`` is a
    rank-1 placeholder)."""
    return k_all.dim() == 6


@functools.lru_cache(maxsize=None)
def _parse_backend(value: str) -> str:
    """JAX's reading of ``XLLM_ATTENTION_BACKEND``: ``ref``, ``interpret``,
    anything else ``auto``."""
    return value if value in ("ref", "interpret") else "auto"


def _use_kernels(head_dim: int, device: torch.device) -> bool:
    """The port's counterpart of JAX's ``_use_pallas``
    (``xllm_tpu/ops/attention.py:66-77``): the kernels run at a head_dim
    that is a multiple of 128 unless ``XLLM_ATTENTION_BACKEND=ref``. JAX
    reads the variable at import; the port reads it at each call (its
    parse cached). ``interpret`` is JAX's CPU hook for running its Pallas
    kernels interpreted; the port's CPU tensors take the kernels' plain
    versions anyway, and a CUDA tensor has no interpreted kernel: raises."""
    backend = _parse_backend(os.environ.get("XLLM_ATTENTION_BACKEND", "auto"))
    if backend == "interpret" and device.type == "cuda":
        raise ValueError(
            "XLLM_ATTENTION_BACKEND=interpret runs the JAX package's Pallas kernels "
            "interpreted on the CPU; the port has no interpreted kernel for a CUDA "
            "tensor (unset it, or use ref)")
    return backend != "ref" and head_dim % 128 == 0


def _parse_tiled_kernel(kver: str, prefix: str) -> int:
    """JAX's ``_parse_tiled_kernel``: ``{prefix}[tT[nN]][p]`` -> the tile T
    (4 by default). The DMA ring depth N and the resident masks ``p`` are
    TPU tuning: parsed, validated and dropped. Raises ValueError where JAX
    raises."""
    spec = kver[len(prefix):]
    if spec.endswith("p"):
        spec = spec[:-1]
        if prefix != "v9":
            raise ValueError(f"premask suffix 'p' is a v9-family option: {kver!r}")
    tile = 4
    if spec.startswith("t"):
        spec = spec[1:]
        if "n" in spec:
            tpart, npart = spec.split("n", 1)
            tile, _ = int(tpart), int(npart)
        else:
            tile = int(spec)
    elif spec:
        raise ValueError(
            f"bad XLLM_DECODE_KERNEL {kver!r}: expected "
            f"{prefix}[tT[nN]][p], e.g. {prefix}t4, {prefix}t4n6")
    return tile


@functools.lru_cache(maxsize=None)
def _resolve(kver: str, layout: str, windowed: bool) -> tuple[Callable, int | None]:
    if layout == "interleaved_rm":
        return paged_decode_attention_write_rm, (
            _parse_tiled_kernel(kver, "v12") if kver.startswith("v12") else 4)
    if layout == "interleaved":
        return paged_decode_attention_write_ilv, (
            _parse_tiled_kernel(kver, "v11") if kver.startswith("v11") else 4)
    if layout != "split":
        raise ValueError(f"unknown kv layout {layout!r}")
    if kver.startswith("v8"):  # "v8cC": chunk C
        return VARIANTS["v8"], int(kver[3:]) if kver.startswith("v8c") else 4
    if kver.startswith("v10"):
        return VARIANTS["v10"], int(kver[4:]) if kver.startswith("v10t") else 4
    if kver.startswith("v9"):
        return VARIANTS["v9"], _parse_tiled_kernel(kver, "v9")
    if kver in ("v7", "v6", "v5", "v4") or kver == "v1" and not windowed:
        return VARIANTS[kver], None
    return VARIANTS["v3"], None  # v1 with a window, v3, v2, and any other name


def resolve_decode_kernel(kver: str, layout: str, window: int) -> tuple[Callable, int | None]:
    """The decode function that ``XLLM_DECODE_KERNEL=kver`` selects on
    ``layout`` (split, interleaved or interleaved_rm), in the JAX dispatch's
    order (``xllm_tpu/ops/attention.py:119-135``, ``:150-253``) -> (wrapper,
    tile): the tile of its rounding walk in pages (v8's chunk, v9's, v10's,
    v11's or v12's T), None for the fixed ones (v1, v3-v7). Raises where
    JAX raises, with the same exception type. Cached per name: decode calls
    it once per layer and step."""
    return _resolve(kver, layout, window > 0)


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
    ilv = is_interleaved(k_all)
    if not _use_kernels(q.shape[-1], q.device):
        if ilv:
            write_kv_interleaved(k_all, layer_idx, k_new, v_new, slot_mapping)
            kc, vc = k_all[:, :, 0], k_all[:, :, 1]
        else:
            kc, vc = write_kv(k_all, v_all, layer_idx, k_new, v_new, slot_mapping)
        out = paged_attention_decode_ref(q, kc, vc, layer_idx, block_tables, seq_lens, scale,
                                         window)
        return out, k_all, v_all
    layout = ("interleaved_rm" if rowmajor_tail else "interleaved") if ilv else "split"
    fn, tile = resolve_decode_kernel(
        os.environ.get("XLLM_DECODE_KERNEL", DEFAULT_DECODE_KERNEL[layout]), layout, window)
    if ilv:
        out = fn(q, k_new, v_new, k_all, layer_idx, slot_mapping, block_tables, seq_lens,
                 scale, window, tile)
    else:
        out = fn(q, k_new, v_new, k_all, v_all, layer_idx, slot_mapping, block_tables,
                 seq_lens, scale, window, tile)
    return out, k_all, v_all


def _prefill_portable(q, k_new, v_new, k_all, v_all, layer_idx, slot_mapping,
                      block_tables, q_offsets, kv_lens, scale, window) -> torch.Tensor:
    """JAX's portable prefill: every row of the P chunks scattered (padded
    ones into the null block), then the oracle per chunk -> [P, S, Hq, D]."""
    p, s = q.shape[:2]
    flat = [x.reshape(p * s, *x.shape[2:]) for x in (k_new, v_new)]
    if is_interleaved(k_all):
        write_kv_interleaved(k_all, layer_idx, *flat, slot_mapping.reshape(p * s))
        kc, vc = k_all[:, :, 0], k_all[:, :, 1]
    else:
        kc, vc = write_kv(k_all, v_all, layer_idx, *flat, slot_mapping.reshape(p * s))
    return torch.stack([
        paged_attention_prefill_ref(q[i], kc, vc, layer_idx, block_tables[i], q_offsets[i],
                                    kv_lens[i], scale, window)
        for i in range(p)])


def prefill_attention_write_batched(
    q: torch.Tensor,  # [P, S, Hq, D]
    k_new: torch.Tensor,  # [P, S, Hkv, D]
    v_new: torch.Tensor,
    k_all: torch.Tensor,  # [L, NB, Hkv, bs, D]
    v_all: torch.Tensor,
    layer_idx: int,
    slot_mapping: torch.Tensor,  # [P, S] int32 (the portable path's; the
    # kernels' writers place rows from block_tables + q_offsets)
    block_tables: torch.Tensor,  # [P, NBmax] int32
    q_offsets: torch.Tensor,  # [P] int32
    kv_lens: torch.Tensor,  # [P] int32 (0 = padded row)
    scale: float,
    window: int = 0,
    rowmajor_tail: bool = False,  # interleaved_rm: row-major tail pages
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """P prompt chunks (one per sequence) written + attended. -> (out, k, v)."""
    if not _use_kernels(q.shape[-1], q.device):
        out = _prefill_portable(q, k_new, v_new, k_all, v_all, layer_idx, slot_mapping,
                                block_tables, q_offsets, kv_lens, scale, window)
        return out, k_all, v_all
    s = q.shape[1]
    ntoks = kv_lens - q_offsets
    if is_interleaved(k_all):
        rm = rowmajor_tail
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
    slot_mapping: torch.Tensor,  # [S] int32 (the portable path's)
    block_table: torch.Tensor,  # [NBmax] int32
    q_offset: torch.Tensor,  # [] int32
    kv_len: torch.Tensor,  # [] int32
    scale: float,
    window: int = 0,
    rowmajor_tail: bool = False,  # interleaved_rm: row-major tail pages
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One sequence's prompt chunk written + attended. -> (out, k, v)."""
    if is_interleaved(k_all) or not _use_kernels(q.shape[-1], q.device):
        # the batched path with P = 1, as in JAX
        out, k_all, v_all = prefill_attention_write_batched(
            q[None], k_new[None], v_new[None], k_all, v_all, layer_idx, slot_mapping[None],
            block_table[None], q_offset.reshape(1), kv_len.reshape(1), scale,
            window=window, rowmajor_tail=rowmajor_tail,
        )
        return out[0], k_all, v_all
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
