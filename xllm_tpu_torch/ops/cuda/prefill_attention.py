"""K3: batched causal flash attention over paged KV (``csrc/prefill_attention.cu``).

Replaces ``xllm_tpu/ops/pallas/prefill_attention.py``
``paged_attention_prefill_batched_tpu``. Contract: P prompt chunks, one per
sequence, ``q [P, S, Hq, D]`` at absolute positions ``q_offsets[p] + i``,
each attending causally to its own paged K/V up to ``kv_lens[p]`` through
``block_tables[p]``, GQA, optional sliding ``window``. ``kv_lens[p] == 0``
marks a padded row. Query rows past a chunk's ``kv_len - q_offset`` tokens
(bucket padding) and padded rows come out as zeros, in the kernel and in
its plain version alike.

Quantized caches (int8 codes or float8_e4m3fn; q and the output stay bf16
or f32): P is rounded to bf16 before P.V, as in the TPU kernel, in the
kernel and its plain version alike.

Bound on the card: operations for long chunks (S = 2048), bytes for
short ragged ones; see the CUDA source.
"""

from __future__ import annotations

import ctypes

import torch

from xllm_tpu_torch.ops.cuda import _build

NAME = "prefill_attention_batched"
TPU_KERNEL = (
    "xllm_tpu/ops/pallas/prefill_attention.py:309 "
    "paged_attention_prefill_batched_tpu"
)
_SOURCE = "prefill_attention"
_MAX_GROUP = 64  # query rows per block in the kernel


def paged_attention_prefill_batched_plain(
    q: torch.Tensor,  # [P, S, Hq, D]
    k_all: torch.Tensor,  # [L, NB, Hkv, bs, D]
    v_all: torch.Tensor,
    layer_idx: int,
    block_tables: torch.Tensor,  # [P, NBmax] int32
    q_offsets: torch.Tensor,  # [P] int32
    kv_lens: torch.Tensor,  # [P] int32 (0 = padded row)
    scale: float,
    window: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same zeros for rows without a
    real token)."""
    p, s, hq, d = q.shape
    hkv = k_all.shape[2]
    layer = int(layer_idx)
    bt = block_tables.long()
    k = k_all[layer][bt].float()  # [P, NB, Hkv, bs, D]
    v = v_all[layer][bt].float()
    k = k.permute(0, 2, 1, 3, 4).reshape(p, hkv, -1, d)
    v = v.permute(0, 2, 1, 3, 4).reshape(p, hkv, -1, d)
    qg = q.float().reshape(p, s, hkv, hq // hkv, d)
    scores = torch.einsum("pqkgd,pksd->pkgqs", qg, k) * scale
    q_pos = q_offsets.long()[:, None] + torch.arange(s, device=q.device)  # [P, S]
    kv_idx = torch.arange(k.shape[2], device=q.device)
    mask = (kv_idx[None, None, :] <= q_pos[:, :, None]) & (
        kv_idx[None, None, :] < kv_lens.long()[:, None, None]
    )  # [P, S, S_kv]
    if window > 0:
        mask = mask & (kv_idx[None, None, :] > q_pos[:, :, None] - window)
    live = q_pos < kv_lens.long()[:, None]  # rows holding a real token
    mask = mask & live[:, :, None]
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    if not _build.is_quantized(k_all.dtype):
        probs = torch.nan_to_num(torch.softmax(scores, dim=-1))
        out = torch.einsum("pkgqs,pksd->pqkgd", probs, v).reshape(p, s, hq, d)
        return out.to(q.dtype)
    # quantized cache: P rounded to bf16 before P.V, l of the unrounded P
    m = scores.amax(-1, keepdim=True)
    probs = torch.exp(scores - torch.where(torch.isfinite(m), m, 0.0))
    l = probs.sum(-1)  # 0 for a row without a real token
    out = torch.einsum("pkgqs,pksd->pqkgd", probs.bfloat16().float(), v)
    l = l.permute(0, 3, 1, 2)[..., None]  # [P, S, Hkv, G, 1]
    out = torch.where(l > 0, out / l, 0.0).reshape(p, s, hq, d)
    return out.to(q.dtype)


_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.xllm_prefill_attention.argtypes = [
            i, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i,
            ctypes.c_float, i, p,
        ]
        lib.xllm_prefill_attention.restype = i
        _lib = lib
    return _lib


def paged_attention_prefill_batched(
    q: torch.Tensor,
    k_all: torch.Tensor,
    v_all: torch.Tensor,
    layer_idx: int,
    block_tables: torch.Tensor,
    q_offsets: torch.Tensor,
    kv_lens: torch.Tensor,
    scale: float,
    window: int = 0,
) -> torch.Tensor:
    """-> out [P, S, Hq, D] in q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_prefill_batched_plain(
            q, k_all, v_all, layer_idx, block_tables, q_offsets, kv_lens,
            scale, window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {q.device}")
    p, s, hq, d = q.shape
    nl, nb, hkv, bs, d_cache = k_all.shape
    _build.check_head_dim(d)
    dtype = _build.dtype_code(k_all.dtype)
    # q and the output in the cache dtype; on a quantized cache in q's own
    work = q.dtype if _build.is_quantized(k_all.dtype) else k_all.dtype
    qtype = _build.dtype_code(work)
    if _build.is_quantized(work):
        raise ValueError(f"{NAME}: q must be bfloat16 or float32, not {q.dtype}")
    if d_cache != d or hq % hkv or v_all.shape != k_all.shape:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} vs cache {tuple(k_all.shape)}")
    if hq // hkv > _MAX_GROUP:
        raise NotImplementedError(f"{NAME}: more than {_MAX_GROUP} query heads per kv head")
    if not (k_all.is_contiguous() and v_all.is_contiguous()):
        raise ValueError(f"{NAME}: caches must be contiguous")
    for t in (block_tables, q_offsets, kv_lens):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{NAME}: index arrays must be contiguous int32 on {q.device}")
    qk = q.to(work).contiguous()
    out = torch.empty_like(qk)
    if p == 0 or s == 0:
        return out.to(q.dtype)
    lib = _load()
    _build.count_launch(NAME)
    err = lib.xllm_prefill_attention(
        q.device.index or 0, _build.ptr(qk), _build.ptr(k_all),
        _build.ptr(v_all), _build.ptr(block_tables), _build.ptr(q_offsets),
        _build.ptr(kv_lens), _build.ptr(out), dtype, qtype, d, p, s, int(layer_idx),
        nb, hkv, bs, block_tables.shape[1], hq // hkv, float(scale),
        int(window), _build.stream_of(q),
    )
    _build.check(lib, err, NAME)
    return out.to(q.dtype)
