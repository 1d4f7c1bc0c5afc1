"""Paged attention oracles (counterpart of ``xllm_tpu/ops/attention_ref.py``).

They gather each sequence's pages into a contiguous K/V and compute GQA
attention with an f32 softmax against absolute positions, as the JAX
oracles do, which are also the JAX package's portable path
(``ops/attention.py`` runs them where JAX does): scores from exact
products summed in f32; the normalised probabilities rounded to V's dtype
(the cache's, or q's for an int8 / fp8 cache, whose codes JAX upcasts to
q's dtype) before P V. A row whose mask is empty (``seq_len`` or ``kv_len``
0) gives the mean of the gathered V, exactly as the JAX oracles do; the
kernels' plain versions in ``ops/cuda/`` give zeros there instead.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def _gather_kv(
    cache_all: torch.Tensor,  # [L, num_blocks, Hkv, bs, D]
    layer_idx: int,
    block_tables: torch.Tensor,  # [B, NB]
) -> torch.Tensor:
    """-> [B, Hkv, NB*bs, D] in f32 (every cache value is exact in it)."""
    pages = cache_all[int(layer_idx)][block_tables.long()]  # [B, NB, Hkv, bs, D]
    b, nb, hkv, bs, d = pages.shape
    return pages.permute(0, 2, 1, 3, 4).reshape(b, hkv, nb * bs, d).float()


def _p_dtype(cache_dtype: torch.dtype, q_dtype: torch.dtype) -> torch.dtype:
    """V's dtype in the JAX oracle, to which it rounds the probabilities: a
    quantized cache's pages upcast to q's dtype."""
    return q_dtype if cache_dtype in (torch.int8, torch.float8_e4m3fn) else cache_dtype


def _softmax(scores: torch.Tensor) -> torch.Tensor:
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    return probs / probs.sum(-1, keepdim=True)


def paged_attention_decode_ref(
    q: torch.Tensor,  # [B, Hq, D]
    k_all: torch.Tensor,  # [L, num_blocks, Hkv, bs, D]
    v_all: torch.Tensor,
    layer_idx: int,
    block_tables: torch.Tensor,  # [B, NB] int (0-padded -> null block)
    seq_lens: torch.Tensor,  # [B] int, kv length incl. current token
    scale: float,
    window: int = 0,
) -> torch.Tensor:  # [B, Hq, D]
    b, hq, d = q.shape
    hkv = k_all.shape[2]
    g = hq // hkv
    k = _gather_kv(k_all, layer_idx, block_tables)
    v = _gather_kv(v_all, layer_idx, block_tables)
    s = k.shape[2]
    qg = q.float().reshape(b, hkv, g, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k) * scale
    kv_idx = torch.arange(s, device=q.device)[None, None, None, :]
    lens = seq_lens.long()[:, None, None, None]
    mask = kv_idx < lens
    if window > 0:
        mask = mask & (kv_idx >= lens - window)
    scores = torch.where(mask, scores, _NEG_INF)
    probs = _softmax(scores).to(_p_dtype(v_all.dtype, q.dtype)).float()
    out = torch.einsum("bkgs,bksd->bkgd", probs, v)
    return out.reshape(b, hq, d).to(q.dtype)


def paged_attention_prefill_ref(
    q: torch.Tensor,  # [S, Hq, D] (padded query chunk of ONE sequence)
    k_all: torch.Tensor,  # [L, num_blocks, Hkv, bs, D]
    v_all: torch.Tensor,
    layer_idx: int,
    block_table: torch.Tensor,  # [NB] int
    q_offset,  # int or [] tensor: absolute position of q token 0
    kv_len,  # int or [] tensor: total kv tokens incl. this chunk
    scale: float,
    window: int = 0,
) -> torch.Tensor:  # [S, Hq, D]
    s_q, hq, d = q.shape
    hkv = k_all.shape[2]
    g = hq // hkv
    k = _gather_kv(k_all, layer_idx, block_table[None, :])[0]
    v = _gather_kv(v_all, layer_idx, block_table[None, :])[0]
    s_kv = k.shape[1]
    qg = q.float().reshape(s_q, hkv, g, d)
    scores = torch.einsum("qkgd,ksd->kgqs", qg, k) * scale
    # tensors stay on the device: no host read
    q_pos = torch.as_tensor(q_offset, device=q.device) + torch.arange(s_q, device=q.device)
    kv_idx = torch.arange(s_kv, device=q.device)
    mask = (kv_idx[None, :] <= q_pos[:, None]) & (
        kv_idx[None, :] < torch.as_tensor(kv_len, device=q.device))
    if window > 0:
        mask = mask & (kv_idx[None, :] > q_pos[:, None] - window)
    scores = torch.where(mask[None, None, :, :], scores, _NEG_INF)
    probs = _softmax(scores).to(_p_dtype(v_all.dtype, q.dtype)).float()
    out = torch.einsum("kgqs,ksd->qkgd", probs, v)
    return out.reshape(s_q, hq, d).to(q.dtype)
