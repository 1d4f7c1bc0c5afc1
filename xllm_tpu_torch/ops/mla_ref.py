"""Plain MLA absorbed attention over the latent paged cache: the oracles
of the tests and, under ``XLLM_ATTENTION_BACKEND=ref``, the portable path
of ``ops/mla.py`` (counterpart of ``xllm_tpu/ops/mla_ref.py``).

Absorbed MLA is an MQA over one shared latent head:

    cache[t] = [c_kv (kv_lora_rank, normed) | k_pe (rope dims, roped)]
    q_eff[h] = [q_nope[h] @ W_UK[h] | q_pe[h]]
    scores[h, t] = q_eff[h] . cache[t]
    out_lat[h] = softmax(scores[h]) @ cache[:, :kv_lora_rank]

As the JAX oracle: masked scores are -1e30 (so a row with nothing visible
averages its values), and the probabilities are rounded to the cache dtype
before the value product.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def _gather_pages(cache, layer_idx, block_tables):
    pages = cache[int(layer_idx)][block_tables.long()]  # [B, NB, 1, bs, D]
    b, nb, _, bs, d = pages.shape
    return pages.reshape(b, nb * bs, d)  # [B, S, D]


def _softmax(scores):
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    return probs / probs.sum(-1, keepdim=True)


def mla_decode_ref(
    q_eff: torch.Tensor,  # [B, H, Dk]
    cache: torch.Tensor,  # [L, NB, 1, bs, Dk]
    layer_idx,
    block_tables: torch.Tensor,  # [B, NBmax]
    seq_lens: torch.Tensor,  # [B] incl. current token
    scale: float,
    dv: int,
) -> torch.Tensor:  # [B, H, dv]
    lat = _gather_pages(cache, layer_idx, block_tables)
    scores = torch.einsum("bhd,bsd->bhs", q_eff.float(), lat.float()) * scale
    kv_idx = torch.arange(lat.shape[1], device=lat.device)[None, None, :]
    scores = torch.where(kv_idx < seq_lens.long()[:, None, None], scores, _NEG_INF)
    probs = _softmax(scores).to(lat.dtype).float()
    out = torch.einsum("bhs,bsd->bhd", probs, lat[..., :dv].float())
    return out.to(q_eff.dtype)


def mla_prefill_ref(
    q_eff: torch.Tensor,  # [S, H, Dk]
    cache: torch.Tensor,  # [L, NB, 1, bs, Dk]
    layer_idx,
    block_table: torch.Tensor,  # [NBmax]
    q_offset,
    kv_len,
    scale: float,
    dv: int,
) -> torch.Tensor:  # [S, H, dv]
    lat = _gather_pages(cache, layer_idx, block_table[None])[0]  # [Skv, Dk]
    s_q, s_kv = q_eff.shape[0], lat.shape[0]
    scores = torch.einsum("qhd,sd->hqs", q_eff.float(), lat.float()) * scale
    q_pos = torch.as_tensor(q_offset, device=lat.device) + torch.arange(s_q, device=lat.device)
    kv_idx = torch.arange(s_kv, device=lat.device)
    mask = (kv_idx[None, :] <= q_pos[:, None]) & (
        kv_idx[None, :] < torch.as_tensor(kv_len, device=lat.device))
    scores = torch.where(mask[None], scores, _NEG_INF)
    probs = _softmax(scores).to(lat.dtype).float()
    out = torch.einsum("hqs,sd->qhd", probs, lat[:, :dv].float())
    return out.to(q_eff.dtype)
