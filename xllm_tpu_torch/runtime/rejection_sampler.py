"""Speculative-decoding rejection sampler.

Counterpart of ``xllm_tpu/runtime/rejection_sampler.py``: given k draft
tokens per sequence and the target model's logits at each of the k+1
verify positions, accept the longest draft prefix and emit one bonus or
corrected token, so each verified step yields between 1 and k+1 tokens.

Greedy rows (temperature 0) accept while the target's argmax equals the
draft. Sampled rows use the deterministic-draft rule of the suffix / MTP
drafters (q one-hot): the target's own choice at each position is the
argmax of ``logits / max(T, 1e-6) + gumbel`` over the full vocabulary, and
the draft is accepted while it equals that choice. There is no top-k /
top-p and no per-request seed, as in the JAX function.

Shapes stay fixed: a dense [B, k+1] token matrix plus ``num_accepted``;
callers take ``tokens[b, :num_accepted[b]]``. Nothing reads back to the
host.
"""

from __future__ import annotations

import torch

from xllm_tpu_torch.runtime.sampler import _gumbel


def rejection_sample(
    draft_tokens: torch.Tensor,  # [B, k] int32 (padded rows: anything)
    draft_lens: torch.Tensor,  # [B] int32 actual drafts per row (0..k)
    target_logits: torch.Tensor,  # [B, k+1, V] f32 or the model dtype
    temperature: torch.Tensor,  # [B] f32 (0 = greedy)
    key: torch.Generator | None = None,
    gumbel: torch.Tensor | None = None,  # [B, k+1, V] f32 noise override
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (tokens [B, k+1] int32, num_accepted [B] int32 in [1, k+1]).

    tokens[b, :num_accepted[b]] are the emitted tokens: the accepted draft
    prefix followed by the target's own token at the first mismatch (or
    the bonus token when everything was accepted). The sampled rows' noise
    is ``gumbel`` when given (the tests hand in JAX's), else drawn from
    ``key``; with neither, every row is taken as greedy (the caller knows
    the temperatures on the host and skips the [B, k+1, V] draw)."""
    b, k1, v = target_logits.shape
    k = k1 - 1
    greedy = torch.argmax(target_logits, dim=-1).int()  # [B, k+1]
    if gumbel is None and key is not None:
        gumbel = _gumbel((b, k1, v), key, target_logits.device)
    if gumbel is None:
        target_choice = greedy
    else:
        temp = torch.clamp(temperature, min=1e-6)[:, None, None]
        sampled = torch.argmax(target_logits / temp + gumbel, dim=-1).int()
        target_choice = torch.where((temperature == 0.0)[:, None], greedy, sampled)

    pos = torch.arange(k, device=target_logits.device)[None, :]
    is_draft = pos < draft_lens[:, None]  # [B, k]
    match = (target_choice[:, :k] == draft_tokens) & is_draft
    # accepted[j] = every match at positions <= j
    num_match = torch.cumprod(match.int(), dim=1).sum(dim=1)  # [B]
    num_accepted = (num_match + 1).int()
    out_pos = torch.arange(k1, device=target_logits.device)[None, :]
    take_draft = out_pos < num_match[:, None]
    draft_padded = torch.nn.functional.pad(draft_tokens, (0, 1))
    # the target's token at the first mismatch, or the bonus position
    break_tok = torch.gather(target_choice, 1, num_match[:, None].long())
    tokens = torch.where(take_draft, draft_padded, break_tok).int()
    return tokens, num_accepted
