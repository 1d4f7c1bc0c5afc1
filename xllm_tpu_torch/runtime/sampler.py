"""Sampler: greedy / temperature / top-k / top-p, repetition / frequency /
presence penalties, per-request seeds, logprobs.

Counterpart of ``xllm_tpu/runtime/sampler.py``, one pass over the [N, V]
logits:

1. ``torch.topk`` keeps K = 64 candidates per row (the JAX module's
   ``lax.approx_max_k``, which returns exactly ``lax.top_k`` on CPU);
2. penalties apply inside the candidate set, with occurrence counts from
   the device-resident token-history ring (no [N, V] histogram);
3. per-row top-k / top-p masks apply inside the candidate set;
4. Gumbel-max picks inside the set. Unseeded rows draw their noise from
   ``si.key`` (a ``torch.Generator``); a row with a per-request ``seed``
   draws from a generator seeded from (seed, step), so a seeded request
   reproduces whatever batch it runs in. ``gumbel`` lets a caller hand in
   the noise instead (the tests feed both packages the same numbers);
5. greedy rows (temperature == 0) take the first argmax of the raw logits,
   or of the penalized candidates when penalties are active.
"""

from __future__ import annotations

import hashlib

import torch

from xllm_tpu_torch.runtime.forward_params import SamplingInput

_PRUNE_K = 64
_NEG_INF = -1e30


def _penalize(
    top_vals: torch.Tensor,  # [N, k] raw candidate logits (f32)
    top_idx: torch.Tensor,  # [N, k] candidate token ids
    hist: torch.Tensor,  # [N, T] token history (junk beyond hist_len)
    si: SamplingInput,
) -> torch.Tensor:
    """HF/OpenAI-semantics penalties on the candidate set."""
    t = hist.shape[1]
    valid = (
        torch.arange(t, device=hist.device)[None, :] < si.hist_len[:, None]
    )  # [N, T]
    eq = (hist[:, None, :] == top_idx[:, :, None]) & valid[:, None, :]
    counts = eq.sum(dim=-1).float()  # [N, k]
    seen = counts > 0
    rp = si.repetition_penalty[:, None]
    vals = torch.where(seen & (top_vals > 0), top_vals / rp, top_vals)
    vals = torch.where(seen & (top_vals <= 0), top_vals * rp, vals)
    vals = vals - counts * si.frequency_penalty[:, None]
    vals = vals - seen.float() * si.presence_penalty[:, None]
    return vals


def _gumbel(shape, generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_(min=1e-20)))


def _stream_seed(seed: int, step: int) -> int:
    """One generator seed per (seed, step), mixed by a hash: the CPU
    generator keeps only the low 32 bits of its seed, so packing the pair
    into one integer would let requests with different seeds share noise."""
    digest = hashlib.blake2b(f"{seed}:{step}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def gumbel_noise(
    n: int,
    k: int,
    generator: torch.Generator,
    device,
    seeds=None,  # host int sequence [N] (-1 = unseeded)
    steps=None,  # host int sequence [N]
) -> torch.Tensor:
    """[N, k] Gumbel noise: rows with a seed >= 0 from their own
    (seed, step) stream, the others from ``generator``."""
    noise = _gumbel((n, k), generator, device)
    if seeds is not None:
        for i, seed in enumerate(seeds):
            if seed >= 0:
                g = torch.Generator(device=device)
                g.manual_seed(_stream_seed(int(seed), int(steps[i])))
                noise[i] = _gumbel((k,), g, device)
    return noise


def sample(
    logits: torch.Tensor,  # [N, V] f32 or bf16 (model dtype)
    si: SamplingInput,
    hist: torch.Tensor | None = None,  # [N, T] rows of the history ring
    num_top: int = 0,  # also return the top-K alternatives (top_logprobs)
    need_logprobs: bool = True,  # skip the exact logsumexp pass when no
    # request of the batch reports logprobs
    gumbel: torch.Tensor | None = None,  # [N, min(64, V)] noise override
):
    """-> (token_ids [N] int32, logprobs [N] f32 of the chosen token
    [, top_ids [N, num_top] int32, top_logprobs [N, num_top] f32])."""
    n, v = logits.shape
    k = min(_PRUNE_K, v)

    top_vals, top_idx = torch.topk(logits, k, dim=-1)  # [N, k] descending
    top_vals = top_vals.float()
    if hist is not None:
        top_vals = _penalize(top_vals, top_idx, hist, si)
        # penalties reorder candidates: re-sort (stable, as jnp.argsort)
        # since the positional top-k and nucleus masks assume sorted order
        order = torch.argsort(-top_vals, dim=-1, stable=True)
        top_vals = torch.gather(top_vals, 1, order)
        top_idx = torch.gather(top_idx, 1, order)
        greedy = top_idx[:, 0].int()
    else:
        greedy = torch.argmax(logits, dim=-1).int()

    temp = torch.clamp(si.temperature, min=1e-6)[:, None]
    scaled = top_vals / temp

    # top-k mask inside the pruned set
    pos = torch.arange(k, device=logits.device)[None, :]
    eff_top_k = torch.where(
        si.top_k > 0, torch.clamp(si.top_k, max=k), k
    )[:, None]
    mask = pos < eff_top_k

    # top-p (nucleus): keep the smallest prefix with cum prob >= top_p
    probs = torch.softmax(torch.where(mask, scaled, _NEG_INF), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    mask = mask & ((cum - probs) < si.top_p[:, None])

    masked = torch.where(mask, scaled, _NEG_INF)
    if gumbel is None:
        gumbel = gumbel_noise(n, k, si.key, logits.device)
    sampled_local = torch.argmax(masked + gumbel, dim=-1)
    sampled = torch.gather(top_idx, 1, sampled_local[:, None])[:, 0]

    tokens = torch.where(si.temperature == 0.0, greedy, sampled.int()).int()

    if not need_logprobs and num_top == 0:
        return tokens, torch.zeros(n, dtype=torch.float32, device=logits.device)

    # logprob of the chosen token under the raw (temperature-free) model
    logz = torch.logsumexp(logits.float(), dim=-1)
    chosen = torch.gather(logits, 1, tokens[:, None].long())[:, 0].float()
    logprobs = chosen - logz
    if num_top > 0:
        # raw-logit candidates (pre-penalty: alternatives report the model
        # distribution, matching the OpenAI semantics)
        raw_vals, raw_idx = torch.topk(logits, min(num_top, k), dim=-1)
        return tokens, logprobs, raw_idx.int(), raw_vals.float() - logz[:, None]
    return tokens, logprobs
