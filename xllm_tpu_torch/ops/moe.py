"""Mixture-of-Experts block: router + grouped expert MLP.

Counterpart of ``xllm_tpu/ops/moe.py`` (single-device subset):

- ``route``: softmax top-k (qwen3-moe) or sigmoid scores with the
  ``e_score_correction_bias`` and group-limited top-k (glm4-moe,
  deepseek-v3 "noaux_tc"); logits in f32 from the model-dtype product;
- ``moe_mlp_gmm``: the (token, expert) pairs sorted by expert, two grouped
  GEMMs (K10, ``ops/cuda/gmm.py``) over the expert-stacked weights, and a
  combine with the routing weights in f32. It runs on the CPU too, with
  K10's plain version, so the tests reach the same sort, gather and
  combine that the card runs;
- ``moe_mlp_ref``: the dense oracle (every expert on every token), kept
  for the tests;
- ``moe_mlp``: the entry the model calls. Expert parallelism, EPLB
  placements, redundant experts and expert-load counts are not ported yet
  and raise.

Weight layout: gate_up ``[E, D, 2I]`` (gate columns, then up columns, per
expert), down ``[E, I, D]``. fp8 expert stacks (float8_e4m3fn, weight-only)
come with f32 per-(expert, channel) scales ``gate_up_scale [E, 2I]`` /
``down_scale [E, D]``: K10 upcasts the weights and the scales multiply its
f32 output rows by each row's expert, before the activation and before the
combine, as the JAX ``deq`` does.

On the card nothing between the router and the combine reads back to the
host: expert counts come from ``scatter_add_`` (``bincount`` would read the
largest id back), the group offsets from ``cumsum``, and K10 builds its
tile list on the device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xllm_tpu_torch.ops.cuda.gmm import gmm
from xllm_tpu_torch.ops.linear import linear_f32


def route(
    x: torch.Tensor,  # [T, D]
    router_w: torch.Tensor,  # [D, E]
    num_experts_per_tok: int,
    norm_topk_prob: bool,
    scoring: str = "softmax",
    bias: torch.Tensor | None = None,  # [E] f32 e_score_correction_bias
    n_group: int = 1,
    topk_group: int = 1,
    routed_scaling: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (weights [T, k] f32, expert_ids [T, k] int64)."""
    logits = linear_f32(x, router_w.to(x.dtype))
    k = num_experts_per_tok
    if scoring == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores if bias is None else scores + bias.float()[None, :]
        if n_group > 1:
            t, e = sel.shape
            gsel = sel.reshape(t, n_group, e // n_group)
            # group strength = sum of its top-2 biased scores
            gscore = gsel.topk(2, dim=-1).values.sum(dim=-1)  # [T, G]
            gidx = gscore.topk(topk_group, dim=-1).indices
            gmask = torch.zeros(t, n_group, dtype=torch.bool, device=x.device)
            gmask.scatter_(1, gidx, True)
            sel = torch.where(
                gmask.repeat_interleave(e // n_group, dim=1), sel, float("-inf")
            )
        topi = sel.topk(k, dim=-1).indices
        topv = torch.gather(scores, 1, topi)
    else:
        probs = torch.softmax(logits, dim=-1)
        topv, topi = probs.topk(k, dim=-1)
    if norm_topk_prob:
        topv = topv / topv.sum(dim=-1, keepdim=True).clamp(min=1e-20)
    if routed_scaling != 1.0:
        topv = topv * routed_scaling
    return topv, topi


def group_by_expert(
    expert_ids: torch.Tensor, num_experts: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(token, expert) pairs grouped by expert, on the device: -> (order
    [T*k] int64, the pairs sorted by expert (stable: token order within an
    expert), group_offsets [E + 1] int32 for K10)."""
    flat_e = expert_ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(num_experts, dtype=torch.int32, device=flat_e.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0).to(torch.int32)])
    return order, offsets


def moe_mlp_ref(
    x: torch.Tensor,  # [T, D]
    router_w: torch.Tensor,
    gate_up: torch.Tensor,  # [E, D, 2I]
    down: torch.Tensor,  # [E, I, D]
    num_experts_per_tok: int,
    norm_topk_prob: bool,
    **route_kw,
) -> torch.Tensor:
    """Dense oracle: every expert on every token, masked combine."""
    t = x.shape[0]
    e, _, i2 = gate_up.shape
    i = i2 // 2
    topv, topi = route(x, router_w, num_experts_per_tok, norm_topk_prob, **route_kw)
    comb = torch.zeros(t, e, dtype=torch.float32, device=x.device)
    comb.scatter_add_(1, topi, topv)
    gu = torch.einsum("td,edi->tei", x.float(), gate_up.float())
    act = (F.silu(gu[..., :i]) * gu[..., i:]).to(x.dtype)
    out = torch.einsum("tei,eid->ted", act.float(), down.float())
    return torch.einsum("ted,te->td", out, comb).to(x.dtype)


def moe_mlp_gmm(
    x: torch.Tensor,  # [T, D]
    router_w: torch.Tensor,  # [D, E]
    gate_up: torch.Tensor,  # [E, D, 2I]
    down: torch.Tensor,  # [E, I, D]
    num_experts_per_tok: int,
    norm_topk_prob: bool,
    gate_up_scale: torch.Tensor | None = None,  # [E, 2I] f32 (fp8 experts)
    down_scale: torch.Tensor | None = None,  # [E, D] f32
    **route_kw,
) -> torch.Tensor:
    """Sorted grouped-GEMM path: only the routed pairs are computed."""
    t = x.shape[0]
    e = gate_up.shape[0]
    i = gate_up.shape[2] // 2
    k = num_experts_per_tok
    topv, topi = route(x, router_w, k, norm_topk_prob, **route_kw)
    order, offsets = group_by_expert(topi, e)  # pair p is token p // k
    expert_of_pair = topi.reshape(-1)[order]

    def deq(o, scales):  # weight-only scales on the f32 GEMM rows
        return o if scales is None else o * scales[expert_of_pair]

    xs = x[order // k]  # [T*k, D] rows gathered in expert order
    gu = deq(gmm(xs, gate_up, offsets), gate_up_scale)  # [T*k, 2I] f32
    act = (F.silu(gu[:, :i]) * gu[:, i:]).to(x.dtype)
    od = deq(gmm(act, down, offsets), down_scale)  # [T*k, D] f32
    # combine without atomics: un-sort the k rows of each token, weight
    # them and sum over k in a fixed order
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=x.device)
    od = od[pos].reshape(t, k, -1)
    out = (od * topv[:, :, None]).sum(dim=1)
    return out.to(x.dtype)


def moe_mlp(
    x: torch.Tensor,
    router_w: torch.Tensor,
    gate_up: torch.Tensor,
    down: torch.Tensor,
    num_experts_per_tok: int,
    norm_topk_prob: bool,
    placement: torch.Tensor | None = None,
    return_counts: bool = False,
    mesh=None,
    gate_up_scale: torch.Tensor | None = None,
    down_scale: torch.Tensor | None = None,
    **route_kw,
) -> torch.Tensor:
    """The MoE block of one layer on one device -> [T, D] in x's dtype.

    ``placement`` (the EPLB slot map) must be None: the model checks at
    load time that the JAX tree's placement is the identity."""
    if mesh is not None:
        raise NotImplementedError("expert parallelism is not ported yet")
    if placement is not None:
        raise NotImplementedError("EPLB placements are not ported yet")
    if gate_up.shape[0] != router_w.shape[-1]:
        raise NotImplementedError("redundant expert slots (EPLB) are not ported yet")
    if return_counts:
        raise NotImplementedError("expert-load counts (EPLB) are not ported yet")
    return moe_mlp_gmm(
        x, router_w, gate_up, down, num_experts_per_tok, norm_topk_prob,
        gate_up_scale=gate_up_scale, down_scale=down_scale, **route_kw
    )
