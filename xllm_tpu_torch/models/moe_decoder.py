"""MoE decoder-only transformer (qwen3-moe, glm4-moe, minimax-m2).

Counterpart of ``xllm_tpu/models/moe_decoder.py`` ``MoeDecoderModel``:
the dense decoder's attention with a routed expert block
(``ops/moe.py``) in place of the dense MLP. The first
``first_k_dense_replace`` layers keep the dense MLP (glm4-moe); the
router's correction bias is f32 even in a bf16 model, and
``routed_scaling_factor`` scales the routed output. Shared experts
(``n_shared_experts``) are a dense MLP of width ``n_shared_experts *
moe_intermediate_size`` added to it.

Single device only: the expert-parallel sharding and the EPLB slot map of
the JAX model are not ported yet (``ops/moe.moe_mlp`` raises for them;
``weights.py`` accepts only the identity placement).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from xllm_tpu_torch.config import ModelConfig
from xllm_tpu_torch.models.decoder import DecoderLayer, DenseDecoderModel, _param
from xllm_tpu_torch.ops.linear import linear_f32
from xllm_tpu_torch.ops.moe import moe_mlp


class MoeDecoderLayer(DecoderLayer):
    """Attention as the dense layer; router and expert stacks in place of
    the dense MLP, named as the JAX parameter tree's keys."""

    def __init__(self, cfg: ModelConfig, dtype, device) -> None:
        super().__init__(cfg, dtype, device, dense_mlp=False)
        d, e, i = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size
        kw = dict(dtype=dtype, device=device)
        self.router_w = _param(d, e, **kw)
        if cfg.scoring_func == "sigmoid":
            self.router_bias = _param(e, dtype=torch.float32, device=device)
        self.experts_gate_up = _param(e, d, 2 * i, **kw)
        self.experts_down = _param(e, i, d, **kw)
        if cfg.n_shared_experts > 0:
            si = cfg.n_shared_experts * i
            self.shared_gate_proj_w = _param(d, si, **kw)
            self.shared_up_proj_w = _param(d, si, **kw)
            self.shared_down_proj_w = _param(si, d, **kw)


class MoeDecoderModel(DenseDecoderModel):
    def __init__(self, cfg: ModelConfig, device="cpu") -> None:
        if cfg.num_experts <= 0:
            raise ValueError("MoeDecoderModel requires num_experts > 0")
        if cfg.mlp_only_layers or cfg.decoder_sparse_step != 1:
            raise NotImplementedError(
                "dense/sparse mixed stacks land with the deepseek family"
            )
        super().__init__(cfg, device=device)
        self.n_dense = cfg.first_k_dense_replace

    def _make_layer(self, layer_idx: int) -> nn.Module:
        if layer_idx < self.cfg.first_k_dense_replace:
            return DecoderLayer(self.cfg, self.dtype, self.device)
        return MoeDecoderLayer(self.cfg, self.dtype, self.device)

    def _mlp(self, lp: DecoderLayer, x: torch.Tensor) -> torch.Tensor:
        if not isinstance(lp, MoeDecoderLayer):
            return super()._mlp(lp, x)
        return self._moe_block(lp, x)

    def _moe_block(self, lp: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """Routed experts x ``routed_scaling_factor`` plus the shared
        experts' MLP (also the MLA families' MoE block)."""
        c = self.cfg
        out = moe_mlp(
            x, lp.router_w, lp.experts_gate_up, lp.experts_down,
            c.num_experts_per_tok, c.norm_topk_prob,
            scoring=c.scoring_func, bias=getattr(lp, "router_bias", None),
            n_group=c.n_group, topk_group=c.topk_group,
        )
        if c.routed_scaling_factor != 1.0:
            out = out * c.routed_scaling_factor
        if c.n_shared_experts > 0:
            gate = linear_f32(x, lp.shared_gate_proj_w)
            up = linear_f32(x, lp.shared_up_proj_w)
            act = (F.silu(gate) * up).to(x.dtype)
            out = out + torch.matmul(act, lp.shared_down_proj_w)
        return out.to(x.dtype)
