"""MoE decoder-only transformer (qwen3-moe, glm4-moe, minimax-m2).

Counterpart of ``xllm_tpu/models/moe_decoder.py`` ``MoeDecoderModel``:
the dense decoder's attention with a routed expert block
(``ops/moe.py``) in place of the dense MLP. The first
``first_k_dense_replace`` layers keep the dense MLP (glm4-moe); the
router's correction bias is f32 even in a bf16 model, and
``routed_scaling_factor`` scales the routed output. Shared experts
(``n_shared_experts``) are a dense MLP of width ``n_shared_experts *
moe_intermediate_size`` added to it.

Quantized (``quant="int8" | "fp8_e4m3"``), with the JAX runner's
eligibility: every ``*_proj_w`` (attention, shared experts, the dense first
layers) is stored quantized with its ``*_scale`` and goes through
``_linear``; the router never is; the routed expert stacks only under fp8
(``experts_*_scale [E, N]``; K10 upcasts them), and stay in the model dtype
under int8.

Single device only: the expert-parallel sharding and the EPLB slot map of
the JAX model are not ported yet (``ops/moe.moe_mlp`` raises for them;
``weights.py`` accepts only the identity placement).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from xllm_tpu_torch.config import ModelConfig
from xllm_tpu_torch.models.decoder import (
    QUANT_WEIGHT_DTYPES,
    DecoderLayer,
    DenseDecoderModel,
    _param,
)
from xllm_tpu_torch.ops.moe import moe_mlp


def add_experts(layer: nn.Module, cfg: ModelConfig, dtype, device, quant: str,
                proj) -> None:
    """The router, the routed expert stacks (fp8 with ``experts_*_scale``
    under ``quant="fp8_e4m3"``, the model dtype otherwise) and the shared
    experts' ``*_proj_w`` (made by ``proj``, quantized with the layer) of a
    MoE layer, named as the JAX tree's keys."""
    d, e, i = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size
    layer.router_w = _param(d, e, dtype=dtype, device=device)
    if cfg.scoring_func == "sigmoid":
        layer.router_bias = _param(e, dtype=torch.float32, device=device)
    fp8 = quant == "fp8_e4m3"
    wdt = QUANT_WEIGHT_DTYPES[quant] if fp8 else dtype
    for name, k, n in (("experts_gate_up", d, 2 * i), ("experts_down", i, d)):
        setattr(layer, name, _param(e, k, n, dtype=wdt, device=device))
        if fp8:
            setattr(layer, name + "_scale", _param(e, n, dtype=torch.float32,
                                                   device=device))
    if cfg.n_shared_experts > 0:
        si = cfg.n_shared_experts * i
        proj("shared_gate_proj_w", d, si)
        proj("shared_up_proj_w", d, si)
        proj("shared_down_proj_w", si, d)


class MoeDecoderLayer(DecoderLayer):
    """Attention as the dense layer; router and expert stacks in place of
    the dense MLP, named as the JAX parameter tree's keys."""

    def __init__(self, cfg: ModelConfig, dtype, device, quant: str = "") -> None:
        super().__init__(cfg, dtype, device, dense_mlp=False, quant=quant)
        add_experts(self, cfg, dtype, device, quant, self.proj)


class MoeDecoderModel(DenseDecoderModel):
    def __init__(self, cfg: ModelConfig, device="cpu", quant: str = "") -> None:
        if cfg.num_experts <= 0:
            raise ValueError("MoeDecoderModel requires num_experts > 0")
        if cfg.mlp_only_layers or cfg.decoder_sparse_step != 1:
            raise NotImplementedError(
                "dense/sparse mixed stacks land with the deepseek family"
            )
        super().__init__(cfg, device=device, quant=quant)
        self.n_dense = cfg.first_k_dense_replace

    def _make_layer(self, layer_idx: int) -> nn.Module:
        if layer_idx < self.cfg.first_k_dense_replace:
            return DecoderLayer(self.cfg, self.dtype, self.device, quant=self.quant)
        return MoeDecoderLayer(self.cfg, self.dtype, self.device, quant=self.quant)

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
            gate_up_scale=getattr(lp, "experts_gate_up_scale", None),
            down_scale=getattr(lp, "experts_down_scale", None),
            scoring=c.scoring_func, bias=getattr(lp, "router_bias", None),
            n_group=c.n_group, topk_group=c.topk_group,
        )
        if c.routed_scaling_factor != 1.0:
            out = out * c.routed_scaling_factor
        if c.n_shared_experts > 0:
            gate = self._linear(lp, "shared_gate_proj_w", x)
            up = self._linear(lp, "shared_up_proj_w", x)
            act = (F.silu(gate) * up).to(x.dtype)
            out = out + self._linear(lp, "shared_down_proj_w", act, x.dtype)
        return out.to(x.dtype)
