"""Model registry (counterpart of ``xllm_tpu/models/registry.py``).

The dense GQA families, the GQA MoE families, the MLA families and the
hybrid linear-attention families (qwen3-next, qwen3.5); every other family
of the JAX registry raises until its slice is ported.
"""

from __future__ import annotations

from xllm_tpu_torch.config import ModelConfig

# dense decoder families (registry rows of the JAX package); mistral is the
# llama architecture with optional sliding-window attention, mimo the qwen2
# decoder layers
DENSE_FAMILIES = ("llama", "mistral", "qwen2", "qwen3", "glm4", "mimo")
# GQA + routed experts: qwen3-moe (softmax top-k), glm4-moe (sigmoid
# noaux routing, shared expert, dense first layers, partial rotate-half
# rope), minimax-m2 (sigmoid routing, partial interleaved rope)
MOE_FAMILIES = ("qwen3_moe", "glm4_moe", "minimax_m2")
# MLA (latent attention) + dense first layers + routed/shared experts:
# deepseek v2/v3, kimi-k2 (the v3 architecture) and glm4-moe-lite (MLA with
# rotate-half rope)
MLA_FAMILIES = ("deepseek_v2", "deepseek_v3", "kimi_k2", "glm4_moe_lite")
# hybrid GatedDeltaNet / full attention + routed and shared experts
# (models/qwen3_next.py)
HYBRID_FAMILIES = ("qwen3_next", "qwen3_5", "qwen3_5_text", "qwen3_5_moe_text")
# MLA + the DSA lightning indexer (deepseek-v3.2, glm5): not ported yet
DSA_FAMILIES = ("deepseek_v32", "glm_moe_dsa")


class ModelRegistry:
    _registry: dict[str, type] = {}

    @classmethod
    def register(cls, *names: str):
        def deco(model_cls: type) -> type:
            for n in names:
                cls._registry[n] = model_cls
            return model_cls

        return deco

    @classmethod
    def get(cls, name: str) -> type:
        if name in DSA_FAMILIES:
            raise NotImplementedError(
                f"model_type {name!r} needs DSA sparse attention, which is "
                "not ported to xllm_tpu_torch yet"
            )
        if name not in cls._registry:
            raise NotImplementedError(
                f"model_type {name!r} is not ported to xllm_tpu_torch yet; "
                f"ported: {sorted(cls._registry)}"
            )
        return cls._registry[name]


def get_model_class(model_type: str) -> type:
    from xllm_tpu_torch.models.decoder import DenseDecoderModel
    from xllm_tpu_torch.models.mla_decoder import Glm4MoeLiteModel, MlaDecoderModel
    from xllm_tpu_torch.models.moe_decoder import MoeDecoderModel
    from xllm_tpu_torch.models.qwen3_next import Qwen3NextModel

    for name in DENSE_FAMILIES:
        ModelRegistry._registry.setdefault(name, DenseDecoderModel)
    for name in MOE_FAMILIES:
        ModelRegistry._registry.setdefault(name, MoeDecoderModel)
    for name in MLA_FAMILIES:
        ModelRegistry._registry.setdefault(
            name, Glm4MoeLiteModel if name == "glm4_moe_lite" else MlaDecoderModel
        )
    for name in HYBRID_FAMILIES:
        ModelRegistry._registry.setdefault(name, Qwen3NextModel)
    return ModelRegistry.get(model_type)


def create_model(cfg: ModelConfig, device="cpu", quant: str = ""):
    """``quant`` ("int8" | "fp8_e4m3") stores every family's ``*_proj_w``
    quantized (and, under fp8, the MoE families' routed expert stacks)."""
    kw = {"quant": quant} if quant else {}
    return get_model_class(cfg.model_type)(cfg, device=device, **kw)
