"""Model registry (counterpart of ``xllm_tpu/models/registry.py``).

This slice serves the dense GQA families only; every other family of the
JAX registry raises until its slice is ported.
"""

from __future__ import annotations

from xllm_tpu_torch.config import ModelConfig

# dense decoder families (registry rows of the JAX package); mistral is the
# llama architecture with optional sliding-window attention, mimo the qwen2
# decoder layers
DENSE_FAMILIES = ("llama", "mistral", "qwen2", "qwen3", "glm4", "mimo")


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
        if name not in cls._registry:
            raise NotImplementedError(
                f"model_type {name!r} is not ported to xllm_tpu_torch yet; "
                f"ported: {sorted(cls._registry)}"
            )
        return cls._registry[name]


def get_model_class(model_type: str) -> type:
    from xllm_tpu_torch.models.decoder import DenseDecoderModel

    for name in DENSE_FAMILIES:
        ModelRegistry._registry.setdefault(name, DenseDecoderModel)
    return ModelRegistry.get(model_type)


def create_model(cfg: ModelConfig, device="cpu"):
    return get_model_class(cfg.model_type)(cfg, device=device)
