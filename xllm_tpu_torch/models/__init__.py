from xllm_tpu_torch.models.registry import ModelRegistry, get_model_class

__all__ = ["ModelRegistry", "get_model_class"]
