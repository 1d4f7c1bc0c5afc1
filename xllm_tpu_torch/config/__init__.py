from xllm_tpu_torch.config.engine_config import (
    CacheConfig,
    EngineConfig,
    EplbConfig,
    ModelConfig,
    ParallelConfig,
    QuantConfig,
    SchedulerConfig,
    SpeculativeConfig,
)

__all__ = [
    "CacheConfig",
    "EngineConfig",
    "EplbConfig",
    "ModelConfig",
    "ParallelConfig",
    "QuantConfig",
    "SchedulerConfig",
    "SpeculativeConfig",
]
