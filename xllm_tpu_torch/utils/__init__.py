from xllm_tpu_torch.utils.common import cdiv, get_logger, next_bucket, round_up

__all__ = ["cdiv", "get_logger", "next_bucket", "round_up"]
