from xllm_tpu_torch.scheduler.continuous import ContinuousScheduler, SchedulerOutput

__all__ = ["ContinuousScheduler", "SchedulerOutput"]
