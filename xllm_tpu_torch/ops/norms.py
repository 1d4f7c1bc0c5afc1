"""Normalization ops (counterpart of ``xllm_tpu/ops/norms.py``).

Plain PyTorch: a [T, D] norm is one memory-bound pass, as on the TPU where
XLA fused it; a hand-written kernel waits for a measurement that asks for
one.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32 accumulation, cast back to x.dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)
