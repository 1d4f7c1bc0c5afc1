"""Weight-only quantization: quantize, the fp8 cast, and the dequant-matmul
dispatch.

Counterpart of ``xllm_tpu/ops/quant.py``. Symmetric per-output-channel
scales:

    w_q[k, n] = round(w[k, n] / s[n]),   s[n] = absmax(w[:, n]) / 127   (int8)
    w_q[k, n] = e4m3(w[k, n] / s[n]),    s[n] = absmax(w[:, n]) / 448   (fp8)

``quantize_int8`` and ``quantize_fp8`` give the bytes of the JAX package's
jitted quantizers (its runner calls them under ``jax.jit``): both round
half to even (``torch.round`` as ``jnp.round``); XLA turns the division by
the constant 127 (or 448) into a product with its f32 reciprocal, and so
does the port (``RECIP_127``, ``RECIP_448``); and every cast to
float8_e4m3fn in the port goes through ``to_e4m3``, which gives JAX's
bytes where PyTorch's own cast differs (above 464 in magnitude PyTorch
saturates to 448, JAX gives NaN).

``quant_matmul`` keeps the JAX default: dequantize, then one product with
an f32 result. With ``XLLM_QMM_KERNEL=pallas`` (the JAX package's switch,
kept under its name so that one environment means the same in both
packages) int8 weights go to K5 (w8a8) and fp8 weights to K6 (weight-only)
of ``ops/cuda/quant_matmul``: on a CUDA tensor that launches the kernel, on
a CPU tensor it takes the kernel's plain version. (The JAX package ignores
the switch off the TPU; the port follows its own wrapper rule.)
"""

from __future__ import annotations

import os

import numpy as np
import torch

from xllm_tpu_torch.ops.cuda import _build
from xllm_tpu_torch.ops.cuda import quant_matmul as qmm
from xllm_tpu_torch.ops.linear import linear_f32

# the f32 reciprocals XLA multiplies by where the JAX code divides by 127
# and 448 (a float tensor times a Python float computes in f32)
RECIP_127 = 1.0 / 127.0
RECIP_448 = 1.0 / 448.0
# e4m3fn's largest finite value is 448; |x| up to 464 rounds to it (the
# tie at 464 goes to 448, whose significand is even), beyond that JAX's
# cast gives NaN (e4m3fn has no infinity), byte 0x7f or 0xff
_E4M3_ROUNDS_TO_MAX = 464.0
_E4M3_NAN = 0x7F


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """Cast to float8_e4m3fn with the JAX package's bytes: PyTorch's cast,
    except that a magnitude above 464 (infinity included) becomes NaN with
    the sign of x instead of saturating to 448."""
    xf = x.float()
    codes = xf.to(torch.float8_e4m3fn).view(torch.uint8)
    nan = torch.where(torch.signbit(xf), _E4M3_NAN | 0x80, _E4M3_NAN).to(torch.uint8)
    codes = torch.where(xf.abs() > _E4M3_ROUNDS_TO_MAX, nan, codes)
    return codes.view(torch.float8_e4m3fn)


def cast_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.to(dtype)``, with fp8 through ``to_e4m3``."""
    if dtype == torch.float8_e4m3fn and x.dtype != dtype:
        return to_e4m3(x)
    return x.to(dtype)


def quantize_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., K, N] -> (int8 weights, f32 scales [..., N])."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=-2) * RECIP_127, min=1e-8)
    w_q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127)
    return w_q.to(torch.int8), scale


def quantize_fp8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., K, N] -> (float8_e4m3fn weights, f32 scales [..., N]): the
    scale maps each column's absmax to e4m3's largest value, 448."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=-2) * RECIP_448, min=1e-8)
    return to_e4m3(wf / scale[..., None, :]), scale


QUANTIZERS = {"int8": quantize_int8, "fp8_e4m3": quantize_fp8}

# matmul weights eligible for weight-only quantization (the JAX runner's
# rule): every "*_proj_w" of a layer group but these, and the routed expert
# stacks under fp8 only (int8 experts would need int8 activations through
# the grouped GEMM; fp8 ones are upcast in K10)
_QUANT_SKIP = ("router_w", "merger_proj_w")
_EXPERT_STACKS = ("experts_gate_up", "experts_down")


def quant_eligible(name: str, method: str) -> bool:
    """Whether the JAX runner quantizes a tree's stack ``name``."""
    is_expert = name in _EXPERT_STACKS
    return ((name.endswith("_proj_w") or (is_expert and method != "int8"))
            and name not in _QUANT_SKIP)


def _kernel_switch() -> bool:
    return os.environ.get("XLLM_QMM_KERNEL", "") == "pallas"


def _dequant_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # dequantize in x's dtype on every device: for the bf16 models served
    # this is the TPU's bf16 dequant (xllm_tpu/ops/quant.py:160), and for
    # the f32 models of the tests the JAX CPU path's x.dtype dequant
    w = w_q.to(x.dtype) * scale[None, :].to(x.dtype)
    return linear_f32(x, w)


def quant_matmul(
    x: torch.Tensor,  # [M, K]
    w_q: torch.Tensor,  # [K, N] int8 or float8_e4m3fn
    scale: torch.Tensor,  # [N] f32
) -> torch.Tensor:
    """-> [M, N] f32."""
    if _kernel_switch():
        if w_q.dtype == torch.int8:
            return qmm.quant_matmul_int8(x, w_q, scale)
        return qmm.quant_matmul_fp8(x, w_q, scale)
    return _dequant_matmul(x, w_q, scale)


def quant_matmul_stacked(
    x: torch.Tensor,  # [M, K]
    w_q: torch.Tensor,  # [L, K, N] int8 or float8_e4m3fn
    scale: torch.Tensor,  # [L, N] f32
    layer_idx: int,
) -> torch.Tensor:
    """-> [M, N] f32 for layer ``layer_idx`` of a stacked weight tensor
    (the kernels take the stack and offset their pointers by the layer)."""
    if _kernel_switch():
        if w_q.dtype == torch.int8:
            return qmm.quant_matmul_int8_stacked(x, w_q, scale, layer_idx)
        return qmm.quant_matmul_fp8_stacked(x, w_q, scale, layer_idx)
    return _dequant_matmul(x, w_q[layer_idx], scale[layer_idx])


@torch.no_grad()
def calibrate_kv_scales(engine, prompts: list[list[int]], margin: float = 1.25):
    """Per-layer-per-head int8-KV scales from representative prompts.

    Runs the prompts through a full-precision-KV engine, reduces the live
    cache to the absmax of each (layer, kv head) and returns ``(s_k, s_v)``
    as [L, Hkv] float32 numpy arrays, ``scale = amax * margin / 127``, for
    ``ModelRunner.set_kv_scales`` of an int8-KV engine. The interleaved
    cache [L, NB, 2, Hkv, bs, D] reduces its K and V halves, as in JAX (a
    row-major tail page's rows fall under the halves its bytes sit in).
    """
    from xllm_tpu_torch.framework.sampling_params import SamplingParams

    runner = engine.runner
    if _build.is_quantized(runner.k_cache.dtype):
        raise ValueError(
            "calibrate on a full-precision-KV engine (kv_cache_dtype "
            "auto/bfloat16/float32), then install the scales on the int8 engine"
        )
    interleaved = runner.k_cache.ndim == 6
    if not interleaved and (runner.k_cache.ndim != 5
                            or runner.k_cache.shape != runner.v_cache.shape):
        raise NotImplementedError("KV-scale calibration covers the paged GQA cache layouts")
    sp = SamplingParams(temperature=0.0, max_tokens=1, ignore_eos=True)
    for i, ids in enumerate(prompts):
        engine.add_request(prompt_token_ids=list(ids), sampling_params=sp,
                           request_id=f"kvcal-{i}")
    engine.generate_all(timeout_s=600)

    def amax(cache):  # [L, NB, Hkv, bs, D] -> [L, Hkv]
        return cache.float().abs().amax(dim=(1, 3, 4)).cpu().numpy()

    if interleaved:
        ak, av = amax(runner.k_cache[:, :, 0]), amax(runner.k_cache[:, :, 1])
    else:
        ak, av = amax(runner.k_cache), amax(runner.v_cache)
    s_k = np.maximum(ak * margin / 127.0, 1e-6).astype(np.float32)
    s_v = np.maximum(av * margin / 127.0, 1e-6).astype(np.float32)
    return s_k, s_v
