"""K5, K6, K7: weight-streaming matrix products (``csrc/quant_matmul.cu``).

One kernel, three contracts, each with its own wrapper, launch counter and
plain PyTorch version; x is ``[M, K]`` (bf16 or f32), the weight ``[K, N]``
(or a stack ``[L, K, N]`` and a layer index), the output ``[M, N]`` f32:

- K5 ``quant_matmul_int8`` (w8a8) replaces
  ``xllm_tpu/ops/pallas/quant_matmul.py`` ``quant_matmul_int8``,
  ``quant_matmul_int8_v2`` and ``quant_matmul_int8_v2_stacked``: x is
  quantized per token outside the kernel, as the JAX package does it
  outside ``pallas_call`` (``sx = max(absmax(x_row) / 127, 1e-10)``, codes
  ``clip(round(x / sx), -127, 127)``, the division by 127 a product with
  its f32 reciprocal as XLA compiles it); int8 x int8 products are summed
  exactly in int32; ``out = (float(acc) * sx) * sw``. The plain version
  sums in f64 (exact: every partial sum is an integer far below 2^53),
  converts to int32 and scales in the same order, so the kernel equals it
  bit for bit;
- K6 ``quant_matmul_fp8`` (weight-only) replaces ``quant_matmul_fp8``,
  ``quant_matmul_fp8_v2``, ``quant_matmul_fp8_v2_stacked`` and
  ``quant_matmul_fp8_stacked``: x in bf16 (an f32 x is rounded to bf16, as
  the TPU kernels do), e4m3 weights upcast to bf16 (exact), f32 sums,
  ``out = acc * sw``;
- K7 ``matmul_bf16`` replaces ``matmul_bf16_v2`` and
  ``matmul_bf16_stacked``: K6 with bf16 weights and no scale.

K and N must be multiples of 16; any M. A stacked call offsets the weight
and scale pointers by the layer. Bound on the card: bytes at decode,
operations for a full prefill chunk; see the CUDA source.
"""

from __future__ import annotations

import ctypes

import torch

from xllm_tpu_torch.ops.cuda import _build

W8A8_NAME = "quant_matmul_int8"
FP8_NAME = "quant_matmul_fp8"
BF16_NAME = "matmul_bf16"
_PALLAS = "xllm_tpu/ops/pallas/quant_matmul.py"
W8A8_TPU_KERNEL = f"{_PALLAS}:45 quant_matmul_int8"  # and :296, :466 (v2, stacked)
FP8_TPU_KERNEL = f"{_PALLAS}:102 quant_matmul_fp8"  # and :303, :480, :500
BF16_TPU_KERNEL = f"{_PALLAS}:589 matmul_bf16_v2"  # and :570 (stacked)
_SOURCE = "quant_matmul"
ROW_TILES = (16, 128)  # the kernel's row tiles (with 64 and 128 columns)
_WEIGHT_DTYPE = {W8A8_NAME: torch.int8, FP8_NAME: torch.float8_e4m3fn,
                 BF16_NAME: torch.bfloat16}


def row_tile(m: int) -> int:
    """16 rows (64 columns) for decode-sized M, else 128 (128 columns)."""
    return 16 if m <= 32 else 128


def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token absmax quantization -> (int8 codes [M, K], f32 [M, 1])."""
    xf = x.float()
    sx = torch.clamp(xf.abs().amax(dim=1, keepdim=True) * (1.0 / 127.0), min=1e-10)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def quant_matmul_int8_plain(x, w_q, scale) -> torch.Tensor:
    """K5's plain version: exact f64 sums, int32, then the kernel's order."""
    xq, sx = quantize_activations(x)
    acc = torch.mm(xq.double(), w_q.double()).to(torch.int32)
    return (acc.float() * sx) * scale[None, :]


def quant_matmul_fp8_plain(x, w_q, scale) -> torch.Tensor:
    """K6's plain version: bf16 x, exact upcast weights, f32 sums."""
    return torch.mm(x.to(torch.bfloat16).float(), w_q.float()) * scale[None, :]


def matmul_bf16_plain(x, w) -> torch.Tensor:
    """K7's plain version."""
    return torch.mm(x.to(torch.bfloat16).float(), w.float())


_PLAIN = {
    W8A8_NAME: quant_matmul_int8_plain,
    FP8_NAME: quant_matmul_fp8_plain,
    BF16_NAME: lambda x, w, scale: matmul_bf16_plain(x, w),
}
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.xllm_quant_matmul.argtypes = [i, p, p, p, p, p, i, i, i, i, i, p]
        lib.xllm_quant_matmul.restype = i
        _lib = lib
    return _lib


def _matmul(name: str, x, w, scale, layer: int | None) -> torch.Tensor:
    """One wrapper for the three contracts; ``layer`` selects a layer of a
    stacked ``w [L, K, N]`` (and ``scale [L, N]``)."""
    if layer is not None:
        layer = int(layer)
        if not 0 <= layer < w.shape[0]:
            raise IndexError(f"{name}: layer {layer} of a stack of {w.shape[0]}")
    if x.device.type == "cpu":
        if layer is not None:
            w = w[layer]
            scale = None if scale is None else scale[layer]
        return _PLAIN[name](x, w, scale)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if w.dtype != _WEIGHT_DTYPE[name]:
        raise ValueError(f"{name}: weights must be {_WEIGHT_DTYPE[name]}, not {w.dtype}")
    k, n = w.shape[-2:]
    m = x.shape[0]
    if x.dim() != 2 or x.shape[1] != k or k % 16 or n % 16:
        raise ValueError(f"{name}: x {tuple(x.shape)} vs w {tuple(w.shape)} "
                         "(K and N must be multiples of 16)")
    if w.dim() != (2 if layer is None else 3):
        raise ValueError(f"{name}: w {tuple(w.shape)} with layer {layer}")
    if not w.is_contiguous() or w.device != x.device:
        raise ValueError(f"{name}: w must be contiguous on {x.device}")
    if scale is not None and (scale.dtype != torch.float32 or not scale.is_contiguous()
                              or scale.shape != w.shape[:-2] + (n,)
                              or scale.device != x.device):
        raise ValueError(f"{name}: scale must be contiguous f32 {w.shape[:-2] + (n,)}")
    if m == 0:
        return torch.empty(0, n, dtype=torch.float32, device=x.device)
    if name == W8A8_NAME:
        xin, sx = quantize_activations(x)
    else:
        xin, sx = x.to(torch.bfloat16), None
    return launch_prepared(name, xin.contiguous(), sx, w, scale, layer)


def launch_prepared(name: str, xin, sx, w, scale, layer: int | None) -> torch.Tensor:
    """The kernel alone, on operands ``_matmul`` has checked and prepared:
    for K5 the int8 codes ``xin [M, K]`` and their f32 scales ``sx [M, 1]``,
    for K6 and K7 a bf16 ``xin`` (``sx`` None). -> f32 [M, N]."""
    k, n = w.shape[-2:]
    m = xin.shape[0]
    out = torch.empty(m, n, dtype=torch.float32, device=xin.device)
    lib = _load()  # a failed build raises here
    row = 0 if layer is None else layer
    w_ptr = ctypes.c_void_p(w.data_ptr() + row * k * n * w.element_size())
    s_ptr = (ctypes.c_void_p(None) if scale is None
             else ctypes.c_void_p(scale.data_ptr() + row * n * 4))
    sx_ptr = ctypes.c_void_p(None) if sx is None else _build.ptr(sx)
    _build.count_launch(name)
    err = lib.xllm_quant_matmul(
        xin.device.index or 0, _build.ptr(xin), sx_ptr, w_ptr, s_ptr, _build.ptr(out),
        _build.dtype_code(w.dtype), m, k, n, row_tile(m), _build.stream_of(xin),
    )
    _build.check(lib, err, name)
    return out


def quant_matmul_int8(x, w_q, scale) -> torch.Tensor:
    """K5: x [M, K] . int8 w_q [K, N] with f32 scale [N] -> f32 [M, N]."""
    return _matmul(W8A8_NAME, x, w_q, scale, None)


def quant_matmul_int8_stacked(x, w_q, scale, layer_idx: int) -> torch.Tensor:
    """K5 on layer ``layer_idx`` of w_q [L, K, N], scale [L, N]."""
    return _matmul(W8A8_NAME, x, w_q, scale, layer_idx)


def quant_matmul_fp8(x, w_q, scale) -> torch.Tensor:
    """K6: x [M, K] . e4m3 w_q [K, N] with f32 scale [N] -> f32 [M, N]."""
    return _matmul(FP8_NAME, x, w_q, scale, None)


def quant_matmul_fp8_stacked(x, w_q, scale, layer_idx: int) -> torch.Tensor:
    """K6 on layer ``layer_idx`` of w_q [L, K, N], scale [L, N]."""
    return _matmul(FP8_NAME, x, w_q, scale, layer_idx)


def matmul_bf16(x, w) -> torch.Tensor:
    """K7: x [M, K] . bf16 w [K, N] -> f32 [M, N]."""
    return _matmul(BF16_NAME, x, w, None, None)


def matmul_bf16_stacked(x, w, layer_idx: int) -> torch.Tensor:
    """K7 on layer ``layer_idx`` of w [L, K, N]."""
    return _matmul(BF16_NAME, x, w, None, layer_idx)
