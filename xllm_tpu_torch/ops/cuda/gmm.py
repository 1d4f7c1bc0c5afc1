"""K10: grouped GEMM over expert-stacked weights (``csrc/gmm.cu``).

Replaces ``xllm_tpu/ops/pallas/gmm.py`` ``gmm``. Contract: ``lhs [M, K]``
with rows sorted by expert, ``rhs [E, K, N]``, ``group_offsets [E + 1]``
int32, nondecreasing within ``[0, M]`` (expert ``e`` owns rows
``offsets[e]:offsets[e + 1]``) -> ``[M, N]`` f32, ``out[r] = lhs[r] @
rhs[expert of r]`` accumulated in f32. Rows outside every group come out
as zeros. Unlike the TPU kernel it takes any M and N (K and N multiples of
8), so the caller pads no rows: ``group_offsets[-1] == M``.

``rhs`` may also be float8_e4m3fn (fp8 expert stacks, weight-only): as in
the TPU kernel its tiles are upcast to the lhs dtype (bf16 or f32, exact)
on load, and the per-(expert, channel) scales stay outside, on the f32
output (``ops/moe.py``). The kernel then takes N a multiple of 16.

Bound on the card: bytes, at decode and at the 2048-token prefill bucket
alike (the weights at one byte an element for fp8); see the CUDA source.
"""

from __future__ import annotations

import ctypes

import torch

from xllm_tpu_torch.ops.cuda import _build

NAME = "gmm"
TPU_KERNEL = "xllm_tpu/ops/pallas/gmm.py:103 gmm"
_SOURCE = "gmm"


def _checked_offsets(offsets: list[int], m: int) -> list[int]:
    if any(b < a for a, b in zip(offsets, offsets[1:])) or offsets[0] < 0 \
            or offsets[-1] > m:
        raise ValueError(f"group_offsets must be nondecreasing within [0, {m}]")
    return offsets


def gmm_plain(
    lhs: torch.Tensor,  # [M, K]
    rhs: torch.Tensor,  # [E, K, N]
    group_offsets: torch.Tensor,  # [E + 1] int32
) -> torch.Tensor:
    """Plain PyTorch version: one f32 matmul per non-empty expert (reads
    the offsets back to the host)."""
    m = lhs.shape[0]
    out = torch.zeros(m, rhs.shape[2], dtype=torch.float32, device=lhs.device)
    offs = _checked_offsets(group_offsets.tolist(), m)
    for g in range(rhs.shape[0]):
        lo, hi = offs[g], offs[g + 1]
        if hi > lo:
            out[lo:hi] = torch.matmul(lhs[lo:hi].float(), rhs[g].float())
    return out


ROW_TILES = (16, 128)  # the bf16 kernel's builds (csrc/gmm.cu)


def row_tile(m: int, e: int) -> int:
    """The bf16 kernel's row tile from the mean rows per expert: 16 when
    experts hold a few rows each (decode), else 128 (prefill chunks)."""
    return 16 if m <= 16 * max(e, 1) else 128


_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.xllm_gmm.argtypes = [i, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.xllm_gmm.restype = i
        _lib = lib
    return _lib


def gmm(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    group_offsets: torch.Tensor,
) -> torch.Tensor:
    """-> out [M, N] f32."""
    if lhs.device.type == "cpu":
        return gmm_plain(lhs, rhs, group_offsets)
    if lhs.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {lhs.device}")
    m, k = lhs.shape
    e, k2, n = rhs.shape
    fp8 = rhs.dtype == torch.float8_e4m3fn
    if lhs.dtype not in (torch.bfloat16, torch.float32) or not (fp8 or lhs.dtype == rhs.dtype):
        raise ValueError(f"{NAME}: lhs {lhs.dtype} vs rhs {rhs.dtype}")
    if fp8 and n % 16:
        raise ValueError(f"{NAME}: an fp8 rhs needs N a multiple of 16, not {n}")
    if k != k2 or k % 8 or n % 8:
        raise ValueError(
            f"{NAME}: lhs {tuple(lhs.shape)} vs rhs {tuple(rhs.shape)} "
            "(K and N must be multiples of 8)"
        )
    if not (lhs.is_contiguous() and rhs.is_contiguous()) or rhs.device != lhs.device:
        raise ValueError(f"{NAME}: lhs and rhs must be contiguous on {lhs.device}")
    if (group_offsets.dtype != torch.int32 or not group_offsets.is_contiguous()
            or group_offsets.device != lhs.device or group_offsets.numel() != e + 1):
        raise ValueError(f"{NAME}: group_offsets must be [E+1] contiguous int32 on {lhs.device}")
    out = torch.empty(m, n, dtype=torch.float32, device=lhs.device)
    if m == 0 or n == 0:
        return out
    lib = _load()
    _build.count_launch(NAME)
    err = lib.xllm_gmm(
        lhs.device.index or 0, _build.ptr(lhs), _build.ptr(rhs),
        _build.ptr(group_offsets), _build.ptr(out), _build.dtype_code(lhs.dtype),
        _build.dtype_code(rhs.dtype), m, k, n, e,
        row_tile(m, e), _build.stream_of(lhs),
    )
    _build.check(lib, err, NAME)
    return out
