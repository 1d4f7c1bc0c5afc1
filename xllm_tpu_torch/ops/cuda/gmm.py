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

``plan`` picks one of three instances from the shapes alone (nothing is
read back to the host): the TMA + wgmma kernel for a bf16 lhs at prefill
rows (row tiles of up to 256 rows, or 128 for e4m3 weights at a few rows
an expert, persistent, column tiles fastest), the
16-row mma.sync kernel for a bf16 lhs at decode rows and the 64-token
bucket, the FMA kernel for an f32 lhs. ``work_list`` is the kernels' cut
of the rows into tiles and units, and ``units_model`` their arithmetic,
in PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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


SMS = 132  # an H100 SXM's SMs; the wrapper passes the device's own count
BN = 128  # columns a tile, every instance but the f32 one
WS_ROWS = (256, 128)  # the TMA + wgmma kernel's row tiles: two consumers of 2 or 1 64-row blocks
WS_FP8_SMALL = 64  # e4m3 rows: 128-row tiles up to this many rows an expert on average
INSTANCES = ("ws", "mma16", "fma")


class Plan(NamedTuple):
    """The shape of one K10 launch."""

    kernel: str  # "ws" (TMA + wgmma), "mma16" (mma.sync) or "fma" (f32 lhs)
    bm: int  # rows a tile (the ws kernel multiplies only its 64-row blocks that hold rows)
    bn: int  # columns a tile
    grid: int  # blocks: persistent (ws; at most), else the most row-tile slots x column tiles
    order: str  # "n" (ws: column tiles fastest) or "rows" (row tiles fastest)

    @property
    def name(self) -> str:
        """The build: "ws256", "ws128", "mma16" or "fma"."""
        return f"ws{self.bm}" if self.kernel == "ws" else self.kernel


@functools.lru_cache(maxsize=4096)
def plan(m: int, k: int, n: int, e: int, lhs_dtype: torch.dtype = torch.bfloat16,
         rhs_dtype: torch.dtype = torch.bfloat16, sms: int = SMS) -> Plan:
    """K10's instance for lhs [m, k] of ``lhs_dtype`` and rhs [e, k, n] of
    ``rhs_dtype``: an f32 lhs takes the FMA kernel (64 x 64 tiles); a bf16
    lhs with a few rows an expert on average (m <= 16 e: decode steps, the
    64-token bucket) the 16-row mma.sync kernel, where taller tiles would
    multiply mostly rows of no group; above that (and K a multiple of 64)
    the TMA + wgmma kernel on at most one persistent block an SM, with
    256-row tiles -- 128-row ones for e4m3 weights at up to 64 rows an
    expert on average, where the converter's deeper ring of smaller stages
    gains (H100 timings, ``scripts/probe_gmm_kernel.py``)."""
    if lhs_dtype == torch.float32:
        return layout("fma", m, n, e)
    if m <= 16 * max(e, 1) or k % 64:
        return layout("mma16", m, n, e)
    small = rhs_dtype == torch.float8_e4m3fn and m <= WS_FP8_SMALL * max(e, 1)
    return layout("ws", m, n, e, sms, bm=128 if small else 256)


def layout(kernel: str, m: int, n: int, e: int, sms: int = SMS, bm: int = 256) -> Plan:
    """The plan of a given instance (``plan`` picks one; checks force the
    others; ``bm`` the ws kernel's row tile). Row-tile slots: ceil(m / bm)
    + e + 2 bound the row tiles of any offsets (each segment adds at most
    one part-filled tile)."""
    if kernel not in INSTANCES or (kernel == "ws" and bm not in WS_ROWS):
        raise ValueError(f"layout: kernel {kernel!r}, row tile {bm}")
    bm, bn = {"ws": (bm, BN), "mma16": (16, BN), "fma": (64, 64)}[kernel]
    units = (-(-m // bm) + e + 2) * -(-n // bn)
    if kernel == "ws":
        return Plan(kernel, bm, bn, min(units, sms), "n")
    return Plan(kernel, bm, bn, units, "rows")


class Unit(NamedTuple):
    """One work unit: a row tile of one segment by a column tile."""

    expert: int  # -1: rows outside every group (written as zeros)
    row0: int
    rows: int
    n0: int
    cols: int
    blocks: int  # the ws kernel's 64-row wgmma blocks that hold rows (0 for zeros)


def work_list(offsets: list[int], m: int, n: int, p: Plan) -> list[Unit]:
    """The kernels' work in launch order: the rows cut into segments (the
    rows before offsets[0], each expert's, the rows after offsets[E]), each
    segment into row tiles of ``p.bm`` from its first row, each row tile by
    the column tiles; column tiles fastest under the ws kernel's order (a
    persistent block takes units u, u + grid, ...), row tiles fastest
    otherwise."""
    offs = _checked_offsets([int(o) for o in offsets], m)
    e = len(offs) - 1
    bounds = [0] + offs + [m]
    tiles = []
    for s in range(e + 2):
        lo, hi = bounds[s], bounds[s + 1]
        expert = s - 1 if 1 <= s <= e else -1
        tiles += [(expert, r, min(p.bm, hi - r)) for r in range(lo, hi, p.bm)]
    cols = [(n0, min(p.bn, n - n0)) for n0 in range(0, n, p.bn)]
    pairs = ([(t, c) for t in tiles for c in cols] if p.order == "n"
             else [(t, c) for c in cols for t in tiles])
    return [Unit(ex, r0, rows, n0, nc, 0 if ex < 0 else -(-rows // 64))
            for (ex, r0, rows), (n0, nc) in pairs]


def units_model(lhs: torch.Tensor, rhs: torch.Tensor, offsets: list[int],
                p: Plan) -> torch.Tensor:
    """K10's arithmetic under plan ``p``, unit by unit in f32: each unit's
    rows times its expert's columns (rows of no group: zeros), every output
    element from the one unit that covers it."""
    m, n = lhs.shape[0], rhs.shape[2]
    out = torch.full((m, n), float("nan"), dtype=torch.float32)
    for u in work_list(offsets, m, n, p):
        rows, cols = slice(u.row0, u.row0 + u.rows), slice(u.n0, u.n0 + u.cols)
        out[rows, cols] = (0.0 if u.expert < 0 else
                           lhs[rows].float() @ rhs[u.expert, :, cols].float())
    return out


_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.xllm_gmm.argtypes = [i, p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.xllm_gmm.restype = i
        _lib = lib
    return _lib


def gmm(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    group_offsets: torch.Tensor,
    p: Plan | None = None,
) -> torch.Tensor:
    """-> out [M, N] f32. ``p``: the launch's plan (default: ``plan``'s; a
    check may force another instance for the lhs dtype)."""
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
    if p is None:
        p = plan(m, k, n, e, lhs.dtype, rhs.dtype, _build.device_sms(lhs.device))
    if (p.kernel == "fma") != (lhs.dtype == torch.float32) or (p.kernel == "ws" and k % 64):
        raise ValueError(f"{NAME}: plan {p.kernel} for an lhs of {lhs.dtype}, K {k}")
    if p.kernel == "ws" and (lhs.data_ptr() % 16 or rhs.data_ptr() % 16):
        raise ValueError(f"{NAME}: the TMA kernel reads lhs and rhs from 16-byte aligned bases")
    out = torch.empty(m, n, dtype=torch.float32, device=lhs.device)
    if m == 0 or n == 0:
        return out
    lib = _load()
    _build.count_launch(NAME)
    err = lib.xllm_gmm(
        lhs.device.index or 0, _build.ptr(lhs), _build.ptr(rhs),
        _build.ptr(group_offsets), _build.ptr(out), _build.dtype_code(lhs.dtype),
        _build.dtype_code(rhs.dtype), m, k, n, e, p.bm, p.grid, _build.stream_of(lhs),
    )
    _build.check(lib, err, NAME)
    return out
