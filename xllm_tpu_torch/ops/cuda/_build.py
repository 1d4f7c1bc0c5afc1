"""Build and load the hand-written Hopper kernels in ``xllm_tpu_torch/csrc``.

Each ``csrc/*.cu`` source compiles with nvcc for ``sm_90a`` into its own
shared library with a plain C interface, all sources in parallel, on first
use. The libraries land in ``xllm_tpu_torch/_build/<hash>/``, keyed by a
hash of every source and the flags, and load with ``ctypes``: no PyTorch
header is compiled, so a build takes seconds instead of minutes. Every
pointer and the stream cross as ``c_void_p``; every C entry returns
``cudaGetLastError()`` after its launch, and ``check`` raises on a
non-zero code.

Nothing here runs at import time: the CPU tests import every kernel module
on a machine with neither nvcc nor a card. A missing nvcc or a failed
build raises; no kernel ever falls back to its plain version on a CUDA
tensor.

Each wrapper counts its launches in ``launch_counts`` (one per kernel
launch, nowhere else), so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

launch_counts: dict[str, int] = {}
_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_log: dict[str, str] = {}  # source stem -> nvcc's output (ptxas -v)


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def count_launch(name: str) -> None:
    launch_counts[name] = launch_counts.get(name, 0) + 1


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of xllm_tpu_torch build from "
            "csrc/ on first use and need the CUDA toolkit (PATH or "
            "/usr/local/cuda/bin)"
        )
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every source that is not built yet, all nvcc processes at
    once. -> {stem: library path}. Raises with nvcc's output on failure."""
    out_dir = _build_dir()
    libs = {src.stem: out_dir / f"lib{src.stem}.so" for src in _sources()}
    todo = {stem: path for stem, path in libs.items() if not path.exists()}
    if not todo:
        return libs
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{stem}.cu")]
        procs[stem] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            path,
        )
    failed = []
    for stem, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        build_log[stem] = log
        if proc.returncode != 0:
            failed.append(f"--- {stem}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return libs


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first
    use)."""
    lib = _libs.get(stem)
    if lib is not None:
        return lib
    with _lock:
        if stem not in _libs:
            libs = build_all()
            if stem not in libs:
                raise RuntimeError(f"no kernel source csrc/{stem}.cu")
            lib = ctypes.CDLL(str(libs[stem]))
            lib.xllm_cuda_error_string.restype = ctypes.c_char_p
            lib.xllm_cuda_error_string.argtypes = [ctypes.c_int]
            _libs[stem] = lib
    return _libs[stem]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.xllm_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address (None: a null pointer)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# dtype codes shared with csrc/common.cuh
DTYPE_F32 = 0
DTYPE_BF16 = 1
DTYPE_I8 = 2
DTYPE_E4M3 = 3


_sms: dict[int, int] = {}


def device_sms(dev) -> int:
    """The SMs of a CUDA device (read once)."""
    import torch

    idx = dev.index or 0
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def dtype_code(dtype) -> int:
    import torch

    codes = {torch.float32: DTYPE_F32, torch.bfloat16: DTYPE_BF16,
             torch.int8: DTYPE_I8, torch.float8_e4m3fn: DTYPE_E4M3}
    if dtype not in codes:
        raise NotImplementedError(
            f"CUDA kernels take float32, bfloat16, int8 or float8_e4m3fn, not {dtype}"
        )
    return codes[dtype]


def is_quantized(dtype) -> bool:
    """A 1-byte cache or weight dtype (int8 codes or float8_e4m3fn)."""
    import torch

    return dtype in (torch.int8, torch.float8_e4m3fn)


def check_head_dim(d: int, work_dtype, cache_dtype, what: str = "CUDA kernels") -> None:
    """The head_dims the attention kernels and their cache writers are built
    for: 64 and 128 for every (q, cache) dtype pair; 256 (qwen3-next's
    full-attention layers) for the pairs a served model reaches: bf16 q on
    a bf16 or float8_e4m3fn cache, f32 q on an f32 or float8_e4m3fn cache.
    An int8 cache at 256 stays refused (the family takes no int8 KV).
    Anything else raises."""
    import torch

    if d in (64, 128):
        return
    e4m3 = torch.float8_e4m3fn
    pairs = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
             (torch.bfloat16, e4m3), (torch.float32, e4m3))
    if d == 256 and (work_dtype, cache_dtype) in pairs:
        return
    raise NotImplementedError(
        f"{what}: built for head_dim 64 and 128 (256 for bf16 q on a bf16 or e4m3 "
        f"cache and f32 q on an f32 or e4m3 cache), not {d} with {work_dtype} q on a "
        f"{cache_dtype} cache")
