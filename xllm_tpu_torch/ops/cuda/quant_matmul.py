"""K5, K6, K7: weight-streaming matrix products (``csrc/quant_matmul.cu``).

Three contracts, each with its own wrapper, launch counter and plain
PyTorch version; x is ``[M, K]`` (bf16 or f32), the weight ``[K, N]`` (or a
stack ``[L, K, N]`` and a layer index), the output ``[M, N]`` f32:

- K5 ``quant_matmul_int8`` (w8a8) replaces
  ``xllm_tpu/ops/pallas/quant_matmul.py`` ``quant_matmul_int8``,
  ``quant_matmul_int8_v2`` and ``quant_matmul_int8_v2_stacked``: x is
  quantized per token (``sx = max(absmax(x_row) / 127, 1e-10)``, codes
  ``clip(round(x / sx), -127, 127)``, the division by 127 a product with
  its f32 reciprocal as XLA compiles it) by one launch of its own counter
  (``quantize_rows``, byte-equal to ``quantize_activations``), where the
  JAX package leaves that to XLA outside ``pallas_call``; int8 x int8
  products are summed exactly in int32; ``out = (float(acc) * sx) * sw``.
  The plain version sums in f64 (exact: every partial sum is an integer far
  below 2^53), converts to int32 and scales in the same order, so the
  kernel equals it bit for bit. A call is two launches;
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

Every GEMM is a warp-specialised, persistent TMA + wgmma kernel that splits
K into ranges of whole stages where its tiles do not fill the card; a split
launch writes partials to a workspace that the wrapper allocates and sums
them in split order in the kernel, and counts as one launch.

- K6 and K7 (``qmm_ws_kernel``): ``plan(m, k, n, kind)`` picks 64-, 128- or
  256-row tiles of 128 columns (64 up to 64 rows) and the splits (few
  tiles, and e4m3 decode tiles); ``split_model`` is that arithmetic.
- K5 (``qmm_s8_kernel``) computes the transposed product on s8 wgmma: 128
  weight columns a tile are wgmma's A, built in registers from the landed
  weight stage, the tokens its N. ``int8_plan(m, k, n)`` picks the tokens a
  tile (16 for a decode step, 64, 128 or 256) and the splits (where the
  tiles fill less than half the SMs); ``int8_layout`` forces one;
  ``int8_split_model`` is its arithmetic (int32 partials in split order,
  then scaled).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from xllm_tpu_torch.ops.cuda import _build

W8A8_NAME = "quant_matmul_int8"
QUANT_NAME = "quantize_rows_int8"  # K5's activation quantizer: a launch of its own
FP8_NAME = "quant_matmul_fp8"
BF16_NAME = "matmul_bf16"
_PALLAS = "xllm_tpu/ops/pallas/quant_matmul.py"
W8A8_TPU_KERNEL = f"{_PALLAS}:45 quant_matmul_int8"  # and :296, :466 (v2, stacked)
# not a Pallas kernel: the quantization XLA runs before K5's pallas_call
QUANT_TPU_KERNEL = f"{_PALLAS}:56 quant_matmul_int8"  # and :250, :407
FP8_TPU_KERNEL = f"{_PALLAS}:102 quant_matmul_fp8"  # and :303, :480, :500
BF16_TPU_KERNEL = f"{_PALLAS}:589 matmul_bf16_v2"  # and :570 (stacked)
_SOURCE = "quant_matmul"
_WEIGHT_DTYPE = {W8A8_NAME: torch.int8, FP8_NAME: torch.float8_e4m3fn,
                 BF16_NAME: torch.bfloat16}
_KIND = {FP8_NAME: "fp8_e4m3", BF16_NAME: "bf16"}

# K6 / K7's plan (csrc/quant_matmul.cu qmm_ws_kernel)
SMS = 132  # an H100 SXM's SMs; the wrapper passes the device's own count
WS_BK = 64  # k a pipeline stage
WS_BN = 128  # columns a tile
# rows a tile: consumer warpgroups x 64-row wgmma tiles, 1 x 1, 2 x 1, 2 x 2
WS_ROWS = (64, 128, 256)
# splits, from H100 sweeps (scripts/probe_qmm_kernel.py --sweep): a block
# streams bf16 weight tiles at ~50 GB/s, so 32-48 tiles of a few thousand
# K already reach the rate one launch gets; a split unit pays a partial's
# write, a fence and the last unit's merge (splitting to two units an SM
# cost 1.2-2x). A block upcasting e4m3 streams far slower (~10 GB/s), so
# K6's decode tiles always split.
SPLITS = 4
FEW_TILES = 16  # this many tiles or fewer: split
LONG_K_TILES = 32  # ... or this many or fewer with K of LONG_K_STAGES stages
LONG_K_STAGES = 64
MIN_SPLIT_STAGES = 8  # a split walks at least this many stages
# a wave of 64- / 256-row tiles against one of 128-row tiles (H100 timings)
WAVE_COST = {64: 0.75, 128: 1.0, 256: 1.6}


class Plan(NamedTuple):
    """The shape of one K6 / K7 launch."""

    path: str  # "decode" (64-row tiles: one consumer warpgroup) or "prefill"
    bm: int  # rows a tile
    bn: int  # columns a tile
    bk: int  # k a stage
    splits: int  # ranges of K; > 1: partials summed in split order
    ranges: tuple  # each split's [k0, k1), in order
    tiles: int  # output tiles
    units: int  # tiles x splits, walked by the persistent grid
    grid: int  # persistent blocks, at most one an SM


@functools.lru_cache(maxsize=4096)
def plan(m: int, k: int, n: int, kind: str, sms: int = SMS) -> Plan:
    """K6 / K7's launch shape for x [m, k] . w [k, n] with ``kind`` ("bf16"
    or "fp8_e4m3") weights.

    Rows: one 64-row wgmma tile holds every row up to 64 (decode, the
    64-token bucket), where more consumer warpgroups would only multiply
    zero rows. Above that, the row tile whose waves of tiles over the SMs
    cost least, a wave weighted by ``WAVE_COST``: more rows a tile read
    each weight stage from L2 once for more rows, fewer rows give more SMs
    a tile. e4m3 weights take 64-row tiles only up to 64 rows: each tile
    upcasts its own copy of every weight stage it reads.
    Splits: ``SPLITS`` ranges of K for e4m3 decode tiles, and for any
    launch with at most ``FEW_TILES`` tiles, or at most ``LONG_K_TILES``
    with ``LONG_K_STAGES`` stages of K or more; else none. Each split walks
    ``MIN_SPLIT_STAGES`` stages or more."""
    if kind not in ("bf16", "fp8_e4m3"):
        raise ValueError(f"plan: weight kind {kind!r}")
    if m <= 0 or k <= 0 or n <= 0 or k % 16 or n % 16:
        raise ValueError(f"plan: M {m}, K {k}, N {n} (K and N multiples of 16)")
    tiles_n = -(-n // WS_BN)
    if m <= WS_ROWS[0]:
        bm = WS_ROWS[0]
    else:
        rows = WS_ROWS if kind == "bf16" else WS_ROWS[1:]
        waves = {b: -(-(-(-m // b) * tiles_n) // sms) * WAVE_COST[b] for b in rows}
        bm = min(waves, key=lambda b: (waves[b], b))
    tiles = -(-m // bm) * tiles_n
    kb = -(-k // WS_BK)
    split = ((kind == "fp8_e4m3" and bm == WS_ROWS[0]) or tiles <= FEW_TILES
             or (tiles <= LONG_K_TILES and kb >= LONG_K_STAGES))
    splits = max(1, min(SPLITS if split else 1, kb // MIN_SPLIT_STAGES))
    return layout(m, k, n, splits, bm, sms)


def layout(m: int, k: int, n: int, splits: int, bm: int, sms: int = SMS) -> Plan:
    """The plan of a given row tile and number of splits (``plan`` picks
    them; checks and probes force others). Split i covers the stages
    [i kb / splits, (i + 1) kb / splits) of the kb = ceil(k / 64), as the
    kernel computes them."""
    kb = -(-k // WS_BK)
    if bm not in WS_ROWS or not 1 <= splits <= kb:
        raise ValueError(f"layout: row tile {bm}, {splits} splits of {kb} stages")
    tiles = -(-m // bm) * -(-n // WS_BN)
    ranges = tuple((min(k, (i * kb // splits) * WS_BK), min(k, ((i + 1) * kb // splits) * WS_BK))
                   for i in range(splits))
    units = tiles * splits
    return Plan("decode" if bm == WS_ROWS[0] else "prefill", bm, WS_BN, WS_BK, splits,
                ranges, tiles, units, min(units, sms))


def split_model(x, w, scale, p: Plan) -> torch.Tensor:
    """K6 / K7's arithmetic under plan ``p``, in PyTorch: each split's f32
    product over its K range, the partials summed in split order, then
    scaled once (``scale`` None for K7). x bf16 or f32 (rounded to bf16),
    w bf16 or e4m3 (upcast exactly)."""
    xf, wf = x.to(torch.bfloat16).float(), w.float()
    acc = None
    for k0, k1 in p.ranges:
        part = torch.mm(xf[:, k0:k1], wf[k0:k1])
        acc = part if acc is None else acc + part
    return acc if scale is None else acc * scale[None, :]


# K5's plan (csrc/quant_matmul.cu qmm_s8_kernel)
S8_BK = 128  # k a stage (bytes)
S8_BN = 128  # weight columns a tile
S8_ROWS = (16, 64, 128, 256)  # tokens a tile: wgmma's N
S8_WAVE_COST = {128: 1.0, 256: 1.6}  # a wave of 128- / 256-token tiles
S8_MAX_SPLITS = 8
S8_MIN_SPLIT_STAGES = 4  # a split walks at least this many stages


@functools.lru_cache(maxsize=4096)
def int8_plan(m: int, k: int, n: int, sms: int = SMS) -> Plan:
    """K5's launch shape for xq [m, k] . w [k, n].

    Tokens a tile: 16 up to 16 rows (a decode step: wgmma's N is the
    tokens, so no tile carries zero rows past 16), 64 up to 64, above that
    the tile of 128 or 256 whose waves over the SMs cost least (weighted
    by ``S8_WAVE_COST``). Splits: where the tiles fill less than half the
    SMs, as many ranges of K as fit in half of them (``sms // (2 tiles)``;
    H100 sweeps, ``scripts/probe_qmm_kernel.py --sweep``: a split unit pays
    a partial's write and the merge, and 48-96 blocks of one unit each
    already stream as fast as 96-132 split ones), at most
    ``S8_MAX_SPLITS``, each at least ``S8_MIN_SPLIT_STAGES`` stages."""
    if m <= 0 or k <= 0 or n <= 0 or k % 16 or n % 16:
        raise ValueError(f"int8_plan: M {m}, K {k}, N {n} (K and N multiples of 16)")
    tiles_n = -(-n // S8_BN)
    if m <= S8_ROWS[1]:
        bt = S8_ROWS[0] if m <= S8_ROWS[0] else S8_ROWS[1]
    else:
        waves = {b: -(-(-(-m // b) * tiles_n) // sms) * S8_WAVE_COST[b] for b in S8_ROWS[2:]}
        bt = min(waves, key=lambda b: (waves[b], b))
    tiles = -(-m // bt) * tiles_n
    kb = -(-k // S8_BK)
    splits = max(1, min(sms // (2 * tiles), S8_MAX_SPLITS, kb // S8_MIN_SPLIT_STAGES))
    return int8_layout(m, k, n, splits, bt, sms)


def int8_layout(m: int, k: int, n: int, splits: int, bt: int, sms: int = SMS) -> Plan:
    """K5's plan of a given token tile and number of splits (``int8_plan``
    picks them; checks and probes force others). Split i covers the stages
    [i kb / splits, (i + 1) kb / splits) of the kb = ceil(k / 128), as the
    kernel computes them."""
    kb = -(-k // S8_BK)
    if bt not in S8_ROWS or not 1 <= splits <= kb:
        raise ValueError(f"int8_layout: token tile {bt}, {splits} splits of {kb} stages")
    tiles = -(-m // bt) * -(-n // S8_BN)
    ranges = tuple((min(k, (i * kb // splits) * S8_BK), min(k, ((i + 1) * kb // splits) * S8_BK))
                   for i in range(splits))
    units = tiles * splits
    return Plan("decode" if bt <= S8_ROWS[1] else "prefill", bt, S8_BN, S8_BK, splits,
                ranges, tiles, units, min(units, sms))


def int8_split_model(x, w_q, scale, p: Plan) -> torch.Tensor:
    """K5's arithmetic under plan ``p``, in PyTorch: the activations
    quantized, each split's exact int32 product over its K range, the
    partials summed in split order, then ``(float(acc) * sx) * sw``."""
    xq, sx = quantize_activations(x)
    acc = None
    for k0, k1 in p.ranges:
        part = torch.mm(xq[:, k0:k1].double(), w_q[k0:k1].double()).to(torch.int32)
        acc = part if acc is None else acc + part
    return (acc.float() * sx) * scale[None, :]


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
        lib.xllm_quantize_rows.argtypes = [i, p, p, p, i, i, i, i, p]
        lib.xllm_quantize_rows.restype = i
        lib.xllm_qmm_s8.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.xllm_qmm_s8.restype = i
        lib.xllm_qmm_ws.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.xllm_qmm_ws.restype = i
        _lib = lib
    return _lib


_split_bufs: dict[tuple[torch.device, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _split_buffers(dev: torch.device, stream: int, partials: int, tiles: int):
    """A split launch's f32 workspace (``partials`` floats) and its tile
    counters (one int a tile, zero between launches: each launch leaves them
    zero). Kept per device and stream and grown, never shrunk: launches on
    one stream use them one after the other, and a call allocates nothing
    (host time counts at decode)."""
    ws, count = _split_bufs.get((dev, stream), (None, None))
    if ws is None or ws.numel() < partials:
        ws = torch.empty(max(partials, 1 << 20), dtype=torch.float32, device=dev)
    if count is None or count.numel() < tiles:
        count = torch.zeros(max(tiles, 4096), dtype=torch.int32, device=dev)
    _split_bufs[(dev, stream)] = (ws, count)
    return ws, count


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
        xin, sx = quantize_rows(x)
    else:
        xin, sx = x.to(torch.bfloat16), None
    return launch_prepared(name, xin.contiguous(), sx, w, scale, layer)


QUANT_CHUNKS = 8  # chunks of 8 values a quantizer thread keeps, at most
QUANT_MAX_THREADS = 512
QUANT_PER_THREAD = 4  # chunks a thread, where the row allows


def quant_threads(k: int) -> int:
    """The quantizer's threads a row: about ``QUANT_PER_THREAD`` chunks of
    8 values a thread, a multiple of 32 from 64 to ``QUANT_MAX_THREADS``."""
    chunks = k // 8
    t = min(QUANT_MAX_THREADS, max(64, -(-chunks // QUANT_PER_THREAD // 32) * 32))
    if chunks > QUANT_CHUNKS * t:
        raise ValueError(f"quantize_rows: K {k} above {QUANT_CHUNKS * 8 * QUANT_MAX_THREADS}")
    return t


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's per-token activation quantizer: x [M, K] (bf16 or f32) ->
    (int8 codes [M, K], f32 scales [M, 1]), one launch on the card,
    byte-equal to ``quantize_activations`` (its plain version, which a CPU
    tensor takes)."""
    if x.device.type == "cpu":
        return quantize_activations(x)
    if x.device.type != "cuda":
        raise ValueError(f"{QUANT_NAME}: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32) or x.shape[1] % 8:
        raise ValueError(f"{QUANT_NAME}: x {tuple(x.shape)} {x.dtype} (bf16 or f32 [M, K], "
                         "K a multiple of 8)")
    m, k = x.shape
    xq = torch.empty(m, k, dtype=torch.int8, device=x.device)
    sx = torch.empty(m, 1, dtype=torch.float32, device=x.device)
    if m == 0:
        return xq, sx
    threads = quant_threads(k)
    if not x.is_contiguous() or x.data_ptr() % 16:  # rows of 16-byte chunks
        x = x.clone(memory_format=torch.contiguous_format)
    lib = _load()
    _build.count_launch(QUANT_NAME)
    err = lib.xllm_quantize_rows(x.device.index or 0, _build.ptr(x), _build.ptr(xq),
                                 _build.ptr(sx), _build.dtype_code(x.dtype), m, k, threads,
                                 _build.stream_of(x))
    _build.check(lib, err, QUANT_NAME)
    return xq, sx


def launch_prepared(name: str, xin, sx, w, scale, layer: int | None,
                    p: Plan | None = None) -> torch.Tensor:
    """The GEMM alone, on operands ``_matmul`` has checked and prepared: for
    K5 the int8 codes ``xin [M, K]`` and their f32 scales ``sx [M, 1]``, for
    K6 and K7 a bf16 ``xin`` (``sx`` None); ``p`` the launch shape
    (default: ``int8_plan``'s or ``plan``'s). -> f32 [M, N]."""
    k, n = w.shape[-2:]
    m = xin.shape[0]
    out = torch.empty(m, n, dtype=torch.float32, device=xin.device)
    lib = _load()  # a failed build raises here
    row = 0 if layer is None else layer
    w_ptr = ctypes.c_void_p(w.data_ptr() + row * k * n * w.element_size())
    s_ptr = (ctypes.c_void_p(None) if scale is None
             else ctypes.c_void_p(scale.data_ptr() + row * n * 4))
    dev = xin.device.index or 0
    int8 = name == W8A8_NAME
    if p is None:
        sms = _build.device_sms(xin.device)
        p = int8_plan(m, k, n, sms) if int8 else plan(m, k, n, _KIND[name], sms)
    if xin.data_ptr() % 16:  # TMA reads from 16-byte aligned bases
        xin = xin.clone()
    stream = _build.stream_of(xin)
    part = count = None
    if p.splits > 1:  # K5's partials are int32, of the same size as f32
        part, count = _split_buffers(xin.device, stream.value, p.splits * m * n, p.tiles)
    _build.count_launch(name)
    if int8:
        err = lib.xllm_qmm_s8(dev, _build.ptr(xin), w_ptr, _build.ptr(sx), s_ptr,
                              _build.ptr(out), _build.ptr(part), _build.ptr(count), m, k, n,
                              p.bm, p.splits, p.grid, stream)
    else:
        err = lib.xllm_qmm_ws(dev, _build.ptr(xin), w_ptr, s_ptr, _build.ptr(out),
                              _build.ptr(part), _build.ptr(count),
                              _build.dtype_code(w.dtype), m, k, n, p.bm, p.splits, p.grid,
                              stream)
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
