"""K11a, K11b, K11e: latent (MLA) paged attention.

- ``mla_decode_attention_write`` (K11a, ``csrc/mla_attention.cu``) replaces
  ``xllm_tpu/ops/pallas/mla_attention.py`` ``mla_decode_attention_write_tpu``:
  write each sequence's new latent row ``lat_new [B, Dk]`` at
  ``slot_mapping`` into the single-head cache ``[L, NB, 1, bs, Dk]`` (in
  place), then attend ``q [B, H, Dk]`` over ``seq_lens`` tokens (the current
  one included) -> ``[B, H, dv]``;
- ``mla_prefill_attention_batched`` (K11b) replaces
  ``mla_prefill_attention_batched_tpu``: P chunks ``q [P, S, H, Dk]``,
  causal at ``q_offsets[p] + t`` over ``kv_lens[p]`` tokens ->
  ``[P, S, H, dv]``;
- ``mla_prefill_attention`` (K11e) replaces ``mla_prefill_attention_tpu``:
  one chunk ``q [S, H, Dk]`` with 0-d ``q_offset`` and ``kv_len`` on the
  device -> ``[S, H, dv]``, K11b's kernel launched with one chunk under its
  own launch counter.

Scores take all Dk lanes of a cached row, values its first ``dv`` lanes
(absorbed MLA: an MQA over one latent head). The softmax is f32. On a bf16
or a float8_e4m3fn cache (whose pages are upcast to bf16, as in the TPU
kernels; q and the output keep their dtype, bf16 or f32) the unnormalised
probabilities are rounded to bf16 before the value product against the
row's running maximum after each page, as the TPU kernels' walk rounds
them, in the kernels and their plain versions alike. A row with ``seq_len``/``kv_len``
0 (a padded row) and a query row past its chunk's ``kv_len - q_offset``
(bucket padding) come out as zeros (the TPU kernels attend a padding
row to all of ``[0, kv_len)``; nothing reads it). Bound on the card: bytes at decode,
operations at prefill; the design notes are in the CUDA sources. A bf16-q
decode is one cooperative launch of ``csrc/mla_attention.cu``'s
``mla_decode_kernel``: the live 64-position units of every (sequence, head
group) spread evenly over a grid of resident blocks, the splits of a pair
exchanging maxima and merging through global memory (``decode_plan`` sizes
the grid, ``decode_partition`` is the kernel's cut); the new row arrives
uncast and is cast in the kernel. A bf16-q prefill runs ``csrc/mla_prefill.cu`` (wgmma + TMA,
64-row tiles), which splits the context when its row tiles alone give few
blocks (``prefill_plan``). An f32-q call (decode or prefill) runs
``csrc/mla_attention.cu``'s f32 kernel.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from xllm_tpu_torch.ops.cuda import _build
from xllm_tpu_torch.ops.quant import cast_to

DECODE_NAME = "mla_decode_attention_write"
PREFILL_NAME = "mla_prefill_attention_batched"
DECODE_TPU_KERNEL = (
    "xllm_tpu/ops/pallas/mla_attention.py:148 mla_decode_attention_write_tpu"
)
PREFILL_TPU_KERNEL = (
    "xllm_tpu/ops/pallas/mla_attention.py:507 mla_prefill_attention_batched_tpu"
)
ONE_PREFILL_NAME = "mla_prefill_attention"
ONE_PREFILL_TPU_KERNEL = (
    "xllm_tpu/ops/pallas/mla_attention.py:331 mla_prefill_attention_tpu"
)
_SOURCE = "mla_attention"
_PREFILL_SOURCE = "mla_prefill"
TC_VALUE_DIMS = (128, 256, 512)  # dv of the bf16 (tensor-core) builds


def _work_dtype(q, cache) -> torch.dtype:
    """The dtype q enters the kernel in: the cache's, or q's own (bf16 or
    f32) on an fp8 cache, whose pages are upcast to bf16 as in the TPU
    kernels."""
    return q.dtype if cache.dtype == torch.float8_e4m3fn else cache.dtype


def _attend_plain(q, lat, limits, scale, dv, bs: int, round_p: bool):
    """q [N, R, Dk], lat [N, KV, Dk], limits [N, R] (row r sees positions
    < limits[n, r]) -> [N, R, dv] f32; rows with limit 0 are zeros. With
    ``round_p`` (a bf16 or fp8 cache) P is rounded to bf16 before the value
    product, as the TPU kernels round it: unnormalised, against the row's
    running maximum after each page of ``bs`` positions; page i's P then
    carries exp(m_i - m_last), l sums the unrounded P."""
    scores = torch.einsum("nrd,nkd->nrk", q.float(), lat.float()) * scale
    kv_idx = torch.arange(lat.shape[1], device=q.device)
    mask = kv_idx[None, None, :] < limits[..., None]
    scores = scores.masked_fill(~mask, float("-inf"))
    v = lat[..., :dv].float()
    if not round_p:
        probs = torch.nan_to_num(torch.softmax(scores, dim=-1))  # fully masked rows -> 0
        return torch.einsum("nrk,nkd->nrd", probs, v)
    paged = scores.unflatten(-1, (-1, bs))  # [N, R, pages, bs]
    m_run = torch.cummax(paged.amax(-1), dim=-1).values
    seen = torch.isfinite(m_run)
    m_run = torch.where(seen, m_run, 0.0)
    weight = torch.where(seen, torch.exp(m_run - m_run[..., -1:]), 0.0)
    probs = torch.exp(paged - m_run[..., None])  # masked positions: 0
    l = (probs.sum(-1) * weight).sum(-1)[..., None]
    probs = (probs.bfloat16().float() * weight[..., None]).flatten(-2)
    out = torch.einsum("nrk,nkd->nrd", probs, v)
    return torch.where(l > 0, out / l, 0.0)


def _gather_latent(cache, layer: int, block_tables) -> torch.Tensor:
    """-> [N, NBmax * bs, Dk]: each row's pages in table order."""
    pages = cache[layer][block_tables.long()]  # [N, NBmax, 1, bs, Dk]
    n, nbmax, _, bs, dk = pages.shape
    return pages.reshape(n, nbmax * bs, dk)


def mla_decode_attention_write_plain(
    q: torch.Tensor,  # [B, H, Dk]
    lat_new: torch.Tensor,  # [B, Dk]
    cache: torch.Tensor,  # [L, NB, 1, bs, Dk], updated in place
    layer_idx: int,
    slot_mapping: torch.Tensor,  # [B] int32
    block_tables: torch.Tensor,  # [B, NBmax] int32
    seq_lens: torch.Tensor,  # [B] int32 (incl. the current token)
    scale: float,
    dv: int,
) -> torch.Tensor:
    """Plain PyTorch version of K11a (same in-place write, same zeros for
    padded rows)."""
    layer = int(layer_idx)
    bs = cache.shape[3]
    slots = slot_mapping[seq_lens > 0].long()
    rows = cast_to(lat_new[seq_lens > 0], cache.dtype)
    dst = cache.view(torch.uint8) if cache.dtype == torch.float8_e4m3fn else cache
    dst[layer, slots // bs, 0, slots % bs, :] = rows.view(dst.dtype)
    lat = _gather_latent(cache, layer, block_tables)
    limits = seq_lens.long()[:, None].expand(-1, q.shape[1])
    out = _attend_plain(q.to(_work_dtype(q, cache)), lat, limits, scale, dv, bs,
                        cache.dtype != torch.float32)
    return out.to(q.dtype)


def prefill_row_limits(s: int, h: int, q_offsets, kv_lens) -> torch.Tensor:
    """[P, S * H]: chunk row (t, h) sees positions < min(kv_len, q_offset
    + t + 1); rows past ntok = kv_len - q_offset (bucket padding) and padded
    rows (kv_len 0) see none."""
    t = torch.arange(s, device=kv_lens.device)
    qo, kl = q_offsets.long()[:, None], kv_lens.long()[:, None]
    lim = torch.minimum(kl, qo + t[None, :] + 1)
    lim = torch.where(t[None, :] < kl - qo, lim, 0)
    return lim.repeat_interleave(h, dim=1)


def mla_prefill_attention_batched_plain(
    q: torch.Tensor,  # [P, S, H, Dk]
    cache: torch.Tensor,  # [L, NB, 1, bs, Dk]
    layer_idx: int,
    block_tables: torch.Tensor,  # [P, NBmax] int32
    q_offsets: torch.Tensor,  # [P] int32
    kv_lens: torch.Tensor,  # [P] int32 (0 = padded row)
    scale: float,
    dv: int,
) -> torch.Tensor:
    """Plain PyTorch version of K11b -> [P, S, H, dv]."""
    p, s, h, dk = q.shape
    lat = _gather_latent(cache, int(layer_idx), block_tables)
    limits = prefill_row_limits(s, h, q_offsets, kv_lens)
    qw = q.to(_work_dtype(q, cache)).reshape(p, s * h, dk)
    out = _attend_plain(qw, lat, limits, scale, dv, cache.shape[3],
                        cache.dtype != torch.float32)
    return out.reshape(p, s, h, dv).to(q.dtype)


def mla_prefill_attention_plain(
    q: torch.Tensor,  # [S, H, Dk]
    cache: torch.Tensor,  # [L, NB, 1, bs, Dk]
    layer_idx: int,
    block_table: torch.Tensor,  # [NBmax] int32
    q_offset: torch.Tensor,  # [] int32
    kv_len: torch.Tensor,  # [] int32
    scale: float,
    dv: int,
) -> torch.Tensor:
    """Plain PyTorch version of K11e (K11b's at one chunk) -> [S, H, dv]."""
    return mla_prefill_attention_batched_plain(
        q[None], cache, layer_idx, block_table[None], q_offset.reshape(1),
        kv_len.reshape(1), scale, dv,
    )[0]


_lib = None
_TILE = 64  # the bf16 kernels' key tile: block sizes divide it or are multiples of it
_MAX_SPLITS = 32  # kMaxSplits of csrc/mla_prefill.cu
# per-device int32 split counters; the kernel leaves them at 0
_counters: dict[torch.device, torch.Tensor] = {}


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.xllm_mla_attention.argtypes = [
            i, i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, f, i, i, p,
        ]
        lib.xllm_mla_attention.restype = i
        lib.xllm_mla_decode.argtypes = [
            i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, f, i, i, i, i,
            i, i, p,
        ]
        lib.xllm_mla_decode.restype = i
        lib.xllm_mla_decode_blocks_per_sm.argtypes = [i, i, i, i, ctypes.c_longlong, p]
        lib.xllm_mla_decode_blocks_per_sm.restype = i
        _lib = lib
    return _lib


# csrc/mla_attention.cu mla_decode_kernel (K11a, bf16 q): 256 threads, 16
# or 32 head rows a block, stages of 16 latent rows in a ring, splits of
# whole 64-position units
_DECODE_ROWS = 16  # kRows: latent rows a stage
_DECODE_UNIT = 64  # kUnit
_DECODE_MAX_DK = 640  # kMaxDk: q's A fragments of five k16 steps a warp
_DECODE_MAX_STAGES = 8  # kMaxStages
_DECODE_RING = 80 * 1024  # the most bytes of ring a block takes
# two blocks an SM: an H100 SM's 228 KB of shared memory, 1 KB reserved a
# block, a few bytes of static shared memory
_DECODE_SMEM_BLOCK = 233472 // 2 - 1024 - 128
_DECODE_BLOCKS_PER_SM = 2  # the registers of 256 threads at 128 a thread allow two
_DECODE_SCORE_SMEM = 20 * 1024  # a block keeps its scores in shared memory up to this
_DECODE_SPAD = 8  # kSPad: floats past a score row


@dataclass(frozen=True)
class DecodePlan:
    """A bf16-q K11a launch (``decode_plan``): heads in ``groups`` groups of
    ``gm`` rows; ``grid`` blocks, all resident at once (a cooperative
    launch), over which the kernel spreads the live 64-position units of
    every (sequence, group) pair (``decode_partition``); splits of at most
    ``chunk`` positions, at most ``nsp_max`` a pair; granules of ``gran``
    positions; ``stages`` ring stages of 16 latent rows; the scores in
    shared memory or (not ``smem_scores``) in a global scratch of ``gm *
    (chunk + 8)`` floats a block; ``smem`` bytes of shared memory a block."""

    gm: int
    groups: int
    grid: int
    chunk: int
    nsp_max: int
    gran: int
    stages: int
    smem_scores: bool
    smem: int


def decode_gran(bs: int) -> int:
    """Positions of a granule, the unit of the maxima a split publishes:
    every page end and every split edge (64-position units) is a granule
    boundary."""
    return min(bs, _DECODE_UNIT)


def decode_stage_bytes(dk: int, elem: int) -> int:
    """A ring stage: 16 rows of ``dk`` values in 128-byte column blocks."""
    return -(-dk * elem // 128) * _DECODE_ROWS * 128


def decode_smem(dk: int, elem: int, gm: int, chunk: int, gran: int, stages: int,
                smem_scores: bool) -> int:
    """csrc mla_decode::smem_bytes: a block's shared memory."""
    floats = (16 * gm * _DECODE_ROWS + 2 * (chunk // gran) * gm + 2 * (chunk // _DECODE_ROWS) * gm
              + 5 * gm + 8 * gm + (gm * (chunk + _DECODE_SPAD) if smem_scores else 0))
    upcast = decode_stage_bytes(dk, 2) if elem == 1 else 0  # an e4m3 stage as bf16
    return (1024 + stages * decode_stage_bytes(dk, elem) + 8 * _DECODE_MAX_STAGES + upcast
            + 4 * (chunk // _DECODE_ROWS + 2) + 4 * floats)


def decode_plan(batch: int, h: int, width: int, bs: int, dk: int, dv: int, cache_dtype,
                sms: int = 132, per_sm=None) -> DecodePlan:
    """The launch of ``batch`` sequences of ``h`` heads over block tables of
    ``width`` positions (pages of ``bs``), from shapes alone (no read of
    seq_lens): head groups of 16 rows (32 above 16 heads, so that a latent
    row feeds all of them); a grid of ``_DECODE_BLOCKS_PER_SM`` blocks an
    SM (fewer where ``per_sm(gm, smem)``, the blocks an SM holds, says so);
    splits sized for the worst case, every pair's table full: the least
    units a split with which every pair's splits fit the grid (one split a
    pair where the pairs outnumber the blocks); as many ring stages (2-8,
    at most 80 KB) as leave two blocks an SM."""
    gm = 16 if h <= 16 else 32
    groups = -(-h // gm)
    pairs = max(batch * groups, 1)
    units = -(-width // _DECODE_UNIT)
    gran = decode_gran(bs)
    elem = torch.empty((), dtype=cache_dtype).element_size()
    stage = decode_stage_bytes(dk, elem)
    per = _DECODE_BLOCKS_PER_SM
    while True:
        grid = per * sms
        upr = units if pairs > grid else -(-units // (grid // pairs))
        chunk = upr * _DECODE_UNIT
        smem_scores = gm * (chunk + _DECODE_SPAD) * 4 <= _DECODE_SCORE_SMEM
        fixed = decode_smem(dk, elem, gm, chunk, gran, 0, smem_scores)
        stages = max(2, min(_DECODE_MAX_STAGES, _DECODE_RING // stage,
                            (_DECODE_SMEM_BLOCK - fixed) // stage))
        smem = fixed + stages * stage
        held = per if per_sm is None else min(per, per_sm(gm, smem))
        if held >= per or per == 1:
            return DecodePlan(gm, groups, grid, chunk, min(units, grid), gran, stages,
                              smem_scores, smem)
        per = max(1, held)


def decode_partition(seq_lens, groups: int, grid: int,
                     max_len: int) -> tuple[int, list[tuple[int, int, int]]]:
    """The kernel's splits (csrc split_units, locate) -> (upr, [(pair,
    split, splits of the pair)] in launch order): pair p = b * groups + hg
    has ceil(min(seq_len_b, max_len) / 64) units, every split upr of them
    (the last of a pair may hold fewer), upr the least with which the
    splits fit ``grid`` blocks (or, where no upr does, one split a pair).
    Split k of the list runs on block k % grid."""
    units = [-(-min(int(n), max_len) // _DECODE_UNIT) if n > 0 else 0
             for n in seq_lens for _ in range(groups)]
    most = max(units, default=0)
    upr = max(1, min(-(-sum(units) // grid), most))
    while sum(-(-u // upr) for u in units) > grid and upr < most:
        upr += 1
    splits = []
    for p, u in enumerate(units):
        nsp = -(-u // upr)
        splits += [(p, k, nsp) for k in range(nsp)]
    return upr, splits


# csrc/mla_prefill.cu: a block holds 64 (token, head) rows (one wgmma M
# tile) and walks keys 64 at a time (two 32-key stages); Dk a multiple of
# 16 up to 640 (column blocks of 64 lanes, the TMA boxes past Dk land as
# zeros)
_PREFILL_ROWS = 64
_KEY_TILE = 64
_PREFILL_MAX_DK = 640
_BUSY_BLOCKS = 264  # two for each of an H100's 132 SMs (one fits an SM at a time)
_MIN_SPLIT_KEYS = 256  # the last split merges every split's rows alone


@dataclass(frozen=True)
class PrefillPlan:
    """The shape of a bf16-q prefill launch (``prefill_plan``): ``row_tiles``
    blocks of 64 rows a chunk, run longest walk first (block b holds row
    tile ``row_tiles - 1 - b``); ``nsplit`` context splits of ``chunk``
    positions (whole pages and key tiles); a first pass when the walk needs
    maxima it cannot see (``first_pass``): each row's maximum over each
    ``seg`` positions (a split, or a page longer than the key tile),
    ``ngran`` of them a row."""

    row_tiles: int
    chunk: int
    nsplit: int
    seg: int
    ngran: int
    first_pass: bool


def prefill_plan(p: int, s: int, h: int, width: int, bs: int) -> PrefillPlan:
    """-> the plan of a bf16-q prefill launch, from shapes alone (the launch
    reads nothing back from the card): P chunks of S tokens x H heads, a
    block table of ``width`` positions, pages of ``bs``. No split while the
    row tiles give ``_BUSY_BLOCKS`` blocks; else splits of whole units (a
    64-key tile, or a page where pages are longer), at least
    ``_MIN_SPLIT_KEYS`` long, enough of them (at most 32) to reach that
    count. A split past a chunk's kv_len exits at once."""
    row_tiles = -(-s * h // _PREFILL_ROWS)
    blocks = p * row_tiles
    want = 1 if blocks >= _BUSY_BLOCKS else min(_MAX_SPLITS, -(-_BUSY_BLOCKS // blocks))
    return plan_splits(row_tiles, width, bs, want)


def plan_splits(row_tiles: int, width: int, bs: int, want: int,
                min_keys: int = _MIN_SPLIT_KEYS) -> PrefillPlan:
    """-> the plan of ``row_tiles`` row tiles over a table of ``width``
    positions in at most ``want`` splits of whole units (a 64-key tile, or
    a page where pages are longer), each at least ``min_keys`` long (or the
    whole table)."""
    unit = max(_KEY_TILE, bs)
    units = -(-width // unit)
    min_units = max(1, min_keys // unit)
    chunk = unit * max(-(-units // want), min(min_units, units))
    nsplit = -(-width // chunk)
    seg = bs if bs > _KEY_TILE else chunk
    return PrefillPlan(row_tiles, chunk, nsplit, seg, -(-width // seg),
                       nsplit > 1 or bs > _KEY_TILE)


def _split_counters(device: torch.device, n: int) -> torch.Tensor:
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


_F32_TILE = 32  # kFT of the f32 kernel


def _check(name, q, cache, dv, index_arrays) -> tuple[torch.dtype, int]:
    """Shape, dtype and layout checks of a CUDA launch -> (q's working
    dtype, Dk)."""
    nl, nb, one, bs, dk = cache.shape
    _build.dtype_code(cache.dtype)
    work = _work_dtype(q, cache)
    if work not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: q must be bfloat16 or float32, not {q.dtype}")
    if cache.dtype == torch.int8:
        raise NotImplementedError(f"{name}: the latent cache is bf16, f32 or fp8, not int8")
    if one != 1 or q.shape[-1] != dk or not 0 < dv <= dk:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs cache {tuple(cache.shape)}, dv {dv}")
    if work == torch.bfloat16 and (dk % 16 or dv not in TC_VALUE_DIMS or not 16 <= bs <= 512):
        raise NotImplementedError(
            f"{name}: the bf16 kernel takes Dk a multiple of 16, dv in "
            f"{TC_VALUE_DIMS} and block_size 16-512, not Dk {dk}, dv {dv}, bs {bs}"
        )
    tile = _TILE if work == torch.bfloat16 else _F32_TILE
    if bs > tile and bs % tile or bs < tile and tile % bs:
        raise NotImplementedError(f"{name}: block_size {bs} must divide or be a multiple of {tile}")
    if not cache.is_contiguous():
        raise ValueError(f"{name}: the cache must be contiguous")
    for t in index_arrays:
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != cache.device:
            raise ValueError(f"{name}: index arrays must be contiguous int32 on {cache.device}")
        if t.shape[0] != q.shape[0]:
            raise ValueError(f"{name}: index arrays must have one row per q row ({q.shape[0]})")
    return work, dk


def _granules(cache, nbmax: int, rows: int, device) -> tuple[torch.Tensor, int, int]:
    """The f32 kernel's first pass: per-(row, granule) maxima -> (gmax [rows,
    ngran] f32, gran, ngran). A 1-element dummy where the kernel runs no
    first pass: an f32 cache (no rounding), or pages no longer than its
    tile (the walk takes its own page maxima)."""
    bs = cache.shape[3]
    gran = min(bs, _F32_TILE)
    ngran = -(-nbmax * bs // _F32_TILE) * _F32_TILE // gran
    if cache.dtype == torch.float32 or bs <= _F32_TILE:
        return torch.empty(1, dtype=torch.float32, device=device), gran, ngran
    return torch.empty(rows, ngran, dtype=torch.float32, device=device), gran, ngran


def mla_decode_attention_write(
    q: torch.Tensor,
    lat_new: torch.Tensor,
    cache: torch.Tensor,
    layer_idx: int,
    slot_mapping: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    scale: float,
    dv: int,
) -> torch.Tensor:
    """K11a -> out [B, H, dv] in q's dtype; the cache is updated in place."""
    if q.device.type == "cpu":
        return mla_decode_attention_write_plain(
            q, lat_new, cache, layer_idx, slot_mapping, block_tables, seq_lens,
            scale, dv,
        )
    if q.device.type != "cuda":
        raise ValueError(f"{DECODE_NAME}: unsupported device {q.device}")
    b, h, _ = q.shape
    work, dk = _check(DECODE_NAME, q, cache, dv, (slot_mapping, block_tables, seq_lens))
    if lat_new.shape != (b, dk):
        raise ValueError(f"{DECODE_NAME}: lat_new {tuple(lat_new.shape)} is not [B, Dk]")
    if b == 0:
        return torch.empty(0, h, dv, dtype=q.dtype, device=q.device)
    if work == torch.bfloat16:
        return _launch_decode(q, lat_new, cache, layer_idx, slot_mapping, block_tables,
                              seq_lens, scale, dv)
    lib = _load()  # a failed build raises here, before any allocation
    qk = q.to(work).contiguous()
    ln = lat_new.float().contiguous()  # cast to the cache's dtype in the kernel
    out = torch.empty(b, h, dv, dtype=work, device=q.device)
    bs, nbmax = cache.shape[3], block_tables.shape[1]
    gmax, gran, ngran = _granules(cache, nbmax, b * h, q.device)
    _build.count_launch(DECODE_NAME)  # one count for the op (one or two kernels)
    err = lib.xllm_mla_attention(
        q.device.index or 0, 1, _build.ptr(qk), _build.ptr(ln), _build.ptr(cache),
        _build.ptr(slot_mapping), _build.ptr(block_tables), None, _build.ptr(seq_lens),
        _build.ptr(gmax), _build.ptr(out), _build.dtype_code(cache.dtype), b, 1, h, dk, dv,
        int(layer_idx), cache.shape[1], bs, nbmax, float(scale), gran, ngran,
        _build.stream_of(q),
    )
    _build.check(lib, err, DECODE_NAME)
    return out.to(q.dtype)


def _launch_decode(q, lat_new, cache, layer_idx, slot_mapping, block_tables, seq_lens,
                   scale, dv) -> torch.Tensor:
    """bf16 q: ``mla_decode_kernel``, one launch. lat_new reaches it in its
    own dtype (bf16 or f32) and is cast there as the cache stores it."""
    b, h, dk = q.shape
    if dk > _DECODE_MAX_DK:
        raise NotImplementedError(f"{DECODE_NAME}: the bf16 decode kernel takes Dk up to "
                                  f"{_DECODE_MAX_DK} (q's fragments in registers), not {dk}")
    if lat_new.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"{DECODE_NAME}: lat_new must be bfloat16 or float32, "
                                  f"not {lat_new.dtype}")
    lib = _load()  # a failed build raises here, before any allocation
    nl, nb, _, bs, _ = cache.shape
    nbmax = block_tables.shape[1]
    dtype = _build.dtype_code(cache.dtype)
    dev = q.device.index or 0

    def per_sm(gm, smem):  # the card's answer, asked once a configuration
        key = (dev, dtype, gm, dv, smem)
        if key not in _blocks_per_sm:
            n = ctypes.c_int(0)
            _build.check(lib, lib.xllm_mla_decode_blocks_per_sm(dev, dtype, gm, dv, smem,
                                                                ctypes.byref(n)), DECODE_NAME)
            _blocks_per_sm[key] = n.value
        return _blocks_per_sm[key]

    plan = decode_plan(b, h, nbmax * bs, bs, dk, dv, cache.dtype, _build.device_sms(q.device),
                       per_sm)
    qk = q.to(torch.bfloat16).contiguous()
    ln = lat_new.contiguous()
    out = torch.empty(b, h, dv, dtype=torch.bfloat16, device=q.device)
    pairs = b * plan.groups
    f32 = dict(dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scores = None if plan.smem_scores else _scratch(
        q.device, stream, "scores", plan.grid * plan.gm * (plan.chunk + _DECODE_SPAD), f32)
    pub = _scratch(q.device, stream, "pub",
                   pairs * plan.nsp_max * (1 + plan.chunk // plan.gran) * plan.gm, f32)
    red = _scratch(q.device, stream, "red", pairs * plan.nsp_max * plan.gm * (dv + 1), f32)
    counters = _scratch(q.device, stream, "counters", 3 * pairs,
                        dict(dtype=torch.int32, device=q.device))
    _build.count_launch(DECODE_NAME)
    err = lib.xllm_mla_decode(
        dev, _build.ptr(qk), _build.ptr(ln), _build.ptr(cache), _build.ptr(slot_mapping),
        _build.ptr(block_tables), _build.ptr(seq_lens), _build.ptr(out), _build.ptr(scores),
        _build.ptr(pub), _build.ptr(red), _build.ptr(counters), dtype,
        int(ln.dtype == torch.float32), b, h, dk, dv, int(layer_idx), nl, nb, bs, nbmax,
        float(scale), plan.gm, plan.grid, plan.chunk, plan.nsp_max,
        plan.gran.bit_length() - 1, plan.stages, _build.stream_of(q),
    )
    _build.check(lib, err, DECODE_NAME)
    return out.to(q.dtype)


def _scratch(device, stream: int, kind: str, n: int, like: dict) -> torch.Tensor:
    """A buffer of at least ``n`` elements for decode launches on ``stream``
    of ``device``, kept for later calls (zeros when made: the split counters
    must start at 0, and the kernel leaves them so)."""
    key = (device, stream, kind)
    buf = _decode_scratch.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1), **like)
        _decode_scratch[key] = buf
    return buf


# the decode kernel's workspaces by (device, stream, kind), grown on demand;
# the blocks an SM holds, by (device, cache dtype, rows, dv, shared memory)
_decode_scratch: dict[tuple, torch.Tensor] = {}
_blocks_per_sm: dict[tuple, int] = {}


def mla_prefill_attention(
    q: torch.Tensor,
    cache: torch.Tensor,
    layer_idx: int,
    block_table: torch.Tensor,
    q_offset: torch.Tensor,
    kv_len: torch.Tensor,
    scale: float,
    dv: int,
) -> torch.Tensor:
    """K11e -> out [S, H, dv] in q's dtype."""
    if q.device.type == "cpu":
        return mla_prefill_attention_plain(q, cache, layer_idx, block_table, q_offset,
                                           kv_len, scale, dv)
    return _launch_prefill(ONE_PREFILL_NAME, q[None], cache, layer_idx, block_table[None],
                           q_offset.reshape(1), kv_len.reshape(1), scale, dv)[0]


def mla_prefill_attention_batched(
    q: torch.Tensor,
    cache: torch.Tensor,
    layer_idx: int,
    block_tables: torch.Tensor,
    q_offsets: torch.Tensor,
    kv_lens: torch.Tensor,
    scale: float,
    dv: int,
) -> torch.Tensor:
    """K11b -> out [P, S, H, dv] in q's dtype."""
    if q.device.type == "cpu":
        return mla_prefill_attention_batched_plain(
            q, cache, layer_idx, block_tables, q_offsets, kv_lens, scale, dv,
        )
    return _launch_prefill(PREFILL_NAME, q, cache, layer_idx, block_tables, q_offsets,
                           kv_lens, scale, dv)


def _launch_prefill(name, q, cache, layer_idx, block_tables, q_offsets, kv_lens,
                    scale, dv) -> torch.Tensor:
    """K11b's kernel over P chunks, counted under ``name`` -> [P, S, H, dv]."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    p, s, h, _ = q.shape
    work, dk = _check(name, q, cache, dv, (block_tables, q_offsets, kv_lens))
    if work == torch.bfloat16 and dk > _PREFILL_MAX_DK:
        raise NotImplementedError(f"{name}: the bf16 prefill kernel takes Dk up to "
                                  f"{_PREFILL_MAX_DK} (its Q tile and three stages fill shared "
                                  f"memory), not {dk}")
    if q.numel() == 0:
        return torch.empty(p, s, h, dv, dtype=q.dtype, device=q.device)
    if work == torch.bfloat16:
        return _launch_prefill_tc(name, q, cache, layer_idx, block_tables, q_offsets,
                                  kv_lens, scale, dv)
    lib = _load()  # a failed build raises here, before any allocation
    out = torch.empty(p, s, h, dv, dtype=work, device=q.device)
    qk = q.to(work).contiguous()
    bs, nbmax = cache.shape[3], block_tables.shape[1]
    gmax, gran, ngran = _granules(cache, nbmax, p * s * h, q.device)
    _build.count_launch(name)  # one count for the op (one or two kernels)
    err = lib.xllm_mla_attention(
        q.device.index or 0, 0, _build.ptr(qk), None, _build.ptr(cache), None,
        _build.ptr(block_tables), _build.ptr(q_offsets), _build.ptr(kv_lens),
        _build.ptr(gmax), _build.ptr(out), _build.dtype_code(cache.dtype), p, s, h, dk, dv,
        int(layer_idx), cache.shape[1], bs, nbmax, float(scale), gran, ngran,
        _build.stream_of(q),
    )
    _build.check(lib, err, name)
    return out.to(q.dtype)


_prefill_lib = None


def _load_prefill() -> ctypes.CDLL:
    global _prefill_lib
    if _prefill_lib is None:
        lib = _build.load(_PREFILL_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.xllm_mla_prefill.argtypes = [
            i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, ctypes.c_float,
            i, i, i, i, p,
        ]
        lib.xllm_mla_prefill.restype = i
        _prefill_lib = lib
    return _prefill_lib


def _launch_prefill_tc(name, q, cache, layer_idx, block_tables, q_offsets, kv_lens,
                       scale, dv) -> torch.Tensor:
    """bf16 q: ``csrc/mla_prefill.cu`` (one launch, two with a first pass),
    counted once under ``name``."""
    p, s, h, dk = q.shape
    lib = _load_prefill()  # a failed build raises here, before any allocation
    out = torch.empty(p, s, h, dv, dtype=torch.bfloat16, device=q.device)
    qk = q.to(torch.bfloat16).contiguous()
    bs, nbmax = cache.shape[3], block_tables.shape[1]
    plan = prefill_plan(p, s, h, nbmax * bs, bs)
    f32 = dict(dtype=torch.float32, device=q.device)
    gmax = (torch.empty(p, plan.row_tiles, _PREFILL_ROWS, plan.ngran, 2, **f32)
            if plan.first_pass else torch.empty(1, **f32))
    part = (torch.empty(p, plan.row_tiles, plan.nsplit, _PREFILL_ROWS, 4 + dv, **f32)
            if plan.nsplit > 1 else torch.empty(1, **f32))
    counters = _split_counters(q.device, p * plan.row_tiles)
    _build.count_launch(name)  # one count for the op (one or two kernels)
    err = lib.xllm_mla_prefill(
        q.device.index or 0, _build.ptr(qk), _build.ptr(cache), _build.ptr(block_tables),
        _build.ptr(q_offsets), _build.ptr(kv_lens), _build.ptr(gmax), _build.ptr(out),
        _build.ptr(part), _build.ptr(counters), _build.dtype_code(cache.dtype), p, s, h, dk,
        dv, int(layer_idx), cache.shape[0], cache.shape[1], bs, nbmax, float(scale),
        plan.chunk, plan.nsplit, plan.seg, plan.ngran, _build.stream_of(q),
    )
    _build.check(lib, err, name)
    return out.to(q.dtype)
