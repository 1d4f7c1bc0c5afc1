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
operations at prefill; the design notes are in the CUDA sources. Decode
splits each row's context across up to 32 blocks. A bf16-q prefill runs
``csrc/mla_prefill.cu`` (wgmma + TMA, 64-row tiles), which splits the
context when its row tiles alone give few blocks (``prefill_plan``). An
f32-q prefill runs ``csrc/mla_attention.cu``'s f32 kernel.
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
_TILE = 64  # KT of the decode build: a context split is a multiple of it
_MAX_SPLITS = 32  # kMaxSplits of csrc/mla_attention.cu
# per-device int32 split counters; the kernel leaves them at 0
_counters: dict[torch.device, torch.Tensor] = {}


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.xllm_mla_attention.argtypes = [
            i, i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i,
            ctypes.c_float, i, i, i, i, p,
        ]
        lib.xllm_mla_attention.restype = i
        _lib = lib
    return _lib


def split_plan(max_ctx: int, max_splits: int = _MAX_SPLITS) -> tuple[int, int]:
    """-> (chunk, nsplit) of a launch: context splits of ``chunk``
    positions, a multiple of the tile, at most ``max_splits`` of them over
    ``max_ctx`` (sized from the block-table width, so the launch reads
    nothing back from the card)."""
    tiles = -(-max_ctx // _TILE)
    chunk = _TILE * max(1, -(-tiles // max_splits))
    return chunk, max(1, -(-max_ctx // chunk))


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


def _granules(work, cache, nbmax: int, rows: int, nsplit: int,
              device) -> tuple[torch.Tensor, int, int]:
    """The first pass's per-(row, granule) maxima -> (gmax [rows, ngran]
    f32, gran, ngran). A 1-element dummy where the kernel runs no first
    pass: an f32 cache (no rounding), or one walk over pages no longer than
    the tile (the walk takes its own page maxima)."""
    bs = cache.shape[3]
    tile = _TILE if work == torch.bfloat16 else _F32_TILE
    gran = min(bs, tile)
    ngran = -(-nbmax * bs // tile) * tile // gran
    if cache.dtype == torch.float32 or (nsplit == 1 and bs <= tile):
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
    lib = _load()  # a failed build raises here, before any allocation
    qk = q.to(work).contiguous()
    ln = cast_to(lat_new, cache.dtype).contiguous()  # attended as stored
    out = torch.empty(b, h, dv, dtype=work, device=q.device)
    bs, nbmax = cache.shape[3], block_tables.shape[1]
    if work == torch.bfloat16:
        chunk, nsplit = split_plan(nbmax * bs)
        row_tiles = -(-h // 16)
    else:  # the f32 kernel does not split the context
        chunk, nsplit, row_tiles = nbmax * bs, 1, 0
    part = torch.empty(
        (b, row_tiles, nsplit, 16, 4 + dv) if nsplit > 1 else (1,),
        dtype=torch.float32, device=q.device,
    )
    gmax, gran, ngran = _granules(work, cache, nbmax, b * h, nsplit, q.device)
    counters = _split_counters(q.device, b * max(row_tiles, 1))
    _build.count_launch(DECODE_NAME)  # one count for the op (one or two kernels)
    err = lib.xllm_mla_attention(
        q.device.index or 0, 1, _build.ptr(qk), _build.ptr(ln), _build.ptr(cache),
        _build.ptr(slot_mapping), _build.ptr(block_tables), None,
        _build.ptr(seq_lens), _build.ptr(gmax), _build.ptr(out), _build.ptr(part),
        _build.ptr(counters), _build.dtype_code(cache.dtype), _build.dtype_code(work),
        b, 1, h, dk, dv, int(layer_idx), cache.shape[1], bs, nbmax, float(scale),
        chunk, nsplit, gran, ngran, _build.stream_of(q),
    )
    _build.check(lib, err, DECODE_NAME)
    return out.to(q.dtype)


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
    gmax, gran, ngran = _granules(work, cache, nbmax, p * s * h, 1, q.device)
    _build.count_launch(name)  # one count for the op (one or two kernels)
    err = lib.xllm_mla_attention(
        q.device.index or 0, 0, _build.ptr(qk), None, _build.ptr(cache), None,
        _build.ptr(block_tables), _build.ptr(q_offsets), _build.ptr(kv_lens),
        _build.ptr(gmax), _build.ptr(out), None, None, _build.dtype_code(cache.dtype),
        _build.dtype_code(work), p, s, h, dk, dv, int(layer_idx), cache.shape[1], bs, nbmax,
        float(scale), nbmax * bs, 1, gran, ngran, _build.stream_of(q),
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
