"""K1, K8, K9: fused KV write + paged GQA decode attention
(``csrc/decode_attention.cu``).

K1 replaces ``xllm_tpu/ops/pallas/decode_attention.py``
``paged_decode_attention_write_v9_tpu``. Contract: write each sequence's
new K/V row at ``slot_mapping`` into the split cache ``[L, NB, Hkv, bs, D]``
at ``layer_idx`` (in place), then attend ``q [B, Hq, D]`` over ``seq_lens``
tokens (current one included) through ``block_tables`` with an f32 softmax
and an optional sliding ``window``. A row with ``seq_len == 0`` writes
nothing and outputs zeros.

The kernel and its plain version walk as the TPU kernel does: the softmax
opens at the new token (its score, l = 1, acc = v_new: the new token is
attended as given and written cast to the cache dtype, never read back),
the cached positions follow in tiles of 4 pages from position 0, and on
every cache but f32 (int8 codes and float8_e4m3fn upcast to bf16; q, the
new rows and the output stay bf16 or f32) the unnormalised P of each tile
is rounded to bf16 against the running maximum after that tile
(``_v9_walk``). (The JAX package's portable CPU path differs: it writes
first, attends to the stored row, and keeps P in q's dtype.)

The interleaved cache ``[L, NB, 2, Hkv, bs, D]`` holds a page's K and V
contiguously (``kv_all[:, :, 0]`` and ``[:, :, 1]``); the same kernel
serves it with another page stride and V offset, under two more
contracts, each with its own wrapper, launch counter and plain version:

- ``paged_decode_attention_write_ilv`` (K8) replaces
  ``paged_decode_attention_write_v11_tpu``: K1 on the interleaved cache,
  the same walk and the same rounding;
- ``paged_decode_attention_write_rm`` (K9) replaces
  ``paged_decode_attention_write_v12_tpu`` (``kv_layout="interleaved_rm"``):
  a sequence's incomplete tail page holds token-major content (row ``w``
  of the page seen as ``[bs, 2*Hkv, D]`` is the token's K heads, then its
  V heads). The walk takes tiles of 4 *full* pages, then the tail page as
  a tile of its own: where ``nfull % 4 != 0`` P of the tail is rounded
  after its own maximum update, not in the last tile of full pages as K8
  rounds it. The new row is written token-major at row ``w`` of the page
  that holds it; when it completes the page (``w == bs - 1``) the whole
  page is rewritten canonical, ``[2, Hkv, bs, D]``.

Bound on the card: bytes (every live K/V row is read once per step); the
design notes are in the CUDA source. Each wrapper takes the kernel for a
CUDA tensor and the plain version for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from xllm_tpu_torch.ops.cuda import _build
from xllm_tpu_torch.ops.quant import cast_to

NAME = "decode_attention_write"
TPU_KERNEL = (
    "xllm_tpu/ops/pallas/decode_attention.py:674 "
    "paged_decode_attention_write_v9_tpu"
)
ILV_NAME = "decode_attention_write_ilv"
ILV_TPU_KERNEL = (
    "xllm_tpu/ops/pallas/decode_attention.py:1078 "
    "paged_decode_attention_write_v11_tpu"
)
RM_NAME = "decode_attention_write_rm"
RM_TPU_KERNEL = (
    "xllm_tpu/ops/pallas/decode_attention.py:1565 "
    "paged_decode_attention_write_v12_tpu"
)
_SOURCE = "decode_attention"


def paged_decode_attention_write_plain(
    q: torch.Tensor,  # [B, Hq, D]
    k_new: torch.Tensor,  # [B, Hkv, D]
    v_new: torch.Tensor,
    k_all: torch.Tensor,  # [L, NB, Hkv, bs, D], updated in place
    v_all: torch.Tensor,
    layer_idx: int,
    slot_mapping: torch.Tensor,  # [B] int32
    block_tables: torch.Tensor,  # [B, NBmax] int32
    seq_lens: torch.Tensor,  # [B] int32 (incl. the current token)
    scale: float,
    window: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same in-place write, same
    zeros for padded rows, same walk)."""
    layer = int(layer_idx)
    bs = k_all.shape[3]
    live = seq_lens > 0
    slot = slot_mapping.long()[live]
    for new, cache in ((k_new, k_all), (v_new, v_all)):
        rows = cast_to(new[live], cache.dtype)
        if _build.is_quantized(cache.dtype):  # write the bytes
            cache, rows = cache.view(torch.uint8), rows.view(torch.uint8)
        cache[layer, slot // bs, :, slot % bs, :] = rows

    # q and the new rows in the kernel's working dtype (the cache's, or
    # q's own on a quantized cache)
    work = q.dtype if _build.is_quantized(k_all.dtype) else k_all.dtype
    b, hq, d = q.shape
    hkv = k_all.shape[2]
    bt = block_tables.long()
    k = k_all[layer][bt].float()  # [B, NB, Hkv, bs, D]
    v = v_all[layer][bt].float()
    k = k.permute(0, 2, 1, 3, 4).reshape(b, hkv, -1, d)
    v = v.permute(0, 2, 1, 3, 4).reshape(b, hkv, -1, d)
    qg = q.to(work).float().reshape(b, hkv, hq // hkv, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k) * scale
    kv_idx = torch.arange(k.shape[2], device=q.device)
    lens = seq_lens.long()[:, None, None, None]
    mask = kv_idx < lens - 1  # the cached positions; the new token as given
    if window > 0:
        mask = mask & (kv_idx >= lens - window)
    scores = scores.masked_fill(~mask, float("-inf"))
    s_new = (qg * k_new.to(work).float()[:, :, None, :]).sum(-1) * scale  # [B, Hkv, G]
    out = _v9_walk(scores, v, s_new, v_new.to(work).float(), 4 * bs,
                   k_all.dtype != torch.float32)
    out = torch.where(live[:, None, None, None], out, 0.0)
    return out.reshape(b, hq, d).to(q.dtype)


def _v9_walk(scores, v, s_new, v_new, tile: int, round_p: bool) -> torch.Tensor:
    """The TPU kernel's softmax walk. scores [B, Hkv, G, S] (-inf where not
    attended), v [B, Hkv, S, D], the new token's s_new [B, Hkv, G] and
    v_new [B, Hkv, D]; tiles of ``tile`` positions from 0 -> [B, Hkv, G, D].
    The running maximum opens at s_new and takes each tile's maximum; P of
    a tile (rounded to bf16 if ``round_p``) carries exp(m_tile - m_final),
    as the TPU kernel's later rescales give it; l sums the unrounded P."""
    pad = -scores.shape[-1] % tile
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    tiles = scores.unflatten(-1, (-1, tile))  # [B, Hkv, G, T, tile]
    m_run = torch.maximum(torch.cummax(tiles.amax(-1), dim=-1).values, s_new[..., None])
    m_fin = m_run[..., -1]
    weight = torch.exp(m_run - m_fin[..., None])  # [B, Hkv, G, T]
    p = torch.exp(tiles - m_run[..., None])  # not attended: 0
    w_new = torch.exp(s_new - m_fin)
    l = (p.sum(-1) * weight).sum(-1) + w_new
    if round_p:
        p = p.bfloat16().float()
    acc = torch.einsum("bkgts,bktsd->bkgd", p * weight[..., None],
                       v.unflatten(2, (-1, tile)))
    acc = acc + w_new[..., None] * v_new[:, :, None, :]
    return acc / l[..., None]


def paged_decode_attention_write_ilv_plain(
    q: torch.Tensor,  # [B, Hq, D]
    k_new: torch.Tensor,  # [B, Hkv, D]
    v_new: torch.Tensor,
    kv_all: torch.Tensor,  # [L, NB, 2, Hkv, bs, D], updated in place
    layer_idx: int,
    slot_mapping: torch.Tensor,  # [B] int32
    block_tables: torch.Tensor,  # [B, NBmax] int32
    seq_lens: torch.Tensor,  # [B] int32 (incl. the current token)
    scale: float,
    window: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of K8: K1's on the K and V halves of the
    interleaved cache."""
    return paged_decode_attention_write_plain(
        q, k_new, v_new, kv_all[:, :, 0], kv_all[:, :, 1], layer_idx, slot_mapping,
        block_tables, seq_lens, scale, window,
    )


def paged_decode_attention_write_rm_plain(
    q: torch.Tensor,  # [B, Hq, D]
    k_new: torch.Tensor,  # [B, Hkv, D]
    v_new: torch.Tensor,
    kv_all: torch.Tensor,  # [L, NB, 2, Hkv, bs, D], updated in place
    layer_idx: int,
    slot_mapping: torch.Tensor,  # [B] int32
    block_tables: torch.Tensor,  # [B, NBmax] int32
    seq_lens: torch.Tensor,  # [B] int32 (incl. the current token)
    scale: float,
    window: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of K9 (same reads of the token-major tail, same
    walk, same writes)."""
    layer = int(layer_idx)
    _, _, _, hkv, bs, d = kv_all.shape
    b, hq, _ = q.shape
    work = q.dtype if _build.is_quantized(kv_all.dtype) else kv_all.dtype
    lens = seq_lens.long()
    nfull = (lens - 1).clamp(min=0) // bs  # complete (canonical) pages
    bt = block_tables.long()
    rows = torch.arange(b, device=q.device)
    pages = kv_all[layer][bt].float()  # [B, NB, 2, Hkv, bs, D]
    # page nfull holds the tail token-major: its content as [bs, 2 * Hkv, D]
    tail = pages[rows, nfull].reshape(b, bs, 2 * hkv, d)
    pages[rows, nfull] = tail.permute(0, 2, 1, 3).reshape(b, 2, hkv, bs, d)
    k = pages[:, :, 0].permute(0, 2, 1, 3, 4).reshape(b, hkv, -1, d)
    v = pages[:, :, 1].permute(0, 2, 1, 3, 4).reshape(b, hkv, -1, d)
    qg = q.to(work).float().reshape(b, hkv, hq // hkv, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k) * scale
    pos = torch.arange(k.shape[2], device=q.device)
    mask = pos < lens[:, None] - 1  # the cached positions; the new token as given
    if window > 0:
        mask = mask & (pos >= lens[:, None] - window)
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    s_new = (qg * k_new.to(work).float()[:, :, None, :]).sum(-1) * scale  # [B, Hkv, G]
    out = _tile_walk(scores, v, s_new, v_new.to(work).float(), _rm_tiles(pos, nfull, bs),
                     -(-bt.shape[1] // 4) + 1, kv_all.dtype != torch.float32)
    out = torch.where((lens > 0)[:, None, None, None], out, 0.0)

    # persist the new row: token-major at row w of its page, or, when it
    # completes the page (w == bs - 1), the whole page rewritten canonical
    live = lens > 0
    slot = slot_mapping.long()
    blk, w = slot // bs, slot % bs
    row = torch.cat([cast_to(k_new, kv_all.dtype), cast_to(v_new, kv_all.dtype)], dim=1)
    cache = kv_all
    if _build.is_quantized(kv_all.dtype):  # write the bytes
        cache, row = kv_all.view(torch.uint8), row.view(torch.uint8)
    tok = cache.view(*cache.shape[:2], bs, 2 * hkv, d)  # every page token-major
    opens = live & (w != bs - 1)
    tok[layer, blk[opens], w[opens]] = row[opens]
    done = live & (w == bs - 1)
    cont = tok[layer, blk[done]]  # [n, bs, 2 * Hkv, D]
    cont[:, bs - 1] = row[done]
    cache[layer, blk[done]] = cont.transpose(1, 2).reshape(-1, 2, hkv, bs, d)
    return out.reshape(b, hq, d).to(q.dtype)


def _rm_tiles(pos: torch.Tensor, nfull: torch.Tensor, bs: int) -> torch.Tensor:
    """K9's tiles: positions [S] of rows with ``nfull`` [B] complete pages ->
    the tile of each [B, S]: 4 full pages each from position 0, then the
    tail page as a tile of its own."""
    full = pos < nfull[:, None] * bs
    return torch.where(full, pos // (4 * bs), -(-nfull // 4)[:, None])


def _tile_walk(scores, v, s_new, v_new, tile_of, ntiles: int,
               round_p: bool) -> torch.Tensor:
    """``_v9_walk`` over tiles given per position: ``tile_of`` [B, S] (the
    tile of each position, non-decreasing) of ``ntiles`` per row. The
    running maximum opens at s_new and takes each tile's maximum in
    order; P of a position is rounded (if ``round_p``) against the running
    maximum after its tile and carries exp(m_tile - m_final)."""
    b, hkv, g, s = scores.shape
    idx = tile_of[:, None, None, :].expand(b, hkv, g, s)
    tmax = torch.full((b, hkv, g, ntiles), float("-inf"), device=scores.device)
    tmax = tmax.scatter_reduce(-1, idx, scores, "amax")
    m_run = torch.maximum(torch.cummax(tmax, dim=-1).values, s_new[..., None])
    m_fin = m_run[..., -1]
    m_pos = torch.gather(m_run, -1, idx)
    p = torch.exp(scores - m_pos)  # not attended: 0
    weight = torch.exp(m_pos - m_fin[..., None])
    w_new = torch.exp(s_new - m_fin)
    l = (p * weight).sum(-1) + w_new
    if round_p:
        p = p.bfloat16().float()
    acc = torch.einsum("bkgs,bksd->bkgd", p * weight, v)
    acc = acc + w_new[..., None] * v_new[:, :, None, :]
    return acc / l[..., None]


_lib = None
_TILE = 64  # kTile of csrc/common.cuh: a context split is a multiple of it
_MAX_SPLITS = 16
# per-device [B * Hkv] int32 split counters; the kernel leaves them at 0
_counters: dict[torch.device, torch.Tensor] = {}


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.xllm_decode_attention_write.argtypes = [
            i, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i,
            ctypes.c_float, i, i, i, i, i, ll, i, p, p,
        ]
        lib.xllm_decode_attention_write.restype = i
        _lib = lib
    return _lib


def _split_plan(max_ctx: int) -> tuple[int, int]:
    """-> (chunk, nsplit): context splits of ``chunk`` positions, a multiple
    of the tile, at most ``_MAX_SPLITS`` of them over ``max_ctx``."""
    tiles = -(-max_ctx // _TILE)
    chunk = _TILE * max(1, -(-tiles // _MAX_SPLITS))
    return chunk, max(1, -(-max_ctx // chunk))


def granule(block_size: int, rm: bool = False) -> int:
    """Positions of a granule of the kernel's first pass: the TPU kernel's
    tile of 4 pages, or the 64-position tile if that is shorter; one must
    divide the other. K9 (``rm``) needs a granule boundary where its tail
    page starts, at a multiple of the page: a page, or the 64-position
    tile if that is shorter."""
    vt = 4 * block_size
    if vt % _TILE and _TILE % vt or rm and block_size % _TILE and _TILE % block_size:
        raise NotImplementedError(
            f"{NAME}: block_size {block_size} (4 pages must divide or be a "
            f"multiple of {_TILE} positions)"
        )
    return min(block_size if rm else vt, _TILE)


def _split_counters(device: torch.device, n: int) -> torch.Tensor:
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def paged_decode_attention_write(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_all: torch.Tensor,
    v_all: torch.Tensor,
    layer_idx: int,
    slot_mapping: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    scale: float,
    window: int = 0,
) -> torch.Tensor:
    """K1 -> out [B, Hq, D] in q's dtype; k_all / v_all are updated in place."""
    if q.device.type == "cpu":
        return paged_decode_attention_write_plain(
            q, k_new, v_new, k_all, v_all, layer_idx, slot_mapping,
            block_tables, seq_lens, scale, window,
        )
    nl, nb, hkv, bs, d = k_all.shape
    if v_all.shape != k_all.shape:
        raise ValueError(f"{NAME}: caches {tuple(k_all.shape)} vs {tuple(v_all.shape)}")
    if not (k_all.is_contiguous() and v_all.is_contiguous()):
        raise ValueError(f"{NAME}: caches must be contiguous")
    return _launch(NAME, q, k_new, v_new, k_all, v_all, 0, nb, hkv, bs, d,
                   hkv * bs * d, False, layer_idx, slot_mapping, block_tables,
                   seq_lens, scale, window)


def _interleaved(name, kv_all):
    """-> (nb, hkv, bs, d) of a contiguous interleaved cache."""
    if kv_all.dim() != 6 or kv_all.shape[2] != 2:
        raise ValueError(f"{name}: the cache must be [L, NB, 2, Hkv, bs, D], not "
                         f"{tuple(kv_all.shape)}")
    if not kv_all.is_contiguous():
        raise ValueError(f"{name}: the cache must be contiguous")
    _, nb, _, hkv, bs, d = kv_all.shape
    return nb, hkv, bs, d


def paged_decode_attention_write_ilv(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    kv_all: torch.Tensor,
    layer_idx: int,
    slot_mapping: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    scale: float,
    window: int = 0,
) -> torch.Tensor:
    """K8 -> out [B, Hq, D] in q's dtype; kv_all is updated in place."""
    if q.device.type == "cpu":
        return paged_decode_attention_write_ilv_plain(
            q, k_new, v_new, kv_all, layer_idx, slot_mapping, block_tables, seq_lens,
            scale, window,
        )
    nb, hkv, bs, d = _interleaved(ILV_NAME, kv_all)
    return _launch(ILV_NAME, q, k_new, v_new, kv_all, kv_all, hkv * bs * d, nb, hkv, bs,
                   d, 2 * hkv * bs * d, False, layer_idx, slot_mapping, block_tables,
                   seq_lens, scale, window)


def paged_decode_attention_write_rm(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    kv_all: torch.Tensor,
    layer_idx: int,
    slot_mapping: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    scale: float,
    window: int = 0,
) -> torch.Tensor:
    """K9 -> out [B, Hq, D] in q's dtype; kv_all is updated in place."""
    if q.device.type == "cpu":
        return paged_decode_attention_write_rm_plain(
            q, k_new, v_new, kv_all, layer_idx, slot_mapping, block_tables, seq_lens,
            scale, window,
        )
    nb, hkv, bs, d = _interleaved(RM_NAME, kv_all)
    return _launch(RM_NAME, q, k_new, v_new, kv_all, kv_all, hkv * bs * d, nb, hkv, bs,
                   d, 2 * hkv * bs * d, True, layer_idx, slot_mapping, block_tables,
                   seq_lens, scale, window)


def _launch(name, q, k_new, v_new, k_base, v_base, v_off: int, nb: int, hkv: int,
            bs: int, d_cache: int, page: int, rm: bool, layer_idx, slot_mapping,
            block_tables, seq_lens, scale, window) -> torch.Tensor:
    """One launch of the kernel, counted under ``name``: K at ``k_base``
    and V ``v_off`` elements into ``v_base``, ``page`` elements from one
    (layer, block) page to the next, row-major tails if ``rm``."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    b, hq, d = q.shape
    _build.check_head_dim(d)
    dtype = _build.dtype_code(k_base.dtype)
    # q, the new rows and the output in the cache dtype; on a quantized
    # cache in q's own (bf16 or f32; int8 codes are exact in either)
    work = q.dtype if _build.is_quantized(k_base.dtype) else k_base.dtype
    qtype = _build.dtype_code(work)
    if _build.is_quantized(work):
        raise ValueError(f"{name}: q must be bfloat16 or float32, not {q.dtype}")
    if d_cache != d or hq % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs cache {tuple(k_base.shape)}")
    if k_new.shape != (b, hkv, d) or v_new.shape != (b, hkv, d):
        raise ValueError(f"{name}: new rows must be [B, Hkv, D]")
    for t in (slot_mapping, block_tables, seq_lens):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name}: index arrays must be contiguous int32 on {q.device}")
    if b == 0:
        return torch.empty_like(q)
    qk = q.to(work).contiguous()
    kn = k_new.to(work).contiguous()
    vn = v_new.to(work).contiguous()
    out = torch.empty_like(qk)
    group = hq // hkv
    # splits are sized from the block-table width, not from seq_lens, so
    # the launch needs no device-to-host read
    chunk, nsplit = _split_plan(block_tables.shape[1] * bs)
    part = torch.empty(
        (b, hkv, nsplit, group, 2 + d) if nsplit > 1 else (1,),
        dtype=torch.float32, device=q.device,
    )
    gran = granule(bs, rm)
    ngran = -(-block_tables.shape[1] * bs // _TILE) * _TILE // gran
    # pass 1's granule maxima; an f32 cache rounds nothing and skips it
    gmax = torch.empty((b, hq, ngran) if k_base.dtype != torch.float32 else (1,),
                       dtype=torch.float32, device=q.device)
    # K9's page rewrites stage a completed page here (csrc: the third launch)
    scratch = torch.empty((b, page) if rm else (1,), dtype=k_base.dtype, device=q.device)
    counters = _split_counters(q.device, b * hkv)
    lib = _load()
    _build.count_launch(name)  # one count for the op's passes
    err = lib.xllm_decode_attention_write(
        q.device.index or 0, _build.ptr(qk), _build.ptr(kn), _build.ptr(vn),
        _build.ptr(k_base), ctypes.c_void_p(v_base.data_ptr() + v_off * v_base.element_size()),
        _build.ptr(slot_mapping), _build.ptr(block_tables), _build.ptr(seq_lens),
        _build.ptr(gmax), _build.ptr(out), _build.ptr(part), _build.ptr(counters), dtype,
        qtype, d, b, int(layer_idx), nb, hkv, bs, block_tables.shape[1], group,
        float(scale), int(window), chunk, nsplit, gran, ngran, page, int(rm),
        _build.ptr(scratch), _build.stream_of(q),
    )
    _build.check(lib, err, name)
    return out.to(q.dtype)
