"""K1: fused KV write + paged GQA decode attention (``csrc/decode_attention.cu``).

Replaces ``xllm_tpu/ops/pallas/decode_attention.py``
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

Bound on the card: bytes (every live K/V row is read once per step); the
design notes are in the CUDA source. ``paged_decode_attention_write`` takes
the kernel for a CUDA tensor and the plain version for a CPU tensor.
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


_lib = None
_TILE = 64  # kTile of csrc/common.cuh: a context split is a multiple of it
_MAX_SPLITS = 16
# per-device [B * Hkv] int32 split counters; the kernel leaves them at 0
_counters: dict[torch.device, torch.Tensor] = {}


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.xllm_decode_attention_write.argtypes = [
            i, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i,
            ctypes.c_float, i, i, i, i, i, p,
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


def granule(block_size: int) -> int:
    """Positions of a granule of the kernel's first pass: the TPU kernel's
    tile of 4 pages, or the 64-position tile if that is shorter. One must
    divide the other."""
    vt = 4 * block_size
    if vt % _TILE and _TILE % vt:
        raise NotImplementedError(
            f"{NAME}: block_size {block_size} (4 pages must divide or be a "
            f"multiple of {_TILE} positions)"
        )
    return min(vt, _TILE)


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
    """-> out [B, Hq, D] in q's dtype; k_all / v_all are updated in place."""
    if q.device.type == "cpu":
        return paged_decode_attention_write_plain(
            q, k_new, v_new, k_all, v_all, layer_idx, slot_mapping,
            block_tables, seq_lens, scale, window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {q.device}")
    b, hq, d = q.shape
    nl, nb, hkv, bs, d_cache = k_all.shape
    _build.check_head_dim(d)
    dtype = _build.dtype_code(k_all.dtype)
    # q, the new rows and the output in the cache dtype; on a quantized
    # cache in q's own (bf16 or f32; int8 codes are exact in either)
    work = q.dtype if _build.is_quantized(k_all.dtype) else k_all.dtype
    qtype = _build.dtype_code(work)
    if _build.is_quantized(work):
        raise ValueError(f"{NAME}: q must be bfloat16 or float32, not {q.dtype}")
    if d_cache != d or hq % hkv or v_all.shape != k_all.shape:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} vs cache {tuple(k_all.shape)}")
    if k_new.shape != (b, hkv, d) or v_new.shape != (b, hkv, d):
        raise ValueError(f"{NAME}: new rows must be [B, Hkv, D]")
    if not (k_all.is_contiguous() and v_all.is_contiguous()):
        raise ValueError(f"{NAME}: caches must be contiguous")
    for t in (slot_mapping, block_tables, seq_lens):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{NAME}: index arrays must be contiguous int32 on {q.device}")
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
    gran = granule(bs)
    ngran = -(-block_tables.shape[1] * bs // _TILE) * _TILE // gran
    # pass 1's granule maxima; an f32 cache rounds nothing and skips it
    gmax = torch.empty((b, hq, ngran) if k_all.dtype != torch.float32 else (1,),
                       dtype=torch.float32, device=q.device)
    counters = _split_counters(q.device, b * hkv)
    lib = _load()
    _build.count_launch(NAME)  # one count for the op's one or two passes
    err = lib.xllm_decode_attention_write(
        q.device.index or 0, _build.ptr(qk), _build.ptr(kn), _build.ptr(vn),
        _build.ptr(k_all), _build.ptr(v_all), _build.ptr(slot_mapping),
        _build.ptr(block_tables), _build.ptr(seq_lens), _build.ptr(gmax),
        _build.ptr(out), _build.ptr(part), _build.ptr(counters), dtype, qtype, d, b,
        int(layer_idx), nb, hkv, bs, block_tables.shape[1], group, float(scale),
        int(window), chunk, nsplit, gran, ngran, _build.stream_of(q),
    )
    _build.check(lib, err, NAME)
    return out.to(q.dtype)
