"""K1, K1b, K8, K9, K12: fused KV write + paged GQA decode attention
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
the cached positions follow in tiles of ``tile`` pages (4 unless
``XLLM_DECODE_KERNEL=v9tT``) from position 0, and on every cache but f32
(int8 codes and float8_e4m3fn upcast to bf16; q, the new rows and the
output stay bf16 or f32) the unnormalised P of each tile is rounded to
bf16 against the running maximum after that tile (``_v9_walk``). (The JAX
package's portable path differs: it writes first, attends to the stored
row, and rounds the normalised P; ``ops/attention.py`` runs it where JAX
does.)

The other TPU decode functions that ``XLLM_DECODE_KERNEL`` selects
(``ops/attention.resolve_decode_kernel``) have K1's contract and differ in
two parameters of that walk, which the same kernel takes: the pages G of
a rounding tile, and where the new token joins the softmax (``mode``):

- ``open``: as K1, the softmax opens at the new token;
- ``last``: the walk opens empty over the cached pages and the new token
  joins after them as one unrounded f32 column;
- ``cache``: the new row is written, and attended from the cache like
  any other position (its bytes cast to the cache dtype): no column of
  its own, and no window.

Each is a ``Variant`` with its own counter name and plain version:

| # | TPU function | mode, G pages |
| --- | --- | --- |
| K1b | ``decode_attention.py:286`` ``…_v5_tpu`` | open, 1 |
| K12a | ``legacy/decode_attention.py:475`` ``…_tpu`` (v1) | cache, 1 |
| K12b | ``legacy/…:372`` ``…_v3_tpu`` | last, 1 |
| K12c | ``legacy/…:800`` ``…_v4_tpu`` | last, 1 |
| K12d | ``legacy/…:1121`` ``…_v6_tpu`` | open, 1 |
| K12e | ``legacy/…:1470`` ``…_v7_tpu`` | open, 2 |
| K12f | ``legacy/…:1860`` ``…_v8_tpu`` | open, ``tile`` (its chunk) |
| K12g | ``legacy/…:2225`` ``…_v10_tpu`` | open, ``tile`` |

The TPU masks with -1e30: a tile wholly masked before the walk's first
attended position (below a window, or the lone tail page at seq_len 1) gets
P = 1 on whatever it holds, which the next finite maximum's rescale
exp(-1e30 - m) = 0 washes out. The port masks with -inf and treats such a
tile as empty, in the kernel and the plain version alike.

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
  V heads). The walk takes tiles of ``tile`` *full* pages, then the tail
  page as a tile of its own: where ``nfull % tile != 0`` P of the tail is
  rounded after its own maximum update, not in the last tile of full pages
  as K8 rounds it. The new row is written token-major at row ``w`` of the
  page that holds it; when it completes the page (``w == bs - 1``) the
  whole page is rewritten canonical, ``[2, Hkv, bs, D]``.

Bound on the card: bytes (every live K/V row is read once per step); the
design notes are in the CUDA source. Each wrapper takes the kernel for a
CUDA tensor and the plain version for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

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
_LEGACY = "xllm_tpu/ops/pallas/legacy/decode_attention.py"

# where the new token joins the walk's softmax (csrc: kMode*)
OPEN, LAST, CACHE = "open", "last", "cache"
_MODE_CODE = {OPEN: 0, LAST: 1, CACHE: 2}


def _write_rows(k_new, v_new, k_all, v_all, layer: int, seq_lens, slot_mapping) -> None:
    """Each live row's new K and V, cast to the cache dtype, at its slot."""
    bs = k_all.shape[3]
    live = seq_lens > 0
    slot = slot_mapping.long()[live]
    for new, cache in ((k_new, k_all), (v_new, v_all)):
        rows = cast_to(new[live], cache.dtype)
        if _build.is_quantized(cache.dtype):  # write the bytes
            cache, rows = cache.view(torch.uint8), rows.view(torch.uint8)
        cache[layer, slot // bs, :, slot % bs, :] = rows


def _split_plain(q, k_new, v_new, k_all, v_all, layer_idx, slot_mapping, block_tables,
                 seq_lens, scale, window: int, pages: int, mode: str) -> torch.Tensor:
    """The plain version of every split-cache variant: the same in-place
    write, the same zeros for padded rows, the walk of ``mode`` over tiles
    of ``pages`` pages."""
    layer = int(layer_idx)
    bs = k_all.shape[3]
    _write_rows(k_new, v_new, k_all, v_all, layer, seq_lens, slot_mapping)

    # q and the new rows in the kernel's working dtype (the cache's, or
    # q's own on a quantized cache)
    work = q.dtype if _build.is_quantized(k_all.dtype) else k_all.dtype
    b, hq, d = q.shape
    hkv = k_all.shape[2]
    bt = block_tables.long()
    k = k_all[layer][bt].float()  # [B, NB, Hkv, bs, D], the new rows written
    v = v_all[layer][bt].float()
    k = k.permute(0, 2, 1, 3, 4).reshape(b, hkv, -1, d)
    v = v.permute(0, 2, 1, 3, 4).reshape(b, hkv, -1, d)
    qg = q.to(work).float().reshape(b, hkv, hq // hkv, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k) * scale
    kv_idx = torch.arange(k.shape[2], device=q.device)
    lens = seq_lens.long()[:, None, None, None]
    # the cached positions; the new token as given, or (cache) as stored
    mask = kv_idx < (lens if mode == CACHE else lens - 1)
    if window > 0:
        mask = mask & (kv_idx >= lens - window)
    scores = scores.masked_fill(~mask, float("-inf"))
    s_new = (qg * k_new.to(work).float()[:, :, None, :]).sum(-1) * scale  # [B, Hkv, G]
    out = _v9_walk(scores, v, s_new, v_new.to(work).float(), pages * bs,
                   k_all.dtype != torch.float32, mode)
    out = torch.where((seq_lens > 0)[:, None, None, None], out, 0.0)
    return out.reshape(b, hq, d).to(q.dtype)


def _v9_walk(scores, v, s_new, v_new, tile: int, round_p: bool,
             mode: str = OPEN) -> torch.Tensor:
    """The TPU kernels' softmax walk. scores [B, Hkv, G, S] (-inf where not
    attended), v [B, Hkv, S, D], the new token's s_new [B, Hkv, G] and
    v_new [B, Hkv, D]; tiles of ``tile`` positions from 0 -> [B, Hkv, G, D].
    The running maximum takes each tile's maximum (``open``: it opens at
    s_new); P of a tile (rounded to bf16 if ``round_p``) carries
    exp(m_tile - m_final), as the TPU kernels' later rescales give it; l
    sums the unrounded P. ``open`` and ``last`` add the new token with
    weight exp(s_new - m_final) (``last``: m_final takes s_new after the
    walk), ``cache`` (whose scores hold the new position) adds nothing."""
    pad = -scores.shape[-1] % tile
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    tiles = scores.unflatten(-1, (-1, tile))  # [B, Hkv, G, T, tile]
    m_run = torch.cummax(tiles.amax(-1), dim=-1).values
    if mode == OPEN:
        m_run = torch.maximum(m_run, s_new[..., None])
    m_fin = m_run[..., -1]
    if mode == LAST:
        m_fin = torch.maximum(m_fin, s_new)
    weight = torch.exp(m_run - m_fin[..., None])  # [B, Hkv, G, T]
    # not attended: 0, also in a tile before any attended one (m_run -inf)
    p = torch.exp(tiles - m_run.clamp(min=torch.finfo(torch.float32).min)[..., None])
    w_new = torch.exp(s_new - m_fin) if mode != CACHE else torch.zeros_like(m_fin)
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
    tile: int = 4,
) -> torch.Tensor:
    """Plain PyTorch version of K8: K1's on the K and V halves of the
    interleaved cache."""
    return _split_plain(q, k_new, v_new, kv_all[:, :, 0], kv_all[:, :, 1], layer_idx,
                        slot_mapping, block_tables, seq_lens, scale, window,
                        _tile_pages(ILV_NAME, tile), OPEN)


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
    tile: int = 4,
) -> torch.Tensor:
    """Plain PyTorch version of K9 (same reads of the token-major tail, same
    walk, same writes)."""
    pages = _tile_pages(RM_NAME, tile)
    layer = int(layer_idx)
    _, _, _, hkv, bs, d = kv_all.shape
    b, hq, _ = q.shape
    work = q.dtype if _build.is_quantized(kv_all.dtype) else kv_all.dtype
    lens = seq_lens.long()
    nfull = (lens - 1).clamp(min=0) // bs  # complete (canonical) pages
    bt = block_tables.long()
    rows = torch.arange(b, device=q.device)
    pages_kv = kv_all[layer][bt].float()  # [B, NB, 2, Hkv, bs, D]
    # page nfull holds the tail token-major: its content as [bs, 2 * Hkv, D]
    tail = pages_kv[rows, nfull].reshape(b, bs, 2 * hkv, d)
    pages_kv[rows, nfull] = tail.permute(0, 2, 1, 3).reshape(b, 2, hkv, bs, d)
    k = pages_kv[:, :, 0].permute(0, 2, 1, 3, 4).reshape(b, hkv, -1, d)
    v = pages_kv[:, :, 1].permute(0, 2, 1, 3, 4).reshape(b, hkv, -1, d)
    qg = q.to(work).float().reshape(b, hkv, hq // hkv, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k) * scale
    pos = torch.arange(k.shape[2], device=q.device)
    mask = pos < lens[:, None] - 1  # the cached positions; the new token as given
    if window > 0:
        mask = mask & (pos >= lens[:, None] - window)
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    s_new = (qg * k_new.to(work).float()[:, :, None, :]).sum(-1) * scale  # [B, Hkv, G]
    out = _tile_walk(scores, v, s_new, v_new.to(work).float(),
                     _rm_tiles(pos, nfull, bs, pages), -(-bt.shape[1] // pages) + 1,
                     kv_all.dtype != torch.float32)
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


def _rm_tiles(pos: torch.Tensor, nfull: torch.Tensor, bs: int, pages: int) -> torch.Tensor:
    """K9's tiles: positions [S] of rows with ``nfull`` [B] complete pages ->
    the tile of each [B, S]: ``pages`` full pages each from position 0,
    then the tail page as a tile of its own."""
    full = pos < nfull[:, None] * bs
    return torch.where(full, pos // (pages * bs), -(-nfull // pages)[:, None])


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
            ctypes.c_float, i, i, i, i, i, ll, i, i, i, p, p,
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


def _tile_pages(name: str, tile: int) -> int:
    if int(tile) < 1:
        raise ValueError(f"{name}: a rounding tile of {tile} pages")
    return int(tile)


def granule(block_size: int, rm: bool = False, pages: int = 4) -> int:
    """Positions of a granule of the kernel's first pass: a granule
    boundary falls at every 64-position tile and at every end of a
    rounding tile of ``pages`` pages (K9, ``rm``: of every page, where its
    tail may start), so a granule is their gcd. The walk's view of one
    64-position tile spans at most 32 granules."""
    span = block_size if rm else pages * block_size
    gran = math.gcd(span, _TILE)
    if (_TILE + pages * block_size - gran) // gran > 32:
        raise NotImplementedError(
            f"{NAME}: a rounding tile of {pages} pages of {block_size} positions "
            f"(more than 32 granules of {gran} in one walk step)")
    return gran


def _split_counters(device: torch.device, n: int) -> torch.Tensor:
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


@dataclasses.dataclass(frozen=True)
class Variant:
    """A TPU decode function on the split cache: the counter ``name`` of its
    wrapper, the ``tpu_kernel`` it replaces, its walk ``mode`` and the
    pages of its rounding tile (None: the call's ``tile``, 4 by default).
    Calling it runs the wrapper: the kernel for a CUDA tensor, ``plain``
    for a CPU tensor -> out [B, Hq, D] in q's dtype; the caches are
    updated in place."""

    name: str
    tpu_kernel: str
    mode: str
    pages: int | None = None

    def _pages(self, tile: int | None, window: int) -> int:
        if self.mode == CACHE and window > 0:
            raise ValueError(f"{self.name}: {self.tpu_kernel.split()[-1]} takes no window")
        if self.pages is None:
            return _tile_pages(self.name, 4 if tile is None else tile)
        if tile is not None and tile != self.pages:
            raise ValueError(f"{self.name}: rounds P after {self.pages} pages, not {tile}")
        return self.pages

    def plain(
        self,
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
        tile: int | None = None,
    ) -> torch.Tensor:
        """Plain PyTorch version of the kernel (same in-place write, same
        zeros for padded rows, same walk)."""
        return _split_plain(q, k_new, v_new, k_all, v_all, layer_idx, slot_mapping,
                            block_tables, seq_lens, scale, window,
                            self._pages(tile, window), self.mode)

    def __call__(self, q, k_new, v_new, k_all, v_all, layer_idx, slot_mapping,
                 block_tables, seq_lens, scale, window: int = 0,
                 tile: int | None = None) -> torch.Tensor:
        if q.device.type == "cpu":
            return self.plain(q, k_new, v_new, k_all, v_all, layer_idx, slot_mapping,
                              block_tables, seq_lens, scale, window, tile)
        pages = self._pages(tile, window)
        nl, nb, hkv, bs, d = k_all.shape
        if v_all.shape != k_all.shape:
            raise ValueError(
                f"{self.name}: caches {tuple(k_all.shape)} vs {tuple(v_all.shape)}")
        if not (k_all.is_contiguous() and v_all.is_contiguous()):
            raise ValueError(f"{self.name}: caches must be contiguous")
        return _launch(self.name, q, k_new, v_new, k_all, v_all, 0, nb, hkv, bs, d,
                       hkv * bs * d, False, layer_idx, slot_mapping, block_tables,
                       seq_lens, scale, window, pages, self.mode)


# every TPU decode function of the split layout, by its XLLM_DECODE_KERNEL
# family (v9 is K1; JAX's v2 and every unknown name resolve to v3)
VARIANTS = {
    "v9": Variant(NAME, TPU_KERNEL, OPEN),
    "v5": Variant("decode_attention_write_v5",
                  "xllm_tpu/ops/pallas/decode_attention.py:286 "
                  "paged_decode_attention_write_v5_tpu", OPEN, 1),
    "v1": Variant("decode_attention_write_v1",
                  f"{_LEGACY}:475 paged_decode_attention_write_tpu", CACHE, 1),
    "v3": Variant("decode_attention_write_v3",
                  f"{_LEGACY}:372 paged_decode_attention_write_v3_tpu", LAST, 1),
    "v4": Variant("decode_attention_write_v4",
                  f"{_LEGACY}:800 paged_decode_attention_write_v4_tpu", LAST, 1),
    "v6": Variant("decode_attention_write_v6",
                  f"{_LEGACY}:1121 paged_decode_attention_write_v6_tpu", OPEN, 1),
    "v7": Variant("decode_attention_write_v7",
                  f"{_LEGACY}:1470 paged_decode_attention_write_v7_tpu", OPEN, 2),
    "v8": Variant("decode_attention_write_v8",
                  f"{_LEGACY}:1860 paged_decode_attention_write_v8_tpu", OPEN),
    "v10": Variant("decode_attention_write_v10",
                   f"{_LEGACY}:2225 paged_decode_attention_write_v10_tpu", OPEN),
}
# K1: the default (v9t4), and every v9 name
paged_decode_attention_write = VARIANTS["v9"]
paged_decode_attention_write_plain = VARIANTS["v9"].plain


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
    tile: int = 4,
) -> torch.Tensor:
    """K8 -> out [B, Hq, D] in q's dtype; kv_all is updated in place."""
    if q.device.type == "cpu":
        return paged_decode_attention_write_ilv_plain(
            q, k_new, v_new, kv_all, layer_idx, slot_mapping, block_tables, seq_lens,
            scale, window, tile,
        )
    nb, hkv, bs, d = _interleaved(ILV_NAME, kv_all)
    return _launch(ILV_NAME, q, k_new, v_new, kv_all, kv_all, hkv * bs * d, nb, hkv, bs,
                   d, 2 * hkv * bs * d, False, layer_idx, slot_mapping, block_tables,
                   seq_lens, scale, window, _tile_pages(ILV_NAME, tile), OPEN)


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
    tile: int = 4,
) -> torch.Tensor:
    """K9 -> out [B, Hq, D] in q's dtype; kv_all is updated in place."""
    if q.device.type == "cpu":
        return paged_decode_attention_write_rm_plain(
            q, k_new, v_new, kv_all, layer_idx, slot_mapping, block_tables, seq_lens,
            scale, window, tile,
        )
    nb, hkv, bs, d = _interleaved(RM_NAME, kv_all)
    return _launch(RM_NAME, q, k_new, v_new, kv_all, kv_all, hkv * bs * d, nb, hkv, bs,
                   d, 2 * hkv * bs * d, True, layer_idx, slot_mapping, block_tables,
                   seq_lens, scale, window, _tile_pages(RM_NAME, tile), OPEN)


def _launch(name, q, k_new, v_new, k_base, v_base, v_off: int, nb: int, hkv: int,
            bs: int, d_cache: int, page: int, rm: bool, layer_idx, slot_mapping,
            block_tables, seq_lens, scale, window, pages: int, mode: str) -> torch.Tensor:
    """One launch of the kernel, counted under ``name``: K at ``k_base``
    and V ``v_off`` elements into ``v_base``, ``page`` elements from one
    (layer, block) page to the next, row-major tails if ``rm``, P rounded
    after tiles of ``pages`` pages, the new token joining as ``mode``
    says."""
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
    gran = granule(bs, rm, pages)
    if b == 0:
        return torch.empty_like(q)
    lib = _load()  # a failed build raises here, before any allocation
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
    ngran = -(-block_tables.shape[1] * bs // _TILE) * _TILE // gran
    # pass 1's granule maxima; an f32 cache rounds nothing and skips it
    gmax = torch.empty((b, hq, ngran) if k_base.dtype != torch.float32 else (1,),
                       dtype=torch.float32, device=q.device)
    # K9's page rewrites stage a completed page here (csrc: the third launch)
    scratch = torch.empty((b, page) if rm else (1,), dtype=k_base.dtype, device=q.device)
    counters = _split_counters(q.device, b * hkv)
    _build.count_launch(name)  # one count for the op's passes
    err = lib.xllm_decode_attention_write(
        q.device.index or 0, _build.ptr(qk), _build.ptr(kn), _build.ptr(vn),
        _build.ptr(k_base), ctypes.c_void_p(v_base.data_ptr() + v_off * v_base.element_size()),
        _build.ptr(slot_mapping), _build.ptr(block_tables), _build.ptr(seq_lens),
        _build.ptr(gmax), _build.ptr(out), _build.ptr(part), _build.ptr(counters), dtype,
        qtype, d, b, int(layer_idx), nb, hkv, bs, block_tables.shape[1], group,
        float(scale), int(window), chunk, nsplit, gran, ngran, page, int(rm),
        pages * bs, _MODE_CODE[mode], _build.ptr(scratch), _build.stream_of(q),
    )
    _build.check(lib, err, name)
    return out.to(q.dtype)
