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

Bound on the card: bytes. Every call is one launch of one kernel on every
cache and layout: a thread-block cluster per (sequence, kv head) whose
blocks are the context splits, each reading its K and V rows from HBM once
(``plan`` is the launch's shape, a pure function of the block-table width;
``partition`` the kernel's cut of one sequence; ``split_model`` its
arithmetic in plain PyTorch). The design notes are in the CUDA source. Each
wrapper takes the kernel for a CUDA tensor and the plain version for a CPU
tensor.
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
_MAX_SPLITS = 16  # the largest cluster (csrc kMaxCluster; non-portable on Hopper)
# clusters are sized so that a launch's blocks fill the card about once at
# this many blocks an SM: every block of a cluster, idle splits included,
# holds its SM until the cluster ends
_BLOCKS_PER_SM = 8
# the least 64-position tiles of a split of the table where the launch
# would give every SM a block without it (cluster_floor): once the card is
# full, a block's fixed cost (ring start, three cluster barriers, merge)
# outweighs a split of a few tiles, and every block of a cluster, idle ones
# included, holds its SM until the cluster ends (H100 scans at 1, 4 and 16
# sequences of 300-4,096 tokens: 6 beat 1, 2, 4, 8, 12 and 16 in sum)
_SPLIT_TILES = 6
_SCORE_SMEM = 32 * 1024  # a block keeps its scores in shared memory up to this
_RING_BYTES = 32 * 1024  # csrc kRingBytes: a block's ring of 64-row K / V tiles
_SMEM_MAX = 232448  # csrc kSmemMax: an H100 block's dynamic shared memory
_SMEM_SM = 233472  # an H100 SM's shared memory (228 KB)
_PORTABLE_CLUSTER = 8  # the cluster size every GPC holds at one block an SM
_INT_MAX = 2 ** 31 - 1
# per-device-and-stream workspaces, grown on demand and reused by every
# call on that stream: K9's per-sequence counters (the kernel leaves them
# at 0), its staged pages, and the scores of the long-table path
_workspaces: dict[tuple, torch.Tensor] = {}


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.xllm_decode_attention_write.argtypes = [
            i, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i,
            ctypes.c_float, i, i, i, i, ll, i, i, i, ll, ll, p,
        ]
        lib.xllm_decode_attention_write.restype = i
        _lib = lib
    return _lib


def _split_plan(max_ctx: int, cap: int = _MAX_SPLITS, least: int = 1,
                floor: int = _MAX_SPLITS) -> tuple[int, int]:
    """-> (chunk, nsplit): context splits of ``chunk`` positions, a multiple
    of the tile, at most ``cap`` of them over ``max_ctx``, and of at least
    ``least`` tiles unless that leaves fewer than ``floor`` splits.
    ``nsplit`` is the kernel's cluster size: the blocks of one (sequence,
    kv head)."""
    tiles = -(-max_ctx // _TILE)
    chunk = _TILE * max(1, -(-tiles // cap), min(least, -(-tiles // max(floor, 1))))
    return chunk, max(1, -(-max_ctx // chunk))


def _tile_pages(name: str, tile: int) -> int:
    if int(tile) < 1:
        raise ValueError(f"{name}: a rounding tile of {tile} pages")
    return int(tile)


def granule(block_size: int, rm: bool = False, pages: int = 4, rounds: bool = True) -> int:
    """Positions of a granule, the unit of the maxima a split publishes: a
    granule boundary falls at every 64-position tile and at every end of a
    rounding tile of ``pages`` pages (K9, ``rm``: of every page, where its
    tail may start), so a granule is their gcd. An f32 cache (``rounds``
    false) rounds nothing and publishes only its maximum: 64."""
    if not rounds:
        return _TILE
    return math.gcd(block_size if rm else pages * block_size, _TILE)


def group_rows(group: int) -> int:
    """The kernel instance's query rows a kv head (GMAX): the least of 2, 4,
    8, 16, 32 that holds ``group``."""
    for rows in (2, 4, 8, 16, 32):
        if group <= rows:
            return rows
    raise NotImplementedError(f"{NAME}: {group} query heads a kv head (at most 32)")


def _stage_bytes(head_dim: int, elem: int) -> int:
    """csrc Ring::kTileBytes: 64 rows."""
    return _TILE * head_dim * elem


def ring_stages(head_dim: int, elem: int) -> int:
    """csrc Ring::kStages: 64-row tiles of ``elem``-byte values in the ring."""
    return min(8, max(2, _RING_BYTES // _stage_bytes(head_dim, elem)))


def smem_bytes(elem: int, head_dim: int, group: int, chunk: int, gran: int,
               smem_scores: bool) -> int:
    """csrc decode_smem_bytes: a block's shared memory."""
    gmax = group_rows(group)
    floats = (gmax * head_dim + (chunk * gmax if smem_scores else 0)
              + 2 * (chunk // gran) * gmax + 12 * gmax + (chunk // 16) * gmax)
    pages = 8 * (chunk // 16 + 2 + 8)  # the split's page rows, the stages' mbarriers
    return (1024 + ring_stages(head_dim, elem) * _stage_bytes(head_dim, elem) + pages
            + 4 * floats + 16)


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch's shape, a pure function of the block-table width and the
    heads (no read of seq_lens): ``cluster`` blocks a (sequence, kv head),
    each a context split of at most ``chunk`` positions (the kernel cuts
    each sequence's own split from its seq_len, ``partition``); granules of
    ``gran`` positions; ``gmax`` query rows an instance; the scores in
    shared memory or (``smem_scores`` false: the long-table path) in a
    global scratch of ``cluster * chunk * gmax`` floats a (sequence, kv
    head); ``smem`` bytes of shared memory a block."""

    cluster: int
    chunk: int
    gran: int
    gmax: int
    smem_scores: bool
    smem: int


def cluster_cap(heads: int, sms: int = 132) -> int:
    """The most blocks a cluster of a launch over ``heads`` (sequence, kv
    head) pairs: enough that the launch fills ``sms`` SMs about once, at
    least 1, at most 16."""
    return min(_MAX_SPLITS, max(1, _BLOCKS_PER_SM * sms // max(heads, 1)))


def cluster_floor(heads: int, sms: int = 132) -> int:
    """The blocks a cluster of a launch over ``heads`` pairs may take
    whatever its splits hold: about one block an SM (at least 1, at most
    16), so a launch over few heads splits its table as far as it can."""
    return min(_MAX_SPLITS, max(1, sms // max(heads, 1)))


def plan(nbmax: int, bs: int, group: int, head_dim: int, cache_dtype, rm: bool = False,
         pages: int = 4, heads: int = 1, sms: int = 132) -> Plan:
    """The launch of a table of ``nbmax`` pages of ``bs`` positions over
    ``heads`` (sequence, kv head) pairs on ``sms`` SMs: clusters of at most
    ``cluster_cap`` blocks, whose splits hold at least ``_SPLIT_TILES``
    tiles beyond ``cluster_floor`` blocks (one pair: up to 16 blocks,
    however short their splits)."""
    gran = granule(bs, rm, pages, cache_dtype != torch.float32)
    gmax = group_rows(group)
    elem = torch.empty((), dtype=cache_dtype).element_size()
    cap, floor = cluster_cap(heads, sms), cluster_floor(heads, sms)
    # a block whose ring and q alone fill more than half an SM (an f32 ring
    # at head_dim 256) runs one a SM: a cluster must then fit the SMs of one
    # GPC, so it keeps to the portable size
    if 2 * (ring_stages(head_dim, elem) * _stage_bytes(head_dim, elem)
            + 4 * gmax * head_dim) > _SMEM_SM:
        cap, floor = min(cap, _PORTABLE_CLUSTER), min(floor, _PORTABLE_CLUSTER)
    chunk, cluster = _split_plan(nbmax * bs, cap, _SPLIT_TILES, floor)
    smem_scores = chunk * gmax * 4 <= _SCORE_SMEM
    smem = smem_bytes(elem, head_dim, group, chunk, gran, smem_scores)
    if smem > _SMEM_MAX:
        raise NotImplementedError(
            f"{NAME}: {smem} bytes of shared memory a block (granules of {gran} "
            f"positions over splits of {chunk})")
    return Plan(cluster, chunk, gran, gmax, smem_scores, smem)


def partition(seq_len: int, window: int, mode: str, cluster: int) -> tuple[int, int, int, int]:
    """The kernel's split of one sequence -> (base, wend, chunk, nsp): the
    walk covers positions [base, wend) (the cached ones, ``cache``: and the
    new one; from the 64-tile below the window's edge), cut into ``nsp``
    splits of ``chunk`` positions (whole tiles, spread evenly over the
    ``cluster`` blocks; the last may be shorter). At least one split, which
    may be empty."""
    lo = max(seq_len - window, 0) if window > 0 else 0
    base = lo // _TILE * _TILE
    wend = seq_len if mode == CACHE else seq_len - 1
    tiles = -(-max(wend - base, 0) // _TILE)
    tpr = max(1, -(-tiles // cluster))
    return base, wend, tpr * _TILE, max(1, -(-tiles // tpr))


def split_model(scores, v, s_new, v_new, seq_lens, window: int, mode: str, vt: int,
                gran: int, round_p: bool, cluster: int, tail_from=None) -> torch.Tensor:
    """What the kernel computes, split after split, in plain PyTorch:
    scores [B, Hkv, G, S] (-inf where not attended), v [B, Hkv, S, D], the
    new token's s_new [B, Hkv, G] and v_new [B, Hkv, D], seq_lens [B];
    rounding tiles of ``vt`` positions, K9's tails from ``tail_from`` [B]
    (None: no tail) -> out [B, Hkv, G, D] (zeros for padded rows).

    Each split of ``partition`` publishes its granule maxima (granules of
    ``gran`` positions) and its maximum; it takes the running maximum
    before it from the earlier splits' (``open``: and s_new), the row's
    final one from all, and M of its last rounding tile from the granules
    of the next splits where that tile runs past it. A position p takes
    M(p), the running maximum at the end of its rounding tile (K9: clipped
    to the tail; in the tail the final maximum), and adds bf16(exp(s - M))
    * exp(M - M_f) to P (``round_p``; else exp(s - M_f)) and exp(s - M) *
    exp(M - M_f) to l; the splits' (l, acc), all in the frame M_f, sum up,
    and the new token (not ``cache``) adds exp(s_new - M_f) v_new."""
    b_, hkv, g_, _ = scores.shape
    ninf = float("-inf")
    out = torch.zeros(b_, hkv, g_, v.shape[-1])
    for b in range(b_):
        n = int(seq_lens[b])
        if n <= 0:
            continue
        base, wend, chunk, nsp = partition(n, window, mode, cluster)
        tail = _INT_MAX if tail_from is None else int(tail_from[b])
        splits = []
        for r in range(nsp):
            cs = base + r * chunk
            ce = max(min(cs + chunk, wend), cs)
            width = -(-(ce - cs) // _TILE) * _TILE
            sc = torch.full((hkv, g_, width), ninf)
            sc[..., : ce - cs] = scores[b, :, :, cs:ce].float()
            gm = sc.unflatten(-1, (-1, gran)).amax(-1)  # [Hkv, G, granules]
            lp = torch.cummax(gm, dim=-1).values if gm.shape[-1] else gm
            smax = gm.amax(-1) if gm.shape[-1] else torch.full((hkv, g_), ninf)
            splits.append((cs, ce, sc, gm, lp, smax))
        smaxes = torch.stack([x[5] for x in splits])  # [nsp, Hkv, G]
        fin = smaxes.amax(0)
        if mode != CACHE:
            fin = torch.maximum(fin, s_new[b].float())
        l = torch.zeros(hkv, g_)
        acc = torch.zeros(hkv, g_, v.shape[-1])
        for r, (cs, ce, sc, gm, lp, smax) in enumerate(splits):
            pre = smaxes[:r].amax(0) if r else torch.full((hkv, g_), ninf)
            if mode == OPEN:
                pre = torch.maximum(pre, s_new[b].float())
            plast = min(ce, tail) - 1
            e_over = min(min((plast // vt + 1) * vt, tail) if plast >= cs else 0, wend)
            over = torch.full((hkv, g_), ninf)
            for p in range(ce, e_over, gran):  # granules of the next splits
                s2 = (p - base) // chunk
                over = torch.maximum(over, splits[s2][3][..., (p - base - s2 * chunk) // gran])
            mover = torch.maximum(torch.maximum(pre, smax), over)
            width = sc.shape[-1]
            if width == 0:
                continue
            pos = cs + torch.arange(width)
            e = torch.minimum((pos // vt + 1) * vt, torch.full_like(pos, tail))
            k = ((e - cs) // gran - 1).clamp(0, max(gm.shape[-1] - 1, 0))
            m = torch.where(e <= ce, torch.maximum(pre[..., None], lp[..., k]), mover[..., None])
            m = torch.where(pos >= tail, fin[..., None], m)
            live = sc != ninf
            if round_p:
                pe = torch.where(live, torch.exp(sc - torch.where(live, m, 0.0)), 0.0)
                w = torch.where(live, torch.exp(torch.where(live, m, 0.0) - fin[..., None]), 0.0)
                l = l + (pe * w).sum(-1)
                p = pe.bfloat16().float() * w
            else:
                p = torch.where(live, torch.exp(sc - fin[..., None]), 0.0)
                l = l + p.sum(-1)
            vs = torch.zeros(hkv, width, v.shape[-1])
            vs[:, : ce - cs] = v[b, :, cs:ce].float()
            acc = acc + torch.einsum("kgs,ksd->kgd", p, vs)
        w_new = (torch.exp(s_new[b].float() - fin) if mode != CACHE
                 else torch.zeros(hkv, g_))
        acc = acc + w_new[..., None] * v_new[b].float()[:, None, :]
        out[b] = acc / (l + w_new)[..., None]
    return out


def split_reference(q, k_new, v_new, k_all, v_all, layer_idx, block_tables, seq_lens, scale,
                    window: int = 0, pages: int = 4, mode: str = OPEN, cluster: int = _MAX_SPLITS,
                    rm: bool = False) -> torch.Tensor:
    """``split_model`` on a call's inputs (on the CPU), the caches as they
    are before the call (untouched): the split cache ``[L, NB, Hkv, bs,
    D]``, or with ``rm`` K9's interleaved cache ``k_all`` (``v_all``
    unused) whose tail pages are token-major -> out [B, Hq, D] in q's
    dtype."""
    layer = int(layer_idx)
    cache_dtype = k_all.dtype
    work = q.dtype if _build.is_quantized(cache_dtype) else cache_dtype
    b, hq, d = q.shape
    lens = seq_lens.long()
    bt = block_tables.long()
    if rm:
        _, _, _, hkv, bs, _ = k_all.shape
        nfull = (lens - 1).clamp(min=0) // bs
        pages_kv = k_all[layer][bt].float()  # [B, NB, 2, Hkv, bs, D]
        rows = torch.arange(b)
        tail = pages_kv[rows, nfull].reshape(b, bs, 2 * hkv, d)
        pages_kv[rows, nfull] = tail.permute(0, 2, 1, 3).reshape(b, 2, hkv, bs, d)
        k, v = pages_kv[:, :, 0], pages_kv[:, :, 1]
        tail_from = nfull * bs
    else:
        hkv, bs = k_all.shape[2], k_all.shape[3]
        k, v = k_all[layer][bt].float(), v_all[layer][bt].float()
        tail_from = None
    k = k.permute(0, 2, 1, 3, 4).reshape(b, hkv, -1, d)
    v = v.permute(0, 2, 1, 3, 4).reshape(b, hkv, -1, d)
    if mode == CACHE:  # position seq_len - 1: the new row as the writer stores it
        live = lens > 0
        idx = torch.arange(b)[live]
        at = lens[live] - 1
        k[idx, :, at] = cast_to(k_new[live], cache_dtype).float()
        v[idx, :, at] = cast_to(v_new[live], cache_dtype).float()
    qg = q.to(work).float().reshape(b, hkv, hq // hkv, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k) * scale
    pos = torch.arange(k.shape[2])
    mask = pos < (lens if mode == CACHE else lens - 1)[:, None]
    if window > 0:
        mask = mask & (pos >= (lens - window)[:, None])
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    s_new = (qg * k_new.to(work).float()[:, :, None, :]).sum(-1) * scale
    rounds = cache_dtype != torch.float32
    out = split_model(scores, v, s_new, v_new.to(work).float(), lens, window, mode, pages * bs,
                      granule(bs, rm, pages, rounds), rounds, cluster, tail_from)
    return out.reshape(b, hq, d).to(q.dtype)


def _workspace(device: torch.device, stream: int, kind: str, dtype, n: int) -> torch.Tensor:
    """A buffer of at least ``n`` elements for launches on ``stream`` of
    ``device``, kept for later calls (zeros when made: K9's counters must
    start at 0)."""
    key = (device, stream, kind)
    buf = _workspaces.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=dtype, device=device)
        _workspaces[key] = buf
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
    dtype = _build.dtype_code(k_base.dtype)
    # q, the new rows and the output in the cache dtype; on a quantized
    # cache in q's own (bf16 or f32; int8 codes are exact in either)
    work = q.dtype if _build.is_quantized(k_base.dtype) else k_base.dtype
    _build.check_head_dim(d, work, k_base.dtype, name)
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
    lib = _load()  # a failed build raises here, before any allocation
    # the launch is a function of the shapes (the block-table width, the
    # heads), not of seq_lens, so it needs no device-to-host read
    p = plan(block_tables.shape[1], bs, hq // hkv, d, k_base.dtype, rm, pages, b * hkv,
             _build.device_sms(q.device))
    qk = q.to(work).contiguous()
    kn = k_new.to(work).contiguous()
    vn = v_new.to(work).contiguous()
    out = torch.empty_like(qk)
    stream = _build.stream_of(q)
    scores = (None if p.smem_scores else
              _workspace(q.device, stream.value, "scores", torch.float32,
                         b * hkv * p.cluster * p.chunk * p.gmax))
    # K9: a completed page is staged here and copied by the sequence's last cluster
    counters = _workspace(q.device, stream.value, "counters", torch.int32, b) if rm else None
    scratch = (_workspace(q.device, stream.value, "scratch", torch.uint8,
                          b * page * k_base.element_size()) if rm else None)
    _build.count_launch(name)
    err = lib.xllm_decode_attention_write(
        q.device.index or 0, _build.ptr(qk), _build.ptr(kn), _build.ptr(vn),
        _build.ptr(k_base), ctypes.c_void_p(v_base.data_ptr() + v_off * v_base.element_size()),
        _build.ptr(slot_mapping), _build.ptr(block_tables), _build.ptr(seq_lens),
        _build.ptr(out), _build.ptr(scores), _build.ptr(counters), _build.ptr(scratch), dtype,
        qtype, d, b, int(layer_idx), nb, hkv, bs, block_tables.shape[1], hq // hkv,
        float(scale), int(window), p.cluster, p.chunk, p.gran.bit_length() - 1, page, int(rm),
        pages * bs, _MODE_CODE[mode], k_base.numel() // d, (v_base.numel() - v_off) // d,
        stream,
    )
    _build.check(lib, err, name)
    return out.to(q.dtype)
