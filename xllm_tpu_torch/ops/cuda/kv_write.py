"""K2, K4, their single-chunk twins K2b, K4b, and K8's / K9's writers:
paged KV-cache writers (``csrc/kv_write.cu``).

One row-scatter kernel serves four contracts through four wrappers, each
with its own launch counter and plain version:

- ``kv_write_prefill_batched`` (K2) replaces
  ``xllm_tpu/ops/pallas/kv_write.py`` ``kv_write_prefill_batched_tpu``:
  P head-major chunks ``[P, Hkv, S, D]`` from page-aligned ``q_offsets``;
- ``kv_write_rmw_batched`` (K4) replaces ``kv_write_rmw_batched_tpu``:
  P token-major chunks ``[P, S, Hkv, D]`` with ``S <= block_size`` that may
  start mid-page;
- ``kv_write_prefill`` (K2b) replaces ``kv_write_prefill_tpu``: one
  head-major chunk ``[Hkv, S_pad, D]`` from a page-aligned ``q_offset``;
- ``kv_write_rmw`` (K4b) replaces ``kv_write_rmw_tpu``: one token-major
  chunk ``[S, Hkv, D]``, ``S <= block_size``, at any alignment.

The latent (MLA) twins write into the single-head cache ``[L, NB, 1, bs,
Dk]`` through one more row scatter, again behind four wrappers and
counters:

- ``latent_write_prefill_batched`` (K11c) replaces
  ``latent_write_prefill_batched_tpu``: P chunks ``[P, S_pad, Dk]`` from
  page-aligned ``q_offsets``;
- ``latent_write_rmw_batched`` (K11d) replaces
  ``latent_write_rmw_batched_tpu``: P chunks ``[P, S, Dk]``, ``S <=
  block_size``, at any alignment;
- ``latent_write_prefill`` (K11f) and ``latent_write_rmw`` (K11g) replace
  ``latent_write_prefill_tpu`` and ``latent_write_rmw_tpu``: the same for
  one chunk ``[S, Dk]``.

The interleaved cache ``[L, NB, 2, Hkv, bs, D]`` (a page's K and V
together) takes four more, each with its own wrapper, counter and plain
version: ``kv_write_prefill_batched_ilv`` and ``kv_write_rmw_batched_ilv``
(K8) replace ``kv_write_prefill_batched_ilv_tpu`` and
``kv_write_rmw_batched_ilv_tpu``, K2's and K4's row scatter with another
page stride; ``kv_write_prefill_batched_rm`` and ``kv_write_rmw_batched_rm``
(K9, ``kv_layout="interleaved_rm"``) replace ``kv_write_prefill_batched_rm_tpu``
and ``kv_write_rmw_batched_rm_tpu``: a row of a page the sequence does not
complete (``(page + 1) * bs > kv_len``) goes token-major, to row ``pos %
bs`` of the page seen as ``[bs, 2 * Hkv, D]`` (K heads, then V heads), and
a page the chunk completes is written canonical, its earlier token-major
rows included (the RMW writer's own kernel: one launch, a thread-block
cluster a page, ``rmw_cluster_share`` its partition).

A single-chunk writer is its batched twin's kernel launched with one chunk
(the contracts are the batched ones at P = 1): ``q_offset`` and ``ntok``
are 0-d int32 tensors on the cache's device, read by the kernel as
one-element arrays, so nothing syncs.

Token ``j < ntoks[p]`` of chunk ``p`` lands at position ``q_offsets[p] + j``
of its sequence, through ``block_tables[p]``; ``ntoks[p] == 0`` marks a
padded row. Exactly the valid rows are written, in place. (The TPU's K2 and
K11c also overwrote the never-read rest of the tail page: their DMAs move
whole pages.) Rows in another dtype than the cache's are cast to it: bf16
or f32 rows bound for an fp8 cache by the kernel itself, with the JAX
package's bytes (``ops.quant.to_e4m3`` in the plain version), any other
pair by ``Tensor.to`` before the launch; int8 codes are copied as bytes.
The RMW writer casts to e4m3 through the paired hardware cast and a NaN
select (``e4m3_pair_model``). Bound on the card: bytes; see the CUDA
source.
"""

from __future__ import annotations

import ctypes

import torch

from xllm_tpu_torch.ops.cuda import _build
from xllm_tpu_torch.ops.quant import cast_to

PREFILL_NAME = "kv_write_prefill_batched"
RMW_NAME = "kv_write_rmw_batched"
PREFILL_TPU_KERNEL = (
    "xllm_tpu/ops/pallas/kv_write.py:355 kv_write_prefill_batched_tpu"
)
RMW_TPU_KERNEL = "xllm_tpu/ops/pallas/kv_write.py:490 kv_write_rmw_batched_tpu"
LATENT_PREFILL_NAME = "latent_write_prefill_batched"
LATENT_RMW_NAME = "latent_write_rmw_batched"
LATENT_PREFILL_TPU_KERNEL = (
    "xllm_tpu/ops/pallas/kv_write.py:759 latent_write_prefill_batched_tpu"
)
LATENT_RMW_TPU_KERNEL = (
    "xllm_tpu/ops/pallas/kv_write.py:846 latent_write_rmw_batched_tpu"
)
ONE_PREFILL_NAME = "kv_write_prefill"
ONE_RMW_NAME = "kv_write_rmw"
ONE_PREFILL_TPU_KERNEL = "xllm_tpu/ops/pallas/kv_write.py:223 kv_write_prefill_tpu"
ONE_RMW_TPU_KERNEL = "xllm_tpu/ops/pallas/kv_write.py:165 kv_write_rmw_tpu"
ONE_LATENT_PREFILL_NAME = "latent_write_prefill"
ONE_LATENT_RMW_NAME = "latent_write_rmw"
ONE_LATENT_PREFILL_TPU_KERNEL = (
    "xllm_tpu/ops/pallas/kv_write.py:595 latent_write_prefill_tpu"
)
ONE_LATENT_RMW_TPU_KERNEL = "xllm_tpu/ops/pallas/kv_write.py:675 latent_write_rmw_tpu"
ILV_PREFILL_NAME = "kv_write_prefill_batched_ilv"
ILV_PREFILL_TPU_KERNEL = "xllm_tpu/ops/pallas/kv_write.py:945 kv_write_prefill_batched_ilv_tpu"
ILV_RMW_NAME = "kv_write_rmw_batched_ilv"
ILV_RMW_TPU_KERNEL = "xllm_tpu/ops/pallas/kv_write.py:1059 kv_write_rmw_batched_ilv_tpu"
RM_PREFILL_NAME = "kv_write_prefill_batched_rm"
RM_PREFILL_TPU_KERNEL = "xllm_tpu/ops/pallas/kv_write.py:1209 kv_write_prefill_batched_rm_tpu"
RM_RMW_NAME = "kv_write_rmw_batched_rm"
RM_RMW_TPU_KERNEL = "xllm_tpu/ops/pallas/kv_write.py:1351 kv_write_rmw_batched_rm_tpu"
_SOURCE = "kv_write"

# K9's RMW writer (csrc/kv_write.cu kv_write_rmw_rm_kernel)
RMW_CLUSTER = 8  # blocks a page: the portable cluster size
RMW_SMEM_MAX = 232448  # an H100 block's dynamic shared memory


def rmw_cluster_smem(hkv: int, bs: int, head_dim: int, elem: int) -> int:
    """Bytes of shared memory a block of the RMW writer's cluster stages
    at most: its share of the page's 16-byte units."""
    units = 2 * hkv * bs * head_dim * elem // 16
    return -(-units // RMW_CLUSTER) * 16


def rmw_cluster_share(hkv: int, bs: int, head_dim: int, elem: int, w0: int,
                      rank: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block ``rank``'s part in rewriting a completed page canonical whose
    first ``w0`` rows were written token-major before the chunk, in 16-byte
    units of an ``elem``-byte cache: -> (the canonical units it writes, in
    order; the staging slots it fills; the token-major unit each slot
    holds). Canonical unit i is head c = i // (bs U), row w = i // U % bs,
    piece u = i % U (U units a head row); its token-major place is w (2 Hkv
    U) + c U + u. The block that writes i stages it in slot i - lo when w
    < w0."""
    per_head = head_dim * elem // 16
    total = 2 * hkv * bs * per_head
    per = -(-total // RMW_CLUSTER)
    i = torch.arange(rank * per, min(total, (rank + 1) * per))
    c, w, u = i // (bs * per_head), i // per_head % bs, i % per_head
    early = w < w0
    token_major = w * (2 * hkv * per_head) + c * per_head + u
    return i, (i - rank * per)[early], token_major[early]


def e4m3_pair_model(x: torch.Tensor) -> torch.Tensor:
    """The RMW writer's e4m3 cast in PyTorch: the hardware's satfinite
    cast (clamp to +-448, round to nearest even: PyTorch's cast of the
    clamped value), then the NaN byte 0x7f with the sign of x where the
    magnitude exceeds 464 or x is NaN. -> float8_e4m3fn, the bytes of
    ``ops.quant.to_e4m3``."""
    xf = x.float()
    codes = xf.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).view(torch.uint8)
    nan = torch.where(torch.signbit(xf), 0xFF, 0x7F).to(torch.uint8)
    return torch.where(xf.abs() <= 464.0, codes, nan).view(torch.float8_e4m3fn)


def kv_write_rows_plain(
    k_rows: torch.Tensor,  # [P, S, Hkv, D] token-major (any strides)
    v_rows: torch.Tensor,
    k_all: torch.Tensor,  # [L, NB, Hkv, bs, D], updated in place
    v_all: torch.Tensor,
    layer_idx: int,
    block_tables: torch.Tensor,  # [P, NBmax] int32
    q_offsets: torch.Tensor,  # [P] int32
    ntoks: torch.Tensor,  # [P] int32 (0 = padded row)
) -> None:
    """Plain PyTorch version of the row scatter: writes the ``ntoks``
    valid rows of each chunk and nothing else."""
    p, s = k_rows.shape[:2]
    bs = k_all.shape[3]
    j = torch.arange(s, device=k_rows.device)
    valid = j[None, :] < ntoks.long()[:, None]  # [P, S]
    pos = q_offsets.long()[:, None] + j[None, :]
    page = torch.where(valid, pos // bs, 0)
    blk = torch.gather(block_tables.long(), 1, page)[valid]
    off = (pos % bs)[valid]
    layer = int(layer_idx)
    for rows, cache in ((k_rows, k_all), (v_rows, v_all)):
        rows = cast_to(rows[valid], cache.dtype)
        if _build.is_quantized(cache.dtype):  # write the bytes
            cache, rows = cache.view(torch.uint8), rows.view(torch.uint8)
        cache[layer, blk, :, off, :] = rows


_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.xllm_kv_write_rows.argtypes = [
            i, p, p, ll, ll, ll, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i,
            ll, i, p,
        ]
        lib.xllm_kv_write_rows.restype = i
        lib.xllm_kv_write_rmw_rm.argtypes = [
            i, p, p, ll, ll, ll, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p,
        ]
        lib.xllm_kv_write_rmw_rm.restype = i
        lib.xllm_latent_write_rows.argtypes = [
            i, p, ll, ll, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p,
        ]
        lib.xllm_latent_write_rows.restype = i
        _lib = lib
    return _lib


def _launch(name, k_rows, v_rows, k_all, v_all, layer_idx, block_tables,
            q_offsets, ntoks, require_aligned: bool, kv_lens=None,
            rmw_rm: bool = False) -> None:
    """k_rows / v_rows: token-major views [P, S, Hkv, D] with unit stride
    in D (a head-major input arrives as a transposed view). ``v_all``
    None: ``k_all`` is the interleaved cache [L, NB, 2, Hkv, bs, D]; with
    ``kv_lens`` its row-major tails are kept (K9), by the row scatter or,
    with ``rmw_rm``, by the RMW kernel that rewrites completed pages."""
    p, s, hkv, d = k_rows.shape
    if v_all is None:
        if k_all.dim() != 6 or k_all.shape[2] != 2:
            raise ValueError(f"{name}: the cache must be [L, NB, 2, Hkv, bs, D], not "
                             f"{tuple(k_all.shape)}")
        nl, nb, _, hkv_c, bs, d_c = k_all.shape
        page, v_base, v_off = 2 * hkv_c * bs * d_c, k_all, hkv_c * bs * d_c
    else:
        nl, nb, hkv_c, bs, d_c = k_all.shape
        page, v_base, v_off = hkv_c * bs * d_c, v_all, 0
        if k_all.dtype != v_all.dtype or not v_all.is_contiguous():
            raise ValueError(f"{name}: K and V caches must share a dtype and be contiguous")
    dtype = _build.dtype_code(k_all.dtype)
    if (hkv, d) != (hkv_c, d_c) or v_rows.shape != k_rows.shape:
        raise ValueError(f"{name}: rows {tuple(k_rows.shape)} vs cache {tuple(k_all.shape)}")
    if not k_all.is_contiguous():
        raise ValueError(f"{name}: caches must be contiguous")
    index = (block_tables, q_offsets, ntoks) + ((kv_lens,) if kv_lens is not None else ())
    for t in index:
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != k_all.device:
            raise ValueError(f"{name}: index arrays must be contiguous int32 on {k_all.device}")
    if k_rows.dtype != v_rows.dtype:
        raise ValueError(f"{name}: K and V rows must share a dtype")
    if not (k_all.dtype == torch.float8_e4m3fn
            and k_rows.dtype in (torch.bfloat16, torch.float32)):
        k_rows, v_rows = k_rows.to(k_all.dtype), v_rows.to(k_all.dtype)
    if k_rows.stride(3) != 1 or k_rows.stride() != v_rows.stride():
        k_rows = k_rows.contiguous()
        v_rows = v_rows.contiguous()
    if p == 0 or s == 0:
        return
    lib = _load()
    sp, ss, sh, _ = k_rows.stride()
    dev = k_all.device.index or 0
    v_ptr = ctypes.c_void_p(v_base.data_ptr() + v_off * v_base.element_size())
    src = _build.dtype_code(k_rows.dtype)
    lens = _build.ptr(kv_lens) if kv_lens is not None else ctypes.c_void_p(0)
    if rmw_rm:
        if rmw_cluster_smem(hkv, bs, d, k_all.element_size()) > RMW_SMEM_MAX:
            raise ValueError(f"{name}: a page of {tuple(k_all.shape[3:])} x "
                             f"{k_all.element_size()} bytes outgrows the cluster's staging")
        vec = 16 // k_all.element_size()  # source elements a 16-byte cache unit
        if any(x % vec for x in (sp, ss, sh)) or k_rows.data_ptr() % 16 \
                or v_rows.data_ptr() % 16:
            k_rows, v_rows = k_rows.contiguous(), v_rows.contiguous()
            sp, ss, sh, _ = k_rows.stride()
        _build.count_launch(name)
        err = lib.xllm_kv_write_rmw_rm(
            dev, _build.ptr(k_rows), _build.ptr(v_rows), sp, ss, sh, _build.ptr(k_all),
            _build.ptr(block_tables), _build.ptr(q_offsets), _build.ptr(ntoks), lens,
            src, dtype, p, s, int(layer_idx), nb, hkv, bs, d,
            block_tables.shape[1], _build.stream_of(k_all),
        )
    else:
        _build.count_launch(name)
        err = lib.xllm_kv_write_rows(
            dev, _build.ptr(k_rows), _build.ptr(v_rows), sp, ss, sh, _build.ptr(k_all),
            v_ptr, _build.ptr(block_tables), _build.ptr(q_offsets), _build.ptr(ntoks),
            lens, src, dtype, p, s, int(layer_idx), nb, hkv, bs, d, block_tables.shape[1],
            int(require_aligned), page, int(kv_lens is not None), _build.stream_of(k_all),
        )
    _build.check(lib, err, name)


def kv_write_prefill_batched(
    kt: torch.Tensor,  # [P, Hkv, S, D] head-major new K per chunk
    vt: torch.Tensor,
    k_all: torch.Tensor,
    v_all: torch.Tensor,
    layer_idx: int,
    block_tables: torch.Tensor,  # [P, NBmax] int32
    q_offsets: torch.Tensor,  # [P] int32, page-aligned
    ntoks: torch.Tensor,  # [P] int32 (0 = padded row)
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: full-page writer contract (chunk starts on a page boundary; the
    kernel asserts it per row). -> (k_all, v_all), updated in place."""
    k_rows, v_rows = kt.transpose(1, 2), vt.transpose(1, 2)  # views
    if k_all.device.type == "cpu":
        _assert_aligned(q_offsets, ntoks, k_all.shape[3])
        kv_write_rows_plain(k_rows, v_rows, k_all, v_all, layer_idx,
                            block_tables, q_offsets, ntoks)
    else:
        _launch(PREFILL_NAME, k_rows, v_rows, k_all, v_all, layer_idx,
                block_tables, q_offsets, ntoks, require_aligned=True)
    return k_all, v_all


def kv_write_rmw_batched(
    kt: torch.Tensor,  # [P, S, Hkv, D] token-major, S <= block_size
    vt: torch.Tensor,
    k_all: torch.Tensor,
    v_all: torch.Tensor,
    layer_idx: int,
    block_tables: torch.Tensor,  # [P, NBmax] int32
    q_offsets: torch.Tensor,  # [P] int32, any alignment
    ntoks: torch.Tensor,  # [P] int32 (0 = padded row)
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: chunks of at most one page that may start mid-page.
    -> (k_all, v_all), updated in place."""
    if kt.shape[1] > k_all.shape[3]:
        raise ValueError("RMW writer covers chunks of at most one page")
    if k_all.device.type == "cpu":
        kv_write_rows_plain(kt, vt, k_all, v_all, layer_idx, block_tables,
                            q_offsets, ntoks)
    else:
        _launch(RMW_NAME, kt, vt, k_all, v_all, layer_idx, block_tables,
                q_offsets, ntoks, require_aligned=False)
    return k_all, v_all


# ---------------------------------------------------------------------------
# K2b + K4b: one chunk (the batched contracts at P = 1)
# ---------------------------------------------------------------------------
def _one_chunk(block_table, q_offset, ntok):
    """A single chunk's block-table row [NBmax] and 0-d ``q_offset`` /
    ``ntok`` -> the batched writers' [1, NBmax], [1], [1] (views)."""
    return block_table[None], q_offset.reshape(1), ntok.reshape(1)


def _assert_aligned(q_offsets, ntoks, bs: int) -> None:
    assert bool(((q_offsets % bs == 0) | (ntoks == 0)).all()), (
        "full-page writer needs page-aligned chunk starts"
    )


def kv_write_prefill_plain(kt, vt, k_all, v_all, layer_idx, block_table,
                           q_offset, ntok) -> None:
    """Plain PyTorch version of K2b: one head-major chunk's valid rows."""
    _assert_aligned(q_offset, ntok, k_all.shape[3])
    kv_write_rows_plain(kt.transpose(0, 1)[None], vt.transpose(0, 1)[None], k_all,
                        v_all, layer_idx, *_one_chunk(block_table, q_offset, ntok))


def kv_write_rmw_plain(kt, vt, k_all, v_all, layer_idx, block_table, q_offset,
                       ntok) -> None:
    """Plain PyTorch version of K4b: one token-major chunk's valid rows."""
    kv_write_rows_plain(kt[None], vt[None], k_all, v_all, layer_idx,
                        *_one_chunk(block_table, q_offset, ntok))


def kv_write_prefill(
    kt: torch.Tensor,  # [Hkv, S_pad, D] head-major new K of the chunk
    vt: torch.Tensor,
    k_all: torch.Tensor,  # [L, NB, Hkv, bs, D], updated in place
    v_all: torch.Tensor,
    layer_idx: int,
    block_table: torch.Tensor,  # [NBmax] int32
    q_offset: torch.Tensor,  # [] int32, page-aligned
    ntok: torch.Tensor,  # [] int32 valid rows of the chunk
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2b: one chunk from a page boundary (the kernel asserts it).
    -> (k_all, v_all), updated in place."""
    if k_all.device.type == "cpu":
        kv_write_prefill_plain(kt, vt, k_all, v_all, layer_idx, block_table,
                               q_offset, ntok)
    else:  # the head-major chunk reaches the kernel as a strided view
        _launch(ONE_PREFILL_NAME, kt.transpose(0, 1)[None], vt.transpose(0, 1)[None],
                k_all, v_all, layer_idx, *_one_chunk(block_table, q_offset, ntok),
                require_aligned=True)
    return k_all, v_all


def kv_write_rmw(
    kt: torch.Tensor,  # [S, Hkv, D] token-major, S <= block_size
    vt: torch.Tensor,
    k_all: torch.Tensor,
    v_all: torch.Tensor,
    layer_idx: int,
    block_table: torch.Tensor,  # [NBmax] int32
    q_offset: torch.Tensor,  # [] int32, any alignment
    ntok: torch.Tensor,  # [] int32
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4b: one chunk of at most one page that may start mid-page.
    -> (k_all, v_all), updated in place."""
    if kt.shape[0] > k_all.shape[3]:
        raise ValueError("RMW writer covers chunks of at most one page")
    if k_all.device.type == "cpu":
        kv_write_rmw_plain(kt, vt, k_all, v_all, layer_idx, block_table, q_offset, ntok)
    else:
        _launch(ONE_RMW_NAME, kt[None], vt[None], k_all, v_all, layer_idx,
                *_one_chunk(block_table, q_offset, ntok), require_aligned=False)
    return k_all, v_all


# ---------------------------------------------------------------------------
# K8 + K9: the interleaved cache [L, NB, 2, Hkv, bs, D]
# ---------------------------------------------------------------------------
def kv_write_rm_plain(
    k_rows: torch.Tensor,  # [P, S, Hkv, D] token-major (any strides)
    v_rows: torch.Tensor,
    kv_all: torch.Tensor,  # [L, NB, 2, Hkv, bs, D], updated in place
    layer_idx: int,
    block_tables: torch.Tensor,  # [P, NBmax] int32
    q_offsets: torch.Tensor,  # [P] int32
    ntoks: torch.Tensor,  # [P] int32 (0 = padded row)
    kv_lens: torch.Tensor,  # [P] int32 the sequence's length after the chunk
) -> None:
    """Plain PyTorch version of the row-major-tail writers: each valid row
    goes token-major to row ``pos % bs`` of its page seen as ``[bs, 2 * Hkv,
    D]`` (K heads, then V heads); then every page the chunk wrote that the
    sequence completes (``(page + 1) * bs <= kv_len``) is rewritten
    canonical, the rows written before the chunk included."""
    p, s, hkv, d = k_rows.shape
    bs = kv_all.shape[4]
    j = torch.arange(s, device=k_rows.device)
    valid = j[None, :] < ntoks.long()[:, None]  # [P, S]
    pos = q_offsets.long()[:, None] + j[None, :]
    page = torch.where(valid, pos // bs, 0)
    blk = torch.gather(block_tables.long(), 1, page)
    done = (valid & ((page + 1) * bs <= kv_lens.long()[:, None]))
    rows = torch.cat([cast_to(k_rows[valid], kv_all.dtype),
                      cast_to(v_rows[valid], kv_all.dtype)], dim=1)  # [N, 2 * Hkv, D]
    cache = kv_all
    if _build.is_quantized(kv_all.dtype):  # write the bytes
        cache, rows = kv_all.view(torch.uint8), rows.view(torch.uint8)
    layer = int(layer_idx)
    tok = cache.view(*cache.shape[:2], bs, 2 * hkv, d)  # every page token-major
    tok[layer, blk[valid], (pos % bs)[valid]] = rows
    full = torch.unique(blk[done])
    cache[layer, full] = tok[layer, full].transpose(1, 2).reshape(-1, 2, hkv, bs, d)


def kv_write_prefill_batched_ilv(
    kt: torch.Tensor,  # [P, Hkv, S, D] head-major new K per chunk
    vt: torch.Tensor,
    kv_all: torch.Tensor,  # [L, NB, 2, Hkv, bs, D], updated in place
    layer_idx: int,
    block_tables: torch.Tensor,  # [P, NBmax] int32
    q_offsets: torch.Tensor,  # [P] int32, page-aligned
    ntoks: torch.Tensor,  # [P] int32 (0 = padded row)
) -> torch.Tensor:
    """K8, replaces ``kv_write_prefill_batched_ilv_tpu`` (whose ``kvt [P,
    2, Hkv, S, D]`` is ``(kt, vt)`` stacked): K2 on the interleaved cache.
    -> kv_all, updated in place."""
    k_rows, v_rows = kt.transpose(1, 2), vt.transpose(1, 2)  # views
    if kv_all.device.type == "cpu":
        _assert_aligned(q_offsets, ntoks, kv_all.shape[4])
        kv_write_rows_plain(k_rows, v_rows, kv_all[:, :, 0], kv_all[:, :, 1], layer_idx,
                            block_tables, q_offsets, ntoks)
    else:
        _launch(ILV_PREFILL_NAME, k_rows, v_rows, kv_all, None, layer_idx, block_tables,
                q_offsets, ntoks, require_aligned=True)
    return kv_all


def kv_write_rmw_batched_ilv(
    kt: torch.Tensor,  # [P, S, Hkv, D] token-major, S <= block_size
    vt: torch.Tensor,
    kv_all: torch.Tensor,
    layer_idx: int,
    block_tables: torch.Tensor,  # [P, NBmax] int32
    q_offsets: torch.Tensor,  # [P] int32, any alignment
    ntoks: torch.Tensor,  # [P] int32 (0 = padded row)
) -> torch.Tensor:
    """K8, replaces ``kv_write_rmw_batched_ilv_tpu``: K4 on the interleaved
    cache. -> kv_all, updated in place."""
    if kt.shape[1] > kv_all.shape[4]:
        raise ValueError("RMW writer covers chunks of at most one page")
    if kv_all.device.type == "cpu":
        kv_write_rows_plain(kt, vt, kv_all[:, :, 0], kv_all[:, :, 1], layer_idx,
                            block_tables, q_offsets, ntoks)
    else:
        _launch(ILV_RMW_NAME, kt, vt, kv_all, None, layer_idx, block_tables, q_offsets,
                ntoks, require_aligned=False)
    return kv_all


def kv_write_prefill_batched_rm(
    kt: torch.Tensor,  # [P, Hkv, S, D] head-major new K per chunk
    vt: torch.Tensor,
    kv_all: torch.Tensor,
    layer_idx: int,
    block_tables: torch.Tensor,  # [P, NBmax] int32
    q_offsets: torch.Tensor,  # [P] int32, page-aligned
    ntoks: torch.Tensor,  # [P] int32 (0 = padded row)
    kv_lens: torch.Tensor,  # [P] int32
) -> torch.Tensor:
    """K9, replaces ``kv_write_prefill_batched_rm_tpu`` (whose head-major
    ``kvt`` and token-major ``kvt_tok [P, S, 2 * Hkv, D]`` are both ``(kt,
    vt)`` read another way): pages the sequence completes are written
    canonical, its final incomplete page token-major. -> kv_all, in place."""
    k_rows, v_rows = kt.transpose(1, 2), vt.transpose(1, 2)  # views
    if kv_all.device.type == "cpu":
        _assert_aligned(q_offsets, ntoks, kv_all.shape[4])
        kv_write_rm_plain(k_rows, v_rows, kv_all, layer_idx, block_tables, q_offsets,
                          ntoks, kv_lens)
    else:
        _launch(RM_PREFILL_NAME, k_rows, v_rows, kv_all, None, layer_idx, block_tables,
                q_offsets, ntoks, require_aligned=True, kv_lens=kv_lens)
    return kv_all


def kv_write_rmw_batched_rm(
    kt: torch.Tensor,  # [P, S, Hkv, D] token-major, S <= block_size
    vt: torch.Tensor,
    kv_all: torch.Tensor,
    layer_idx: int,
    block_tables: torch.Tensor,  # [P, NBmax] int32
    q_offsets: torch.Tensor,  # [P] int32, any alignment
    ntoks: torch.Tensor,  # [P] int32 (0 = padded row)
    kv_lens: torch.Tensor,  # [P] int32
) -> torch.Tensor:
    """K9, replaces ``kv_write_rmw_batched_rm_tpu``: rows merge into their
    page's token-major content; a page the sequence completes is rewritten
    canonical. -> kv_all, updated in place."""
    if kt.shape[1] > kv_all.shape[4]:
        raise ValueError("RMW writer covers chunks of at most one page")
    if kv_all.device.type == "cpu":
        kv_write_rm_plain(kt, vt, kv_all, layer_idx, block_tables, q_offsets, ntoks,
                          kv_lens)
    else:
        _launch(RM_RMW_NAME, kt, vt, kv_all, None, layer_idx, block_tables, q_offsets,
                ntoks, require_aligned=False, kv_lens=kv_lens, rmw_rm=True)
    return kv_all


# ---------------------------------------------------------------------------
# K11c + K11d: the latent (MLA) writers
# ---------------------------------------------------------------------------
def latent_write_rows_plain(
    rows: torch.Tensor,  # [P, S, Dk] token-major
    cache: torch.Tensor,  # [L, NB, 1, bs, Dk], updated in place
    layer_idx: int,
    block_tables: torch.Tensor,  # [P, NBmax] int32
    q_offsets: torch.Tensor,  # [P] int32
    ntoks: torch.Tensor,  # [P] int32 (0 = padded row)
) -> None:
    """Plain PyTorch version of the latent row scatter: writes the
    ``ntoks`` valid rows of each chunk and nothing else."""
    p, s = rows.shape[:2]
    bs = cache.shape[3]
    j = torch.arange(s, device=rows.device)
    valid = j[None, :] < ntoks.long()[:, None]  # [P, S]
    pos = q_offsets.long()[:, None] + j[None, :]
    page = torch.where(valid, pos // bs, 0)
    blk = torch.gather(block_tables.long(), 1, page)[valid]
    off = (pos % bs)[valid]
    rows = cast_to(rows[valid], cache.dtype)
    if _build.is_quantized(cache.dtype):  # write the bytes
        cache, rows = cache.view(torch.uint8), rows.view(torch.uint8)
    cache[int(layer_idx), blk, 0, off, :] = rows


def _launch_latent(name, rows, cache, layer_idx, block_tables, q_offsets,
                   ntoks, require_aligned: bool) -> None:
    p, s, dk = rows.shape
    nl, nb, one, bs, dk_c = cache.shape
    dtype = _build.dtype_code(cache.dtype)
    if (one, dk_c) != (1, dk):
        raise ValueError(f"{name}: rows {tuple(rows.shape)} vs cache {tuple(cache.shape)}")
    if not cache.is_contiguous():
        raise ValueError(f"{name}: the cache must be contiguous")
    for t in (block_tables, q_offsets, ntoks):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != cache.device:
            raise ValueError(f"{name}: index arrays must be contiguous int32 on {cache.device}")
        if t.shape[0] != p:
            raise ValueError(f"{name}: index arrays must have one row per chunk ({p})")
    if p == 0 or s == 0:
        return
    lib = _load()  # a failed build raises here, before any copy
    # bf16 / f32 rows bound for an fp8 cache are cast in the kernel
    if not (cache.dtype == torch.float8_e4m3fn
            and rows.dtype in (torch.bfloat16, torch.float32)):
        rows = rows.to(cache.dtype)
    if rows.stride(2) != 1:
        rows = rows.contiguous()
    _build.count_launch(name)
    err = lib.xllm_latent_write_rows(
        cache.device.index or 0, _build.ptr(rows), rows.stride(0), rows.stride(1),
        _build.ptr(cache), _build.ptr(block_tables), _build.ptr(q_offsets),
        _build.ptr(ntoks), _build.dtype_code(rows.dtype), dtype, p, s, int(layer_idx),
        nb, bs, dk,
        block_tables.shape[1], int(require_aligned), _build.stream_of(cache),
    )
    _build.check(lib, err, name)


def latent_write_prefill_batched(
    rows: torch.Tensor,  # [P, S_pad, Dk]
    cache: torch.Tensor,
    layer_idx: int,
    block_tables: torch.Tensor,  # [P, NBmax] int32
    q_offsets: torch.Tensor,  # [P] int32, page-aligned
    ntoks: torch.Tensor,  # [P] int32 (0 = padded row)
) -> torch.Tensor:
    """K11c: full-page writer contract (chunks start on a page boundary;
    the kernel asserts it per row). -> cache, updated in place."""
    if cache.device.type == "cpu":
        _assert_aligned(q_offsets, ntoks, cache.shape[3])
        latent_write_rows_plain(rows, cache, layer_idx, block_tables, q_offsets, ntoks)
    else:
        _launch_latent(LATENT_PREFILL_NAME, rows, cache, layer_idx, block_tables,
                       q_offsets, ntoks, require_aligned=True)
    return cache


def latent_write_rmw_batched(
    rows: torch.Tensor,  # [P, S, Dk], S <= block_size
    cache: torch.Tensor,
    layer_idx: int,
    block_tables: torch.Tensor,  # [P, NBmax] int32
    q_offsets: torch.Tensor,  # [P] int32, any alignment
    ntoks: torch.Tensor,  # [P] int32 (0 = padded row)
) -> torch.Tensor:
    """K11d: chunks of at most one page that may start mid-page.
    -> cache, updated in place."""
    if rows.shape[1] > cache.shape[3]:
        raise ValueError("RMW writer covers chunks of at most one page")
    if cache.device.type == "cpu":
        latent_write_rows_plain(rows, cache, layer_idx, block_tables, q_offsets, ntoks)
    else:
        _launch_latent(LATENT_RMW_NAME, rows, cache, layer_idx, block_tables,
                       q_offsets, ntoks, require_aligned=False)
    return cache


# ---------------------------------------------------------------------------
# K11f + K11g: one latent chunk (the batched contracts at P = 1)
# ---------------------------------------------------------------------------
def latent_write_prefill_plain(rows, cache, layer_idx, block_table, q_offset,
                               ntok) -> None:
    """Plain PyTorch version of K11f: one chunk's valid latent rows."""
    _assert_aligned(q_offset, ntok, cache.shape[3])
    latent_write_rows_plain(rows[None], cache, layer_idx,
                            *_one_chunk(block_table, q_offset, ntok))


def latent_write_rmw_plain(rows, cache, layer_idx, block_table, q_offset,
                           ntok) -> None:
    """Plain PyTorch version of K11g."""
    latent_write_rows_plain(rows[None], cache, layer_idx,
                            *_one_chunk(block_table, q_offset, ntok))


def latent_write_prefill(
    rows: torch.Tensor,  # [S_pad, Dk]
    cache: torch.Tensor,  # [L, NB, 1, bs, Dk], updated in place
    layer_idx: int,
    block_table: torch.Tensor,  # [NBmax] int32
    q_offset: torch.Tensor,  # [] int32, page-aligned
    ntok: torch.Tensor,  # [] int32
) -> torch.Tensor:
    """K11f: one latent chunk from a page boundary. -> cache, in place."""
    if cache.device.type == "cpu":
        latent_write_prefill_plain(rows, cache, layer_idx, block_table, q_offset, ntok)
    else:
        _launch_latent(ONE_LATENT_PREFILL_NAME, rows[None], cache, layer_idx,
                       *_one_chunk(block_table, q_offset, ntok), require_aligned=True)
    return cache


def latent_write_rmw(
    rows: torch.Tensor,  # [S, Dk], S <= block_size
    cache: torch.Tensor,
    layer_idx: int,
    block_table: torch.Tensor,  # [NBmax] int32
    q_offset: torch.Tensor,  # [] int32, any alignment
    ntok: torch.Tensor,  # [] int32
) -> torch.Tensor:
    """K11g: one latent chunk of at most one page that may start mid-page.
    -> cache, in place."""
    if rows.shape[0] > cache.shape[3]:
        raise ValueError("RMW writer covers chunks of at most one page")
    if cache.device.type == "cpu":
        latent_write_rmw_plain(rows, cache, layer_idx, block_table, q_offset, ntok)
    else:
        _launch_latent(ONE_LATENT_RMW_NAME, rows[None], cache, layer_idx,
                       *_one_chunk(block_table, q_offset, ntok), require_aligned=False)
    return cache
