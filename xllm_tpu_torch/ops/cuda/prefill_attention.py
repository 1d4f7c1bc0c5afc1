"""K3, K3b and K8's prefill: causal flash attention over paged KV (``csrc/prefill_attention.cu``).

- ``paged_attention_prefill_batched`` (K3) replaces
  ``xllm_tpu/ops/pallas/prefill_attention.py``
  ``paged_attention_prefill_batched_tpu``. Contract: P prompt chunks, one
  per sequence, ``q [P, S, Hq, D]`` at absolute positions ``q_offsets[p] +
  i``, each attending causally to its own paged K/V up to ``kv_lens[p]``
  through ``block_tables[p]``, GQA, optional sliding ``window``.
  ``kv_lens[p] == 0`` marks a padded row.
- ``paged_attention_prefill`` (K3b) replaces ``paged_attention_prefill_tpu``:
  the same for one chunk, ``q [S, Hq, D]`` with 0-d ``q_offset`` and
  ``kv_len`` on the device. It launches K3's kernel with one chunk, under
  its own launch counter.

Query rows past a chunk's ``kv_len - q_offset`` tokens (bucket padding)
and padded rows come out as zeros, in the kernels and in their plain
versions alike. The TPU kernels differ there: their mask
``(kv_idx <= row_pos) & (kv_idx < kv_len)`` lets a padding row (``row_pos
>= kv_len``) attend to all of ``[0, kv_len)``. No served result reads
those rows (logits and scores come from real rows, writers store only real
rows), so the port skips their work.

P is rounded to bf16 before P.V on every cache but f32 (bf16, and int8
codes or float8_e4m3fn upcast to bf16; q and the output stay bf16 or f32),
as in the TPU kernel, in the kernel and its plain version alike: the
unnormalised P of each page against the running maximum after that page.

- ``paged_attention_prefill_batched_ilv`` (K8) replaces
  ``paged_attention_prefill_batched_ilv_tpu``: K3 on the interleaved cache
  ``[L, NB, 2, Hkv, bs, D]``, launched as K3's kernel with another page
  stride and V offset. With ``rowmajor_tail`` (``kv_layout=
  "interleaved_rm"``, K9's layout) a sequence's final incomplete page is
  read from its token-major content (``[bs, 2 * Hkv, D]``: K heads, then
  V heads); it is the walk's last page, so the rounding is K3's. The
  single-chunk passes of the interleaved layouts run this kernel with P =
  1, as the JAX package runs its batched kernels.

Two kernels, chosen by q's dtype: bf16 q at head_dim 128 (and at 256 on a
bf16 or e4m3 cache, with row tiles of 64) runs on the tensor cores and,
where its (chunk, kv head, row tile) blocks are too few
for the card, splits each chunk's key range (``split_plan``, from shapes
alone) and merges the splits; f32 q and head_dim 64 run on the CUDA cores.
Bound on the card: operations for long chunks (S = 2048), bytes for
short ragged ones; see the CUDA source.
"""

from __future__ import annotations

import ctypes

import torch

from xllm_tpu_torch.ops.cuda import _build

NAME = "prefill_attention_batched"
TPU_KERNEL = (
    "xllm_tpu/ops/pallas/prefill_attention.py:309 "
    "paged_attention_prefill_batched_tpu"
)
ONE_NAME = "prefill_attention"
ONE_TPU_KERNEL = (
    "xllm_tpu/ops/pallas/prefill_attention.py:390 paged_attention_prefill_tpu"
)
ILV_NAME = "prefill_attention_batched_ilv"
ILV_TPU_KERNEL = (
    "xllm_tpu/ops/pallas/prefill_attention.py:628 "
    "paged_attention_prefill_batched_ilv_tpu"
)
_SOURCE = "prefill_attention"
_MAX_GROUP = 64  # query rows per block of the CUDA-core kernel
_TILE = 64  # KV positions per shared-memory tile in the kernel
_TC_ROWS = {128: 128, 256: 64}  # query rows a block of the tensor-core kernel, by head_dim
_MAX_SPLITS = 32  # kMaxSplits of csrc/prefill_attention.cu
_BUSY_BLOCKS = 256  # about two blocks for each of an H100's 132 SMs
_MIN_SPLIT_UNITS = 4  # key tiles (or pages, if longer) a split walks at least
# per-device int32 split counters; the kernel leaves them at 0
_counters: dict[torch.device, torch.Tensor] = {}


def paged_attention_prefill_batched_plain(
    q: torch.Tensor,  # [P, S, Hq, D]
    k_all: torch.Tensor,  # [L, NB, Hkv, bs, D]
    v_all: torch.Tensor,
    layer_idx: int,
    block_tables: torch.Tensor,  # [P, NBmax] int32
    q_offsets: torch.Tensor,  # [P] int32
    kv_lens: torch.Tensor,  # [P] int32 (0 = padded row)
    scale: float,
    window: int = 0,
    chunk: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same zeros for rows without a
    real token); ``chunk`` models a context split (``_prefill_plain``)."""
    p, d, hkv = q.shape[0], q.shape[3], k_all.shape[2]
    layer = int(layer_idx)
    bt = block_tables.long()
    k = k_all[layer][bt].float()  # [P, NB, Hkv, bs, D]
    v = v_all[layer][bt].float()
    k = k.permute(0, 2, 1, 3, 4).reshape(p, hkv, -1, d)
    v = v.permute(0, 2, 1, 3, 4).reshape(p, hkv, -1, d)
    return _prefill_plain(q, k, v, k_all.dtype, k_all.shape[3], q_offsets, kv_lens,
                          scale, window, chunk)


def _prefill_plain(q, k, v, cache_dtype, bs: int, q_offsets, kv_lens, scale,
                   window, chunk: int | None = None) -> torch.Tensor:
    """The kernel's arithmetic over the gathered pages of each chunk, k / v
    [P, Hkv, NBmax * bs, D] in f32 (cached values) -> [P, S, Hq, D].

    ``chunk`` models the kernel's context split: splits of ``chunk``
    positions (a multiple of ``bs``), each walked on its own and published
    as (m, l, acc), then merged with weights exp(m_i - max m). On every
    cache but f32 a split starts its running maximum at the maximum of the
    earlier splits' scores (the kernel's first pass), so each page rounds P
    against the single walk's running maximum; on f32 each split starts
    afresh. None is the single walk."""
    p, s, hq, d = q.shape
    hkv, width = k.shape[1], k.shape[2]
    # q in the kernel's working dtype (the cache's, or q's own on a
    # quantized cache)
    work = q.dtype if _build.is_quantized(cache_dtype) else cache_dtype
    qg = q.to(work).float().reshape(p, s, hkv, hq // hkv, d)
    scores = torch.einsum("pqkgd,pksd->pkgqs", qg, k) * scale
    q_pos = q_offsets.long()[:, None] + torch.arange(s, device=q.device)  # [P, S]
    kv_idx = torch.arange(width, device=q.device)
    mask = (kv_idx[None, None, :] <= q_pos[:, :, None]) & (
        kv_idx[None, None, :] < kv_lens.long()[:, None, None]
    )  # [P, S, S_kv]
    if window > 0:
        mask = mask & (kv_idx[None, None, :] > q_pos[:, :, None] - window)
    live = q_pos < kv_lens.long()[:, None]  # rows holding a real token
    mask = mask & live[:, :, None]
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    nsplit = 1
    if chunk is not None:
        if chunk <= 0 or chunk % bs:
            raise ValueError(f"a context split of {chunk} positions at block_size {bs}")
        nsplit = -(-width // chunk)
        pad = nsplit * chunk - width
        scores = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    if cache_dtype == torch.float32:
        if chunk is None:
            probs = torch.nan_to_num(torch.softmax(scores, dim=-1))
            out = torch.einsum("pkgqs,pksd->pqkgd", probs, v).reshape(p, s, hq, d)
            return out.to(q.dtype)
        # each split an online softmax of its own, from -inf
        split = scores.unflatten(-1, (nsplit, chunk))  # [P, Hkv, G, S, n, chunk]
        m = split.amax(-1)
        seen = torch.isfinite(m)
        m = torch.where(seen, m, 0.0)
        probs = torch.exp(split - m[..., None])
        l_i = probs.sum(-1)
        acc = torch.einsum("pkgqnc,pkncd->pkgqnd", probs, v.unflatten(2, (nsplit, chunk)))
        return _merge(acc, l_i, m, seen, q.dtype)
    # P rounded to bf16 before P.V, as the TPU kernel's online softmax
    # rounds it: against the running maximum after each page. Page i's P.V
    # then carries the weight exp(m_i - m_last) that the kernel's later
    # rescales give it; l sums the unrounded P.
    paged = scores.unflatten(-1, (-1, bs))  # [P, Hkv, G, S, pages, bs]
    m_run = torch.cummax(paged.amax(-1), dim=-1).values  # [P, Hkv, G, S, NB]
    seen = torch.isfinite(m_run)
    m_run = torch.where(seen, m_run, 0.0)
    probs = torch.exp(paged - m_run[..., None])  # masked positions: 0
    if chunk is None:
        weight = torch.where(seen, torch.exp(m_run - m_run[..., -1:]), 0.0)
        l = (probs.sum(-1) * weight).sum(-1)  # 0 for a row without a real token
        probs = (probs.bfloat16().float() * weight[..., None]).flatten(-2)
        out = torch.einsum("pkgqs,pksd->pqkgd", probs, v)
        l = l.permute(0, 3, 1, 2)[..., None]  # [P, S, Hkv, G, 1]
        out = torch.where(l > 0, out / l, 0.0).reshape(p, s, hq, d)
        return out.to(q.dtype)
    # split i's frame: the running maximum after its last page (the walk
    # that started at the earlier splits' maximum); its pages weighted into
    # that frame
    per = chunk // bs
    m_i = m_run.unflatten(-1, (nsplit, per))[..., -1]  # [P, Hkv, G, S, n]
    seen_i = seen.unflatten(-1, (nsplit, per))[..., -1]
    weight = torch.where(seen, torch.exp(m_run - m_i.repeat_interleave(per, -1)), 0.0)
    l_i = (probs.sum(-1) * weight).unflatten(-1, (nsplit, per)).sum(-1)
    probs = (probs.bfloat16().float() * weight[..., None]).unflatten(-2, (nsplit, per))
    acc = torch.einsum("pkgqnc,pkncd->pkgqnd", probs.flatten(-2),
                       v.unflatten(2, (nsplit, chunk)))
    return _merge(acc, l_i, m_i, seen_i, q.dtype)


def _merge(acc, l_i, m_i, seen_i, dtype) -> torch.Tensor:
    """The splits' partials acc [P, Hkv, G, S, n, D], l_i and m_i [P, Hkv,
    G, S, n] (seen_i: m_i holds a score) -> out [P, S, Hq, D]: each split
    weighted by exp(m_i - max m), as the kernel's last split merges them."""
    p, hkv, grp, s, _, d = acc.shape
    m = torch.where(seen_i, m_i, float("-inf")).amax(-1, keepdim=True)
    w = torch.where(seen_i, torch.exp(m_i - torch.where(torch.isfinite(m), m, 0.0)), 0.0)
    l = (l_i * w).sum(-1)[..., None]
    out = (acc * w[..., None]).sum(-2)
    out = torch.where(l > 0, out / l, 0.0)  # [P, Hkv, G, S, D]
    return out.permute(0, 3, 1, 2, 4).reshape(p, s, hkv * grp, d).to(dtype)


def paged_attention_prefill_batched_ilv_plain(
    q: torch.Tensor,  # [P, S, Hq, D]
    kv_all: torch.Tensor,  # [L, NB, 2, Hkv, bs, D]
    layer_idx: int,
    block_tables: torch.Tensor,  # [P, NBmax] int32
    q_offsets: torch.Tensor,  # [P] int32
    kv_lens: torch.Tensor,  # [P] int32 (0 = padded row)
    scale: float,
    window: int = 0,
    rowmajor_tail: bool = False,
    chunk: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of K8's prefill: K3's arithmetic over the
    interleaved cache; with ``rowmajor_tail`` (K9's layout) a sequence's
    final incomplete page (``kv_len % bs != 0``) is read from its
    token-major content. ``chunk`` as in K3's."""
    p = q.shape[0]
    _, _, _, hkv, bs, d = kv_all.shape
    pages = kv_all[int(layer_idx)][block_tables.long()].float()  # [P, NB, 2, Hkv, bs, D]
    if rowmajor_tail:
        kvl = kv_lens.long()
        rows = torch.arange(p, device=q.device)[kvl % bs != 0]
        last = (kvl // bs)[kvl % bs != 0]
        tail = pages[rows, last].reshape(-1, bs, 2 * hkv, d)
        pages[rows, last] = tail.permute(0, 2, 1, 3).reshape(-1, 2, hkv, bs, d)
    k = pages[:, :, 0].permute(0, 2, 1, 3, 4).reshape(p, hkv, -1, d)
    v = pages[:, :, 1].permute(0, 2, 1, 3, 4).reshape(p, hkv, -1, d)
    return _prefill_plain(q, k, v, kv_all.dtype, bs, q_offsets, kv_lens, scale, window,
                          chunk)


_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.xllm_prefill_attention.argtypes = [
            i, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i,
            ctypes.c_float, i, ctypes.c_longlong, i, i, i, i, i, p,
        ]
        lib.xllm_prefill_attention.restype = i
        _lib = lib
    return _lib


def key_tile(block_size: int, head_dim: int = 128) -> int:
    """Key positions per tile of the tensor-core kernel: a page never spans
    two tiles up to block_size 128 (64 at head_dim 256); longer pages take
    their maxima from a first pass."""
    return 128 if block_size == 128 and head_dim == 128 else _TILE


def tensor_cores(work_dtype, cache_dtype, head_dim: int) -> bool:
    """Whether a launch takes the tensor-core kernel: bf16 q at head_dim
    128 (any cache) or 256 (a bf16 or float8_e4m3fn cache)."""
    return work_dtype == torch.bfloat16 and (
        head_dim == 128
        or (head_dim == 256 and cache_dtype in (torch.bfloat16, torch.float8_e4m3fn)))


def split_plan(p: int, s: int, hq: int, hkv: int, width: int,
               block_size: int, head_dim: int = 128) -> tuple[int, int]:
    """-> (chunk, nsplit) of a tensor-core launch, from shapes alone (the
    launch reads nothing back from the card): P chunks of S query tokens,
    Hq / Hkv heads, a block table of ``width`` positions. No split while
    the (chunk, kv head, row tile) blocks number about two for each
    streaming multiprocessor (a chunk of 2048 tokens, or four of 512, at
    qwen3's groups); else splits of ``chunk`` positions, a multiple of the
    key tile and of the page, enough of them (at most ``_MAX_SPLITS``, each
    at least four tiles long) to reach that count over the whole table
    width. A split past a chunk's kv_len exits at once. Row tiles are of
    ``_TC_ROWS[head_dim]`` query rows."""
    blocks = p * hkv * -(-s // (_TC_ROWS[head_dim] // (hq // hkv)))
    unit = max(key_tile(block_size, head_dim), block_size)
    units = -(-width // unit)
    want = 1 if blocks >= _BUSY_BLOCKS else min(_MAX_SPLITS, -(-_BUSY_BLOCKS // blocks))
    # at least _MIN_SPLIT_UNITS units a split: the last split merges every
    # split's partial rows alone
    chunk = unit * max(-(-units // want), min(_MIN_SPLIT_UNITS, units))
    return chunk, -(-width // chunk)


def _split_counters(device: torch.device, n: int) -> torch.Tensor:
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def paged_attention_prefill_plain(
    q: torch.Tensor,  # [S, Hq, D]
    k_all: torch.Tensor,  # [L, NB, Hkv, bs, D]
    v_all: torch.Tensor,
    layer_idx: int,
    block_table: torch.Tensor,  # [NBmax] int32
    q_offset: torch.Tensor,  # [] int32
    kv_len: torch.Tensor,  # [] int32
    scale: float,
    window: int = 0,
    chunk: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of K3b (K3's at one chunk) -> [S, Hq, D]."""
    return paged_attention_prefill_batched_plain(
        q[None], k_all, v_all, layer_idx, block_table[None], q_offset.reshape(1),
        kv_len.reshape(1), scale, window, chunk,
    )[0]


def paged_attention_prefill(
    q: torch.Tensor,
    k_all: torch.Tensor,
    v_all: torch.Tensor,
    layer_idx: int,
    block_table: torch.Tensor,
    q_offset: torch.Tensor,
    kv_len: torch.Tensor,
    scale: float,
    window: int = 0,
) -> torch.Tensor:
    """K3b -> out [S, Hq, D] in q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_prefill_plain(
            q, k_all, v_all, layer_idx, block_table, q_offset, kv_len, scale, window,
        )
    return _launch_split(ONE_NAME, q[None], k_all, v_all, layer_idx, block_table[None],
                         q_offset.reshape(1), kv_len.reshape(1), scale, window)[0]


def paged_attention_prefill_batched(
    q: torch.Tensor,
    k_all: torch.Tensor,
    v_all: torch.Tensor,
    layer_idx: int,
    block_tables: torch.Tensor,
    q_offsets: torch.Tensor,
    kv_lens: torch.Tensor,
    scale: float,
    window: int = 0,
) -> torch.Tensor:
    """K3 -> out [P, S, Hq, D] in q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_prefill_batched_plain(
            q, k_all, v_all, layer_idx, block_tables, q_offsets, kv_lens,
            scale, window,
        )
    return _launch_split(NAME, q, k_all, v_all, layer_idx, block_tables, q_offsets,
                         kv_lens, scale, window)


def paged_attention_prefill_batched_ilv(
    q: torch.Tensor,
    kv_all: torch.Tensor,
    layer_idx: int,
    block_tables: torch.Tensor,
    q_offsets: torch.Tensor,
    kv_lens: torch.Tensor,
    scale: float,
    window: int = 0,
    rowmajor_tail: bool = False,
) -> torch.Tensor:
    """K8 (and, with ``rowmajor_tail``, K9's prefill) -> out [P, S, Hq, D]
    in q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_prefill_batched_ilv_plain(
            q, kv_all, layer_idx, block_tables, q_offsets, kv_lens, scale, window,
            rowmajor_tail,
        )
    if kv_all.dim() != 6 or kv_all.shape[2] != 2:
        raise ValueError(f"{ILV_NAME}: the cache must be [L, NB, 2, Hkv, bs, D], not "
                         f"{tuple(kv_all.shape)}")
    if not kv_all.is_contiguous():
        raise ValueError(f"{ILV_NAME}: the cache must be contiguous")
    _, nb, _, hkv, bs, d = kv_all.shape
    return _launch(ILV_NAME, q, kv_all, kv_all, hkv * bs * d, nb, hkv, bs, d,
                   2 * hkv * bs * d, rowmajor_tail, layer_idx, block_tables, q_offsets,
                   kv_lens, scale, window)


def _launch_split(name, q, k_all, v_all, layer_idx, block_tables, q_offsets, kv_lens,
                  scale, window) -> torch.Tensor:
    """K3's kernel over the split cache, counted under ``name``."""
    nl, nb, hkv, bs, d = k_all.shape
    if v_all.shape != k_all.shape:
        raise ValueError(f"{name}: caches {tuple(k_all.shape)} vs {tuple(v_all.shape)}")
    if not (k_all.is_contiguous() and v_all.is_contiguous()):
        raise ValueError(f"{name}: caches must be contiguous")
    return _launch(name, q, k_all, v_all, 0, nb, hkv, bs, d, hkv * bs * d, False,
                   layer_idx, block_tables, q_offsets, kv_lens, scale, window)


def _launch(name, q, k_base, v_base, v_off: int, nb: int, hkv: int, bs: int,
            d_cache: int, page: int, rm: bool, layer_idx, block_tables, q_offsets,
            kv_lens, scale, window) -> torch.Tensor:
    """K3's kernel over P chunks, counted under ``name`` -> [P, S, Hq, D]:
    K at ``k_base``, V ``v_off`` elements into ``v_base``, ``page``
    elements from one (layer, block) page to the next, row-major tails if
    ``rm``."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    p, s, hq, d = q.shape
    dtype = _build.dtype_code(k_base.dtype)
    # q and the output in the cache dtype; on a quantized cache in q's own
    work = q.dtype if _build.is_quantized(k_base.dtype) else k_base.dtype
    _build.check_head_dim(d, work, k_base.dtype, name)
    qtype = _build.dtype_code(work)
    if _build.is_quantized(work):
        raise ValueError(f"{name}: q must be bfloat16 or float32, not {q.dtype}")
    if d_cache != d or hq % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs cache {tuple(k_base.shape)}")
    if hq // hkv > _MAX_GROUP:
        raise NotImplementedError(f"{name}: more than {_MAX_GROUP} query heads per kv head")
    for t in (block_tables, q_offsets, kv_lens):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name}: index arrays must be contiguous int32 on {q.device}")
    qk = q.to(work).contiguous()
    out = torch.empty_like(qk)
    if p == 0 or s == 0:
        return out.to(q.dtype)
    if bs > _TILE and bs % _TILE or bs < _TILE and _TILE % bs:
        raise NotImplementedError(
            f"{name}: block_size {bs} must divide or be a multiple of {_TILE}"
        )
    lib = _load()
    nbmax = block_tables.shape[1]
    width = nbmax * bs
    chunk, nsplit, seg = width, 1, width
    # placeholders where a launch reads none: the CUDA-core kernel, or one
    # tensor-core walk over pages no longer than its tile
    gmax = part = counters = out
    if tensor_cores(work, k_base.dtype, d):
        kt, br = key_tile(bs, d), _TC_ROWS[d]
        chunk, nsplit = split_plan(p, s, hq, hkv, width, bs, d)
        seg = bs if bs > kt else chunk  # the first pass's maxima: per page or per split
        rows = p * hkv * -(-s // (br // (hq // hkv))) * br  # every block's
        if nsplit > 1 or bs > kt:
            gmax = torch.empty(rows, -(-width // seg), dtype=torch.float32, device=q.device)
        if nsplit > 1:
            part = torch.empty(rows, nsplit, 4 + d, dtype=torch.float32, device=q.device)
            counters = _split_counters(q.device, rows // br)
    _build.count_launch(name)  # one count for the op (one or two kernels)
    err = lib.xllm_prefill_attention(
        q.device.index or 0, _build.ptr(qk), _build.ptr(k_base),
        ctypes.c_void_p(v_base.data_ptr() + v_off * v_base.element_size()),
        _build.ptr(block_tables), _build.ptr(q_offsets),
        _build.ptr(kv_lens), _build.ptr(gmax), _build.ptr(out), _build.ptr(part),
        _build.ptr(counters), dtype, qtype, d, p, s, int(layer_idx),
        nb, hkv, bs, nbmax, hq // hkv, float(scale),
        int(window), page, int(rm), chunk, nsplit, seg, -(-width // seg),
        _build.stream_of(q),
    )
    _build.check(lib, err, name)
    return out.to(q.dtype)
