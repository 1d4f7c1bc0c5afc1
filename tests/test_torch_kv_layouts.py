"""The interleaved KV layouts (``kv_layout="interleaved"`` / ``"interleaved_rm"``,
kernels K8 and K9) of the port against the JAX package.

- The plain versions of the seven TPU functions against the Pallas kernels
  in interpret mode, on numpy inputs from a seed: the four writers byte for
  byte at every valid row (the TPU full-page writers also copy the bucket
  padding rows of a chunk's last page; nothing reads them and the port
  writes only valid rows), decode (v11, v12) and the batched prefill (with
  and without row-major tails) within the P-rounding bounds of PERF.md §2
  on inputs whose scores are exact in f32. The decode cases hold sequences
  whose tail page follows ``nfull % 4 != 0`` full pages, new tokens that
  open a page and new tokens that complete one (v12 then rewrites the page
  canonical); a K9 that rounded P as v11 does (the tail inside the last
  tile of full pages) fails them.
- The layout the runner resolves, case by case against the JAX runner.
- Greedy serving on both layouts: the port's CPU engine against the JAX
  CPU engine, and against the port on the split layout (tokens equal,
  scores within 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xllm_tpu.config as jcfg
import xllm_tpu_torch.config as tcfg
from xllm_tpu.engine import LLMEngine as JEngine
from xllm_tpu.framework.sampling_params import SamplingParams as JSP
from xllm_tpu.ops import attention as jattention
from xllm_tpu.ops.pallas import decode_attention as jdecode
from xllm_tpu.ops.pallas import kv_write as jkv
from xllm_tpu.ops.pallas import prefill_attention as jprefill
from xllm_tpu.runtime.model_runner import ModelRunner as JRunner
from xllm_tpu_torch.engine import LLMEngine as TEngine
from xllm_tpu_torch.framework.sampling_params import SamplingParams as TSP
from xllm_tpu_torch.ops import attention as tattention
from xllm_tpu_torch.ops.cuda import decode_attention as tdecode
from xllm_tpu_torch.ops.cuda import kv_write as tkv
from xllm_tpu_torch.ops.cuda import prefill_attention as tprefill
from xllm_tpu_torch.runtime.model_runner import ModelRunner as TRunner
from xllm_tpu_torch.weights import random_param_tree
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platforms", "cpu")

HKV, G, D = 8, 2, 128
HQ = HKV * G
ATOL = 1e-5
BF16_RTOL = 2.0 ** -7  # one bf16 ulp of the result
QUANT_ATOL = 1e-4  # f32 out: f32 q on f32, int8 and fp8 caches
SCALE = 2.0 ** -4  # a power of two keeps grid scores exact
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def _grid(rng, shape, step=2.0 ** -3, lim=3.0):
    """Values on a grid of ``step`` within [-lim, lim] (exact in bf16)."""
    n = int(lim / step)
    return (rng.integers(-n, n + 1, shape) * step).astype(np.float32)


def _pair(x: np.ndarray, kind: str):
    """The same values as a JAX array and a torch tensor of a cache ``kind``
    (bf16, f32, int8 codes, fp8_e4m3)."""
    jt = {"bf16": jnp.bfloat16, "f32": jnp.float32, "int8": jnp.int8,
          "fp8_e4m3": jnp.float8_e4m3fn}[kind]
    jx = jnp.asarray(x, jt)
    raw = np.array(jx)
    tt = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8,
          "fp8_e4m3": torch.float8_e4m3fn}[kind]
    if kind in ("bf16", "fp8_e4m3"):
        return jx, torch.from_numpy(raw.view(_UINT[raw.itemsize]).astype(
            {1: np.uint8, 2: np.int16}[raw.itemsize])).view(tt)
    return jx, torch.from_numpy(raw)


def _cache_values(rng, kind, shape):
    """Cache (or K row) values for which every score is exact in f32:
    the bf16 / f32 grid, integers up to 16 (exact in e4m3) for int8 / fp8."""
    if kind in ("bf16", "f32"):
        return _grid(rng, shape)
    return rng.integers(-16, 17, shape).astype(np.float32)


def _q_kind(kind):
    """q's dtype: bf16 on a bf16 cache, f32 on the others (the kernels'
    working dtype; int8 codes and e4m3 values are exact in either)."""
    return "bf16" if kind == "bf16" else "f32"


def _bits(x) -> np.ndarray:
    """A JAX array's or a torch tensor's elements as unsigned integers."""
    if isinstance(x, torch.Tensor):
        x = x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[x.element_size()]).numpy()
    x = np.array(x)
    return x.view(_UINT[x.itemsize])


def _assert_within(got, want, kind):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol, rtol = (ATOL, BF16_RTOL) if kind == "bf16" else (QUANT_ATOL, 0.0)
    excess = np.abs(got - want) - (atol + rtol * np.abs(want))
    assert (excess <= 0).all(), (np.abs(got - want).max(), (excess > 0).mean())


def _tables(lens, bs, nbmax):
    """Disjoint pages per sequence (block 0 is the null block)."""
    bt = np.zeros((len(lens), nbmax), np.int32)
    nxt = 1
    for i, n in enumerate(lens):
        for j in range(-(-n // bs)):
            bt[i, j] = nxt
            nxt += 1
    return bt, nxt + 1


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the writers
# ---------------------------------------------------------------------------
# full-page writers: page-aligned chunks, one ending mid-page, a padded row
PREFILL_ROWS = lambda bs: [(0, 4 * bs), (bs, 2 * bs + 5), (0, 0), (2 * bs, 7)]  # noqa: E731
# RMW writers: chunks from mid-page across a page boundary (completing the
# first page), one completing a page it started, a padded row, a short one
RMW_ROWS = lambda bs: [(bs + 3, bs - 3), (5, bs), (0, 0), (2 * bs + 1, 10)]  # noqa: E731


def _padding_slots(rows, bt, bs, rm):
    """The cache rows a TPU full-page writer copies from bucket padding:
    the slots of each chunk's last page past its tokens -> [(block, slot,
    token-major?)]."""
    out = []
    for i, (a, n) in enumerate(rows):
        end = -(-n // bs) * bs
        for j in range(n, end):
            pos = a + j
            out.append((bt[i, pos // bs], pos % bs, rm))
    return out


# each writer on each cache its layout serves (the JAX runner serves an
# int8 cache on plain interleaved only)
WRITER_CASES = [(w, kind, bs) for w in ("prefill_ilv", "rmw_ilv", "prefill_rm", "rmw_rm")
                for kind, bs in (("bf16", 16), ("bf16", 64), ("f32", 16), ("int8", 16),
                                 ("fp8_e4m3", 16))
                if not (w.endswith("_rm") and kind == "int8")]


@pytest.mark.parametrize("writer,kind,bs", WRITER_CASES)
def test_writers_match_pallas(writer, kind, bs):
    rm = writer.endswith("_rm")
    rng = np.random.default_rng(1)
    rmw = writer.startswith("rmw")
    rows = (RMW_ROWS if rmw else PREFILL_ROWS)(bs)
    p, s = len(rows), bs if rmw else 4 * bs
    bt, nb = _tables([a + n for a, n in rows], bs, 12)
    jc, tc = _pair(_cache_values(rng, kind, (2, nb, 2, HKV, bs, D)), kind)
    # new rows as the dispatch hands them over: the cache dtype in JAX (the
    # e4m3 cast before the kernel), values (fp8) or codes (int8) to the port
    src = _cache_values(rng, kind, (2, p, s, HKV, D))
    if kind == "fp8_e4m3":
        src = rng.standard_normal((2, p, s, HKV, D)).astype(np.float32) * 4
    (jk, tk), (jv, tv) = (_pair(x, kind if kind != "fp8_e4m3" else "f32") for x in src)
    jk, jv = jk.astype(jc.dtype), jv.astype(jc.dtype)
    qo = np.asarray([a for a, _ in rows], np.int32)
    nt = np.asarray([n for _, n in rows], np.int32)
    kvl = np.where(nt > 0, qo + nt, 0).astype(np.int32)
    idx = (jnp.int32(1), jnp.asarray(bt), jnp.asarray(qo), jnp.asarray(nt))
    tidx = (1, _t(bt), _t(qo), _t(nt))
    got = tc.clone()
    if rmw:
        if rm:
            want = jkv.kv_write_rmw_batched_rm_tpu(jk, jv, jc, *idx, jnp.asarray(kvl),
                                                    interpret=True)
            tkv.kv_write_rmw_batched_rm(tk, tv, got, *tidx, _t(kvl))
        else:
            want = jkv.kv_write_rmw_batched_ilv_tpu(jk, jv, jc, *idx, interpret=True)
            tkv.kv_write_rmw_batched_ilv(tk, tv, got, *tidx)
    else:
        kvt = jnp.stack([jk.transpose(0, 2, 1, 3), jv.transpose(0, 2, 1, 3)], axis=1)
        tkt, tvt = tk.transpose(1, 2), tv.transpose(1, 2)  # head-major views
        if rm:
            want = jkv.kv_write_prefill_batched_rm_tpu(
                kvt, jnp.concatenate([jk, jv], axis=2), jc, *idx, jnp.asarray(kvl),
                interpret=True)
            tkv.kv_write_prefill_batched_rm(tkt, tvt, got, *tidx, _t(kvl))
        else:
            want = jkv.kv_write_prefill_batched_ilv_tpu(kvt, jc, *idx, interpret=True)
            tkv.kv_write_prefill_batched_ilv(tkt, tvt, got, *tidx)
    want, got, before = _bits(want), _bits(got), _bits(tc)
    assert not np.array_equal(got, before), "nothing was written"
    if not rmw:  # the TPU's copies of bucket padding rows: nothing reads them
        for blk, w, tok in _padding_slots(rows, bt, bs, rm):
            if tok:
                page = want[1, blk].reshape(bs, 2 * HKV, D)
                page[w] = got[1, blk].reshape(bs, 2 * HKV, D)[w]
            else:
                want[1, blk, :, :, w] = got[1, blk, :, :, w]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# decode: v11 (K8) and v12 (K9)
# ---------------------------------------------------------------------------
# bs 16: a new token that opens a page (1, 17), completes one (96: page 5,
# 64: page 3 after nfull 3), tails after nfull % 4 != 0 full pages (99:
# nfull 6, 127: nfull 7), a padded row; bs 64 alike
DECODE_LENS = {16: [1, 17, 96, 99, 0, 64, 127], 64: [64, 65, 300, 129, 0, 350]}


def _decode_case(kind, bs, rm, window=0, seed=0):
    rng = np.random.default_rng(seed)
    lens = DECODE_LENS[bs]
    b = len(lens)
    bt, nb = _tables(lens, bs, max(-(-n // bs) for n in lens) + 1)
    jc, tc = _pair(_cache_values(rng, kind, (2, nb, 2, HKV, bs, D)), kind)
    qk = _q_kind(kind)
    jq, tq = _pair(_grid(rng, (b, HQ, D), 2.0 ** -6, 0.25) if qk == "f32"
                   else _grid(rng, (b, HQ, D)), qk)
    new_kind = "int8" if kind == "int8" else qk
    jkn, tkn = _pair(_cache_values(rng, kind, (b, HKV, D)), new_kind)
    jvn, tvn = _pair(_cache_values(rng, kind, (b, HKV, D)), new_kind)
    sl = np.asarray(lens, np.int32)
    sm = np.asarray([bt[i, (n - 1) // bs] * bs + (n - 1) % bs if n else 0
                     for i, n in enumerate(lens)], np.int32)
    fn = (jdecode.paged_decode_attention_write_v12_tpu if rm
          else jdecode.paged_decode_attention_write_v11_tpu)
    want, wcache = fn(jq, jkn, jvn, jc, jnp.int32(1), jnp.asarray(sm), jnp.asarray(bt),
                      jnp.asarray(sl), SCALE, interpret=True, window=window)
    args = (tq, tkn, tvn, tc.clone(), 1, _t(sm), _t(bt), _t(sl), SCALE, window)
    return want, wcache, args


@pytest.mark.parametrize("rm,kind,bs,window", [
    (False, "bf16", 16, 0), (False, "f32", 64, 0), (False, "int8", 16, 0),
    (False, "fp8_e4m3", 64, 0),
    (True, "bf16", 16, 0), (True, "bf16", 64, 0), (True, "f32", 16, 0),
    (True, "fp8_e4m3", 16, 0), (True, "bf16", 16, 37),
])
def test_decode_matches_pallas(rm, kind, bs, window):
    want, wcache, args = _decode_case(kind, bs, rm, window)
    plain = (tdecode.paged_decode_attention_write_rm_plain if rm
             else tdecode.paged_decode_attention_write_ilv_plain)
    got = plain(*args)
    _assert_within(got.float().numpy(), np.asarray(want.astype(jnp.float32)), _q_kind(kind))
    # the new rows, token-major or (completing a page) the page canonical
    np.testing.assert_array_equal(_bits(args[3]), _bits(wcache))


def test_rm_decode_rounds_the_tail_on_its_own(monkeypatch):
    """A K9 whose walk put the tail page into the last tile of full pages
    (v11's tiles) fails against v12 where ``nfull % 4 != 0``."""
    want, _, args = _decode_case("fp8_e4m3", 16, True)
    monkeypatch.setattr(tdecode, "_rm_tiles", lambda pos, nfull, bs, pages: (
        pos // (pages * bs)).expand(nfull.shape[0], -1))
    got = tdecode.paged_decode_attention_write_rm_plain(*args)
    with pytest.raises(AssertionError):
        _assert_within(got.numpy(), np.asarray(want), "f32")


# ---------------------------------------------------------------------------
# batched prefill over the interleaved cache (K8's, K9's row-major tails)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rm,kind,bs", [
    (False, "bf16", 16), (False, "int8", 16), (False, "f32", 64),
    (True, "bf16", 16), (True, "bf16", 64), (True, "fp8_e4m3", 16), (True, "f32", 16),
])
def test_prefill_matches_pallas(rm, kind, bs):
    rng = np.random.default_rng(3)
    # chunks at q_offset > 0 (a tail page mid-chunk), a full chunk, a padded
    # row, a chunk whose sequence ends on a page boundary
    rows = [(0, 2 * bs + 5), (bs, bs), (0, 0), (2 * bs, 7), (bs, 2 * bs)]
    s = 2 * bs + 8
    lens = [a + n for a, n in rows]
    bt, nb = _tables(lens, bs, max(-(-n // bs) for n in lens) + 1)
    jc, tc = _pair(_cache_values(rng, kind, (2, nb, 2, HKV, bs, D)), kind)
    qk = _q_kind(kind)
    jq, tq = _pair(_grid(rng, (len(rows), s, HQ, D), 2.0 ** -6, 0.25) if qk == "f32"
                   else _grid(rng, (len(rows), s, HQ, D)), qk)
    qo = np.asarray([a for a, _ in rows], np.int32)
    kvl = np.asarray([a + n if n else 0 for a, n in rows], np.int32)
    want = jprefill.paged_attention_prefill_batched_ilv_tpu(
        jq, jc, jnp.int32(1), jnp.asarray(bt), jnp.asarray(qo), jnp.asarray(kvl), SCALE,
        interpret=True, rowmajor_tail=rm)
    got = tprefill.paged_attention_prefill_batched_ilv_plain(
        tq, tc, 1, _t(bt), _t(qo), _t(kvl), SCALE, rowmajor_tail=rm)
    want = np.asarray(want.astype(jnp.float32))
    for i, (_, n) in enumerate(rows):  # bucket padding rows: the port's zeros
        _assert_within(got[i, :n].float().numpy(), want[i, :n], qk)
        assert not got[i, n:].float().abs().any()


def test_head_dim_64_rm_keeps_canonical_pages():
    """At head_dim 64 the JAX package runs its portable path, which writes
    canonical pages even under interleaved_rm: so does the port's (neither
    K8 nor K9 runs there), leaving the same bytes outside the null block,
    where both scatter the padding rows."""
    rng = np.random.default_rng(4)
    d, bs, hkv, s = 64, 16, 8, 32
    rows = [(0, 21), (16, 9)]
    bt, nb = _tables([a + n for a, n in rows], bs, 4)
    cache = rng.standard_normal((2, nb, 2, hkv, bs, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, s, hkv, d)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((2, s, 2 * hkv, d)).astype(np.float32)
    qo = np.asarray([a for a, _ in rows], np.int32)
    kvl = np.asarray([a + n for a, n in rows], np.int32)
    sm = np.asarray([[bt[i, (a + j) // bs] * bs + (a + j) % bs if j < n else 0
                      for j in range(s)] for i, (a, n) in enumerate(rows)], np.int32)
    _, jcache, _ = jattention.prefill_attention_write_batched(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cache), jnp.zeros(1),
        jnp.int32(1), jnp.asarray(sm), jnp.asarray(bt), jnp.asarray(qo), jnp.asarray(kvl),
        0.125, rowmajor_tail=True)
    tcache = _t(cache)
    tattention.prefill_attention_write_batched(
        _t(q), _t(k), _t(v), tcache, torch.zeros(1), 1, _t(sm), _t(bt), _t(qo), _t(kvl),
        0.125, rowmajor_tail=True)
    np.testing.assert_array_equal(tcache.numpy()[:, 1:], np.asarray(jcache)[:, 1:])
    # decode: the new rows land canonical too
    b = len(rows)
    lens = kvl + 1
    dsm = np.asarray([bt[i, n // bs] * bs + n % bs for i, n in enumerate(kvl)], np.int32)
    qd = rng.standard_normal((b, 2 * hkv, d)).astype(np.float32)
    kn, vn = (rng.standard_normal((b, hkv, d)).astype(np.float32) for _ in range(2))
    _, jcache2, _ = jattention.decode_attention_write(
        jnp.asarray(qd), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(jcache), jnp.zeros(1),
        jnp.int32(1), jnp.asarray(dsm), jnp.asarray(bt), jnp.asarray(lens), 0.125,
        rowmajor_tail=True)
    tattention.decode_attention_write(_t(qd), _t(kn), _t(vn), tcache, torch.zeros(1), 1,
                                      _t(dsm), _t(bt), _t(lens), 0.125, rowmajor_tail=True)
    np.testing.assert_array_equal(tcache.numpy()[:, 1:], np.asarray(jcache2)[:, 1:])


# ---------------------------------------------------------------------------
# the layout the runner resolves
# ---------------------------------------------------------------------------
_BASE = dict(model_type="qwen3", dtype="float32", vocab_size=64, hidden_size=32,
             intermediate_size=64, num_hidden_layers=1, num_attention_heads=16,
             num_key_value_heads=8, head_dim=128, qk_norm=True, max_position_embeddings=64)
_MLA = dict(_BASE, model_type="deepseek_v2", num_attention_heads=4, num_key_value_heads=4,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16,
            q_lora_rank=0, num_experts=4, num_experts_per_tok=2, moe_intermediate_size=16,
            first_k_dense_replace=1)


def _config(c, model=None, layout="interleaved_rm", bs=16, kv="auto"):
    return c.EngineConfig(
        model=c.ModelConfig(**(model or _BASE)),
        cache=c.CacheConfig(block_size=bs, num_blocks=16, kv_layout=layout,
                            kv_cache_dtype=kv),
        scheduler=c.SchedulerConfig(max_seqs_per_batch=2, max_model_len=64,
                                    decode_batch_buckets=[2], prefill_token_buckets=[16]),
    )


@pytest.mark.parametrize("case,over,expect", [
    ("rm", {}, "interleaved_rm"),
    ("int8-rm", {"kv": "int8"}, "interleaved"),
    ("fp8-rm", {"kv": "fp8_e4m3"}, "interleaved_rm"),
    ("hkv4-rm", {"model": dict(_BASE, num_key_value_heads=4)}, "interleaved"),
    ("bs24-rm", {"bs": 24}, "interleaved"),
    ("head_dim64-rm", {"model": dict(_BASE, head_dim=64)}, "interleaved_rm"),
    ("mla-interleaved", {"model": _MLA, "layout": "interleaved"}, "split"),
    ("interleaved", {"layout": "interleaved"}, "interleaved"),
])
def test_resolved_layout_matches_jax(case, over, expect, caplog):
    jr = JRunner(_config(jcfg, **over))
    jr.initialize_kv_cache(16)
    tr = TRunner(_config(tcfg, **over), device="cpu")
    tr.initialize_kv_cache(16)
    assert tr.model.kv_layout == jr.model.kv_layout == expect
    assert tuple(tr.k_cache.shape) == tuple(jr.k_cache.shape)
    assert tuple(tr.v_cache.shape) == tuple(jr.v_cache.shape)
    if case == "mla-interleaved":
        assert "using split" in caplog.text


# ---------------------------------------------------------------------------
# greedy serving on both layouts
# ---------------------------------------------------------------------------
def _engine_config(c, layout, model, **scheduler):
    sched = dict(max_seqs_per_batch=3, max_tokens_per_chunk_for_prefill=32,
                 max_model_len=256, decode_batch_buckets=[4],
                 prefill_token_buckets=[16, 32], prefill_row_buckets=[1, 4])
    sched.update(scheduler)
    return c.EngineConfig(
        model=c.ModelConfig(**model),
        cache=c.CacheConfig(block_size=16, num_blocks=96, kv_layout=layout),
        scheduler=c.SchedulerConfig(**sched),
    )


# qwen3 at Hkv 8 (16 | 2 * Hkv | block_size 16: stays on interleaved_rm), a
# qwen3_moe at Hkv 2 (interleaved_rm resolves to interleaved)
_QWEN3 = dict(model_type="qwen3", dtype="float32", vocab_size=97, hidden_size=128,
              intermediate_size=128, num_hidden_layers=2, num_attention_heads=16,
              num_key_value_heads=8, head_dim=128, qk_norm=True,
              max_position_embeddings=256, eos_token_ids=[0])
_MOE = dict(_QWEN3, model_type="qwen3_moe", num_attention_heads=4, num_key_value_heads=2,
            num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
            norm_topk_prob=True)
_PROMPTS = [list(range(3, 12)), [(7 * i) % 96 + 1 for i in range(40)],
            [(5 * i) % 96 + 1 for i in range(21)]]


@pytest.fixture(autouse=False)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _port(layout, model, tree, **scheduler):
    cfg = _engine_config(tcfg, layout, model, **scheduler)
    runner = TRunner(cfg, device="cpu")
    runner.load_model(params=tree)
    return TEngine(cfg, runner=runner)


def _tokens(eng, sp):
    ids = [eng.add_request(prompt_token_ids=p, sampling_params=sp(
        temperature=0.0, max_tokens=24, ignore_eos=True)).request_id for p in _PROMPTS]
    outs = {ro.request_id: ro.outputs[0].token_ids for ro in eng.generate_all()}
    assert eng.block_manager.num_used_blocks == 0
    return [outs[i] for i in ids]


@pytest.mark.parametrize("name,model,layout,resolved", [
    ("qwen3", _QWEN3, "interleaved_rm", "interleaved_rm"),
    ("qwen3", _QWEN3, "interleaved", "interleaved"),
    ("qwen3_moe", _MOE, "interleaved_rm", "interleaved"),
])
def test_greedy_matches_jax_and_split(name, model, layout, resolved, _highest_precision):
    tree = random_param_tree(_engine_config(tcfg, layout, model).model, seed=5)
    jc = _engine_config(jcfg, layout, model)
    runner = JRunner(jc)
    runner.load_model(params=jax.tree.map(jnp.asarray, tree))
    want = _tokens(JEngine(jc, runner=runner), JSP)
    assert runner.model.kv_layout == resolved
    eng = _port(layout, model, tree)
    assert eng.runner.model.kv_layout == resolved
    assert _tokens(eng, TSP) == want
    split = _port("split", model, tree)
    assert _tokens(split, TSP) == want
    prompt = [(3 * i) % 96 + 1 for i in range(70)]  # chunks of 32, 32, 6
    np.testing.assert_allclose(eng.score_prompt(prompt), split.score_prompt(prompt),
                               atol=1e-4, rtol=0)


def test_calibrate_kv_scales_on_interleaved_matches_jax(_highest_precision):
    """``ops.quant.calibrate_kv_scales`` reduces an interleaved cache's K and
    V halves, as the JAX function does (it raised for any cache but split)."""
    from xllm_tpu.ops import quant as jquant
    from xllm_tpu_torch.ops import quant as tquant

    # full chunks of full row buckets: the JAX portable writer stores
    # padding rows in the null block, the port none, and the absmax would
    # see them
    sched = dict(max_seqs_per_batch=4, prefill_row_buckets=[4])
    prompts = [[(k * i + 3) % 96 + 1 for i in range(32)] for k in (1, 5, 7, 11)]
    tree = random_param_tree(_engine_config(tcfg, "interleaved", _QWEN3).model, seed=6)
    jc = _engine_config(jcfg, "interleaved", _QWEN3, **sched)
    runner = JRunner(jc)
    runner.load_model(params=jax.tree.map(jnp.asarray, tree))
    want = jquant.calibrate_kv_scales(JEngine(jc, runner=runner), prompts)
    got = tquant.calibrate_kv_scales(_port("interleaved", _QWEN3, tree, **sched), prompts)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, HKV) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-5)
