"""The port's MLA path vs the JAX package's, on the CPU, from numpy seeds.

- ``apply_rope_interleaved`` against ``xllm_tpu.ops.rope``;
- the plain versions of K11a (decode + latent write), K11b (batched latent
  prefill), K11c and K11d (latent writers) against the Pallas kernels in
  interpret mode and against ``mla_ref``, as ``tests/test_mla.py`` runs
  them, within 2e-5; writers leave byte-equal valid rows (the TPU's K11c
  also fills the never-read tail of the last page, so that tail is not
  compared); the port's ``mla_ref`` against the JAX one;
- K11b's context-split plan; a failed kernel build raises on a CUDA tensor
  instead of taking the plain version, and so do block tables of another
  row count than the batch;
- ``MlaDecoderModel`` logits and latent caches against the JAX model for
  deepseek_v2 (q_lora_rank 0, YaRN, two shared experts, a dense first
  layer, kv_lora_rank + rope = 144, padded to 256 lanes), deepseek_v3
  (q_lora_rank > 0, sigmoid routing with a non-zero bias, two groups,
  routed_scaling_factor 2.5) and glm4_moe_lite (rotate-half rope);
- one bf16 layer's q/latent projections and output projection round where
  the JAX layer rounds;
- greedy ``generate`` token-identical to the JAX ``LLMEngine`` on a tiny
  f32 deepseek_v2;
- ``load_param_tree`` on the JAX MLA tree, and the DSA families raise.

f32 on both sides at full matmul precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xllm_tpu.config as jcfg
import xllm_tpu_torch.config as tcfg
from test_torch_model import _assert_rounds_like
from xllm_tpu.engine import LLMEngine as JEngine
from xllm_tpu.framework.sampling_params import SamplingParams as JSP
from xllm_tpu.models.registry import create_model as jcreate
from xllm_tpu.ops import mla_ref as jref
from xllm_tpu.ops import rope as jrope
from xllm_tpu.ops.pallas.kv_write import (
    latent_write_prefill_batched_tpu,
    latent_write_rmw_batched_tpu,
)
from xllm_tpu.ops.pallas.mla_attention import (
    mla_decode_attention_write_tpu,
    mla_prefill_attention_batched_tpu,
)
from xllm_tpu.runtime import forward_params as jfp
from xllm_tpu.runtime.model_runner import ModelRunner as JRunner
from xllm_tpu_torch.framework.sampling_params import SamplingParams as TSP
from xllm_tpu_torch.llm import LLM
from xllm_tpu_torch.models.registry import create_model as tcreate
from xllm_tpu_torch.ops import mla_ref as tref
from xllm_tpu_torch.ops import rope as trope
from xllm_tpu_torch.ops.cuda import _build
from xllm_tpu_torch.ops.cuda import kv_write as kw
from xllm_tpu_torch.ops.cuda import mla_attention as ka
from xllm_tpu_torch.runtime import forward_params as tfp
from xllm_tpu_torch.weights import load_param_tree, random_param_tree
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tables(specs, bs, nbmax, first=1):
    """Disjoint pages per row for (q_offset, kv_len) specs -> [P, nbmax]."""
    bt = np.zeros((len(specs), nbmax), np.int32)
    nxt = first
    for i, (_, kl) in enumerate(specs):
        for j in range(-(-max(kl, 1) // bs)):
            bt[i, j] = nxt
            nxt += 1
    return bt


def test_rope_interleaved_matches_jax():
    rng = np.random.default_rng(20)
    q = rng.standard_normal((7, 4, 16)).astype(np.float32)
    k = rng.standard_normal((7, 1, 16)).astype(np.float32)
    pos = rng.integers(0, 3000, 7).astype(np.int32)
    scaling = {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
               "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707}
    inv = trope.rope_inv_freq(16, 10000.0, scaling)
    jq, jk = jrope.apply_rope_interleaved(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                                          jnp.asarray(inv.numpy()))
    tq, tk = trope.apply_rope_interleaved(_t(q), _t(k), _t(pos), inv)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# K11a-d plain versions
# ---------------------------------------------------------------------------
def test_decode_plain_matches_pallas_and_ref():
    """K11a: new rows opening a page, mid-page and a padded row; the cache
    after the write is byte-equal to the Pallas kernel's."""
    rng = np.random.default_rng(21)
    L, NB, bs, Dk, dv, H, NBmax = 2, 24, 16, 96, 64, 4, 6
    seq_lens = [18, 1, 33, 17, 0]
    b = len(seq_lens)
    cache = rng.standard_normal((L, NB, 1, bs, Dk)).astype(np.float32)
    q = rng.standard_normal((b, H, Dk)).astype(np.float32)
    lat_new = rng.standard_normal((b, Dk)).astype(np.float32)
    bt = _tables([(0, n) for n in seq_lens], bs, NBmax)
    slots = np.asarray([bt[i, (n - 1) // bs] * bs + (n - 1) % bs if n else 0
                        for i, n in enumerate(seq_lens)], np.int32)
    sl = np.asarray(seq_lens, np.int32)
    scale = Dk ** -0.5
    want, want_cache = mla_decode_attention_write_tpu(
        jnp.asarray(q), jnp.asarray(lat_new), jnp.asarray(cache), jnp.int32(1),
        jnp.asarray(slots), jnp.asarray(bt), jnp.asarray(sl), scale, dv, interpret=True)
    tc = _t(cache.copy())
    got = ka.mla_decode_attention_write(_t(q), _t(lat_new), tc, 1, _t(slots), _t(bt),
                                        _t(sl), scale, dv)
    live = [i for i, n in enumerate(seq_lens) if n]
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], rtol=2e-5, atol=2e-5)
    assert not got[-1].any(), "a padded row gives zeros"
    np.testing.assert_array_equal(tc.numpy(), np.asarray(want_cache))
    ref = jref.mla_decode_ref(jnp.asarray(q), want_cache, jnp.int32(1), jnp.asarray(bt),
                              jnp.asarray(sl), scale, dv)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(ref)[live], rtol=2e-5, atol=2e-5)
    # the port's oracle is the JAX oracle
    tr = tref.mla_decode_ref(_t(q), tc, 1, _t(bt), _t(sl), scale, dv)
    np.testing.assert_allclose(tr.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


# (q_offset, kv_len) per chunk: fresh, second chunk at q_offset 16, a short
# one with bucket padding, a padded row
PREFILL_SPECS = [(0, 32), (16, 48), (0, 9), (0, 0)]


def test_prefill_plain_matches_pallas_and_ref():
    """K11b over S 32 chunks; rows past ntok and the padded row are zeros."""
    rng = np.random.default_rng(22)
    L, NB, bs, Dk, dv, H, s = 2, 32, 16, 64, 48, 4, 32
    p = len(PREFILL_SPECS)
    cache = rng.standard_normal((L, NB, 1, bs, Dk)).astype(np.float32)
    q = rng.standard_normal((p, s, H, Dk)).astype(np.float32)
    bt = _tables(PREFILL_SPECS, bs, 8)
    qo = np.asarray([a for a, _ in PREFILL_SPECS], np.int32)
    kl = np.asarray([b for _, b in PREFILL_SPECS], np.int32)
    scale = Dk ** -0.5
    want = np.asarray(mla_prefill_attention_batched_tpu(
        jnp.asarray(q), jnp.asarray(cache), jnp.int32(1), jnp.asarray(bt),
        jnp.asarray(qo), jnp.asarray(kl), scale, dv, interpret=True))
    got = ka.mla_prefill_attention_batched(_t(q), _t(cache), 1, _t(bt), _t(qo), _t(kl),
                                           scale, dv).numpy()
    for i, (a, b) in enumerate(PREFILL_SPECS):
        n = b - a
        assert not got[i, n:].any(), f"row {i}: past ntok not zero"
        if n == 0:
            continue
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=2e-5, atol=2e-5)
        ref = np.asarray(jref.mla_prefill_ref(
            jnp.asarray(q[i]), jnp.asarray(cache), jnp.int32(1), jnp.asarray(bt[i]),
            jnp.int32(a), jnp.int32(b), scale, dv))
        np.testing.assert_allclose(got[i, :n], ref[:n], rtol=2e-5, atol=2e-5)
        tr = tref.mla_prefill_ref(_t(q[i]), _t(cache), 1, _t(bt[i]), a, b, scale, dv)
        np.testing.assert_allclose(tr.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("writer", ["pages", "rmw"])
def test_latent_writers_match_pallas(writer):
    """K11c (S 48 from page-aligned offsets) and K11d (S 5 across a page
    boundary and mid-page): every valid row byte-equal, nothing else
    written; the TPU's K11c also fills the rest of the last page, which is
    never read, so those positions are left out of the comparison."""
    rng = np.random.default_rng(23)
    L, NB, bs, Dk = 2, 32, 16, 64
    if writer == "pages":
        s, specs = 48, [(0, 40), (16, 48), (0, 0)]
        tpu, port = latent_write_prefill_batched_tpu, kw.latent_write_prefill_batched
    else:
        s, specs = 5, [(13, 18), (3, 8), (30, 33), (0, 0)]
        tpu, port = latent_write_rmw_batched_tpu, kw.latent_write_rmw_batched
    cache = rng.standard_normal((L, NB, 1, bs, Dk)).astype(np.float32)
    rows = rng.standard_normal((len(specs), s, Dk)).astype(np.float32)
    bt = _tables(specs, bs, 8)
    qo = np.asarray([a for a, _ in specs], np.int32)
    nt = np.asarray([b - a for a, b in specs], np.int32)
    want = np.asarray(tpu(jnp.asarray(rows), jnp.asarray(cache), jnp.int32(1),
                          jnp.asarray(bt), jnp.asarray(qo), jnp.asarray(nt), interpret=True))
    got = port(_t(rows), _t(cache.copy()), 1, _t(bt), _t(qo), _t(nt)).numpy()
    tail = np.zeros((NB, bs), bool)
    for i, (a, b) in enumerate(specs):
        for pos in range(b, -(-b // bs) * bs if b > a else b):
            tail[bt[i, pos // bs], pos % bs] = True
        for j in range(b - a):
            pos = a + j
            blk, off = bt[i, pos // bs], pos % bs
            np.testing.assert_array_equal(got[1, blk, 0, off], rows[i, j], f"row {i} tok {j}")
    np.testing.assert_array_equal(got[1, :, 0][~tail], want[1, :, 0][~tail])
    np.testing.assert_array_equal(got[0], cache[0])
    if writer == "rmw":
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p,s,h", [(3, 2048, 16), (4, 512, 16), (3, 64, 16), (1, 64, 16),
                                   (3, 64, 20), (3, 64, 128)])
def test_prefill_split_plan_covers_the_context(p, s, h):
    """K11b's bf16 launch splits the context only when its 64-row tiles
    give few blocks; the splits are whole 64-token tiles, at most 32, and
    cover the block table's 4,096 positions."""
    plan = ka.prefill_plan(p, s, h, 4096, 64)
    assert 1 <= plan.nsplit <= 32 and plan.chunk % 64 == 0 and plan.chunk * plan.nsplit >= 4096
    blocks = p * -(-s * h // 64)
    assert (plan.nsplit == 1) == (blocks >= 264)


def _fake_cuda(t: torch.Tensor) -> torch.Tensor:
    """A CPU tensor that reports a CUDA device, so that a wrapper takes its
    kernel path on a machine without a card."""

    class FakeCuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    return torch.Tensor._make_subclass(FakeCuda, t)


def _call_on_fake_cuda(kernel: str, monkeypatch, table_rows: int = 1) -> None:
    """Call a K11 wrapper on one row of fake CUDA tensors (block tables of
    ``table_rows`` rows) with a build that fails, and the plain versions
    replaced by a failure: the call must not reach either."""
    def failed_build(stem):
        raise RuntimeError(f"CUDA kernel build failed: csrc/{stem}.cu")

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(_build, "load", failed_build)
    monkeypatch.setattr(ka, "_lib", None)
    monkeypatch.setattr(kw, "_lib", None)
    for mod, name in ((ka, "mla_decode_attention_write_plain"),
                      (ka, "mla_prefill_attention_batched_plain"),
                      (kw, "latent_write_rows_plain")):
        monkeypatch.setattr(mod, name, no_plain)
    cache = _fake_cuda(torch.zeros(2, 4, 1, 16, 128, dtype=torch.bfloat16))
    i32 = lambda *v: _fake_cuda(torch.tensor(v, dtype=torch.int32))  # noqa: E731
    bt = _fake_cuda(torch.ones(table_rows, 2, dtype=torch.int32))
    if kernel == "decode":
        q = _fake_cuda(torch.zeros(1, 16, 128, dtype=torch.bfloat16))
        ka.mla_decode_attention_write(q, _fake_cuda(torch.zeros(1, 128)), cache, 0,
                                      i32(3), bt, i32(4), 0.1, 128)
    elif kernel == "prefill":
        q = _fake_cuda(torch.zeros(1, 8, 16, 128, dtype=torch.bfloat16))
        ka.mla_prefill_attention_batched(q, cache, 0, bt, i32(0), i32(8), 0.1, 128)
    else:
        rows = _fake_cuda(torch.zeros(1, 8, 128, dtype=torch.bfloat16))
        kw.latent_write_rmw_batched(rows, cache, 0, bt, i32(0), i32(8))


@pytest.mark.parametrize("kernel", ["decode", "prefill", "latent_write"])
def test_cuda_tensor_with_failed_build_raises(kernel, monkeypatch):
    """A CUDA tensor goes to the kernel: a failed build raises, and neither
    the plain version runs nor the launch counter moves."""
    before = dict(_build.launch_counts)
    with pytest.raises(RuntimeError, match="build failed"):
        _call_on_fake_cuda(kernel, monkeypatch)
    assert _build.launch_counts == before


@pytest.mark.parametrize("kernel", ["decode", "prefill", "latent_write"])
def test_cuda_wrappers_check_index_rows(kernel, monkeypatch):
    """Block tables with another row count than the batch raise before the
    build and the launch (the kernels index them by row)."""
    before = dict(_build.launch_counts)
    with pytest.raises(ValueError, match="one row per"):
        _call_on_fake_cuda(kernel, monkeypatch, table_rows=2)
    assert _build.launch_counts == before


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
BS, NB, NBMAX = 4, 32, 8
_YARN = {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
         "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707}
_COMMON = dict(dtype="float32", vocab_size=97, hidden_size=64, intermediate_size=96,
               num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
               head_dim=16, max_position_embeddings=128, eos_token_ids=[0],
               qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16,
               num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
               first_k_dense_replace=1)
FAMILIES = {
    # kv_lora_rank + rope = 144: the latent is padded to 256 lanes
    "deepseek_v2": dict(_COMMON, kv_lora_rank=128, n_shared_experts=2,
                        norm_topk_prob=False, rope_scaling=_YARN),
    "deepseek_v3": dict(_COMMON, q_lora_rank=32, kv_lora_rank=64, n_shared_experts=1,
                        norm_topk_prob=True, scoring_func="sigmoid", n_group=2,
                        topk_group=1, routed_scaling_factor=2.5),
    "glm4_moe_lite": dict(_COMMON, q_lora_rank=32, kv_lora_rank=64, n_shared_experts=1,
                          norm_topk_prob=True, scoring_func="sigmoid",
                          routed_scaling_factor=1.8),
}


def _prefill_arrays(rows, s, bt):
    """rows: (table row, q_offset, ntok, tokens); one padded row after."""
    p = len(rows) + 1
    a = {n: np.zeros((p, s), np.int32) for n in ("token_ids", "positions", "slot_mapping")}
    a["block_tables"] = np.zeros((p, NBMAX), np.int32)
    for n in ("kv_lens", "q_offsets", "logits_idx", "sample_slots", "hist_slots"):
        a[n] = np.zeros(p, np.int32)
    for i, (r, qo, n, toks) in enumerate(rows):
        pos = qo + np.arange(s)
        a["token_ids"][i, :n] = toks
        a["positions"][i] = np.minimum(pos, qo + n - 1)
        a["slot_mapping"][i, :n] = bt[r, pos[:n] // BS] * BS + pos[:n] % BS
        a["block_tables"][i] = bt[r]
        a["kv_lens"][i] = qo + n
        a["q_offsets"][i] = qo
        a["logits_idx"][i] = n - 1
    return a


def _inputs(cls_j, cls_t, arrays):
    return (cls_j(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            cls_t(**{k: _t(v) for k, v in arrays.items()}))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_model_logits_and_caches_match_jax(family):
    """Prefill (a fresh prompt, the second chunk of a chunked one at
    q_offset 4, a padded row), then a decode step whose new token opens a
    page: logits within 1e-4, latent cache rows within 1e-5."""
    kw_ = FAMILIES[family]
    jm = jcreate(jcfg.ModelConfig(model_type=family, **kw_))
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0)))
    rng = np.random.default_rng(24)
    if "router_bias" in params.get("moe_layers", {}):  # non-zero biases show more
        b = params["moe_layers"]["router_bias"]
        params["moe_layers"]["router_bias"] = (rng.standard_normal(b.shape) * 0.5).astype(b.dtype)
    tm = tcreate(tcfg.ModelConfig(model_type=family, **kw_), device="cpu")
    assert (tm.dk, tm.dk_pad) == ((144, 256) if family == "deepseek_v2" else (80, 80))
    load_param_tree(tm, params)
    jp = jax.tree.map(jnp.asarray, params)
    prompts = {0: rng.integers(1, 97, 8).astype(np.int32),
               1: rng.integers(1, 97, 7).astype(np.int32)}
    bt = np.pad(np.arange(1, 9, dtype=np.int32).reshape(2, 4), ((0, 0), (0, NBMAX - 4)))
    kj, vj = jm.new_kv_cache(NB, BS)
    kt, vt = tm.new_kv_cache(NB, BS)
    assert tuple(kt.shape) == tuple(kj.shape)

    def prefill(rows):
        ij, it = _inputs(jfp.BatchedPrefillInput, tfp.BatchedPrefillInput,
                         _prefill_arrays(rows, 8, bt))
        hj, kj2, vj2 = jm.prefill_batched(jp, kj, vj, ij)
        ht, _, _ = tm.prefill_batched(kt, vt, it)
        n = len(rows)
        np.testing.assert_allclose(
            tm.compute_logits(ht[:n, 0]).numpy(),
            np.asarray(jm.compute_logits(jp, hj[:n, 0])), rtol=1e-4, atol=1e-4)
        return kj2, vj2

    kj, vj = prefill([(0, 0, 8, prompts[0]), (1, 0, 4, prompts[1][:4])])
    kj, vj = prefill([(1, 4, 3, prompts[1][4:])])
    seq_lens = np.asarray([9, 8, 0], np.int32)  # row 0's token opens page 2
    pos = np.maximum(seq_lens - 1, 0)
    dec = dict(
        slot_ids=np.asarray([0, 1, 9], np.int32),
        positions=pos.astype(np.int32),
        slot_mapping=np.asarray([bt[i, pos[i] // BS] * BS + pos[i] % BS if seq_lens[i] else 0
                                 for i in range(3)], np.int32),
        block_tables=np.concatenate([bt, np.zeros((1, NBMAX), np.int32)]),
        seq_lens=seq_lens,
    )
    toks = np.asarray([11, 22, 0], np.int32)
    ij, it = _inputs(jfp.DecodeInput, tfp.DecodeInput, dec)
    hj, kj, vj = jm.decode(jp, kj, vj, ij, jnp.asarray(toks))
    ht, _, _ = tm.decode(kt, vt, it, _t(toks))
    np.testing.assert_allclose(tm.compute_logits(ht).numpy()[:2],
                               np.asarray(jm.compute_logits(jp, hj))[:2], rtol=1e-4, atol=1e-4)
    got, want = kt.numpy(), np.asarray(kj)
    for r in range(2):
        for p in range(seq_lens[r]):
            blk, off = int(bt[r, p // BS]), p % BS
            np.testing.assert_allclose(got[:, blk, 0, off], want[:, blk, 0, off],
                                       rtol=1e-5, atol=1e-5)


def test_bf16_layer_rounds_like_jax(monkeypatch):
    """One bf16 deepseek_v2 layer: q_eff and the latent row (the absorption
    product summed in f32, rounded once) and the output projection (the
    W_UV product rounded once before o_proj) round where JAX rounds.

    The CPU's XLA has no batched bf16 x bf16 -> f32 dot, so the JAX einsums
    get their bf16 operands upcast: a product of two bf16 values is exact in
    f32, so that is the same function."""
    einsum = jnp.einsum

    def einsum_f32(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) for o in ops]
        return einsum(spec, *ops, preferred_element_type=preferred_element_type, **kw)

    monkeypatch.setattr(jnp, "einsum", einsum_f32)
    kw_ = dict(FAMILIES["deepseek_v2"], dtype="bfloat16", num_hidden_layers=1,
               hidden_size=256, kv_lora_rank=256, num_experts=0, rope_scaling=None)
    jm = jcreate(jcfg.ModelConfig(model_type="deepseek_v2", **kw_))
    tm = tcreate(tcfg.ModelConfig(model_type="deepseek_v2", **kw_), device="cpu")
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.key(1)))
    load_param_tree(tm, params)
    lpj = {k: jnp.asarray(v[0]) for k, v in params["dense_layers"].items()}
    rng = np.random.default_rng(25)
    hj = jnp.asarray(rng.standard_normal((64, 256)), jnp.bfloat16)
    ht = torch.from_numpy(np.array(hj.astype(jnp.float32))).bfloat16()
    pos = np.arange(64, dtype=np.int32)
    inv = jnp.asarray(tm.inv_freq.numpy())
    want = jm._mla_qkv(lpj, hj, jnp.asarray(pos), inv)
    got = tm._mla_qkv(tm.layers[0], ht, _t(pos))
    for g, w in zip(got, want[:2]):
        _assert_rounds_like(g, w)
    lat = jnp.asarray(rng.standard_normal((64, 4, 256)), jnp.bfloat16)
    lat_t = torch.from_numpy(np.array(lat.astype(jnp.float32))).bfloat16()
    _assert_rounds_like(tm._mla_out(tm.layers[0], lat_t),
                        jm._mla_out(lpj, lat, 64).astype(jnp.bfloat16))


def test_load_param_tree_takes_the_jax_mla_tree():
    """Both q layouts, dense-only and MoE stacks; a missing key raises."""
    for family in ("deepseek_v2", "deepseek_v3"):
        for experts in (8, 0):
            kw_ = dict(FAMILIES[family], num_experts=experts)
            jm = jcreate(jcfg.ModelConfig(model_type=family, **kw_))
            tree = jax.tree.map(np.asarray, jm.init_params(jax.random.key(2)))
            tm = tcreate(tcfg.ModelConfig(model_type=family, **kw_), device="cpu")
            load_param_tree(tm, tree)
            ref = random_param_tree(tm.cfg, seed=0)
            assert jax.tree.map(np.shape, ref) == jax.tree.map(np.shape, tree)
            group = "moe_layers" if experts else "dense_layers"
            np.testing.assert_array_equal(tm.layers[-1].kv_b_v_w.numpy(),
                                          tree[group]["kv_b_v_w"][-1])
    del tree["dense_layers"]["kv_a_norm"]
    with pytest.raises(ValueError, match="dense_layers"):
        load_param_tree(tm, tree)


@pytest.mark.parametrize("family", ["deepseek_v32", "glm_moe_dsa"])
def test_dsa_families_raise(family):
    cfg = tcfg.ModelConfig(model_type=family, **dict(FAMILIES["deepseek_v3"], index_topk=8))
    with pytest.raises(NotImplementedError, match="DSA"):
        tcreate(cfg, device="cpu")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _tiny_ds(c):
    """The deepseek_v2 engine config of tests/test_mla.py, f32."""
    return c.EngineConfig(
        model=c.ModelConfig(
            model_type="deepseek_v2", dtype="float32", vocab_size=96, hidden_size=48,
            intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=4, head_dim=16, max_position_embeddings=128,
            q_lora_rank=24, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, num_experts=4, num_experts_per_tok=2,
            moe_intermediate_size=16, norm_topk_prob=True, first_k_dense_replace=1,
            n_shared_experts=1,
        ),
        cache=c.CacheConfig(block_size=16, num_blocks=24),
        scheduler=c.SchedulerConfig(max_seqs_per_batch=2, decode_batch_buckets=[2],
                                    prefill_token_buckets=[16, 32], max_model_len=128),
    )


def test_greedy_generate_matches_jax_engine():
    """Three requests over a batch of two (one waits), prompts taking both
    writers (a 24-token prompt in the 32 bucket, short ones in the 16)."""
    tree = random_param_tree(_tiny_ds(tcfg).model, seed=6)
    prompts = [[3, 5, 7, 9, 11, 13], list(range(1, 25)), [9, 1, 4, 4, 1, 7, 30, 2]]
    sp = dict(temperature=0.0, max_tokens=8, ignore_eos=True)

    jc = _tiny_ds(jcfg)
    runner = JRunner(jc)
    runner.load_model(params=jax.tree.map(jnp.asarray, tree))
    je = JEngine(jc, runner=runner)
    ids = [je.add_request(prompt_token_ids=p, sampling_params=JSP(**sp)).request_id
           for p in prompts]
    outs = {ro.request_id: ro.outputs[0].token_ids for ro in je.generate_all(timeout_s=600)}
    want = [outs[i] for i in ids]

    llm = LLM(config=_tiny_ds(tcfg), device="cpu")
    llm.engine.runner.load_model(params=tree)
    got = [ro.outputs[0].token_ids
           for ro in llm.generate(prompt_token_ids=prompts,
                                  sampling_params=[TSP(**sp)] * len(prompts))]
    assert got == want
    assert all(len(g) == 8 for g in got)
    assert llm.engine.block_manager.num_used_blocks == 0
