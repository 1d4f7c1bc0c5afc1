"""The port's MoE path vs the JAX package's, on the CPU, from numpy seeds.

- ``route`` (softmax top-k; sigmoid with correction bias and group-limited
  top-k) against JAX ``route``: identical expert ids, weights within 1e-6;
- K10's plain version ``gmm_plain`` against the Pallas ``gmm`` in
  interpret mode: tiles that straddle expert boundaries, an empty expert,
  and an M that is no multiple of the TPU's tile on the port's side;
- the row tile and instance K10's wrapper picks at each served shape;
- ``moe_mlp`` (the sorted grouped-GEMM path the card runs, with K10's
  plain version) against JAX ``moe_mlp_gmm`` (Pallas, interpret mode) and
  the dense oracle ``moe_mlp_ref``, within 2e-4 as ``tests/test_moe.py``;
- ``MoeDecoderModel`` logits and caches against the JAX model for
  qwen3-moe, glm4-moe (sigmoid routing with a non-zero bias, one shared
  expert, one dense first layer, partial rotate-half rope), minimax-m2
  (partial interleaved rope), and the dense glm4 (partial interleaved
  rope, sandwich norms), which runs now that partial rope is ported;
- greedy ``generate`` token-identical to the JAX ``LLMEngine`` on the tiny
  f32 qwen3-moe of ``tests/test_moe.py``;
- the partial rope variants against ``xllm_tpu.ops.rope``.

f32 on both sides at full matmul precision.
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
from xllm_tpu.models.registry import create_model as jcreate
from xllm_tpu.ops import moe as jmoe
from xllm_tpu.ops import rope as jrope
from xllm_tpu.ops.pallas.gmm import gmm as pallas_gmm
from xllm_tpu.runtime import forward_params as jfp
from xllm_tpu.runtime.model_runner import ModelRunner as JRunner
from xllm_tpu_torch.framework.sampling_params import SamplingParams as TSP
from xllm_tpu_torch.llm import LLM
from xllm_tpu_torch.models.registry import create_model as tcreate
from xllm_tpu_torch.ops import moe as tmoe
from xllm_tpu_torch.ops import rope as trope
from xllm_tpu_torch.ops.cuda.gmm import gmm, gmm_plain, plan
from xllm_tpu_torch.runtime import forward_params as tfp
from xllm_tpu_torch.weights import load_param_tree, random_param_tree


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# route, K10, the MoE block
# ---------------------------------------------------------------------------
ROUTE_CASES = {
    "softmax": dict(e=8, k=2, norm=True, kw={}),
    "softmax-unnormed": dict(e=8, k=2, norm=False, kw={}),
    "sigmoid-bias-groups": dict(
        e=16, k=4, norm=True,
        kw=dict(scoring="sigmoid", n_group=4, topk_group=2, routed_scaling=2.5)),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_matches_jax(case):
    c = ROUTE_CASES[case]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((24, 32)).astype(np.float32)
    w = (rng.standard_normal((32, c["e"])) * 0.3).astype(np.float32)
    kw = dict(c["kw"])
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("scoring") == "sigmoid":
        bias = (rng.standard_normal(c["e"]) * 0.1).astype(np.float32)
        jkw["bias"], tkw["bias"] = jnp.asarray(bias), _t(bias)
    jv, ji = jmoe.route(jnp.asarray(x), jnp.asarray(w), c["k"], c["norm"], **jkw)
    tv, ti = tmoe.route(_t(x), _t(w), c["k"], c["norm"], **tkw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)


def test_gmm_plain_matches_pallas():
    """Group sizes 10, 0, 19, 3, 8 over M 40: with the TPU's 8-row tiles,
    tiles straddle expert boundaries; expert 1 is empty. The port's side
    also takes M 37 (no multiple of 8) with the same first groups."""
    rng = np.random.default_rng(12)
    e, k, n = 5, 32, 48
    sizes = np.array([10, 0, 19, 3, 8], np.int32)
    m = int(sizes.sum())
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    rhs = rng.standard_normal((e, k, n)).astype(np.float32)
    want = np.asarray(pallas_gmm(jnp.asarray(lhs), jnp.asarray(rhs),
                                 jnp.asarray(offs), tm=8, tn=16, interpret=True))
    got = gmm(_t(lhs), _t(rhs), _t(offs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # M 37: the last expert keeps 5 rows; nothing is padded
    offs37 = offs.copy()
    offs37[-1] = 37
    got37 = gmm(_t(lhs[:37]), _t(rhs), _t(offs37)).numpy()
    np.testing.assert_allclose(got37, want[:37], rtol=1e-5, atol=1e-5)
    # rows outside every group come out as zeros
    offs_gap = offs.copy()
    offs_gap[0], offs_gap[-1] = 4, 36
    got_gap = gmm_plain(_t(lhs), _t(rhs), _t(offs_gap)).numpy()
    assert not got_gap[:4].any() and not got_gap[36:].any()
    np.testing.assert_allclose(got_gap[4:36], want[4:36], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="nondecreasing"):
        gmm_plain(_t(lhs), _t(rhs), _t(offs[::-1].copy()))


@pytest.mark.parametrize("tokens, tile, instance", [(16, 16, "mma16"), (64, 16, "mma16"),
                                                     (512, 256, "ws256"), (2048, 256, "ws256")])
def test_gmm_row_tile_at_served_shapes(tokens, tile, instance):
    """K10's bf16 row tile at Qwen3-30B-A3B's 128 experts, top-8, gate_up
    (K 2048, N 1536): a decode step of 16 and a full chunk of each prefill
    bucket. ``chip_smoke.py`` times every build at these shapes; each
    bf16-rhs build is picked at one."""
    p = plan(tokens * 8, 2048, 1536, 128)
    assert (p.bm, p.name) == (tile, instance)


@pytest.mark.parametrize("scoring", ["softmax", "sigmoid"])
def test_moe_mlp_matches_jax_gmm_and_ref(scoring):
    rng = np.random.default_rng(13)
    t, d, e, i, k = 16, 128, 4, 128, 2
    x = rng.standard_normal((t, d)).astype(np.float32)
    rw = rng.standard_normal((d, e)).astype(np.float32)
    gu = (rng.standard_normal((e, d, 2 * i)) * 0.1).astype(np.float32)
    dn = (rng.standard_normal((e, i, d)) * 0.1).astype(np.float32)
    jkw, tkw = {}, {}
    if scoring == "sigmoid":
        bias = (rng.standard_normal(e) * 0.1).astype(np.float32)
        jkw = dict(scoring="sigmoid", bias=jnp.asarray(bias))
        tkw = dict(scoring="sigmoid", bias=_t(bias))
    args = [jnp.asarray(a) for a in (x, rw, gu, dn)]
    want_gmm = np.asarray(jmoe.moe_mlp_gmm(*args, k, True, impl="own",
                                           interpret=True, **jkw))
    want_ref = np.asarray(jmoe.moe_mlp_ref(*args, k, True, **jkw))
    got = tmoe.moe_mlp(_t(x), _t(rw), _t(gu), _t(dn), k, True, **tkw).numpy()
    np.testing.assert_allclose(got, want_gmm, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, want_ref, rtol=2e-4, atol=2e-4)
    ref = tmoe.moe_mlp_ref(_t(x), _t(rw), _t(gu), _t(dn), k, True, **tkw).numpy()
    np.testing.assert_allclose(ref, want_ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize(
    "kw",
    [dict(mesh=object()), dict(placement=torch.arange(4)),
     dict(return_counts=True)],
    ids=["ep-mesh", "eplb-placement", "expert-counts"],
)
def test_moe_mlp_unported_options_raise(kw):
    x = torch.zeros(2, 8)
    with pytest.raises(NotImplementedError):
        tmoe.moe_mlp(x, torch.zeros(8, 4), torch.zeros(4, 8, 16),
                     torch.zeros(4, 8, 8), 2, True, **kw)


# ---------------------------------------------------------------------------
# partial rope
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("interleaved", [False, True])
def test_partial_rope_matches_jax(interleaved):
    rng = np.random.default_rng(14)
    t, d, rd = 7, 32, 16
    q = rng.standard_normal((t, 4, d)).astype(np.float32)
    k = rng.standard_normal((t, 2, d)).astype(np.float32)
    pos = rng.integers(0, 500, t).astype(np.int32)
    inv = trope.rope_inv_freq(rd, 10000.0)
    name = "apply_rope_partial_interleaved_cos" if interleaved else "apply_rope_partial"
    jq, jk = getattr(jrope, name)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                                  jnp.asarray(inv.numpy()), rd)
    tq, tk = getattr(trope, name)(_t(q), _t(k), _t(pos), inv, rd)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tq.numpy()[..., rd:], q[..., rd:])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
BS, NB, NBMAX = 4, 32, 8
_COMMON = dict(
    dtype="float32", vocab_size=97, hidden_size=64, intermediate_size=96,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    head_dim=16, max_position_embeddings=128, eos_token_ids=[0],
)
_MOE = dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
            norm_topk_prob=True)
FAMILIES = {
    "qwen3_moe": dict(_COMMON, qk_norm=True, **_MOE),
    "glm4_moe": dict(_COMMON, qk_norm=True, attention_bias=True,
                     partial_rotary_factor=0.5, rope_interleaved=False,
                     scoring_func="sigmoid", n_group=2, topk_group=1,
                     routed_scaling_factor=1.5, first_k_dense_replace=1,
                     n_shared_experts=1, **_MOE),
    "minimax_m2": dict(_COMMON, qk_norm=True, partial_rotary_factor=0.5,
                       scoring_func="sigmoid", **_MOE),
    "glm4": dict(_COMMON, use_sandwich_norms=True, attention_bias=True,
                 partial_rotary_factor=0.5, rope_interleaved=True),
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
    kw = FAMILIES[family]
    jm = jcreate(jcfg.ModelConfig(model_type=family, **kw))
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0)))
    rng = np.random.default_rng(15)
    for group in ("layers", "dense_layers"):  # non-zero biases show more
        for name in ("router_bias", "qkv_proj_b"):
            if name in params.get(group, {}):
                b = params[group][name]
                params[group][name] = (rng.standard_normal(b.shape) * 0.5).astype(b.dtype)
    tm = tcreate(tcfg.ModelConfig(model_type=family, **kw), device="cpu")
    load_param_tree(tm, params)
    jparams = jax.tree.map(jnp.asarray, params)

    lens = {0: 8, 1: 5}
    prompts = {r: rng.integers(1, 97, n).astype(np.int32) for r, n in lens.items()}
    bt = np.arange(1, 1 + 2 * 4, dtype=np.int32).reshape(2, 4)
    bt = np.pad(bt, ((0, 0), (0, NBMAX - 4)))
    kj, vj = jm.new_kv_cache(NB, BS)
    kt, vt = tm.new_kv_cache(NB, BS)
    ij, it = _inputs(jfp.BatchedPrefillInput, tfp.BatchedPrefillInput,
                     _prefill_arrays([(r, 0, n, prompts[r]) for r, n in lens.items()], 8, bt))
    hj, kj, vj = jm.prefill_batched(jparams, kj, vj, ij)
    ht, _, _ = tm.prefill_batched(kt, vt, it)
    np.testing.assert_allclose(
        tm.compute_logits(ht[:2, 0]).numpy(),
        np.asarray(jm.compute_logits(jparams, hj[:2, 0])), rtol=1e-4, atol=1e-4)

    seq_lens = np.asarray([9, 6, 0], np.int32)
    pos = np.maximum(seq_lens - 1, 0)
    dec = dict(
        slot_ids=np.asarray([0, 1, 9], np.int32),
        positions=pos.astype(np.int32),
        slot_mapping=np.asarray(
            [bt[i, pos[i] // BS] * BS + pos[i] % BS if seq_lens[i] else 0
             for i in range(3)], np.int32),
        block_tables=np.concatenate([bt, np.zeros((1, NBMAX), np.int32)]),
        seq_lens=seq_lens,
    )
    toks = np.asarray([11, 22, 0], np.int32)
    ij, it = _inputs(jfp.DecodeInput, tfp.DecodeInput, dec)
    hj, kj, vj = jm.decode(jparams, kj, vj, ij, jnp.asarray(toks))
    ht, _, _ = tm.decode(kt, vt, it, _t(toks))
    np.testing.assert_allclose(
        tm.compute_logits(ht).numpy()[:2],
        np.asarray(jm.compute_logits(jparams, hj))[:2], rtol=1e-4, atol=1e-4)
    owned = [(int(bt[r, p // BS]), p % BS) for r in range(2) for p in range(seq_lens[r])]
    for got, want in ((kt, kj), (vt, vj)):
        got, want = got.numpy(), np.asarray(want)
        for blk, off in owned:
            np.testing.assert_allclose(got[:, blk, :, off], want[:, blk, :, off],
                                       rtol=1e-5, atol=1e-5)


def test_placement_other_than_identity_raises():
    kw = FAMILIES["qwen3_moe"]
    cfg = tcfg.ModelConfig(model_type="qwen3_moe", **kw)
    tree = random_param_tree(cfg, seed=0)
    tree["layers"]["expert_placement"][1] = np.roll(np.arange(8), 1)
    with pytest.raises(NotImplementedError, match="EPLB placements"):
        load_param_tree(tcreate(cfg, device="cpu"), tree)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _tiny_moe(c):
    """The qwen3-moe engine config of tests/test_moe.py."""
    return c.EngineConfig(
        model=c.ModelConfig(
            model_type="qwen3_moe", dtype="float32", vocab_size=128,
            hidden_size=32, intermediate_size=0, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=8,
            qk_norm=True, max_position_embeddings=64, num_experts=4,
            num_experts_per_tok=2, moe_intermediate_size=16,
            norm_topk_prob=True,
        ),
        cache=c.CacheConfig(block_size=16, num_blocks=16),
        scheduler=c.SchedulerConfig(
            max_seqs_per_batch=2, decode_batch_buckets=[2],
            prefill_token_buckets=[16], max_model_len=64,
        ),
    )


def test_greedy_generate_matches_jax_engine():
    tree = random_param_tree(_tiny_moe(tcfg).model, seed=5)
    prompts = [[3, 5, 7, 9], [2, 4, 6], [9, 1, 4, 4, 1, 7, 30, 2]]
    sp = dict(temperature=0.0, max_tokens=8, ignore_eos=True)

    jc = _tiny_moe(jcfg)
    runner = JRunner(jc)
    runner.load_model(params=jax.tree.map(jnp.asarray, tree))
    je = JEngine(jc, runner=runner)
    ids = [je.add_request(prompt_token_ids=p, sampling_params=JSP(**sp)).request_id
           for p in prompts]
    outs = {ro.request_id: ro.outputs[0].token_ids for ro in je.generate_all(timeout_s=600)}
    want = [outs[i] for i in ids]
    assert je.block_manager.num_used_blocks == 0

    llm = LLM(config=_tiny_moe(tcfg), device="cpu")
    llm.engine.runner.load_model(params=tree)
    got = [ro.outputs[0].token_ids
           for ro in llm.generate(prompt_token_ids=prompts,
                                  sampling_params=[TSP(**sp)] * len(prompts))]
    assert got == want
    assert all(len(g) == 8 for g in got)
    assert llm.engine.block_manager.num_used_blocks == 0
