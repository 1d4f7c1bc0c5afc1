"""Quantized MoE and MLA families in the port, against the JAX package.

- K10's plain version with an fp8 ``rhs`` against the Pallas ``gmm`` in
  interpret mode, and ``ops/moe.moe_mlp`` with fp8 expert stacks and their
  per-(expert, channel) scales against the JAX ``moe_mlp_gmm`` through it;
- K11a / K11b / K11e's plain versions on an fp8 latent cache (bf16 and f32
  q) against the Pallas kernels in interpret mode, and the fp8 latent
  writers K11c / K11d / K11f / K11g byte-equal to theirs;
- the JAX runner's quantized parameter trees of qwen3_moe, glm4_moe (shared
  experts, a dense first layer) and deepseek_v2 load byte for byte, with the
  JAX eligibility (every ``*_proj_w``; the expert stacks under fp8 only;
  never the router or ``kv_b_*``); an int8 latent cache raises, as in JAX;
- greedy tokens of the port on the CPU equal the JAX engine's through its
  Pallas kernels in interpret mode (the GQA, latent and grouped-GEMM
  kernels) for qwen3_moe with fp8 weights and an fp8 KV cache and for
  deepseek_v2 with fp8 weights and an fp8 latent cache, or int8 weights.

f32 models at tiny widths, inputs from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xllm_tpu.config as jcfg
import xllm_tpu.ops.attention as jattention
import xllm_tpu.ops.mla as jmla_ops
import xllm_tpu.ops.moe as jmoe
import xllm_tpu.ops.pallas.decode_attention as jdecode
import xllm_tpu.ops.pallas.kv_write as jkv_write
import xllm_tpu.ops.pallas.mla_attention as jmla
import xllm_tpu.ops.pallas.prefill_attention as jprefill
import xllm_tpu_torch.config as tcfg
from xllm_tpu.engine import LLMEngine as JEngine
from xllm_tpu.framework.sampling_params import SamplingParams as JSP
from xllm_tpu.ops.pallas.gmm import gmm as jgmm
from xllm_tpu.ops.quant import quantize_fp8 as jquantize_fp8
from xllm_tpu.runtime.model_runner import ModelRunner as JRunner
from xllm_tpu_torch.engine import LLMEngine as TEngine
from xllm_tpu_torch.framework.sampling_params import SamplingParams as TSP
from xllm_tpu_torch.ops import moe as tmoe
from xllm_tpu_torch.ops.cuda import kv_write as tkv
from xllm_tpu_torch.ops.cuda import mla_attention as tmla
from xllm_tpu_torch.ops.cuda.gmm import gmm_plain
from xllm_tpu_torch.runtime.model_runner import ModelRunner as TRunner
from xllm_tpu_torch.weights import as_tensor, load_param_tree, random_param_tree
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platforms", "cpu")


def _t(a) -> torch.Tensor:
    return as_tensor(np.asarray(a))


def _fp8(x: np.ndarray):
    """float8_e4m3fn values of ``x``: (jax array, torch tensor), same bytes."""
    j = jnp.asarray(x, jnp.float8_e4m3fn)
    return j, _t(j)


# ---------------------------------------------------------------------------
# K10 with an fp8 rhs, and the MoE block with fp8 expert stacks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lhs_dtype", ["float32", "bfloat16"])
def test_gmm_fp8_rhs_plain_matches_pallas(lhs_dtype):
    """K10's plain version with float8_e4m3fn ``rhs`` (the Pallas kernel
    upcasts its tiles to the lhs dtype) within K 2^-24 (|lhs| @ |rhs_e|) +
    1e-6, K10's card tolerance: the f32 sums in another order."""
    rng = np.random.default_rng(3)
    e, k, n, m = 4, 64, 128, 32
    wq, _ = jquantize_fp8(jnp.asarray(rng.standard_normal((e, k, n)) * 0.05, jnp.float32))
    x = jnp.asarray(rng.standard_normal((m, k)), getattr(jnp, lhs_dtype))
    sizes = np.array([10, 0, 14, 8], np.int32)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    want = np.asarray(jgmm(x, wq, jnp.asarray(offs), tm=8, tn=64, interpret=True))
    tx = _t(x.astype(jnp.float32)).to(getattr(torch, lhs_dtype))
    got = gmm_plain(tx, _t(wq), _t(offs)).numpy()
    eid = np.repeat(np.arange(e), sizes)
    wf = np.asarray(wq.astype(jnp.float32))
    bound = np.stack([np.abs(np.asarray(tx.float()))[r] @ np.abs(wf[eid[r]])
                      for r in range(m)]) * k * 2.0 ** -24 + 1e-6
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("scoring", ["softmax", "sigmoid"])
def test_moe_mlp_fp8_experts_match_jax(scoring):
    """``moe_mlp`` with fp8 stacks: K10 on the e4m3 weights, the scales on
    the f32 rows by expert before the activation and the combine, as the
    JAX ``moe_mlp_gmm`` through the Pallas gmm (interpret mode)."""
    rng = np.random.default_rng(5)
    t, d, i, e, k = 16, 32, 64, 8, 2
    x = rng.standard_normal((t, d)).astype(np.float32) * 0.3
    router = rng.standard_normal((d, e)).astype(np.float32) * 0.3
    gu, gus = jquantize_fp8(jnp.asarray(rng.standard_normal((e, d, 2 * i)) * 0.1, jnp.float32))
    dn, dns = jquantize_fp8(jnp.asarray(rng.standard_normal((e, i, d)) * 0.1, jnp.float32))
    kw = dict(scoring=scoring)
    if scoring == "sigmoid":
        kw["bias"] = rng.standard_normal(e).astype(np.float32) * 0.1
    want = jmoe.moe_mlp_gmm(
        jnp.asarray(x), jnp.asarray(router), gu, dn, k, True, interpret=True,
        gate_up_scale=gus, down_scale=dns,
        **{a: jnp.asarray(v) if isinstance(v, np.ndarray) else v for a, v in kw.items()})
    got = tmoe.moe_mlp(
        torch.from_numpy(x), torch.from_numpy(router), _t(gu), _t(dn), k, True,
        gate_up_scale=_t(gus), down_scale=_t(dns),
        **{a: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for a, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# K11 on an fp8 latent cache, and the fp8 latent writers
# ---------------------------------------------------------------------------
H, DK, DV, BS = 8, 128, 64, 16
LENS = [30, 50, 70, 90, 110, 120]


def _tables(lens, nbmax):
    bt = np.zeros((len(lens), nbmax), np.int32)
    nxt = 1
    for r, n in enumerate(lens):
        for j in range(-(-n // BS)):
            bt[r, j] = nxt
            nxt += 1
    return bt, nxt


def _q(rng, shape, q_dtype):
    """q on a grid that keeps every score exact in f32 against integer
    e4m3 pages, whatever the order of the dot (see test_torch_p_rounding)."""
    step, lim = (2.0 ** -3, 3.0) if q_dtype == "bfloat16" else (2.0 ** -6, 0.25)
    x = (rng.integers(-int(lim / step), int(lim / step) + 1, shape) * step).astype(np.float32)
    return jnp.asarray(x, getattr(jnp, q_dtype)), torch.from_numpy(x).to(getattr(torch, q_dtype))


@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("which", ["decode", "prefill_batched", "prefill"])
def test_mla_fp8_cache_plain_matches_pallas(which, q_dtype):
    """Pages upcast to bf16, P rounded to bf16 against the running maximum
    after each page, out in q's dtype: every valid output within 1e-5 +
    2^-7 |ref| (bf16 q) or 1e-5 (f32 q)."""
    rng = np.random.default_rng(7)
    scale = DK ** -0.5
    rtol = 2.0 ** -7 if q_dtype == "bfloat16" else 0.0
    if which == "decode":
        lens = LENS
    else:
        rows = [(48, 64), (32, 50)]
        lens = [a + n for a, n in rows]
    bt, nb = _tables(lens, max(-(-n // BS) for n in lens) + 1)
    jc, tc = _fp8(rng.integers(-16, 17, (2, nb + 1, 1, BS, DK)).astype(np.float32))
    if which == "decode":
        b = len(lens)
        jq, tq = _q(rng, (b, H, DK), q_dtype)
        jl, tl = _q(rng, (b, DK), q_dtype)  # cast to e4m3 on its way in
        sl = np.asarray(lens, np.int32)
        sm = np.asarray([bt[r, (n - 1) // BS] * BS + (n - 1) % BS
                         for r, n in enumerate(lens)], np.int32)
        want, jcache = jmla.mla_decode_attention_write_tpu(
            jq, jl, jc, jnp.int32(1), jnp.asarray(sm), jnp.asarray(bt), jnp.asarray(sl),
            scale, DV, interpret=True)
        tcache = tc.clone()
        got = tmla.mla_decode_attention_write_plain(tq, tl, tcache, 1, _t(sm), _t(bt), _t(sl),
                                                    scale, DV)
        assert np.array_equal(tcache.view(torch.uint8).numpy(),
                              np.asarray(jcache).view(np.uint8))
        valid = [np.s_[:]]
    else:
        s = 64
        jq, tq = _q(rng, (len(rows), s, H, DK), q_dtype)
        qo = np.asarray([a for a, _ in rows], np.int32)
        kl = np.asarray(lens, np.int32)
        if which == "prefill_batched":
            want = jmla.mla_prefill_attention_batched_tpu(
                jq, jc, jnp.int32(1), jnp.asarray(bt), jnp.asarray(qo), jnp.asarray(kl),
                scale, DV, interpret=True)
            got = tmla.mla_prefill_attention_batched_plain(tq, tc, 1, _t(bt), _t(qo), _t(kl),
                                                           scale, DV)
            valid = [np.s_[i, :n] for i, (_, n) in enumerate(rows)]  # both chunks
        else:
            want = jmla.mla_prefill_attention_tpu(
                jq[1], jc, jnp.int32(1), jnp.asarray(bt[1]), jnp.int32(qo[1]),
                jnp.int32(kl[1]), scale, DV, interpret=True)
            got = tmla.mla_prefill_attention_plain(
                tq[1], tc, 1, _t(bt[1]), torch.tensor(qo[1], dtype=torch.int32),
                torch.tensor(kl[1], dtype=torch.int32), scale, DV)
            valid = [np.s_[:rows[1][1]]]
    assert got.dtype == getattr(torch, q_dtype)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    for rows_valid in valid:
        diff = np.abs(got[rows_valid] - want[rows_valid])
        excess = diff - (1e-5 + rtol * np.abs(want[rows_valid]))
        assert (excess <= 0).all(), (rows_valid, diff.max())


E4M3_EDGES = [448.0, 456.0, 464.0, 480.0, 1000.0, float("inf"), -465.0, 2.0 ** -10, 0.0]


@pytest.mark.parametrize("which", ["prefill_batched", "rmw_batched", "prefill", "rmw"])
def test_fp8_latent_writers_match_pallas(which):
    """K11c / K11d / K11f / K11g on an fp8 latent cache: f32 rows cast to
    e4m3 with the JAX package's bytes (NaN above 464, the JAX dispatch casts
    before its writers), the same cache bytes."""
    rng = np.random.default_rng(9)
    rmw = which.startswith("rmw")
    s = 12 if rmw else 32
    rows = [(20, 12), (0, 0)] if rmw else [(0, 30), (16, 20)]
    bt, nb = _tables([max(a + n, 1) for a, n in rows], 8)
    jc, tc = _fp8(rng.standard_normal((2, nb + 1, 1, BS, DK)).astype(np.float32))
    lat = (rng.standard_normal((len(rows), s, DK)) * 100).astype(np.float32)
    lat[0, 0, :len(E4M3_EDGES)] = E4M3_EDGES
    qo = np.asarray([a for a, _ in rows], np.int32)
    nt = np.asarray([n for _, n in rows], np.int32)
    jlat = jnp.asarray(lat).astype(jnp.float8_e4m3fn)
    tcache = tc.clone()
    if which.endswith("batched"):
        jfn = (jkv_write.latent_write_rmw_batched_tpu if rmw
               else jkv_write.latent_write_prefill_batched_tpu)
        tfn = tkv.latent_write_rmw_batched if rmw else tkv.latent_write_prefill_batched
        want = jfn(jlat, jc, jnp.int32(1), jnp.asarray(bt), jnp.asarray(qo), jnp.asarray(nt),
                   interpret=True)
        tfn(torch.from_numpy(lat), tcache, 1, _t(bt), _t(qo), _t(nt))
    else:
        jfn = jkv_write.latent_write_rmw_tpu if rmw else jkv_write.latent_write_prefill_tpu
        tfn = tkv.latent_write_rmw if rmw else tkv.latent_write_prefill
        want = jfn(jlat[0], jc, jnp.int32(1), jnp.asarray(bt[0]), jnp.int32(qo[0]),
                   jnp.int32(nt[0]), interpret=True)
        tfn(torch.from_numpy(lat[0]), tcache, 1, _t(bt[0]),
            torch.tensor(qo[0], dtype=torch.int32), torch.tensor(nt[0], dtype=torch.int32))
    # the rows each chunk owns (the TPU writers also fill the rest of a page)
    got, want = tcache.view(torch.uint8).numpy(), np.asarray(want).view(np.uint8)
    for r, (a, n) in enumerate(rows if which.endswith("batched") else rows[:1]):
        for pos in range(a, a + n):
            blk, off = bt[r, pos // BS], pos % BS
            assert np.array_equal(got[1, blk, 0, off], want[1, blk, 0, off]), (r, pos)
    assert np.array_equal(got[0], np.asarray(jc).view(np.uint8)[0])  # other layers untouched


# ---------------------------------------------------------------------------
# parameter trees, eligibility, the int8 latent cache
# ---------------------------------------------------------------------------
_BASE = dict(dtype="float32", vocab_size=97, hidden_size=64, intermediate_size=96,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16, max_position_embeddings=128, eos_token_ids=[0],
             num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32)
MODELS = {
    "qwen3_moe": dict(_BASE, model_type="qwen3_moe", qk_norm=True),
    # a dense first layer, a shared expert, sigmoid routing, partial rope
    "glm4_moe": dict(_BASE, model_type="glm4_moe", first_k_dense_replace=1,
                     n_shared_experts=1, scoring_func="sigmoid",
                     partial_rotary_factor=0.5, norm_topk_prob=True),
    # MLA with q_lora_rank 0, a dense first layer, two shared experts
    "deepseek_v2": dict(_BASE, model_type="deepseek_v2", num_key_value_heads=4,
                        kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16,
                        v_head_dim=16, first_k_dense_replace=1, n_shared_experts=2),
}


def _config(c, model: str, quant: str = "", kv: str = "auto", head_dim: int = 16):
    cfg = c.EngineConfig(
        model=c.ModelConfig(**dict(MODELS[model], head_dim=head_dim)),
        cache=c.CacheConfig(block_size=16, num_blocks=64, kv_cache_dtype=kv),
        scheduler=c.SchedulerConfig(
            max_seqs_per_batch=4, max_tokens_per_chunk_for_prefill=32, max_model_len=128,
            decode_batch_buckets=[4], prefill_token_buckets=[16, 32]),
    )
    cfg.quant.method = quant
    return cfg


def _jax_quantized(model, quant, seed=3):
    cfg = _config(jcfg, model, quant)
    tree = random_param_tree(_config(tcfg, model).model, seed=seed)
    qtree = JRunner(cfg)._quantize_params(jax.tree.map(jnp.asarray, tree))
    return tree, jax.tree.map(np.asarray, qtree)


@pytest.mark.parametrize("quant", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("model", list(MODELS))
def test_quantized_tree_loads_byte_for_byte(model, quant):
    """The JAX runner's quantized tree loads into the port byte for byte,
    and the port's own quantization of the float tree gives the same tree."""
    tree, qtree = _jax_quantized(model, quant)
    cfg = _config(tcfg, model, quant)
    from_jax = _model(cfg)
    load_param_tree(from_jax, qtree)
    port = TRunner(cfg, device="cpu")
    port.load_model(params=tree)
    a = dict(from_jax.named_parameters())
    b = dict(port.model.named_parameters())
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(_raw(a[name]), _raw(b[name])), name


def _raw(p: torch.Tensor) -> torch.Tensor:
    return p.view(torch.uint8) if p.dtype.itemsize == 1 else p


def _model(cfg):
    from xllm_tpu_torch.models.registry import create_model

    return create_model(cfg.model, device="cpu", quant=cfg.quant.method)


@pytest.mark.parametrize("quant", ["int8", "fp8_e4m3"])
def test_quant_eligibility_matches_jax(quant):
    """The stacks the port stores quantized are the ones the JAX runner
    quantizes: every ``*_proj_w`` (attention, MLA q / kv_a / o, dense MLP,
    shared experts), the expert stacks under fp8 only; never the router or
    ``kv_b_*``."""
    for model in MODELS:
        _, qtree = _jax_quantized(model, quant)
        want = {name for group in qtree.values() if isinstance(group, dict)
                for name in group if name + "_scale" in group}
        m = _model(_config(tcfg, model, quant))
        got = {name.rsplit(".", 1)[-1] for name, p in m.named_parameters()
               if p.dtype in (torch.int8, torch.float8_e4m3fn)}
        assert got == want, (model, got ^ want)
        experts = {"experts_gate_up", "experts_down"}
        assert (experts <= got) == (quant == "fp8_e4m3")
        assert not got & {"router_w", "kv_b_nope_w", "kv_b_v_w"}
        assert all(TRunner.quant_eligible(n, quant) for n in got)


def test_int8_latent_cache_raises_as_jax():
    jc, tc = _config(jcfg, "deepseek_v2", kv="int8"), _config(tcfg, "deepseek_v2", kv="int8")
    with pytest.raises(NotImplementedError) as jerr:
        JEngine(jc)
    with pytest.raises(NotImplementedError) as terr:
        TEngine(tc, device="cpu")
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# greedy tokens against the JAX engine through its Pallas kernels
# ---------------------------------------------------------------------------
@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    """The JAX engine through its split-layout GQA kernels, its latent
    kernels and writers and (``moe_mlp_gmm``) its grouped GEMM, each in
    interpret mode. -> {kernel name: calls traced}."""
    monkeypatch.setattr(jattention, "_use_pallas", lambda *a, **k: True)
    monkeypatch.setattr(jmla_ops, "_use_pallas", lambda *a, **k: True)
    traced = {}
    kernels = [(jdecode, "paged_decode_attention_write_v9_tpu"),
               (jprefill, "paged_attention_prefill_batched_tpu"),
               (jmla, "mla_decode_attention_write_tpu"),
               (jmla, "mla_prefill_attention_batched_tpu")]
    kernels += [(jkv_write, n) for n in ("kv_write_prefill_batched_tpu",
                                         "kv_write_rmw_batched_tpu",
                                         "latent_write_prefill_batched_tpu",
                                         "latent_write_rmw_batched_tpu")]
    for mod, name in kernels:
        def interpreted(*a, _fn=getattr(mod, name), _name=name, **k):
            traced[_name] = traced.get(_name, 0) + 1
            return _fn(*a, interpret=True, **k)

        monkeypatch.setattr(mod, name, interpreted)
    gmm_path = jmoe.moe_mlp_gmm

    def moe_gmm(x, router_w, gate_up, down, k, norm, placement=None, mesh=None,
                return_counts=False, **kw):
        traced["gmm"] = traced.get("gmm", 0) + 1
        return gmm_path(x, router_w, gate_up, down, k, norm, interpret=True, **kw)

    for mod in ("xllm_tpu.models.moe_decoder", "xllm_tpu.models.mla_decoder"):
        monkeypatch.setattr(f"{mod}.moe_mlp", moe_gmm, raising=False)
    return traced


PROMPTS = [[3, 5, 7, 9, 11, 13], list(range(1, 25)), [9, 1, 4, 4, 1, 7, 30, 2]]


def _tokens(engine, sp_cls, prompts, **gen):
    sp = dict(temperature=0.0, max_tokens=5, ignore_eos=True)
    ids = [engine.add_request(prompt_token_ids=p, sampling_params=sp_cls(**sp)).request_id
           for p in prompts]
    outs = {ro.request_id: ro.outputs[0].token_ids for ro in engine.generate_all(**gen)}
    assert engine.block_manager.num_used_blocks == 0
    return [outs[i] for i in ids]


@pytest.mark.parametrize("model,quant,kv", [
    ("qwen3_moe", "fp8_e4m3", "fp8_e4m3"),
    ("deepseek_v2", "fp8_e4m3", "fp8_e4m3"),
    ("deepseek_v2", "int8", "auto"),
])
def test_quantized_greedy_matches_jax_kernels(model, quant, kv, jax_pallas_interpret):
    head_dim = 128 if model == "qwen3_moe" else 16  # the GQA kernels' head_dim
    tree = random_param_tree(_config(tcfg, model, head_dim=head_dim).model, seed=6)
    jc = _config(jcfg, model, quant, kv, head_dim)
    runner = JRunner(jc)
    runner.load_model(params=jax.tree.map(jnp.asarray, tree))
    want = _tokens(JEngine(jc, runner=runner), JSP, PROMPTS, timeout_s=600)
    tc = _config(tcfg, model, quant, kv, head_dim)
    trunner = TRunner(tc, device="cpu")
    trunner.load_model(params=tree)
    assert _tokens(TEngine(tc, runner=trunner), TSP, PROMPTS) == want
    assert "gmm" in jax_pallas_interpret
    attn = ("mla_decode_attention_write_tpu" if model == "deepseek_v2"
            else "paged_decode_attention_write_v9_tpu")
    assert attn in jax_pallas_interpret
