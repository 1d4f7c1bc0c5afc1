"""The port's hybrid GatedDeltaNet / full-attention family (qwen3-next,
qwen3.5) against the JAX package's, on the CPU, from numpy seeds.

- ``Qwen3NextModel.prefill_batched`` (two chunks, the second resuming its
  row's state) and ``decode`` on a tiny f32 model (2 groups of 4 layers,
  head_dim 16, 4 experts; and its dense-MLP variant), weights carried by
  ``weights.py``: logits within 1e-4 of the JAX model's, the GatedDeltaNet
  states within 1e-5;
- greedy ``generate`` token-identical to the JAX ``LLMEngine``, and each
  case of JAX's ``tests/test_qwen3_next.py`` mirrored on the port: chunked
  prefill equals a single shot, batched rows are isolated, a RECOMPUTE
  preemption restores the state, the hybrid guards (speculative decoding,
  context parallelism, beam search, embeddings, scoring, the host tier and
  PD refused; the prefix cache off), int8 weights are consumed;
- the plain versions of K1 and K3 at head_dim 256 (Hq 4 / Hkv 2,
  block_size 16) against the Pallas kernels in interpret mode, within
  PERF.md section 2's P-rounding tolerance on grid inputs;
- the head_dim rules of the kernel wrappers (at 256: bf16 and f32 q on a
  cache of their own dtype or e4m3, never int8) and the D-256 launch plans
  (pure Python).

The JAX engine runs once, in a module fixture.
"""

import dataclasses

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
from xllm_tpu.ops.pallas import decode_attention as jdecode
from xllm_tpu.ops.pallas import prefill_attention as jprefill
from xllm_tpu.runtime import forward_params as jfp
from xllm_tpu.runtime.model_runner import ModelRunner as JRunner
from xllm_tpu_torch.engine import LLMEngine as TEngine
from xllm_tpu_torch.framework.sampling_params import SamplingParams as TSP
from xllm_tpu_torch.models.registry import create_model as tcreate
from xllm_tpu_torch.ops.cuda import _build
from xllm_tpu_torch.ops.cuda import decode_attention as tdecode
from xllm_tpu_torch.ops.cuda import prefill_attention as tprefill
from xllm_tpu_torch.runtime import forward_params as tfp
from xllm_tpu_torch.runtime.model_runner import ModelRunner as TRunner
from xllm_tpu_torch.weights import load_param_tree, random_param_tree
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platforms", "cpu")

MODEL = dict(
    model_type="qwen3_next", dtype="float32", vocab_size=128, hidden_size=32,
    intermediate_size=64, num_hidden_layers=8, num_attention_heads=4,
    num_key_value_heads=2, head_dim=16, partial_rotary_factor=0.25,
    max_position_embeddings=256, full_attention_interval=4, linear_conv_kernel_dim=3,
    linear_key_head_dim=8, linear_num_key_heads=2, linear_value_head_dim=8,
    linear_num_value_heads=4, num_experts=4, num_experts_per_tok=2,
    moe_intermediate_size=16, shared_expert_intermediate_size=32, norm_topk_prob=True,
)
PROMPT_LENS = (37, 9, 14)


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfg(c, chunk=16, num_blocks=32, max_seqs=4, **model):
    """The engine config of JAX's tests/test_qwen3_next.py at 2 groups."""
    return c.EngineConfig(
        model=c.ModelConfig(**dict(MODEL, **model)),
        cache=c.CacheConfig(num_blocks=num_blocks, block_size=8),
        scheduler=c.SchedulerConfig(
            max_seqs_per_batch=max_seqs, max_tokens_per_chunk_for_prefill=chunk,
            max_model_len=128, decode_batch_buckets=[max_seqs],
            prefill_token_buckets=[chunk]),
    )


def _prompts(seed=0, lens=PROMPT_LENS):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, 127, size=n)] for n in lens]


def _sp(cls, n=8):
    return cls(temperature=0.0, max_tokens=n, ignore_eos=True)


def _port_engine(tree, **kw):
    cfg = _cfg(tcfg, **kw)
    runner = TRunner(cfg, device="cpu")
    runner.load_model(params=tree)
    return TEngine(cfg, runner=runner, device="cpu")


def _generate(eng, prompts, sp):
    ids = [eng.add_request(prompt_token_ids=p, sampling_params=sp).request_id
           for p in prompts]
    outs = {o.request_id: list(o.outputs[0].token_ids) for o in eng.generate_all()}
    assert eng.block_manager.num_used_blocks == 0
    return [outs[i] for i in ids]


@pytest.fixture(scope="module")
def jax_run():
    """JAX's engine on the tiny model: its weights (numpy) and greedy tokens
    of ``_prompts()`` served together, and the engine itself."""
    with jax.default_matmul_precision("highest"):
        jr = JRunner(_cfg(jcfg))
        jr.load_model()
        tree = jax.tree.map(np.asarray, jr.params)
        je = JEngine(_cfg(jcfg), runner=jr)
        ids = [je.add_request(prompt_token_ids=p, sampling_params=_sp(JSP)).request_id
               for p in _prompts()]
        outs = {o.request_id: o.outputs[0].token_ids for o in je.generate_all(timeout_s=600)}
    return tree, [outs[i] for i in ids], je


# ---------------------------------------------------------------------------
# the model against the JAX model
# ---------------------------------------------------------------------------
BS, NB, NBMAX, SLOTS = 8, 16, 4, 4


def _prefill_arrays(rows, s):
    """rows: (state slot, table row, q_offset, ntok, tokens); one padded
    row after (the trash slot)."""
    bt = np.arange(1, 1 + 2 * NBMAX, dtype=np.int32).reshape(2, NBMAX)
    p = len(rows) + 1
    a = {n: np.zeros((p, s), np.int32) for n in ("token_ids", "positions", "slot_mapping")}
    a["block_tables"] = np.zeros((p, NBMAX), np.int32)
    for n in ("kv_lens", "q_offsets", "logits_idx", "sample_slots"):
        a[n] = np.zeros(p, np.int32)
    a["hist_slots"] = np.full(p, SLOTS, np.int32)
    for i, (slot, r, qo, n, toks) in enumerate(rows):
        pos = qo + np.arange(s)
        a["token_ids"][i, :n] = toks
        a["positions"][i] = np.minimum(pos, qo + n - 1)
        a["slot_mapping"][i, :n] = bt[r, pos[:n] // BS] * BS + pos[:n] % BS
        a["block_tables"][i] = bt[r]
        a["kv_lens"][i] = qo + n
        a["q_offsets"][i] = qo
        a["logits_idx"][i] = n - 1
        a["hist_slots"][i] = slot
    return a, bt


def _both(cls_j, cls_t, arrays):
    return (cls_j(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            cls_t(**{k: _t(v) for k, v in arrays.items()}))


@pytest.mark.parametrize("mlp", ["moe", "dense"])
def test_model_prefill_and_decode_match_jax(mlp):
    kw = dict(MODEL) if mlp == "moe" else dict(MODEL, num_experts=0)
    jm = jcreate(jcfg.ModelConfig(**kw))
    tm = tcreate(tcfg.ModelConfig(**kw), device="cpu")
    jm.num_state_slots = tm.num_state_slots = SLOTS
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.key(1)))
    rng = np.random.default_rng(6)
    for name in ("lin_A_log", "lin_dt_bias"):  # away from the init's constants
        params["groups"][name] = (params["groups"][name]
                                  + rng.standard_normal(params["groups"][name].shape) * 0.3
                                  ).astype(np.float32)
    load_param_tree(tm, params)
    jp = jax.tree.map(jnp.asarray, params)
    kj, vj = jm.new_kv_cache(NB, BS)
    kt, vt = tm.new_kv_cache(NB, BS)
    toks = {r: rng.integers(1, 127, n).astype(np.int32) for r, n in ((0, 12), (1, 5))}

    def logits_equal(hj, ht, rows):
        np.testing.assert_allclose(tm.compute_logits(ht).numpy()[rows],
                                   np.asarray(jm.compute_logits(jp, hj))[rows],
                                   rtol=1e-4, atol=1e-4)

    # chunk 1: row 0's first 8 tokens (slot 2), row 1's 5 (slot 0), a pad row
    a, bt = _prefill_arrays([(2, 0, 0, 8, toks[0][:8]), (0, 1, 0, 5, toks[1])], 8)
    ij, it = _both(jfp.BatchedPrefillInput, tfp.BatchedPrefillInput, a)
    hj, kj, vj = jm.prefill_batched(jp, kj, vj, ij)
    ht, _, _ = tm.prefill_batched(kt, vt, it)
    logits_equal(hj[:, 0], ht[:, 0], slice(0, 2))
    # chunk 2: row 0 resumes its slot at q_offset 8
    a, _ = _prefill_arrays([(2, 0, 8, 4, toks[0][8:])], 8)
    ij, it = _both(jfp.BatchedPrefillInput, tfp.BatchedPrefillInput, a)
    hj, kj, vj = jm.prefill_batched(jp, kj, vj, ij)
    ht, _, _ = tm.prefill_batched(kt, vt, it)
    logits_equal(hj[:, 0], ht[:, 0], slice(0, 1))
    # decode: both rows and a padded one
    seq_lens = np.asarray([13, 6, 0], np.int32)
    pos = np.maximum(seq_lens - 1, 0)
    dec = dict(
        slot_ids=np.asarray([2, 0, SLOTS], np.int32), positions=pos,
        slot_mapping=np.asarray([bt[i, pos[i] // BS] * BS + pos[i] % BS if seq_lens[i] else 0
                                 for i in range(3)], np.int32),
        block_tables=np.concatenate([bt, np.zeros((1, NBMAX), np.int32)]),
        seq_lens=seq_lens,
    )
    ij, it = _both(jfp.DecodeInput, tfp.DecodeInput, dec)
    new = np.asarray([11, 22, 0], np.int32)
    hj, kj, vj = jm.decode(jp, kj, vj, ij, jnp.asarray(new))
    ht, _, _ = tm.decode(kt, vt, it, _t(new))
    logits_equal(hj, ht, slice(0, 2))
    # the live slots' conv tails and recurrent states
    for got, want in zip(vt[1:], vj[1:]):
        np.testing.assert_allclose(got.numpy()[:, :, [0, 2]], np.asarray(want)[:, :, [0, 2]],
                                   rtol=1e-5, atol=1e-5)
    assert not vt[1][:, :, [1, 3]].any() and not vt[2][:, :, [1, 3]].any()


def test_weights_carry_the_group_stacks(jax_run):
    tree, _, _ = jax_run
    tm = tcreate(tcfg.ModelConfig(**MODEL), device="cpu")
    load_param_tree(tm, tree)
    assert tm.groups.lin_A_log.dtype == torch.float32
    assert tm.groups.lin_dt_bias.dtype == torch.float32
    for name, stack in tree["groups"].items():
        np.testing.assert_array_equal(getattr(tm.groups, name).numpy(), stack)
    # the random tree has the JAX tree's names and shapes
    ours = random_param_tree(tcfg.ModelConfig(**MODEL), seed=0)
    assert {k: v.shape for k, v in ours["groups"].items()} == {
        k: v.shape for k, v in tree["groups"].items()}
    bad = dict(tree, groups=dict(tree["groups"]))
    del bad["groups"]["lin_conv_w"]
    with pytest.raises(ValueError, match="groups tensors"):
        load_param_tree(tm, bad)


# ---------------------------------------------------------------------------
# the engine (JAX's tests/test_qwen3_next.py, mirrored)
# ---------------------------------------------------------------------------
def test_greedy_generate_matches_jax_engine(jax_run):
    tree, want, _ = jax_run
    got = _generate(_port_engine(tree), _prompts(), _sp(TSP))
    assert got == want
    assert all(len(g) == 8 for g in got)


def test_chunked_prefill_equals_single_shot(jax_run):
    """A prompt longer than the chunk budget gives the continuation of one
    processed in a single chunk (the conv tail and the state carry across
    chunks), and JAX's."""
    tree, want, _ = jax_run
    prompt = _prompts()[0]  # 37 tokens: chunks of 16, 16, 5
    outs = [_generate(_port_engine(tree, chunk=chunk, num_blocks=64), [prompt], _sp(TSP))[0]
            for chunk in (16, 48)]
    assert outs[0] == outs[1] == want[0]


def test_batched_rows_isolated(jax_run):
    """Sequences in one batch keep their own state: each matches its solo run."""
    tree, _, _ = jax_run
    p1, p2 = _prompts(1, (9, 14))
    solo = [_generate(_port_engine(tree), [p], _sp(TSP))[0] for p in (p1, p2)]
    assert _generate(_port_engine(tree), [p1, p2], _sp(TSP)) == solo


def test_preemption_recompute_restores_state(jax_run):
    """With a tiny block pool one sequence is preempted (RECOMPUTE) and
    replays its prompt into a fresh slot: the same tokens as alone."""
    tree, _, _ = jax_run
    p1, p2 = _prompts(2, (16, 16))
    want = _generate(_port_engine(tree, num_blocks=64), [p1], _sp(TSP, 12))[0]
    eng = _port_engine(tree, num_blocks=7, max_seqs=2)
    preempted = []
    schedule = eng.scheduler.schedule

    def watched():
        out = schedule()
        preempted.extend(out.preempted_requests)
        return out

    eng.scheduler.schedule = watched
    got = _generate(eng, [p1, p2], _sp(TSP, 12))
    assert preempted, "no preemption happened"
    assert got[0] == want
    assert len(got[1]) == 12


def test_hybrid_guards(jax_run):
    tree, _, je = jax_run
    cfg = _cfg(tcfg)
    cfg.speculative = tcfg.SpeculativeConfig(method="suffix")
    with pytest.raises(NotImplementedError, match="hybrid"):
        TEngine(cfg, device="cpu")
    cfg = _cfg(tcfg)
    cfg.parallel.cp_size = 2
    with pytest.raises(NotImplementedError, match="hybrid"):
        TEngine(cfg, device="cpu")
    eng = _port_engine(tree)
    assert eng.config.cache.enable_prefix_cache is False
    assert not eng.block_manager.enable_prefix_cache
    with pytest.raises(ValueError, match="beam"):
        eng.add_request(prompt_token_ids=[1, 2, 3], sampling_params=TSP(
            use_beam_search=True, best_of=2, max_tokens=4))
    with pytest.raises(NotImplementedError, match="hybrid"):
        eng.add_request(prompt_token_ids=[1, 2, 3], embed=True)
    with pytest.raises(NotImplementedError, match="single-sequence"):
        eng.score_prompt([1, 2, 3, 4])
    # the host tier and PD move pages only; JAX's runner fails there too
    # (its v_cache.ndim check meets the hybrid's state tuple)
    for call in (lambda: eng.runner.init_host_kv(4),
                 lambda: eng.runner.extract_blocks([1]),
                 lambda: eng.runner.inject_blocks(None, None, [1])):
        with pytest.raises(NotImplementedError, match="GatedDeltaNet"):
            call()
    with pytest.raises(AttributeError, match="ndim"):
        je.runner.init_host_kv(4)
    # int8 KV has no scale folding here, as in JAX
    cfg = _cfg(tcfg)
    cfg.cache.kv_cache_dtype = "int8"
    with pytest.raises(NotImplementedError, match="int8 KV"):
        TRunner(cfg, device="cpu").initialize_kv_cache()
    assert _generate(eng, [[5, 6, 7]], _sp(TSP, 3))  # still serves


def test_int8_weights_consumed_by_forward(jax_run):
    """The runner's catch-all quantizes the family's ``*_proj_w`` stacks
    (the shared expert's); the forward folds their scales back: greedy
    tokens of the int8 engine equal an f32 engine's on the round-tripped
    weights (JAX's test_int8_weights_consumed_by_forward)."""
    tree, _, _ = jax_run
    cfg = _cfg(tcfg)
    qcfg = dataclasses.replace(cfg, quant=tcfg.QuantConfig(method="int8"))
    runner = TRunner(qcfg, device="cpu")
    runner.load_model(params=tree)
    gp = runner.model.groups
    assert gp.shared_gate_proj_w.dtype == torch.int8 and hasattr(gp, "shared_gate_proj_w_scale")
    assert gp.experts_gate_up.dtype == torch.float32 and gp.router_w.dtype == torch.float32
    eng_q = TEngine(qcfg, runner=runner, device="cpu")

    def rt(w):
        w32 = w.astype(np.float32)
        s = np.maximum(np.abs(w32).max(axis=-2) / np.float32(127.0), np.float32(1e-8))
        q = np.clip(np.round(w32 / s[..., None, :]), -127, 127)
        return (q.astype(np.float32) * s[..., None, :]).astype(w.dtype)

    deq = dict(tree, groups={k: (rt(w) if k.endswith("_proj_w") else w)
                             for k, w in tree["groups"].items()})
    prompt = _prompts(7, (11,))
    assert _generate(eng_q, prompt, _sp(TSP, 6)) == _generate(_port_engine(deq), prompt,
                                                               _sp(TSP, 6))


# ---------------------------------------------------------------------------
# K1 and K3 at head_dim 256: the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------
D256, HQ, HKV, KBS = 256, 4, 2, 16
BF16_RTOL, ATOL = 2.0 ** -7, 1e-5  # PERF.md section 2: grid inputs


def _grid(rng, shape, step=2.0 ** -3, lim=3.0):
    n = int(lim / step)
    return (rng.integers(-n, n + 1, shape) * step).astype(np.float32)


def _pair(x, dtype: str):
    jx = jnp.asarray(x, getattr(jnp, dtype))
    return jx, _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))


def _within(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    excess = np.abs(got - want) - (ATOL + rtol * np.abs(want))
    assert (excess <= 0).all(), (np.abs(got - want).max(), (excess > 0).mean())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_plain_matches_v9_at_head_dim_256(dtype):
    rng = np.random.default_rng(21)
    lens = [20, 32, 9, 27]  # two pages at most
    bt = np.arange(1, 1 + 2 * len(lens), dtype=np.int32).reshape(len(lens), 2)
    nb = 1 + bt.size
    (jk, tk), (jv, tv) = (_pair(_grid(rng, (2, nb, HKV, KBS, D256)), dtype) for _ in range(2))
    jq, tq = _pair(_grid(rng, (len(lens), HQ, D256)), dtype)
    jkn, tkn = _pair(_grid(rng, (len(lens), HKV, D256)), dtype)
    jvn, tvn = _pair(rng.standard_normal((len(lens), HKV, D256)).astype(np.float32), dtype)
    sl = np.asarray(lens, np.int32)
    sm = np.asarray([bt[i, (n - 1) // KBS] * KBS + (n - 1) % KBS for i, n in enumerate(lens)],
                    np.int32)
    scale = 2.0 ** -4
    want, _, _ = jdecode.paged_decode_attention_write_v9_tpu(
        jq, jkn, jvn, jk, jv, jnp.int32(1), jnp.asarray(sm), jnp.asarray(bt), jnp.asarray(sl),
        scale, interpret=True)
    got = tdecode.paged_decode_attention_write_plain(tq, tkn, tvn, tk.clone(), tv.clone(), 1,
                                                     _t(sm), _t(bt), _t(sl), scale)
    _within(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            BF16_RTOL if dtype == "bfloat16" else 1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prefill_plain_matches_pallas_at_head_dim_256(dtype):
    rng = np.random.default_rng(22)
    s, rows = 16, [(16, 16), (0, 11)]  # a chunk on its second page, a fresh one
    bt = np.asarray([[1, 2], [3, 4]], np.int32)
    (jk, tk), (jv, tv) = (_pair(_grid(rng, (2, 5, HKV, KBS, D256)), dtype) for _ in range(2))
    jq, tq = _pair(_grid(rng, (len(rows), s, HQ, D256)), dtype)
    qo = np.asarray([r[0] for r in rows], np.int32)
    kvl = np.asarray([a + b for a, b in rows], np.int32)
    scale = 2.0 ** -4
    want = jprefill.paged_attention_prefill_batched_tpu(
        jq, jk, jv, jnp.int32(1), jnp.asarray(bt), jnp.asarray(qo), jnp.asarray(kvl), scale,
        interpret=True)
    got = tprefill.paged_attention_prefill_batched_plain(tq, tk, tv, 1, _t(bt), _t(qo),
                                                         _t(kvl), scale)
    want = np.asarray(want.astype(jnp.float32))
    for i, (_, n) in enumerate(rows):  # real rows only: the TPU kernel attends padding too
        _within(got[i, :n].float().numpy(), want[i, :n],
                BF16_RTOL if dtype == "bfloat16" else 1e-5)


# ---------------------------------------------------------------------------
# the D-256 rules and plans (pure Python)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d,work,cache,ok", [
    (128, torch.bfloat16, torch.int8, True), (64, torch.float32, torch.float8_e4m3fn, True),
    (256, torch.bfloat16, torch.bfloat16, True), (256, torch.float32, torch.float32, True),
    (256, torch.bfloat16, torch.int8, False), (256, torch.bfloat16, torch.float8_e4m3fn, True),
    (256, torch.float32, torch.bfloat16, False), (192, torch.bfloat16, torch.bfloat16, False),
    (256, torch.float32, torch.float8_e4m3fn, True), (256, torch.float32, torch.int8, False),
])
def test_check_head_dim_per_dtype_pair(d, work, cache, ok):
    if ok:
        _build.check_head_dim(d, work, cache)
    else:
        with pytest.raises(NotImplementedError, match="head_dim"):
            _build.check_head_dim(d, work, cache)


def test_head_dim_256_plans():
    # K1: an f32 block at head_dim 256 fills most of an SM; its cluster keeps
    # to the portable 8 (a bf16 one, two a SM, takes up to 16)
    for heads in (1, 2, 8):
        f32 = tdecode.plan(64, 64, 8, 256, torch.float32, heads=heads)
        bf = tdecode.plan(64, 64, 8, 256, torch.bfloat16, heads=heads)
        assert f32.cluster <= 8 and f32.smem <= 232448 and 2 * f32.smem > 233472
        assert 2 * bf.smem <= 233472
    assert tdecode.plan(64, 64, 8, 256, torch.bfloat16, heads=1).cluster == 16
    # K3: 64-row tiles and 64-key tiles at head_dim 256 (block_size 128's
    # pages take the first pass)
    assert tprefill.key_tile(128, 256) == 64 and tprefill.key_tile(128, 128) == 128
    assert tprefill.tensor_cores(torch.bfloat16, torch.bfloat16, 256)
    assert not tprefill.tensor_cores(torch.bfloat16, torch.int8, 256)
    assert not tprefill.tensor_cores(torch.float32, torch.float32, 256)
    # a 2048-token chunk at Hq 16 / Hkv 2: 2 x 2048 / 8 = 512 blocks, no split;
    # a 52-token chunk deep in its prompt splits its 4,096 positions
    assert tprefill.split_plan(1, 2048, 16, 2, 4096, 64, 256) == (4096, 1)
    chunk, nsplit = tprefill.split_plan(1, 64, 16, 2, 4096, 64, 256)
    assert nsplit > 1 and chunk % 64 == 0 and chunk * nsplit >= 4096
