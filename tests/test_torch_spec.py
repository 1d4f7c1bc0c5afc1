"""Speculative decoding in ``xllm_tpu_torch`` on the CPU vs ``xllm_tpu``.

Held to the JAX package on inputs made from a seed with numpy:

- ``rejection_sample`` on greedy and sampled rows (JAX's gumbel noise
  handed in): equal tokens and counts, exactly;
- ``SuffixProposer`` and ``GlobalSuffixCache`` on a seeded fuzz: the same
  proposals;
- ``build_batched_verify_input``: every array equal;
- ``prefill_batched(return_hidden=True)`` of qwen3, qwen3_moe and
  deepseek_v2 (f32): the pre-final-norm states within 1e-5;
- suffix engines on qwen3, glm4_moe and deepseek_v2 (``tests/test_mtp.py``'s
  prompts and configurations) and ``tests/test_speculative.py``'s five
  drafting sequences over a row bucket of 2: greedy tokens identical to
  JAX's spec engine and to the port's spec-off engine, ``spec_stats``
  equal to JAX's, every KV block given back;
- on an fp8 cache, against JAX's engines through its Pallas kernels
  (interpret mode): spec-on and spec-off tokens each equal JAX's, and the
  two modes part on a near-tie in both packages;
- the layout rule: ``interleaved_rm`` serves ``interleaved`` under spec,
  as the JAX runner resolves it;
- no fallback: the verify pass's kernels on fake CUDA tensors raise when
  the build fails, and no plain version runs.

The JAX engines are shared by module-scoped fixtures.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xllm_tpu.config as jcfg
import xllm_tpu.ops.attention as jattention
import xllm_tpu.ops.pallas.decode_attention as jdecode
import xllm_tpu.ops.pallas.kv_write as jkv_write
import xllm_tpu.ops.pallas.prefill_attention as jprefill
import xllm_tpu_torch.config as tcfg
from test_torch_mla import _fake_cuda
from xllm_tpu.engine import LLMEngine as JEngine
from xllm_tpu.framework.request import Sequence as JSeq
from xllm_tpu.framework.request import StoppingChecker as JStop
from xllm_tpu.framework.sampling_params import SamplingParams as JSP
from xllm_tpu.framework.suffix_cache import GlobalSuffixCache as JGlobal
from xllm_tpu.framework.suffix_cache import SuffixProposer as JProposer
from xllm_tpu.models.registry import create_model as jcreate
from xllm_tpu.runtime.input_builder import build_batched_prefill_input as jbuild_prefill
from xllm_tpu.runtime.input_builder import build_batched_verify_input as jbuild_verify
from xllm_tpu.runtime.model_runner import ModelRunner as JRunner
from xllm_tpu.runtime.rejection_sampler import rejection_sample as jreject
from xllm_tpu_torch.engine import LLMEngine as TEngine
from xllm_tpu_torch.framework.request import Sequence as TSeq
from xllm_tpu_torch.framework.request import StoppingChecker as TStop
from xllm_tpu_torch.framework.sampling_params import SamplingParams as TSP
from xllm_tpu_torch.framework.suffix_cache import GlobalSuffixCache, SuffixProposer
from xllm_tpu_torch.models.registry import create_model as tcreate
from xllm_tpu_torch.ops import attention as tattention
from xllm_tpu_torch.ops.cuda import _build
from xllm_tpu_torch.ops.cuda import decode_attention as tdecode
from xllm_tpu_torch.ops.cuda import kv_write as tkv
from xllm_tpu_torch.ops.cuda import prefill_attention as tprefill
from xllm_tpu_torch.runtime.forward_params import BatchedPrefillInput
from xllm_tpu_torch.runtime.input_builder import build_batched_prefill_input
from xllm_tpu_torch.runtime.input_builder import build_batched_verify_input
from xllm_tpu_torch.runtime.model_runner import ModelRunner as TRunner
from xllm_tpu_torch.runtime.rejection_sampler import rejection_sample
from xllm_tpu_torch.weights import random_param_tree
from torch_threads import one_torch_thread  # noqa: F401

# tests/test_mtp.py's model widths and its MLA configuration (:127); the
# glm4_moe model adds sigmoid routing in two groups, a shared expert, a
# dense first layer and partial rotate-half rope
QWEN3 = dict(model_type="qwen3", dtype="float32", vocab_size=211, hidden_size=64,
             intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, qk_norm=True, max_position_embeddings=256)
MODELS = {
    "qwen3": QWEN3,
    "glm4_moe": dict(QWEN3, model_type="glm4_moe", qk_norm=False, attention_bias=True,
                     partial_rotary_factor=0.5, rope_interleaved=False,
                     scoring_func="sigmoid", n_group=2, topk_group=1,
                     routed_scaling_factor=1.5, first_k_dense_replace=1,
                     n_shared_experts=1, num_experts=8, num_experts_per_tok=2,
                     moe_intermediate_size=32, norm_topk_prob=True),
    "deepseek_v2": dict(QWEN3, model_type="deepseek_v2", qk_norm=False,
                        num_key_value_heads=4, q_lora_rank=32, kv_lora_rank=32,
                        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
}
# tests/test_mtp.py's prompts: 13 / 37 / 5 / 26 tokens
PROMPT_LENS = (13, 37, 5, 26)


def spec_config(c, model_kw: dict, method: str = "", k: int = 3, rows: int = 4):
    """tests/test_mtp.py's engine: block_size 8, chunks of 32, buckets 8 /
    32, ``rows`` sequences (its MLA test: 2)."""
    return c.EngineConfig(
        model=c.ModelConfig(**model_kw),
        cache=c.CacheConfig(num_blocks=64, block_size=8),
        scheduler=c.SchedulerConfig(
            max_seqs_per_batch=rows, max_tokens_per_chunk_for_prefill=32,
            max_model_len=256, decode_batch_buckets=[rows],
            prefill_token_buckets=[8, 32], prefill_row_buckets=[1, rows]),
        speculative=(c.SpeculativeConfig(method=method, num_speculative_tokens=k)
                     if method else c.SpeculativeConfig()),
    )


def serve(eng, sp_cls, prompts, max_tokens: int = 20) -> list[list[int]]:
    """Greedy tokens of ``prompts`` on ``eng``, in prompt order."""
    for i, ids in enumerate(prompts):
        eng.add_request(prompt_token_ids=list(ids), request_id=f"r{i}",
                        sampling_params=sp_cls(temperature=0.0, max_tokens=max_tokens,
                                               ignore_eos=True))
    outs = {o.request_id: o.outputs[0].token_ids for o in eng.generate_all(timeout_s=600)}
    assert eng.block_manager.num_used_blocks == 0
    return [outs[f"r{i}"] for i in range(len(prompts))]


def jax_engine(cfg, tree, jax_spec: bool = True):
    """The JAX engine of ``cfg`` on ``tree`` -> (engine, its draft head's
    parameters as numpy, or None). ``jax_spec=False`` drops the
    speculative method (JAX's spec-off engine)."""
    if not jax_spec:
        cfg.speculative = jcfg.SpeculativeConfig()
    runner = JRunner(cfg)
    runner.load_model(params=jax.tree.map(jnp.asarray, tree))
    head = (jax.tree.map(np.asarray, runner.head_params)
            if runner.head_params is not None else None)
    return JEngine(cfg, runner=runner), head


def port_engine(cfg, tree, head=None) -> TEngine:
    runner = TRunner(cfg, device="cpu")
    runner.load_model(params=tree, head_params=head)
    return TEngine(cfg, runner=runner)


def run_pairs(cases: dict) -> dict:
    """Each case ``(model_kw, method, prompts, max_tokens, k, rows,
    jax_spec)`` served on JAX's engine (spec on unless ``jax_spec`` is
    False), the port's spec engine and the port's spec-off engine, all on
    one seeded tree -> {case: dict of their tokens and both spec_stats}.
    The JAX engines run in threads (XLA compiles outside the GIL)."""
    trees = {name: random_param_tree(spec_config(tcfg, c[0]).model, seed=3)
             for name, c in cases.items()}

    def jax_side(name):
        model_kw, method, prompts, max_tokens, k, rows, jax_spec = cases[name]
        with jax.default_matmul_precision("highest"):
            je, head = jax_engine(spec_config(jcfg, model_kw, method, k, rows), trees[name],
                                  jax_spec)
            return serve(je, JSP, prompts, max_tokens), head, list(je.spec_stats)

    with ThreadPoolExecutor(len(cases)) as ex:
        jax_out = dict(zip(cases, ex.map(jax_side, cases)))
    runs = {}
    for name, (model_kw, method, prompts, max_tokens, k, rows, _) in cases.items():
        want, head, jax_stats = jax_out[name]
        te = port_engine(spec_config(tcfg, model_kw, method, k, rows), trees[name], head)
        got = serve(te, TSP, prompts, max_tokens)
        off = serve(port_engine(spec_config(tcfg, model_kw, rows=rows), trees[name]), TSP,
                    prompts, max_tokens)
        runs[name] = {"jax": want, "port": got, "port_off": off, "jax_stats": jax_stats,
                      "stats": te.spec_stats}
    return runs


def mtp_prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(1, 200, size=n).tolist() for n in PROMPT_LENS]


# ---------------------------------------------------------------------------
# rejection sampler
# ---------------------------------------------------------------------------
REJECT_CASES = ["accept_all", "reject_first", "partial", "no_draft", "padded_rows",
                "sampled"]


@pytest.mark.parametrize("case", REJECT_CASES)
def test_rejection_sample_matches_jax(case):
    """Tokens and counts equal JAX's exactly, on seeded logits with JAX's
    gumbel noise handed to the port."""
    rng = np.random.default_rng(REJECT_CASES.index(case))
    b, k, v = 4, 3, 50
    logits = rng.standard_normal((b, k + 1, v)).astype(np.float32) * 3
    temperature = np.zeros(b, np.float32)
    key = jax.random.key(7)
    noise = np.asarray(jax.random.gumbel(key, (b, k + 1, v), dtype=jnp.float32))
    target = logits.argmax(-1)
    if case == "sampled":
        temperature[:3] = (0.7, 1.0, 1e-7)
        t = np.maximum(temperature, 1e-6)[:, None, None]
        target = np.where(temperature[:, None] > 0, (logits / t + noise).argmax(-1), target)
    drafts = target[:, :k].copy()
    lens = np.full(b, k, np.int32)
    if case in ("reject_first", "sampled"):
        drafts[1, 0] = (drafts[1, 0] + 1) % v
    if case in ("partial", "sampled"):
        drafts[:, 2] = (drafts[:, 2] + 1) % v
        drafts[3, 1] = (drafts[3, 1] + 1) % v
    if case == "no_draft":
        lens[:] = 0
    if case == "padded_rows":  # the builder's pad rows: zero drafts, length 0
        drafts[2:] = 0
        lens[2:] = 0
        lens[1] = 2
    drafts = drafts.astype(np.int32)
    jt, jn = jax.jit(jreject)(jnp.asarray(drafts), jnp.asarray(lens), jnp.asarray(logits),
                     jnp.asarray(temperature), key)
    tt, tn = rejection_sample(torch.from_numpy(drafts), torch.from_numpy(lens),
                              torch.from_numpy(logits), torch.from_numpy(temperature),
                              gumbel=torch.from_numpy(noise.copy()))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tt.dtype == tn.dtype == torch.int32
    if case == "accept_all":
        assert (tn.numpy() == k + 1).all()
    if case in ("no_draft", "reject_first"):
        assert (tn.numpy()[1] == 1)


def test_rejection_sample_greedy_needs_no_noise():
    """Without a generator or noise every row takes the target's argmax:
    the runner skips the [B, k+1, V] draw when every row is greedy."""
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((3, 4, 30)).astype(np.float32))
    drafts = logits.argmax(-1)[:, :3].int()
    zeros = torch.zeros(3)
    lens = torch.full((3,), 3, dtype=torch.int32)
    a = rejection_sample(drafts, lens, logits, zeros)
    g = torch.Generator().manual_seed(0)
    b = rejection_sample(drafts, lens, logits, zeros, key=g)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert (a[1] == 4).all()


# ---------------------------------------------------------------------------
# suffix proposers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_suffix_proposers_match_jax(seed):
    """A seeded fuzz over small alphabets (so n-grams repeat): every
    proposal of the per-sequence and the global proposer equals JAX's."""
    rng = np.random.default_rng(seed)
    tp, jp = SuffixProposer(), JProposer()
    tg, jg = GlobalSuffixCache(max_tokens=300), JGlobal(max_tokens=300)
    toks = rng.integers(0, 6, 20).tolist()
    proposals = 0
    for step in range(120):
        toks.append(int(rng.integers(0, 6)))
        upto = len(toks) - int(rng.integers(0, 3))
        tp.extend(toks, upto)
        jp.extend(toks, upto)
        k = int(rng.integers(1, 6))
        want = jp.propose(toks, k)
        assert tp.propose(toks, k) == want
        proposals += bool(want)
        if step % 15 == 0:  # a finished generation joins the global cache
            gen = rng.integers(0, 8, int(rng.integers(1, 60))).tolist()
            tg.add(gen)
            jg.add(gen)
        tail = rng.integers(0, 8, int(rng.integers(1, 6))).tolist()
        assert tg.propose(tail, k) == jg.propose(tail, k)
    assert proposals > 50


# ---------------------------------------------------------------------------
# verify input builder
# ---------------------------------------------------------------------------
def _verify_seqs(seq_cls, stop_cls, sp_cls):
    """Three sequences after their last sample: one whose k + 1 positions
    cross a page, a fresh one, one deep in its table."""
    out = []
    for i, (n, blocks) in enumerate([(14, [3, 7, 9]), (5, [1, 2]), (30, [4, 5, 6, 8, 10])]):
        seq = seq_cls(list(range(1, n + 1)), sp_cls(), stop_cls(max_new_tokens=40, max_model_len=256))
        seq.num_computed_tokens = n - 1
        seq.block_ids = list(blocks)
        seq.slot_id = 2 * i + 1
        out.append(seq)
    return out


def test_build_batched_verify_input_matches_jax():
    drafts = [[4, 5, 6], [7], []]
    jseqs = _verify_seqs(JSeq, JStop, JSP)
    tseqs = _verify_seqs(TSeq, TStop, TSP)
    args = (3, 8, [2, 4], 12, 9)
    jinp, jd, jl, jrows = jbuild_verify(list(zip(jseqs, drafts)), *args)
    tinp, td, tl, trows = build_batched_verify_input(list(zip(tseqs, drafts)), *args)
    assert trows == jrows
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tl, jl)
    for name, value in vars(tinp).items():
        want = getattr(jinp, name)
        if value is None:
            assert want is None, name
            continue
        assert value.dtype == np.asarray(want).dtype, name
        np.testing.assert_array_equal(value, np.asarray(want), err_msg=name)
    assert tinp.kv_lens.tolist() == [17, 8, 33, 0]  # start + S; the pad row 0


# ---------------------------------------------------------------------------
# pre-norm hidden states
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", ["qwen3", "qwen3_moe", "deepseek_v2"])
def test_return_hidden_matches_jax(family):
    """prefill_batched(num_logits=4, return_hidden=True) over two chunks
    (one at q_offset 8): the [P, S, D] pre-final-norm states and the
    verify rows' hidden states within 1e-5 (f32)."""
    kw = (dict(QWEN3, model_type="qwen3_moe", num_experts=4, num_experts_per_tok=2,
               moe_intermediate_size=32) if family == "qwen3_moe" else MODELS[family])
    tc, jc = tcfg.ModelConfig(**kw), jcfg.ModelConfig(**kw)
    tree = random_param_tree(tc, seed=5)
    jm, tm = jcreate(jc), tcreate(tc)
    from xllm_tpu_torch.weights import load_param_tree

    load_param_tree(tm, tree)
    items = []
    for cls, stop, sp in ((JSeq, JStop, JSP), (TSeq, TStop, TSP)):
        a = cls(list(range(3, 23)), sp(), stop(max_new_tokens=8, max_model_len=256))
        a.block_ids, a.num_computed_tokens, a.slot_id = [1, 2, 3], 8, 0
        b = cls(list(range(40, 47)), sp(), stop(max_new_tokens=8, max_model_len=256))
        b.block_ids, b.slot_id = [4], 1
        items.append([(a, 12), (b, 7)])
    args = (8, [16], [2], 4, 5)
    jinp, _, _ = jbuild_prefill(items[0], *args)
    tinp, _, _ = build_batched_prefill_input(items[1], *args)
    with jax.default_matmul_precision("highest"):
        jk, jv = jm.new_kv_cache(8, 8, jnp.float32)
        # one XLA program (JAX's op-by-op dispatch compiles every op)
        fn = jax.jit(jm.prefill_batched, static_argnames=("num_logits", "return_hidden"))
        jh, _, _, jpre = fn(jax.tree.map(jnp.asarray, tree), jk, jv, jinp, num_logits=4,
                            return_hidden=True)
    tk, tv = tm.new_kv_cache(8, 8, torch.float32)
    inp = BatchedPrefillInput(**{k: torch.from_numpy(v) for k, v in vars(tinp).items()})
    with torch.inference_mode():
        th, _, _, tpre = tm.prefill_batched(tk, tv, inp, num_logits=4, return_hidden=True)
    assert tuple(tpre.shape) == (2, 16, kw["hidden_size"])
    # rows past each chunk's tokens are bucket padding: compare the real ones
    for i, n in enumerate((12, 7)):
        np.testing.assert_allclose(tpre[i, :n].numpy(), np.asarray(jpre)[i, :n],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# suffix engines
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def suffix_runs():
    """Each family's suffix engine run, once: JAX, the port, the port's
    spec-off engine, on tests/test_mtp.py's prompts and a repetitive one
    (so that drafts are proposed and accepted)."""
    prompts = mtp_prompts()
    prompts[2] = [5, 6, 7, 8] * 3
    return run_pairs({
        family: (kw, "suffix", prompts[:2] if family == "deepseek_v2" else prompts, 20, 3,
                 2 if family == "deepseek_v2" else 4, True)
        for family, kw in MODELS.items()})


@pytest.mark.parametrize("family", list(MODELS))
def test_suffix_engine_matches_jax(family, suffix_runs):
    r = suffix_runs[family]
    assert r["port"] == r["jax"]
    assert r["stats"] == r["jax_stats"]
    assert r["stats"][0] > 0


@pytest.mark.parametrize("family", list(MODELS))
def test_suffix_engine_equals_spec_off(family, suffix_runs):
    r = suffix_runs[family]
    assert r["port"] == r["port_off"]
    assert all(len(t) == 20 for t in r["port"])


def test_suffix_verify_beyond_largest_row_bucket():
    """tests/test_speculative.py:117: five sequences draft in one step over
    a row bucket of 2, so the engine verifies them in three dispatches."""
    kw = dict(model_type="qwen3", dtype="float32", vocab_size=64, hidden_size=32,
              intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, head_dim=8, qk_norm=True, max_position_embeddings=128)

    def cfg(c, spec):
        return c.EngineConfig(
            model=c.ModelConfig(**kw), cache=c.CacheConfig(block_size=16, num_blocks=64),
            scheduler=c.SchedulerConfig(max_seqs_per_batch=6, decode_batch_buckets=[6],
                                        prefill_token_buckets=[32],
                                        prefill_row_buckets=[1, 2], max_model_len=128),
            speculative=c.SpeculativeConfig(method="suffix" if spec else "",
                                            num_speculative_tokens=3),
            seed=7)

    tree = random_param_tree(cfg(tcfg, False).model, seed=7)
    prompts = [[5, 6, 7, 8] * 3] * 5
    with jax.default_matmul_precision("highest"):
        je, _ = jax_engine(cfg(jcfg, True), tree)
        want = serve(je, JSP, prompts, 16)
    te = port_engine(cfg(tcfg, True), tree)
    calls = []
    verify = te.runner.run_verify_batched
    te.runner.run_verify_batched = lambda pairs, k: calls.append(len(pairs)) or verify(pairs, k)
    got = serve(te, TSP, prompts, 16)
    assert got == want and all(t == got[0] and len(t) == 16 for t in got)
    assert te.spec_stats == je.spec_stats
    # the step where all five draft verifies them in dispatches of 2, 2, 1
    assert max(calls) == 2 and any(calls[i : i + 3] == [2, 2, 1] for i in range(len(calls)))



def test_quantized_cache_suffix_engine_matches_jax(monkeypatch):
    """On an fp8 cache the suffix engine gives JAX's suffix engine's greedy
    tokens and the spec-off engine JAX's spec-off tokens, JAX's attention
    and cache writers running as Pallas kernels in interpret mode (K3
    rounds P to bf16 a page at a time in the verify pass, K1 a 4-page tile
    at a time in a decode step). The two modes part at token 4 in both
    packages: a near-tie that the two roundings break differently, so a
    quantized cache does not give spec-on = spec-off, in JAX either."""
    monkeypatch.setattr(jattention, "_use_pallas", lambda *a, **k: True)
    for mod, name in ((jdecode, "paged_decode_attention_write_v9_tpu"),
                      (jkv_write, "kv_write_prefill_batched_tpu"),
                      (jkv_write, "kv_write_rmw_batched_tpu"),
                      (jprefill, "paged_attention_prefill_batched_tpu")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))
    kw = dict(QWEN3, vocab_size=1000, hidden_size=256, intermediate_size=512, head_dim=128)

    def cfg(c, spec):
        return c.EngineConfig(
            model=c.ModelConfig(**kw),
            cache=c.CacheConfig(block_size=16, num_blocks=32, kv_cache_dtype="fp8_e4m3"),
            scheduler=c.SchedulerConfig(max_seqs_per_batch=4, max_model_len=256,
                                        max_tokens_per_chunk_for_prefill=64,
                                        prefill_token_buckets=[16, 64],
                                        decode_batch_buckets=[2, 4]),
            speculative=(c.SpeculativeConfig(method="suffix", num_speculative_tokens=3)
                         if spec else c.SpeculativeConfig()))

    tree = random_param_tree(cfg(tcfg, False).model, seed=7)
    prompts = [np.random.default_rng(1).integers(1, 1000, 10).tolist()]
    jax_engines = [jax_engine(cfg(jcfg, spec), tree)[0] for spec in (False, True)]
    with ThreadPoolExecutor(2) as pool:  # XLA compiles outside the GIL
        want = list(pool.map(lambda e: serve(e, JSP, prompts, 8), jax_engines))
    for spec, je, toks in zip((False, True), jax_engines, want):
        te = port_engine(cfg(tcfg, spec), tree)
        assert serve(te, TSP, prompts, 8) == toks, spec
        assert te.spec_stats == je.spec_stats, spec
    off, on = want[0][0], want[1][0]
    assert on[:4] == off[:4] and on[4] != off[4], (on, off)

# ---------------------------------------------------------------------------
# layout rule, no fallback
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", ["suffix", "mtp"])
def test_spec_resolves_interleaved_rm_to_interleaved(method):
    """A spec engine asking for interleaved_rm (eligible without spec: Hkv
    8, block_size 16) serves interleaved, as the JAX runner resolves it."""
    kw = dict(QWEN3, num_attention_heads=16, num_key_value_heads=8, head_dim=16)
    layouts = []
    for c, runner_cls, extra in ((jcfg, JRunner, {}), (tcfg, TRunner, {"device": "cpu"})):
        cfg = spec_config(c, kw, method)
        cfg.cache.kv_layout, cfg.cache.block_size = "interleaved_rm", 16
        runner = runner_cls(cfg, **extra)
        runner.initialize_kv_cache(16)
        layouts.append(runner.model.kv_layout)
        cfg.speculative = c.SpeculativeConfig()
        plain = runner_cls(cfg, **extra)
        plain.initialize_kv_cache(16)
        assert plain.model.kv_layout == "interleaved_rm"
    assert layouts == ["interleaved", "interleaved"]


@pytest.mark.parametrize("kernel", ["K4", "K3", "K1"])
def test_spec_kernels_on_cuda_tensors_do_not_fall_back(kernel, monkeypatch):
    """The verify pass's kernels at S = k + 1 (K4's write, K3's attention)
    and the draft head's decode (K1) on fake CUDA tensors: a failed build
    raises, no plain version runs and no launch is counted."""
    def failed_build(stem):
        raise RuntimeError(f"CUDA kernel build failed: csrc/{stem}.cu")

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(_build, "load", failed_build)
    for mod in (tkv, tprefill, tdecode):
        monkeypatch.setattr(mod, "_lib", None)
    monkeypatch.setattr(tkv, "kv_write_rows_plain", no_plain)
    monkeypatch.setattr(tprefill, "paged_attention_prefill_batched_plain", no_plain)
    monkeypatch.setattr(tdecode, "_split_plain", no_plain)
    f = _fake_cuda
    cache = f(torch.zeros(1, 4, 2, 16, 128, dtype=torch.bfloat16))
    bt = f(torch.ones(1, 2, dtype=torch.int32))
    before = dict(_build.launch_counts)
    with pytest.raises(RuntimeError, match="build failed"):
        if kernel == "K4":  # four rows from position 14 of a 16-row page
            rows = f(torch.zeros(1, 4, 2, 128, dtype=torch.bfloat16))
            tkv.kv_write_rmw_batched(rows, rows, cache, cache, 0, bt,
                                     f(torch.tensor([14], dtype=torch.int32)),
                                     f(torch.tensor([4], dtype=torch.int32)))
        elif kernel == "K3":
            q = f(torch.zeros(1, 4, 4, 128, dtype=torch.bfloat16))
            tprefill.paged_attention_prefill_batched(
                q, cache, cache, 0, bt, f(torch.tensor([14], dtype=torch.int32)),
                f(torch.tensor([18], dtype=torch.int32)), 0.1)
        else:
            q = f(torch.zeros(1, 4, 128, dtype=torch.bfloat16))
            kv = f(torch.zeros(1, 2, 128, dtype=torch.bfloat16))
            tattention.decode_attention_write(
                q, kv, kv, cache, cache, 0, f(torch.tensor([15], dtype=torch.int32)), bt,
                f(torch.tensor([16], dtype=torch.int32)), 0.1)
    assert _build.launch_counts == before
