"""The MTP draft head of ``xllm_tpu_torch`` on the CPU vs ``xllm_tpu``.

- ``MTPHead.prefill_batched`` (a prompt chunk, and a verify chunk with
  explicit next tokens) and ``MTPHead.draft_tokens``, with the JAX head's
  weights carried over (``weights.load_mtp_head_params``), on a qwen3 and a
  deepseek_v2 target: the head's caches within 1e-5 (f32) and the drafts
  identical;
- MTP engines on ``tests/test_mtp.py``'s configurations and prompts (qwen3
  with 13 / 37 / 5 / 26-token prompts at k = 3, the 70 / 101-token prompts
  at k = 2, the MLA configuration of its :127 at k = 2): greedy tokens
  identical to JAX's MTP engine and to the port's spec-off engine,
  ``spec_stats`` equal to JAX's, every KV block given back;
- glm4_moe: JAX's head cannot serve it (its head layer has no
  ``qkv_proj_b`` for the attention bias, and its rope frequencies span the
  full head_dim where the target rotates half), so the port's MTP engine
  is held to JAX's spec-off engine and to its own.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xllm_tpu.config as jcfg
import xllm_tpu_torch.config as tcfg
from test_torch_spec import MODELS, mtp_prompts, run_pairs, spec_config
from torch_threads import one_torch_thread  # noqa: F401
from xllm_tpu.framework.request import Sequence as JSeq
from xllm_tpu.framework.request import StoppingChecker as JStop
from xllm_tpu.framework.sampling_params import SamplingParams as JSP
from xllm_tpu.models.mtp_head import MTPHead as JHead
from xllm_tpu.models.registry import create_model as jcreate
from xllm_tpu.runtime.input_builder import build_batched_prefill_input as jbuild
from xllm_tpu_torch.framework.request import Sequence as TSeq
from xllm_tpu_torch.framework.request import StoppingChecker as TStop
from xllm_tpu_torch.framework.sampling_params import SamplingParams as TSP
from xllm_tpu_torch.models.mtp_head import MTPHead
from xllm_tpu_torch.models.registry import create_model as tcreate
from xllm_tpu_torch.runtime.forward_params import BatchedPrefillInput
from xllm_tpu_torch.runtime.input_builder import build_batched_prefill_input
from xllm_tpu_torch.weights import load_mtp_head_params, load_param_tree, random_param_tree

TOL = dict(rtol=1e-5, atol=1e-5)  # f32, the same products in another order


def _chunks(cls, stop, sp):
    """A fresh 12-token chunk and a 7-token one at q_offset 8 (block_size 8)."""
    a = cls(list(range(3, 23)), sp(), stop(max_new_tokens=8, max_model_len=256))
    a.block_ids, a.num_computed_tokens, a.slot_id = [1, 2, 3], 8, 0
    b = cls(list(range(40, 52)), sp(), stop(max_new_tokens=8, max_model_len=256))
    b.block_ids, b.slot_id = [4, 5], 1
    return [(a, 12), (b, 7)]


@pytest.mark.parametrize("family", ["qwen3", "deepseek_v2"])
def test_head_caches_and_drafts_match_jax(family):
    kw = MODELS[family]
    tc, jc = tcfg.ModelConfig(**kw), jcfg.ModelConfig(**kw)
    tree = random_param_tree(tc, seed=5)
    params = jax.tree.map(jnp.asarray, tree)
    jm, tm = jcreate(jc), tcreate(tc)
    load_param_tree(tm, tree)
    jhead = JHead(jc, jm)
    hp = jhead.init_params(jax.random.key(4))
    head = MTPHead(tc, tm)
    load_mtp_head_params(head, jax.tree.map(np.asarray, hp))

    rng = np.random.default_rng(9)
    hidden = rng.standard_normal((2, 16, kw["hidden_size"])).astype(np.float32)
    args = (8, [16], [2], 4, 5)
    jinp, _, _ = jbuild(_chunks(JSeq, JStop, JSP), *args)
    tinp_np, _, _ = build_batched_prefill_input(_chunks(TSeq, TStop, TSP), *args)
    tinp = BatchedPrefillInput(**{k: torch.from_numpy(v) for k, v in vars(tinp_np).items()})
    nxt = rng.integers(1, 200, (2, 16)).astype(np.int32)
    dk, dv = head.new_kv_cache(8, 8)
    assert tuple(dk.shape) == (1, 8, jc.num_kv_heads, 8, jc.head_dim)
    # one XLA program a call (JAX's op-by-op dispatch compiles every op)
    jprefill = jax.jit(jhead.prefill_batched)
    jdraft = jax.jit(jhead.draft_tokens, static_argnums=10)
    with jax.default_matmul_precision("highest"):
        jdk, jdv = jhead.new_kv_cache(8, 8)
        jdk, jdv = jprefill(params, hp, jdk, jdv, jnp.asarray(hidden), jinp)
        # the verify pass's rewrite: explicit next tokens
        jdk, jdv = jprefill(params, hp, jdk, jdv, jnp.asarray(hidden), jinp,
                            tokens_next=jnp.asarray(nxt))
        # three drafts from positions 19 and 11 (the next page of each)
        pos = np.asarray([19, 11], np.int32)
        tables = np.asarray([[1, 2, 3, 6], [4, 5, 7, 0]], np.int32)
        slots = np.stack([tables[i, (pos[i] + j) // 8] * 8 + (pos[i] + j) % 8
                          for j in range(3) for i in range(2)]).reshape(3, 2).T
        last = rng.standard_normal((2, kw["hidden_size"])).astype(np.float32)
        toks = np.asarray([17, 99], np.int32)
        jd, jdk2, jdv2 = jdraft(params, hp, jdk, jdv, jnp.asarray(last),
                                          jnp.asarray(toks), jnp.asarray(pos),
                                          jnp.asarray(slots.astype(np.int32)),
                                          jnp.asarray(tables), jnp.asarray(pos + 1), 3)
    with torch.inference_mode():
        head.prefill_batched(dk, dv, torch.from_numpy(hidden), tinp)
        head.prefill_batched(dk, dv, torch.from_numpy(hidden), tinp,
                             tokens_next=torch.from_numpy(nxt))
        live = [1, 2, 3, 4, 5]  # the blocks the two chunks wrote
        for got, want in ((dk, jdk), (dv, jdv)):
            np.testing.assert_allclose(got[:, live].numpy(), np.asarray(want)[:, live], **TOL)
        drafts = head.draft_tokens(dk, dv, torch.from_numpy(last), torch.from_numpy(toks),
                                   torch.from_numpy(pos), torch.from_numpy(slots.astype(np.int32)),
                                   torch.from_numpy(tables), torch.from_numpy(pos + 1), 3)
    assert drafts.dtype == torch.int32 and tuple(drafts.shape) == (2, 3)
    np.testing.assert_array_equal(drafts.numpy(), np.asarray(jd))
    for got, want in ((dk, jdk2), (dv, jdv2)):
        np.testing.assert_allclose(got[:, live].numpy(), np.asarray(want)[:, live], **TOL)


# (family, prompts, max_tokens, k, rows): tests/test_mtp.py's cases
MTP_CASES = {
    "qwen3": ("qwen3", None, 20, 3, 4),
    "qwen3-chunked": ("qwen3", (12, (70, 101)), 30, 2, 4),
    "deepseek_v2": ("deepseek_v2", (17, (11, 23)), 14, 2, 2),
    "glm4_moe": ("glm4_moe", None, 20, 3, 4),
}


@pytest.fixture(scope="module")
def mtp_runs():
    cases = {}
    for name, (family, spec, max_tokens, k, rows) in MTP_CASES.items():
        if spec is None:
            prompts = mtp_prompts()
        else:
            rng = np.random.default_rng(spec[0])
            prompts = [rng.integers(1, 200, size=n).tolist() for n in spec[1]]
        cases[name] = (MODELS[family], "mtp", prompts, max_tokens, k, rows,
                       family != "glm4_moe")
    return run_pairs(cases)


@pytest.mark.parametrize("case", list(MTP_CASES))
def test_mtp_engine_matches_jax(case, mtp_runs):
    """Tokens equal JAX's MTP engine (glm4_moe: JAX's spec-off engine) and
    spec_stats equal JAX's."""
    r = mtp_runs[case]
    assert r["port"] == r["jax"]
    if case != "glm4_moe":
        assert r["stats"] == r["jax_stats"]
    assert r["stats"][0] > 0


@pytest.mark.parametrize("case", list(MTP_CASES))
def test_mtp_engine_equals_spec_off(case, mtp_runs):
    r = mtp_runs[case]
    assert r["port"] == r["port_off"]
    assert all(len(t) == MTP_CASES[case][2] for t in r["port"])


def test_mtp_runner_head_from_seed(caplog):
    """Without head_params the head starts from config.seed + 1 (norms 1,
    weights N(0, 0.02)), its cache is the model dtype whatever the target's
    KV dtype, and a draft_model_path that cannot be read keeps that init
    with a warning (JAX's best-effort head loading; a readable one:
    tests/test_torch_loader.py)."""
    from xllm_tpu_torch.runtime.model_runner import ModelRunner

    cfg = spec_config(tcfg, MODELS["qwen3"], "mtp")
    cfg.cache.kv_cache_dtype = "int8"
    runner = ModelRunner(cfg, device="cpu")
    runner.load_model()
    runner.initialize_kv_cache(16)
    head = runner.draft_head
    assert runner.k_cache.dtype == torch.int8 and runner.dk_cache.dtype == torch.float32
    assert (head.enorm == 1).all() and abs(head.eh_proj.std().item() - 0.02) < 2e-3
    again = ModelRunner(cfg, device="cpu")
    again.load_model()
    assert torch.equal(again.draft_head.eh_proj, head.eh_proj)
    cfg.speculative.draft_model_path = "/nonexistent"
    unread = ModelRunner(cfg, device="cpu")
    with caplog.at_level(logging.WARNING):
        unread.load_model()
    assert "cannot read /nonexistent" in caplog.text
    assert torch.equal(unread.draft_head.eh_proj, head.eh_proj)
