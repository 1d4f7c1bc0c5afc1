"""The scheduler policies and ``/v1/sample``'s engine path: ``xllm_tpu_torch``
on the CPU vs ``xllm_tpu``.

- ``MixScheduler`` / ``ProfileManager``: the cases of
  ``tests/test_mix_scheduler.py``, each run on both packages' classes; the
  schedules (prefill items, decode sequences, preemptions) must be equal,
  and the port's must pass the JAX test's assertions; where a page alone
  exceeds the budget, JAX's walk schedules nothing (its engine would spin
  forever) and the port's takes one page;
- engines under ``policy="mix"`` (with a step latency budget) and under
  ``ttft_budget_ms``: the per-step schedules and greedy tokens equal JAX's
  engine on the same requests (tiny f32). Step wall times differ between
  the packages, so both engines' predictors are fitted from the same
  synthetic samples and never refitted; a third engine checks that the
  predictors fit from real step times;
- forward interruption: ``tests/test_interruption.py``'s bus and engine
  cases (the engine's steps equal JAX's);
- ``LLMEngine.sample_slots`` (one batched prefill pass): greedy tokens and
  top ids equal JAX's, logprobs within 1e-5, and JAX's two refusals.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import xllm_tpu.config as jcfg
import xllm_tpu_torch.config as tcfg
from xllm_tpu.common.interruption import InterruptionBus as JBus
from xllm_tpu.engine import LLMEngine as JEngine
from xllm_tpu.framework import request as jreq
from xllm_tpu.framework.block_manager import BlockManager as JBM
from xllm_tpu.framework.sampling_params import SamplingParams as JSP
from xllm_tpu.runtime.model_runner import ModelRunner as JRunner
from xllm_tpu.scheduler.mix import MixScheduler as JMix
from xllm_tpu.scheduler.profile import ProfileManager as JPM
from xllm_tpu_torch.common.interruption import InterruptionBus as TBus
from xllm_tpu_torch.engine import LLMEngine as TEngine
from xllm_tpu_torch.framework import request as treq
from xllm_tpu_torch.framework.block_manager import BlockManager as TBM
from xllm_tpu_torch.framework.sampling_params import SamplingParams as TSP
from xllm_tpu_torch.runtime.model_runner import ModelRunner as TRunner
from xllm_tpu_torch.scheduler.mix import MixScheduler as TMix
from xllm_tpu_torch.scheduler.profile import ProfileManager as TPM
from xllm_tpu_torch.weights import random_param_tree
from torch_threads import one_torch_thread  # noqa: F401

PKGS = {
    "jax": types.SimpleNamespace(cfg=jcfg, req=jreq, BM=JBM, Mix=JMix, PM=JPM, SP=JSP),
    "torch": types.SimpleNamespace(cfg=tcfg, req=treq, BM=TBM, Mix=TMix, PM=TPM, SP=TSP),
}


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


# ---------------------------------------------------------------------------
# MixScheduler units (tests/test_mix_scheduler.py), on both packages
# ---------------------------------------------------------------------------
def make_request(p, rid, prompt_len, max_tokens=8, priority=0, offline=False):
    return p.req.Request(
        request_id=rid,
        prompt_token_ids=list(range(1, prompt_len + 1)),
        sampling_params=p.SP(max_tokens=max_tokens, ignore_eos=True),
        max_model_len=256,
        priority=priority,
        offline=offline,
    )


def make_scheduler(p, num_blocks=64, block_size=4, chunk=16, max_seqs=8,
                   latency_ms=0.0, profile=None):
    bm = p.BM(num_blocks, block_size)
    cfg = p.cfg.SchedulerConfig(
        max_seqs_per_batch=max_seqs,
        max_tokens_per_chunk_for_prefill=chunk,
        max_model_len=256,
        policy="mix",
        step_latency_budget_ms=latency_ms,
    )
    cfg.resolve_buckets()
    return p.Mix(cfg, bm, profile), bm


def complete_prefill(out):
    for seq, n in out.prefill_items:
        seq.num_computed_tokens += n
        if seq.num_computed_tokens == seq.num_tokens:
            seq.append_token(7)


def fitted_profile(p, prefill_us_per_tok=10.0, decode_us_per_seq=100.0, refit_every=1):
    """A ProfileManager with linear models fitted from synthetic samples."""
    pm = p.PM(refit_every=refit_every)
    for n in (1, 64, 128, 512, 1024):
        pm.observe_prefill(n, n * prefill_us_per_tok / 1e6)
    for b in (1, 2, 8, 32, 128):
        pm.observe_decode(b, b * decode_us_per_seq / 1e6)
    pm.prefill.fit()
    pm.decode.fit()
    return pm


def summary(out) -> dict:
    return {
        "prefill": [(s.request_id, n) for s, n in out.prefill_items],
        "decode": [s.request_id for s in out.decode_seqs],
        "preempted": [r.request_id for r in out.preempted_requests],
    }


def case_mixed_step(p):
    sched, _ = make_scheduler(p)
    sched.add_request(make_request(p, "a", 8))
    out1 = sched.schedule()
    assert {s.request_id for s, _ in out1.prefill_items} == {"a"}
    complete_prefill(out1)
    sched.add_request(make_request(p, "b", 8))
    out2 = sched.schedule()
    # one step carries b's prefill AND a's decode
    assert {s.request_id for s, _ in out2.prefill_items} == {"b"}
    assert {s.request_id for s in out2.decode_seqs} == {"a"}
    return [summary(out1), summary(out2)]


def case_priority_crowds_out(p):
    pm = fitted_profile(p, prefill_us_per_tok=50.0, decode_us_per_seq=50.0)
    sched, _ = make_scheduler(p, latency_ms=1.0, profile=pm, chunk=64)
    for rid in ("low-1", "low-2"):
        sched.add_request(make_request(p, rid, 8))
    out1 = sched.schedule()
    complete_prefill(out1)
    sched.add_request(make_request(p, "hi", 16, priority=9))
    out2 = sched.schedule()
    assert {s.request_id for s, _ in out2.prefill_items} == {"hi"}
    assert all(s.request_id.startswith("low") for s in out2.decode_seqs)
    return [summary(out1), summary(out2)]


def case_latency_caps_chunk(p):
    pm = fitted_profile(p, prefill_us_per_tok=100.0)
    # 0.5 ms budget / 100 us per token -> ~5 tokens -> page-aligned 4
    sched, _ = make_scheduler(p, latency_ms=0.5, profile=pm, chunk=64)
    sched.add_request(make_request(p, "a", 40))
    out = sched.schedule()
    assert [n for _, n in out.prefill_items] == [4]
    return [summary(out)]


def case_unfitted_profile(p):
    sched, _ = make_scheduler(p, latency_ms=0.1, profile=p.PM())
    sched.add_request(make_request(p, "a", 16))
    out = sched.schedule()
    assert [(s.request_id, n) for s, n in out.prefill_items] == [("a", 16)]
    return [summary(out)]


def case_preempts_lower_class(p):
    sched, bm = make_scheduler(p, num_blocks=8, block_size=4, chunk=16, max_seqs=4)
    sched.add_request(make_request(p, "off", 4, offline=True))
    out1 = sched.schedule()
    complete_prefill(out1)
    sched.add_request(make_request(p, "on", 4))
    out2 = sched.schedule()
    complete_prefill(out2)
    bm.free_lru.clear()
    out3 = sched.schedule()
    assert [r.request_id for r in out3.preempted_requests] == ["off"]
    assert {s.request_id for s in out3.decode_seqs} == {"on"}
    return [summary(out1), summary(out2), summary(out3)]


def case_offline_waits(p):
    sched, _ = make_scheduler(p, max_seqs=1)
    sched.add_request(make_request(p, "off", 8, offline=True))
    sched.add_request(make_request(p, "on", 8))
    out = sched.schedule()
    assert {s.request_id for s, _ in out.prefill_items} == {"on"}
    return [summary(out)]


def case_profile_inversions(p):
    """ProfileManager's predictions and inversions (pure numpy)."""
    pm = fitted_profile(p, prefill_us_per_tok=37.0, decode_us_per_seq=91.0)
    return [[pm.predict_prefill_s(n) for n in (1, 100, 3000)],
            [pm.predict_tpot_s(b) for b in (1, 16, 200)],
            pm.max_prefill_tokens_for_ttft(0.05), pm.max_decode_batch_for_tpot(0.002),
            p.PM().max_prefill_tokens_for_ttft(1.0)]


def test_budget_below_a_page_still_progresses():
    """A step latency budget below one page's predicted cost: JAX's walk
    schedules nothing, and an engine would spin on empty steps forever; the
    port's first unit of an empty step takes one page."""
    runs = {}
    for name, p in PKGS.items():
        pm = fitted_profile(p, prefill_us_per_tok=1000.0)  # a page ~4 ms
        sched, _ = make_scheduler(p, latency_ms=1.0, profile=pm, chunk=64)
        sched.add_request(make_request(p, "a", 40))
        runs[name] = summary(sched.schedule())
    assert runs["jax"]["prefill"] == []
    assert runs["torch"]["prefill"] == [("a", 4)]


@pytest.mark.parametrize("case", [
    case_mixed_step, case_priority_crowds_out, case_latency_caps_chunk,
    case_unfitted_profile, case_preempts_lower_class, case_offline_waits,
    case_profile_inversions,
], ids=lambda f: f.__name__.removeprefix("case_"))
def test_mix_scheduler_matches_jax(case):
    assert case(PKGS["torch"]) == case(PKGS["jax"])


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------
def tiny_config(c, **sched):
    return c.EngineConfig(
        model=c.ModelConfig(
            model_type="qwen3", dtype="float32", vocab_size=97, hidden_size=64,
            intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, qk_norm=True,
            max_position_embeddings=256, eos_token_ids=[0],
        ),
        cache=c.CacheConfig(block_size=4, num_blocks=128),
        scheduler=c.SchedulerConfig(
            max_seqs_per_batch=8, max_tokens_per_chunk_for_prefill=16,
            max_model_len=256, decode_batch_buckets=[2, 4, 8],
            prefill_token_buckets=[4, 8, 16], **sched,
        ),
    )


TREE = random_param_tree(tiny_config(tcfg).model, seed=5)


def engines(**sched):
    jc = tiny_config(jcfg, **sched)
    runner = JRunner(jc)
    runner.load_model(params=jax.tree.map(jnp.asarray, TREE))
    je = JEngine(jc, runner=runner)
    tc = tiny_config(tcfg, **sched)
    runner = TRunner(tc, device="cpu")
    runner.load_model(params=TREE)
    return je, TEngine(tc, runner=runner)


def pin_profile(eng, p) -> None:
    """The same fitted predictors on both engines, never refitted: the
    schedule then depends on the requests alone."""
    pm = fitted_profile(p, prefill_us_per_tok=60.0, decode_us_per_seq=150.0,
                        refit_every=1 << 30)
    eng.profile_manager = pm
    eng.scheduler.profile_manager = pm


def record(eng) -> list:
    trace = []
    inner = eng.scheduler.schedule

    def schedule():
        out = inner()
        trace.append(summary(out))
        return out

    eng.scheduler.schedule = schedule
    return trace


REQS = [(12, 0, False), (9, 2, False), (30, 0, True), (5, 1, False), (21, 0, True),
        (40, 3, False)]


def drive(eng, p, steps_before: int = 0, publish_at: int = -1) -> tuple[list, dict]:
    """The REQS requests (prompt length, priority, offline), half added
    after ``steps_before`` steps -> (per-step schedules, tokens)."""
    rng = np.random.default_rng(4)
    trace = record(eng)
    sp = p.SP(temperature=0.0, max_tokens=6, ignore_eos=True)
    prompts = [rng.integers(1, 90, n).tolist() for n, _, _ in REQS]
    finals = {}

    def add(i):
        _, prio, off = REQS[i]
        eng.add_request(prompt_token_ids=prompts[i], sampling_params=sp,
                        request_id=f"r{i}", priority=prio, offline=off)

    for i in range(3):
        add(i)
    step = 0
    while eng.has_unfinished() or step <= steps_before:
        if step == steps_before:
            for i in range(3, len(REQS)):
                add(i)
        if step == publish_at:
            eng.interruption_bus.publish(True)
        for ro in eng.step():
            if ro.finished:
                finals[ro.request_id] = ro.outputs[0].token_ids
        step += 1
        assert step < 500
    assert eng.block_manager.num_used_blocks == 0
    return trace, finals


@pytest.mark.parametrize("sched", [
    {"policy": "mix", "step_latency_budget_ms": 2.0},
    {"policy": "mix"},
    {"ttft_budget_ms": 0.9},
], ids=["mix-budget", "mix", "ttft"])
def test_engine_policy_schedules_match_jax(sched):
    je, te = engines(**sched)
    assert type(te.scheduler).__name__ == type(je.scheduler).__name__
    pin_profile(je, PKGS["jax"])
    pin_profile(te, PKGS["torch"])
    want = drive(je, PKGS["jax"], steps_before=2)
    got = drive(te, PKGS["torch"], steps_before=2)
    assert got[1] == want[1]
    assert got[0] == want[0]
    assert len(got[1]) == len(REQS) and all(len(t) == 6 for t in got[1].values())
    if sched.get("step_latency_budget_ms") or sched.get("ttft_budget_ms"):
        # the budget cut some chunk below the 16-token cap
        assert any(0 < n < 16 for s in got[0] for _, n in s["prefill"])


def test_engine_profile_fits_from_step_times():
    cfg = tiny_config(tcfg, policy="mix")
    eng = TEngine(cfg, device="cpu")
    assert isinstance(eng.scheduler, TMix)
    assert eng.scheduler.profile_manager is eng.profile_manager
    eng.profile_manager.refit_every = 4
    rng = np.random.default_rng(0)
    sp = TSP(temperature=0.0, max_tokens=12, ignore_eos=True)
    for n in (12, 9, 30, 40, 23):  # one at a time: prefill-only steps
        eng.add_request(prompt_token_ids=rng.integers(1, 90, n).tolist(), sampling_params=sp)
        while eng.has_unfinished():
            eng.step()
    pm = eng.profile_manager
    assert pm.decode.num_samples > 0 and pm.prefill.num_samples > 0
    assert pm.predict_tpot_s(4) is not None and pm.predict_prefill_s(16) is not None
    assert eng.block_manager.num_used_blocks == 0


# ---------------------------------------------------------------------------
# forward interruption (tests/test_interruption.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Bus", [TBus, JBus], ids=["torch", "jax"])
def test_bus_latch_and_subscribe(Bus):
    bus = Bus()
    seen = []
    bus.subscribe(seen.append)
    assert not bus.consume()
    bus.publish(True)
    assert seen == [True]
    assert bus.pending
    assert bus.consume()
    assert not bus.consume()  # the latched flag clears on consume


def interruption_config(c):
    cfg = tiny_config(c, enable_forward_interruption=True)
    cfg.scheduler.max_tokens_per_chunk_for_prefill = 8
    cfg.scheduler.prefill_token_buckets = [4, 8]
    return cfg


def test_interruption_preempts_offline_for_online():
    runs = {}
    for name, eng_cls, runner_cls, p in (("jax", JEngine, JRunner, PKGS["jax"]),
                                         ("torch", TEngine, TRunner, PKGS["torch"])):
        cfg = interruption_config(p.cfg)
        if name == "jax":
            runner = runner_cls(cfg)
            runner.load_model(params=jax.tree.map(jnp.asarray, TREE))
        else:
            runner = runner_cls(cfg, device="cpu")
            runner.load_model(params=TREE)
        eng = eng_cls(cfg, runner=runner)
        trace = record(eng)
        sp = p.SP(temperature=0.0, max_tokens=4, ignore_eos=True)
        prompts = np.random.default_rng(3).integers(1, 90, 72)
        off = eng.add_request(prompt_token_ids=[int(x) for x in prompts[:64]],
                              sampling_params=sp, request_id="off-0", offline=True)
        eng.step()  # the offline prefill's first chunk
        off_seq = off.sequences[0]
        assert 0 < off_seq.num_computed_tokens < off_seq.num_prompt_tokens
        eng.add_request(prompt_token_ids=[int(x) for x in prompts[64:]],
                        sampling_params=sp, request_id="on-0")
        eng.interruption_bus.publish(True)
        eng.step()
        # the offline request was preempted (blocks freed, RECOMPUTE requeue)
        assert off_seq.status in (p.req.SequenceStatus.PREEMPTED,
                                  p.req.SequenceStatus.WAITING)
        assert off not in eng.scheduler.running
        results = {}
        for _ in range(600):
            for o in eng.step():
                if o.finished:
                    results[o.request_id] = o.outputs[0].token_ids
            if len(results) == 2:
                break
        assert set(results) == {"off-0", "on-0"}
        assert all(len(t) == 4 for t in results.values())
        assert eng.block_manager.num_used_blocks == 0
        runs[name] = (trace, results)
    assert runs["torch"] == runs["jax"]


# ---------------------------------------------------------------------------
# sample_slots (/v1/sample's engine path)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def sample_engines():
    with jax.default_matmul_precision("highest"):
        return engines()


def test_sample_slots_matches_jax(sample_engines):
    je, te = sample_engines
    rng = np.random.default_rng(11)
    prompt = rng.integers(1, 90, 14).tolist()
    positions = [1, 5, 9, 13]
    want = je.sample_slots(prompt, positions, temperature=0.0, num_top=5)
    got = te.sample_slots(prompt, positions, temperature=0.0, num_top=5)
    assert [g["token_id"] for g in got] == [w["token_id"] for w in want]
    assert [g["top_ids"] for g in got] == [w["top_ids"] for w in want]
    err = max(max(abs(a - b) for a, b in zip(g["top_logprobs"] + [g["logprob"]],
                                              w["top_logprobs"] + [w["logprob"]]))
              for g, w in zip(got, want))
    assert err <= 1e-5, err
    # each slot is the greedy continuation of its prefix
    for p, g in zip(positions, got):
        te.add_request(prompt_token_ids=prompt[:p],
                       sampling_params=TSP(temperature=0.0, max_tokens=1, ignore_eos=True))
        assert te.generate_all()[0].outputs[0].token_ids == [g["token_id"]]
    # without num_top: no alternatives; a seeded sampled draw repeats
    plain = te.sample_slots(prompt, positions)
    assert [x["token_id"] for x in plain] == [g["token_id"] for g in got]
    assert all("top_ids" not in x for x in plain)
    a = te.sample_slots(prompt, positions, temperature=1.0, seed=7)
    b = te.sample_slots(prompt, positions, temperature=1.0, seed=7)
    assert a == b
    assert te.block_manager.num_used_blocks == 0
    assert te.sample_slots(prompt, []) == je.sample_slots(prompt, []) == []


@pytest.mark.parametrize("args,match", [
    (([1, 2, 3], [0]), "out of range"),
    (([1, 2, 3], [3]), "out of range"),
    ((list(range(1, 20)), [2]), "single-dispatch sample limit 16"),
], ids=["position-0", "position-n", "too-long"])
def test_sample_slots_refusals(sample_engines, args, match):
    je, te = sample_engines
    for eng in (je, te):
        with pytest.raises(ValueError, match=match):
            eng.sample_slots(*args)
    assert te.block_manager.num_used_blocks == 0
