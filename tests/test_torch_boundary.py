"""The port's boundaries: what it imports, where it runs, what it refuses.

- ``xllm_tpu_torch`` and ``chip_smoke.py`` import neither jax nor
  ``xllm_tpu``, nor ``safetensors``, ``transformers``, ``aiohttp`` or
  ``ml_dtypes``, which the card's machine lacks (checked in a subprocess: this test process has jax loaded
  by ``tests/conftest.py``), and every kernel module imports without nvcc
  or triton;
- the entry points run on the card unless the caller asks for the CPU,
  and never fall back to it;
- knobs whose code is not ported yet raise ``NotImplementedError``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from xllm_tpu_torch.config import (
    CacheConfig,
    EngineConfig,
    ModelConfig,
    SchedulerConfig,
)
from xllm_tpu_torch.engine import LLMEngine
from xllm_tpu_torch.framework.sampling_params import SamplingParams
from xllm_tpu_torch.llm import LLM
from xllm_tpu_torch.ops.cuda import _build
from xllm_tpu_torch.runtime.model_runner import ModelRunner
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import xllm_tpu_torch
names = ["xllm_tpu_torch"]
for m in pkgutil.walk_packages(xllm_tpu_torch.__path__, "xllm_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n in ("jax", "xllm_tpu", "triton", "safetensors", "transformers",
                      "aiohttp", "ml_dtypes")
             or n.startswith(("jax.", "xllm_tpu.", "triton.", "safetensors.",
                              "transformers.", "aiohttp.", "ml_dtypes.")))
print(json.dumps({"imported": names, "bad": bad}))
"""


_MOE = {"model_type": "qwen3_moe", "num_experts": 4, "num_experts_per_tok": 2,
        "moe_intermediate_size": 16}
_MLA = dict(_MOE, model_type="deepseek_v3", kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=16, v_head_dim=16, first_k_dense_replace=1)


def _tiny(**over) -> EngineConfig:
    cfg = EngineConfig(
        model=ModelConfig(model_type="qwen3", dtype="float32", vocab_size=64,
                          hidden_size=32, intermediate_size=64,
                          num_hidden_layers=1, num_attention_heads=2,
                          num_key_value_heads=1, head_dim=16, qk_norm=True,
                          max_position_embeddings=64),
        cache=CacheConfig(block_size=4, num_blocks=16),
        scheduler=SchedulerConfig(max_seqs_per_batch=2, max_model_len=64,
                                  decode_batch_buckets=[2],
                                  prefill_token_buckets=[8]),
    )
    for group, kw in over.items():
        for k, v in kw.items():
            setattr(getattr(cfg, group), k, v)
    return cfg


def test_imports_no_jax_no_reference_no_triton():
    # PATH without any CUDA toolkit: importing must not look for nvcc
    env = dict(os.environ, PYTHONPATH=str(ROOT), PATH="/usr/bin:/bin")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    for mod in ("xllm_tpu_torch.ops.cuda.decode_attention",
                "xllm_tpu_torch.ops.cuda.kv_write",
                "xllm_tpu_torch.ops.cuda.prefill_attention",
                "xllm_tpu_torch.ops.cuda.gmm", "xllm_tpu_torch.ops.moe",
                "xllm_tpu_torch.ops.cuda.quant_matmul", "xllm_tpu_torch.ops.quant",
                "xllm_tpu_torch.models.moe_decoder",
                "xllm_tpu_torch.ops.cuda.mla_attention", "xllm_tpu_torch.ops.mla",
                "xllm_tpu_torch.models.mla_decoder",
                "xllm_tpu_torch.server.async_engine", "xllm_tpu_torch.common.metrics",
                "xllm_tpu_torch.engine", "xllm_tpu_torch.llm",
                "xllm_tpu_torch.runtime.rejection_sampler",
                "xllm_tpu_torch.framework.suffix_cache", "xllm_tpu_torch.models.mtp_head",
                "xllm_tpu_torch.models.loader", "xllm_tpu_torch.server.http",
                "xllm_tpu_torch.server.api", "xllm_tpu_torch.server.registry",
                "xllm_tpu_torch.parser.function_call",
                "xllm_tpu_torch.parser.reasoning_parser",
                "xllm_tpu_torch.framework.chat_template",
                "xllm_tpu_torch.scheduler.mix", "xllm_tpu_torch.scheduler.profile",
                "xllm_tpu_torch.common.interruption", "xllm_tpu_torch.common.health",
                "xllm_tpu_torch.common.rate_limiter", "xllm_tpu_torch.framework.host_kv",
                "xllm_tpu_torch.disagg.pd", "xllm_tpu_torch.disagg.kv_store",
                "xllm_tpu_torch.disagg.service", "xllm_tpu_torch.disagg.ooc"):
        assert mod in out["imported"]


def test_chip_smoke_refuses_without_a_card():
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(_tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelRunner(_tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLM(config=_tiny())
    # a MoE and an MLA engine too
    for model in (_MOE, _MLA):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LLMEngine(_tiny(model=model))
    # asked for explicitly, the CPU serves
    for cfg in (_tiny(), _tiny(model=_MOE), _tiny(model=_MLA)):
        eng = LLMEngine(cfg, device="cpu")
        eng.add_request(prompt_token_ids=[1, 2, 3],
                        sampling_params=SamplingParams(max_tokens=2, ignore_eos=True))
        assert len(eng.generate_all()[0].outputs[0].token_ids) == 2


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_build_dir", lambda: tmp_path / "kernels")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


@pytest.mark.parametrize(
    "over",
    [
        # quantized weights and KV serve for every family now
        # (tests/test_torch_quant_moe_mla.py); with a knob that is not
        # ported they still raise, and an int8 latent cache raises as in JAX
        pytest.param({"model": _MLA, "quant": {"method": "int8"},
                      "cache": {"kv_cache_dtype": "int8"}}, id="int8_1"),
        # speculative decoding serves (tests/test_torch_spec.py,
        # tests/test_torch_mtp.py), a draft head checkpoint loads
        # (tests/test_torch_loader.py), and the mix scheduler serves
        # (tests/test_torch_mix_scheduler.py); the native block manager
        # is not ported
        {"cache": {"block_backend": "native"}},
        {"parallel": {"tp_size": 2}},
        {"parallel": {"dp_size": 2}},
        {"parallel": {"cp_size": 2}},
        # MLA serves now; DSA (index_topk > 0), quantized and interleaved
        # latent caches still raise
        pytest.param({"model": dict(_MLA, model_type="deepseek_v32", index_topk=8)},
                     id="deepseek_v3"),
        pytest.param({"model": dict(_MLA, index_topk=8)}, id="deepseek_v3-dsa"),
        # MoE serves on one device now; what it still lacks raises
        pytest.param({"model": _MOE, "eplb": {"enable_eplb": True}}, id="qwen3_moe-4"),
        {"model": _MOE, "eplb": {"redundant_experts": 2}},
        {"model": _MOE, "parallel": {"ep_size": 2}},
        pytest.param({"model": _MOE, "quant": {"method": "fp8_e4m3"},
                      "parallel": {"ep_size": 2}}, id="qwen3_moe-4-2-16-fp8_e4m3"),
        pytest.param({"model": _MLA, "cache": {"kv_cache_dtype": "int8"}},
                     id="deepseek_v3-4-2-16-32"),
    ],
    ids=lambda o: "-".join(f"{k}" for g in o.values() for k in g.values()),
)
def test_unported_knobs_raise(over):
    with pytest.raises(NotImplementedError):
        LLMEngine(_tiny(**over), device="cpu")


def _jax_layout(over) -> str:
    """The KV layout the JAX runner resolves for ``_tiny(**over)``."""
    import xllm_tpu.config as jcfg
    from xllm_tpu.runtime.model_runner import ModelRunner as JRunner

    cfg = _tiny(**over)
    jc = jcfg.EngineConfig(
        model=jcfg.ModelConfig(**vars(cfg.model)),
        cache=jcfg.CacheConfig(**vars(cfg.cache)),
        scheduler=jcfg.SchedulerConfig(**vars(cfg.scheduler)),
    )
    jc.quant.method = cfg.quant.method
    runner = JRunner(jc)
    runner.initialize_kv_cache(cfg.cache.num_blocks)
    return runner.model.kv_layout


@pytest.mark.parametrize(
    "over,layout",
    [
        # the interleaved layouts serve (K8, K9); at Hkv 1 interleaved_rm
        # resolves to interleaved, as in JAX (16 must divide 2 * Hkv)
        ({"cache": {"kv_layout": "interleaved"}}, "interleaved"),
        ({"cache": {"kv_layout": "interleaved_rm"}}, "interleaved"),
        ({"model": {"num_attention_heads": 16, "num_key_value_heads": 8, "head_dim": 128,
                    "hidden_size": 64},
          "cache": {"kv_layout": "interleaved_rm", "block_size": 16}}, "interleaved_rm"),
        # an int8 KV cache keeps plain interleaved
        pytest.param({"model": _MOE, "cache": {"kv_cache_dtype": "int8",
                                               "kv_layout": "interleaved"}},
                     "interleaved", id="int8_0"),
        # the MLA latent cache keeps split, with a warning
        pytest.param({"model": _MLA, "cache": {"kv_cache_dtype": "fp8_e4m3",
                                               "kv_layout": "interleaved"}},
                     "split", id="fp8_e4m3"),
        pytest.param({"model": _MLA, "cache": {"kv_layout": "interleaved"}}, "split",
                     id="deepseek_v3-interleaved"),
    ],
    ids=lambda o: "-".join(f"{k}" for g in o.values() for k in g.values())
    if isinstance(o, dict) else o,
)
def test_ported_knobs_serve(over, layout):
    """Knobs that once raised here and serve now: each engine serves on the
    CPU, on the KV layout the JAX runner resolves for the same config."""
    eng = LLMEngine(_tiny(**over), device="cpu")
    assert eng.runner.model.kv_layout == _jax_layout(over) == layout
    eng.add_request(prompt_token_ids=[1, 2, 3, 4, 5],
                    sampling_params=SamplingParams(max_tokens=3, ignore_eos=True))
    assert len(eng.generate_all()[0].outputs[0].token_ids) == 3
    assert eng.block_manager.num_used_blocks == 0


@pytest.mark.parametrize(
    "kw",
    [{"sampling_params": SamplingParams(use_beam_search=True, best_of=2)},
     {"images": [object()]}],
    ids=["beam", "image"],
)
def test_unported_requests_raise(kw):
    # embed requests and prompt scoring serve now
    # (tests/test_torch_score.py::test_embed_and_score_requests_serve)
    eng = LLMEngine(_tiny(), device="cpu")
    with pytest.raises(NotImplementedError):
        eng.add_request(prompt_token_ids=[1, 2, 3], **kw)

