"""HF safetensors checkpoints in ``xllm_tpu_torch`` on the CPU vs ``xllm_tpu``.

Nothing is downloaded: the checkpoints are written here, from seeds.

- ``SafetensorsReader`` against ``safetensors.torch.load_file``, byte for
  byte: every dtype the port reads (bf16 and e4m3 included, which the JAX
  reader's numpy path cannot hold), one file and an index with shards, and
  the ``model.language_model.`` alias of multimodal checkpoints;
- every registry family's checkpoint against JAX's ``load_params(cfg, None,
  dtype)``: the port's ``load_params`` tree, and the model the runner
  streams the checkpoint into, equal to JAX's tree in f32 and byte-equal in
  bf16, the router's correction bias included (JAX rounds it through the
  model dtype). qwen2, qwen3, llama, mistral, glm4, qwen3_moe, glm4_moe,
  deepseek_v2, deepseek_v3 and qwen3_next are written by transformers
  (``tests/test_model_parity.py``'s builder, f32, a non-zero correction
  bias); mimo, minimax_m2, kimi_k2, glm4_moe_lite and a qwen3_moe in the
  batched-experts convention by ``safetensors`` under the names JAX reads;
- ``LLM(model=path)``: the greedy tokens of JAX's ``LLM`` on the same path
  (qwen3, qwen3_moe, deepseek_v2; f32);
- the rolling int8 / fp8 loads on ``tests/test_rolling_load.py``'s
  checkpoint: byte-equal to JAX's rolling load and to the port's two-phase
  path (load, then ``_quantize_params``); greedy tokens equal to JAX's int8
  engine on that checkpoint;
- the MTP head (``speculative.draft_model_path``) under ``model.layers.0.``
  and under ``mtp.``: equal to JAX's ``load_mtp_head_params``; the MTP
  engine's tokens and ``spec_stats`` equal JAX's; a missing tensor and an
  unreadable path warn and keep the init;
- refusals: an e4m3 weight (a pre-quantized checkpoint) raises
  ``NotImplementedError``, a directory without a checkpoint
  ``FileNotFoundError``; VLM and DSA checkpoints raise;
- qwen3.5's split-projection layout under ``model.language_model.``:
  JAX's tree, the qwen3-next checkpoint's tree and its greedy tokens; the
  hybrid family's int8 load (the runner's catch-all quantizer).

The JAX engines run in threads of a module fixture (XLA compiles outside
the GIL).
"""

import os

os.environ.setdefault("USE_TF", "0")  # transformers without TensorFlow's import time

import dataclasses
import json
import logging
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

import xllm_tpu.config as jcfg
import xllm_tpu_torch.config as tcfg
from test_model_parity import _tiny_hf_model
from test_rolling_load import _tiny_checkpoint
from test_torch_spec import MODELS, jax_engine, mtp_prompts, serve, spec_config
from xllm_tpu.llm import LLM as JLLM
from xllm_tpu.models.loader import load_mtp_head_params as jload_head
from xllm_tpu.models.loader import load_params as jload
from xllm_tpu.models.model_args import load_model_config as jmodel_config
from xllm_tpu.models.mtp_head import MTPHead as JHead
from xllm_tpu.models.registry import create_model as jcreate
from xllm_tpu.runtime.model_runner import ModelRunner as JRunner
from xllm_tpu_torch.engine import LLMEngine as TEngine
from xllm_tpu_torch.framework.sampling_params import SamplingParams as TSP
from xllm_tpu_torch.llm import LLM as TLLM
from xllm_tpu_torch.models import loader
from xllm_tpu_torch.models.model_args import load_model_config as tmodel_config
from xllm_tpu_torch.models.mtp_head import MTPHead
from xllm_tpu_torch.models.registry import create_model as tcreate
from xllm_tpu_torch.runtime.model_runner import ModelRunner as TRunner
from xllm_tpu_torch.weights import load_param_tree, random_param_tree
from torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"f32": (jnp.float32, torch.float32, "float32"),
          "bf16": (jnp.bfloat16, torch.bfloat16, "bfloat16")}
VOCAB = 99


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def jax_bytes(a) -> tuple:
    a = np.asarray(a)
    return a.dtype.name, tuple(a.shape), np.ascontiguousarray(a).view(np.uint8).tobytes()


def torch_bytes(t: torch.Tensor) -> tuple:
    name = str(t.dtype).removeprefix("torch.")
    return name, tuple(t.shape), t.reshape(-1).view(torch.uint8).numpy().tobytes()


def assert_same_bytes(got: torch.Tensor, want, what: str) -> None:
    g, w = torch_bytes(got), jax_bytes(want)
    assert g[:2] == w[:2], f"{what}: {g[:2]} != {w[:2]}"
    assert g[2] == w[2], f"{what}: bytes differ"


def set_torch_dtype(path: str, dtype: str) -> str:
    """Published config.json files name their weights' dtype under
    ``torch_dtype`` (transformers 4.57 writes ``dtype``), which both
    packages read."""
    p = os.path.join(path, "config.json")
    with open(p) as f:
        cfg = json.load(f)
    cfg["torch_dtype"] = dtype
    with open(p, "w") as f:
        json.dump(cfg, f)
    return path


def write_checkpoint(path, config: dict, tensors: dict, shards: int = 1) -> str:
    """``config.json`` and ``tensors`` as ``model.safetensors``, or as
    ``shards`` files beside ``model.safetensors.index.json``."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(config, torch_dtype="float32"), f)
    if shards == 1:
        save_file(tensors, os.path.join(path, "model.safetensors"))
        return str(path)
    names = sorted(tensors)
    weight_map = {}
    for s in range(shards):
        fname = f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
        part = {n: tensors[n] for n in names[s::shards]}
        save_file(part, os.path.join(path, fname))
        weight_map.update(dict.fromkeys(part, fname))
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    return str(path)


class _Gen:
    """f32 tensors from a seed: weights N(0, 0.1), norms 1 + N(0, 0.1)."""

    def __init__(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def __call__(self, *shape, norm: bool = False) -> torch.Tensor:
        w = self.rng.standard_normal(shape).astype(np.float32) * 0.1
        return torch.from_numpy(w + 1.0 if norm else w)


D, I, H, HKV, DH, MI = 64, 128, 4, 2, 16, 32
_BASE = dict(vocab_size=VOCAB, hidden_size=D, intermediate_size=I, num_hidden_layers=2,
             num_attention_heads=H, num_key_value_heads=HKV, head_dim=DH,
             max_position_embeddings=256, rms_norm_eps=1e-6, rope_theta=10000.0,
             tie_word_embeddings=False)


def _gqa_attn(t: dict, g: _Gen, i: int, bias: bool, qk_norm: bool) -> None:
    p = f"model.layers.{i}."
    t[p + "input_layernorm.weight"] = g(D, norm=True)
    t[p + "post_attention_layernorm.weight"] = g(D, norm=True)
    for proj, n in (("q", H), ("k", HKV), ("v", HKV)):
        t[p + f"self_attn.{proj}_proj.weight"] = g(n * DH, D)
        if bias:
            t[p + f"self_attn.{proj}_proj.bias"] = g(n * DH)
    t[p + "self_attn.o_proj.weight"] = g(D, H * DH)
    if qk_norm:
        t[p + "self_attn.q_norm.weight"] = g(DH, norm=True)
        t[p + "self_attn.k_norm.weight"] = g(DH, norm=True)


def _mlp(t: dict, g: _Gen, p: str, inter: int) -> None:
    t[p + "gate_proj.weight"] = g(inter, D)
    t[p + "up_proj.weight"] = g(inter, D)
    t[p + "down_proj.weight"] = g(D, inter)


def _experts(t: dict, g: _Gen, i: int, e: int, bias_at: str = "", shared: int = 0,
             batched: bool = False) -> None:
    p = f"model.layers.{i}.mlp."
    t[p + "gate.weight"] = g(e, D)
    if bias_at:  # a non-zero correction bias
        t[p + bias_at + "e_score_correction_bias"] = g(e) * 5
    if batched:  # qwen3-vl-moe: [E, D, 2I] (gate | up) and [E, I, D]
        t[p + "experts.gate_up_proj"] = g(e, D, 2 * MI)
        t[p + "experts.down_proj"] = g(e, MI, D)
    else:
        for j in range(e):
            _mlp(t, g, p + f"experts.{j}.", MI)
    if shared:
        _mlp(t, g, p + "shared_experts.", shared * MI)


def _mla_attn(t: dict, g: _Gen, i: int, q_lora: int) -> None:
    p = f"model.layers.{i}."
    nope, rope, vh, kvr = 16, 8, 16, 32
    t[p + "input_layernorm.weight"] = g(D, norm=True)
    t[p + "post_attention_layernorm.weight"] = g(D, norm=True)
    a = p + "self_attn."
    if q_lora:
        t[a + "q_a_proj.weight"] = g(q_lora, D)
        t[a + "q_a_layernorm.weight"] = g(q_lora, norm=True)
        t[a + "q_b_proj.weight"] = g(H * (nope + rope), q_lora)
    else:
        t[a + "q_proj.weight"] = g(H * (nope + rope), D)
    t[a + "kv_a_proj_with_mqa.weight"] = g(kvr + rope, D)
    t[a + "kv_a_layernorm.weight"] = g(kvr, norm=True)
    t[a + "kv_b_proj.weight"] = g(H * (nope + vh), kvr)
    t[a + "o_proj.weight"] = g(D, H * vh)


_MLA_CFG = dict(_BASE, num_key_value_heads=H, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=4, num_experts_per_tok=2,
                moe_intermediate_size=MI, first_k_dense_replace=1, n_shared_experts=1,
                scoring_func="sigmoid", n_group=2, topk_group=1, norm_topk_prob=True,
                routed_scaling_factor=2.5)


def _written_family(path, family: str) -> str:
    """A checkpoint of ``family`` under the HF names the JAX loader reads,
    from a seed."""
    g = _Gen(len(family))
    t = {"model.embed_tokens.weight": g(VOCAB, D), "model.norm.weight": g(D, norm=True),
         "lm_head.weight": g(VOCAB, D)}
    if family == "mimo":  # the qwen2 decoder layers (q / k / v bias) + an MTP module
        cfg = dict(_BASE, architectures=["MiMoForCausalLM"], model_type="mimo")
        for i in range(2):
            _gqa_attn(t, g, i, bias=True, qk_norm=False)
            _mlp(t, g, f"model.layers.{i}.mlp.", I)
        t["model.mtp_layers.0.enorm.weight"] = g(D, norm=True)  # not the target's
    elif family in ("minimax_m2", "qwen3_moe_batched"):
        minimax = family == "minimax_m2"
        cfg = dict(_BASE, num_experts_per_tok=2, moe_intermediate_size=MI)
        if minimax:  # sigmoid routing, its correction bias under mlp., partial rope
            cfg.update(architectures=["MiniMaxM2ForCausalLM"], model_type="minimax_m2",
                       num_local_experts=4, scoring_func="sigmoid", use_qk_norm=True,
                       rotary_dim=8)
        else:
            cfg.update(architectures=["Qwen3MoeForCausalLM"], model_type="qwen3_moe",
                       num_experts=4, norm_topk_prob=True)
        for i in range(2):
            _gqa_attn(t, g, i, bias=False, qk_norm=True)
            _experts(t, g, i, 4, batched=not minimax)
            if minimax:
                t[f"model.layers.{i}.mlp.e_score_correction_bias"] = g(4) * 5
    else:  # kimi_k2 (q_lora), glm4_moe_lite (q_proj): MLA, a dense first layer
        kimi = family == "kimi_k2"
        cfg = dict(_MLA_CFG, model_type=family, q_lora_rank=48 if kimi else 0)
        for i in range(2):
            _mla_attn(t, g, i, 48 if kimi else 0)
        _mlp(t, g, "model.layers.0.mlp.", I)
        _experts(t, g, 1, 4, bias_at="gate.", shared=1)
    return write_checkpoint(path, cfg, t)


def _mistral(path) -> str:
    from transformers import AutoModelForCausalLM, MistralConfig

    torch.manual_seed(0)
    cfg = MistralConfig(**_BASE, sliding_window=None)
    model = AutoModelForCausalLM.from_config(cfg).eval().to(torch.float32)
    model.save_pretrained(path, safe_serialization=True)
    return str(path)


TRANSFORMERS_FAMILIES = ("qwen2", "qwen3", "llama", "glm4", "qwen3_moe", "glm4_moe",
                         "deepseek_v2", "deepseek_v3", "qwen3_next")
WRITTEN_FAMILIES = ("mimo", "minimax_m2", "kimi_k2", "glm4_moe_lite", "qwen3_moe_batched")
FAMILIES = TRANSFORMERS_FAMILIES + ("mistral",) + WRITTEN_FAMILIES


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory) -> dict:
    root = tmp_path_factory.mktemp("ckpt")
    out = {f: set_torch_dtype(_tiny_hf_model(root, f)[1], "float32")
           for f in TRANSFORMERS_FAMILIES}
    out["mistral"] = set_torch_dtype(_mistral(root / "mistral"), "float32")
    for f in WRITTEN_FAMILIES:
        out[f] = _written_family(root / f, f)
    return out


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------
READER_DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.float64,
                 torch.float8_e4m3fn, torch.int8, torch.int16, torch.int32, torch.int64,
                 torch.uint8, torch.bool]


def _reader_tensors(dtype: torch.dtype) -> dict:
    g = torch.Generator().manual_seed(READER_DTYPES.index(dtype))
    x = torch.randn((5, 7, 3), generator=g) * 300
    out = {}
    for name, shape in (("a", (5, 7, 3)), ("b", (13,)), ("c", ())):
        v = x.flatten()[: int(np.prod(shape))].reshape(shape)
        if dtype == torch.bool:
            v = v > 0
        elif not dtype.is_floating_point:
            info = torch.iinfo(dtype)
            v = v.round().clamp(info.min, info.max)
        out[f"model.t_{name}"] = v.to(dtype).clone()
    out["model.empty"] = torch.zeros((0, 4), dtype=dtype)
    return out


@pytest.mark.parametrize("shards", [1, 3], ids=["single", "sharded"])
@pytest.mark.parametrize("dtype", READER_DTYPES, ids=lambda d: str(d).removeprefix("torch."))
def test_reader_matches_safetensors(tmp_path, dtype, shards):
    path = write_checkpoint(tmp_path, {}, _reader_tensors(dtype), shards=shards)
    want = {}
    for fname in os.listdir(path):
        if fname.endswith(".safetensors"):
            want.update(load_file(os.path.join(path, fname)))
    with loader.SafetensorsReader(path) as reader:
        assert set(reader.name_to_file) == set(want)
        for name, w in want.items():
            got = reader.get(name)
            assert got.dtype == w.dtype and got.shape == w.shape, name
            assert torch.equal(got.reshape(-1).view(torch.uint8),
                               w.reshape(-1).view(torch.uint8)), name
            assert name in reader


def test_reader_misaligned_offset(tmp_path):
    """A tensor whose bytes start off its dtype's alignment (the format
    does not forbid it) reads as a copy of the same values."""
    x = torch.randn(5, dtype=torch.float32)
    header = {"b": {"dtype": "U8", "shape": [3], "data_offsets": [0, 3]},
              "a": {"dtype": "F32", "shape": [5], "data_offsets": [3, 23]}}
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(tmp_path / "model.safetensors", "wb") as f:
        f.write(len(text).to_bytes(8, "little") + text + bytes([1, 2, 3]))
        f.write(x.numpy().tobytes())
    with loader.SafetensorsReader(str(tmp_path)) as reader:
        assert torch.equal(reader.get("a"), x)
        assert reader.get("b").tolist() == [1, 2, 3]


def test_reader_language_model_alias(tmp_path):
    t = {"model.language_model.embed_tokens.weight": torch.randn(4, 3),
         "model.language_model.layers.0.x": torch.randn(2).to(torch.bfloat16),
         "model.visual.y": torch.randn(2)}
    with loader.SafetensorsReader(write_checkpoint(tmp_path, {}, t)) as reader:
        assert "model.embed_tokens.weight" in reader and "model.layers.0.x" in reader
        assert torch.equal(reader.get("model.layers.0.x"),
                           t["model.language_model.layers.0.x"])
        assert "model.visual.y" in reader and "model.nothing" not in reader


# ---------------------------------------------------------------------------
# families against JAX's load_params
# ---------------------------------------------------------------------------
def _jax_tree(path: str, dt: str) -> dict:
    jc = jmodel_config(path)
    return flat(jload(jc, None, DTYPES[dt][0]))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("family", FAMILIES)
def test_tree_matches_jax(checkpoints, family, dt):
    """The port's ``load_params`` tree: JAX's names, shapes and bytes."""
    path = checkpoints[family]
    want = _jax_tree(path, dt)
    got = flat(loader.load_params(tmodel_config(path), DTYPES[dt][1]))
    assert set(got) == set(want)
    for name in want:
        assert_same_bytes(got[name], want[name], f"{family} {dt} {name}")
    if family in ("deepseek_v3", "glm4_moe", "minimax_m2", "kimi_k2", "glm4_moe_lite"):
        bias = [n for n in want if n.endswith("router_bias")]
        assert bias and float(np.abs(np.asarray(want[bias[0]], np.float32)).max()) > 0.1


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("family", FAMILIES)
def test_streamed_model_matches_jax(checkpoints, family, dt):
    """The runner's streaming load: every parameter byte-equal to JAX's
    tree carried into a model of the port (the f32 router bias holds the
    model dtype's rounding, as JAX's tree does)."""
    path = checkpoints[family]
    mc = tmodel_config(path)
    mc.dtype = DTYPES[dt][2]
    runner = TRunner(tcfg.EngineConfig(model=mc), device="cpu")
    runner.load_model()
    ref = tcreate(mc)
    tree = {}
    for name, v in _jax_tree(path, dt).items():
        node = tree
        *parents, leaf = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(v)
    load_param_tree(ref, tree)
    got, want = dict(runner.model.named_parameters()), dict(ref.named_parameters())
    assert set(got) == set(want)
    for name, p in want.items():
        assert torch_bytes(got[name]) == torch_bytes(p), name
    if "router_bias" in tree.get("layers", tree.get("moe_layers", {})) and dt == "bf16":
        b = [p for n, p in got.items() if n.endswith("router_bias")][0]
        assert b.dtype == torch.float32 and torch.equal(b, b.to(torch.bfloat16).float())


# ---------------------------------------------------------------------------
# engines: LLM(model=path), the rolling int8 load, the MTP head
# ---------------------------------------------------------------------------
LLM_FAMILIES = ("qwen3", "qwen3_moe", "deepseek_v2")
LLM_KW = dict(block_size=4, num_blocks=48, max_model_len=64, max_seqs_per_batch=2,
              decode_batch_buckets=[2], prefill_token_buckets=[16])


def _prompts(seed: int, vocab: int, lens=(11, 7)) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lens]


def _llm_tokens(llm, sp_cls, prompts) -> list[list[int]]:
    sp = sp_cls(temperature=0.0, max_tokens=8, ignore_eos=True)
    return [o.outputs[0].token_ids for o in llm.generate(prompt_token_ids=prompts,
                                                        sampling_params=sp)]


def _quant_config(c, path: str, method: str, dtype: str):
    mc = (jmodel_config if c is jcfg else tmodel_config)(path)
    mc.dtype = dtype
    return c.EngineConfig(
        model=mc, cache=c.CacheConfig(block_size=8, num_blocks=16),
        scheduler=c.SchedulerConfig(max_model_len=64, max_seqs_per_batch=2,
                                    decode_batch_buckets=[2], prefill_token_buckets=[16]),
        quant=c.QuantConfig(method=method))


def _head_checkpoint(path, prefix: str, drop: str = "") -> str:
    """An MTP module at ``MODELS["qwen3"]``'s widths under ``prefix``
    (its final norm under the prefix, or the target's ``model.norm``)."""
    kw = MODELS["qwen3"]
    d, hq, hkv, dh, inter = (kw["hidden_size"], kw["num_attention_heads"],
                             kw["num_key_value_heads"], kw["head_dim"],
                             kw["intermediate_size"])
    g = _Gen(7)
    t = {"enorm.weight": g(d, norm=True), "hnorm.weight": g(d, norm=True),
         "eh_proj.weight": g(d, 2 * d),
         "input_layernorm.weight": g(d, norm=True),
         "post_attention_layernorm.weight": g(d, norm=True),
         "self_attn.q_proj.weight": g(hq * dh, d), "self_attn.k_proj.weight": g(hkv * dh, d),
         "self_attn.v_proj.weight": g(hkv * dh, d), "self_attn.o_proj.weight": g(d, hq * dh),
         "self_attn.q_norm.weight": g(dh, norm=True),
         "self_attn.k_norm.weight": g(dh, norm=True),
         "mlp.gate_proj.weight": g(inter, d), "mlp.up_proj.weight": g(inter, d),
         "mlp.down_proj.weight": g(d, inter)}
    t = {prefix + k: v for k, v in t.items() if k != drop}
    norm = "model.norm.weight" if prefix == "model.layers.0." else prefix + "shared_head.norm.weight"
    t[norm] = g(d, norm=True)
    return write_checkpoint(path, {}, t)


def _mtp_config(c, draft: str):
    cfg = spec_config(c, MODELS["qwen3"], "mtp", 3, 4)
    cfg.speculative.draft_model_path = draft
    return cfg


@pytest.fixture(scope="module")
def engine_runs(checkpoints, tmp_path_factory) -> dict:
    """JAX's engines in threads: ``LLM(model=path)`` of ``LLM_FAMILIES``,
    the f32 int8 engine on the rolling-load checkpoint, and the MTP engine
    with a draft head checkpoint."""
    root = tmp_path_factory.mktemp("engines")
    rolling = _tiny_checkpoint(root)
    draft = _head_checkpoint(root / "draft", "mtp.")
    tree = random_param_tree(spec_config(tcfg, MODELS["qwen3"]).model, seed=3)
    prompts = {f: _prompts(len(f), VOCAB) for f in LLM_FAMILIES}
    prompts["int8"] = _prompts(5, 128)

    def run(job):
        from xllm_tpu.framework.sampling_params import SamplingParams as JSP

        with jax.default_matmul_precision("highest"):
            if job in LLM_FAMILIES:
                return _llm_tokens(JLLM(model=checkpoints[job], **LLM_KW), JSP, prompts[job])
            if job == "int8":
                cfg = _quant_config(jcfg, rolling, "int8", "float32")
                eng = JLLM(config=cfg)
                return _llm_tokens(eng, JSP, prompts["int8"])
            eng, _ = jax_engine(_mtp_config(jcfg, draft), tree)
            return serve(eng, JSP, mtp_prompts()), list(eng.spec_stats)

    jobs = LLM_FAMILIES + ("int8", "mtp")
    with ThreadPoolExecutor(len(jobs)) as ex:
        out = dict(zip(jobs, ex.map(run, jobs)))
    return {"jax": out, "prompts": prompts, "rolling": rolling, "draft": draft, "tree": tree}


@pytest.mark.parametrize("family", LLM_FAMILIES)
def test_llm_greedy_matches_jax(checkpoints, engine_runs, family):
    llm = TLLM(model=checkpoints[family], device="cpu", **LLM_KW)
    assert llm.engine.config.model.model_path == checkpoints[family]
    assert llm.engine.config.model.dtype == "float32"
    got = _llm_tokens(llm, TSP, engine_runs["prompts"][family])
    assert got == engine_runs["jax"][family]
    assert llm.engine.block_manager.num_used_blocks == 0


def _model_bytes(model) -> dict:
    return {n: torch_bytes(p) for n, p in model.named_parameters()}


@pytest.mark.parametrize("method", ["int8", "fp8_e4m3"])
def test_rolling_load_matches_jax_and_two_phase(engine_runs, method):
    """The rolling load (each slice quantized as it lands) against JAX's
    rolling load and the port's two-phase path, byte for byte (bf16)."""
    path = engine_runs["rolling"]
    jr = JRunner(_quant_config(jcfg, path, method, "bfloat16"))
    jr.load_model()
    cfg = _quant_config(tcfg, path, method, "bfloat16")
    rolling = TRunner(cfg, device="cpu")
    rolling.load_model()
    carried = tcreate(cfg.model, quant=method)
    load_param_tree(carried, jax.tree.map(np.asarray, jr.params))
    two_phase = TRunner(cfg, device="cpu")
    two_phase.load_model(params=loader.load_params(cfg.model, torch.bfloat16))
    got = _model_bytes(rolling.model)
    assert got == _model_bytes(carried) == _model_bytes(two_phase.model)
    qdtype = {"int8": "int8", "fp8_e4m3": "float8_e4m3fn"}[method]
    n_q = sum(d == qdtype for d, _, _ in got.values())
    assert n_q == 5 * 3, n_q  # qkv, o, gate, up, down x 3 layers


def test_int8_checkpoint_tokens_match_jax(engine_runs):
    cfg = _quant_config(tcfg, engine_runs["rolling"], "int8", "float32")
    got = _llm_tokens(TLLM(config=cfg, device="cpu"), TSP, engine_runs["prompts"]["int8"])
    assert got == engine_runs["jax"]["int8"]


@pytest.mark.parametrize("prefix", ["model.layers.0.", "mtp."])
def test_mtp_head_matches_jax(tmp_path, prefix):
    draft = _head_checkpoint(tmp_path, prefix)
    jc, tc = jcfg.ModelConfig(**MODELS["qwen3"]), tcfg.ModelConfig(**MODELS["qwen3"])
    jm = jcreate(jc)
    jhead = JHead(jc, jm)
    want = flat(jload_head(draft, jhead.init_params(jax.random.key(1)), cfg=jc))
    head = MTPHead(tc, tcreate(tc))
    head.init_random_(2)
    loader.load_mtp_head(head, draft, tc)
    got = {n: p for n, p in head.named_parameters()}
    assert {n.removeprefix("layer.") for n in got} == {n.removeprefix("layers.") for n in want}
    for name, p in got.items():
        w = np.asarray(want[name.replace("layer.", "layers.")])
        if name.startswith("layer."):
            w = w[0]
        assert_same_bytes(p, w, name)


def test_mtp_head_missing_tensor_or_path_keeps_init(tmp_path, caplog):
    tc = tcfg.ModelConfig(**MODELS["qwen3"])
    head = MTPHead(tc, tcreate(tc))
    head.init_random_(2)
    init = {n: p.clone() for n, p in head.named_parameters()}
    draft = _head_checkpoint(tmp_path / "d", "mtp.", drop="mlp.down_proj.weight")
    with caplog.at_level(logging.WARNING):
        loader.load_mtp_head(head, draft, tc)
    assert "mlp.down_proj.weight missing" in caplog.text
    got = dict(head.named_parameters())
    assert torch.equal(got["layer.down_proj_w"], init["layer.down_proj_w"])
    assert not torch.equal(got["layer.up_proj_w"], init["layer.up_proj_w"])
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        loader.load_mtp_head(head, str(tmp_path / "nowhere"), tc)
    assert "cannot read" in caplog.text


def test_mtp_engine_with_draft_checkpoint_matches_jax(engine_runs):
    """``speculative.draft_model_path`` loads (it raised before the loader
    was ported): tokens and ``spec_stats`` equal JAX's engine with the
    same head checkpoint."""
    cfg = _mtp_config(tcfg, engine_runs["draft"])
    runner = TRunner(cfg, device="cpu")
    runner.load_model(params=engine_runs["tree"])
    eng = TEngine(cfg, runner=runner)
    want_toks, want_stats = engine_runs["jax"]["mtp"]
    assert serve(eng, TSP, mtp_prompts()) == want_toks
    assert list(eng.spec_stats) == want_stats


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
def test_prequantized_tensor_raises(checkpoints, tmp_path):
    tensors = load_file(os.path.join(checkpoints["qwen3"], "model.safetensors"))
    name = "model.layers.1.mlp.up_proj.weight"
    tensors[name] = tensors[name].to(torch.float8_e4m3fn)
    tensors[name.replace("weight", "weight_scale_inv")] = torch.ones(1)
    with open(os.path.join(checkpoints["qwen3"], "config.json")) as f:
        cfg = json.load(f)
    path = write_checkpoint(tmp_path, cfg, tensors)
    with pytest.raises(NotImplementedError, match=name):
        loader.load_params(tmodel_config(path))
    runner = TRunner(tcfg.EngineConfig(model=tmodel_config(path)), device="cpu")
    with pytest.raises(NotImplementedError, match=name):
        runner.load_model()


def test_no_checkpoint_raises_and_dummy_keeps_random(checkpoints, tmp_path):
    with open(os.path.join(checkpoints["qwen3"], "config.json")) as f:
        cfg = json.load(f)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(cfg, f)
    mc = tmodel_config(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        TRunner(tcfg.EngineConfig(model=mc), device="cpu").load_model()
    # load_format="dummy" never reads model_path
    runner = TRunner(tcfg.EngineConfig(model=mc, load_format="dummy"), device="cpu")
    runner.load_model()
    assert runner.weights_loaded


@pytest.mark.parametrize("over", [
    {"vision": {"depth": 2}},
    {"model_type": "deepseek_v32", "kv_lora_rank": 32, "index_topk": 8},
], ids=["vision", "dsa"])
def test_unported_checkpoints_raise(checkpoints, over):
    mc = tmodel_config(checkpoints["qwen3"])
    for k, v in over.items():
        setattr(mc, k, v)
    with pytest.raises(NotImplementedError):
        loader.load_params(mc)
    with pytest.raises(NotImplementedError):
        TRunner(tcfg.EngineConfig(model=mc), device="cpu").load_model()


def test_qwen3_5_split_layout_loads_as_qwen3_next(checkpoints, tmp_path):
    """qwen3.5's on-disk convention (tests/test_qwen3_5.py's rewrite of the
    qwen3-next checkpoint: split ``in_proj_qkv / z / b / a``, the LM under
    ``model.language_model.``, the config nested under ``text_config``)
    loads to JAX's tree for it and to the qwen3-next checkpoint's tree, and
    serves the same greedy tokens."""
    from types import SimpleNamespace

    from test_qwen3_5 import _rewrite_as_qwen3_5

    next_path = checkpoints["qwen3_next"]
    with open(os.path.join(next_path, "config.json")) as f:
        hf_cfg = SimpleNamespace(**json.load(f))
    q35 = str(tmp_path / "q35")
    _rewrite_as_qwen3_5(next_path, q35, hf_cfg)
    set_torch_dtype(q35, "float32")
    mc = tmodel_config(q35)
    assert mc.model_type == "qwen3_5"
    assert dataclasses.asdict(mc) == dataclasses.asdict(jmodel_config(q35))  # text_config
    assert type(tcreate(mc)).__name__ == "Qwen3NextModel"
    got = flat(loader.load_params(mc, torch.float32))
    want = _jax_tree(q35, "f32")
    assert set(got) == set(want)
    for name in want:
        assert_same_bytes(got[name], want[name], f"qwen3_5 {name}")
    base = flat(loader.load_params(tmodel_config(next_path), torch.float32))
    for name, t in base.items():
        assert torch.equal(got[name], t), name
    prompts = _prompts(3, VOCAB)
    tokens = [_llm_tokens(TLLM(model=p, device="cpu", **LLM_KW), TSP, prompts)
              for p in (next_path, q35)]
    assert tokens[0] == tokens[1] and all(len(t) == 8 for t in tokens[0])


def test_qwen3_next_checkpoint_quantized_load(checkpoints):
    """The hybrid family's checkpoint with ``quant.method="int8"``: the
    runner's catch-all quantizes the group stacks the JAX runner does (the
    shared expert's ``*_proj_w``) to the bytes of ``_quantize_params`` on
    the loaded tree, and leaves the rest in the model dtype."""
    mc = tmodel_config(checkpoints["qwen3_next"])
    cfg = tcfg.EngineConfig(model=mc)
    cfg.quant.method = "int8"
    runner = TRunner(cfg, device="cpu")
    runner.load_model()
    want = runner._quantize_params(loader.load_params(mc, runner.model.dtype))["groups"]
    gp = runner.model.groups
    assert gp.shared_up_proj_w.dtype == torch.int8 and gp.full_q_w.dtype == torch.float32
    assert set(n for n, _ in gp.named_parameters()) == set(want)
    for name, t in want.items():
        assert torch.equal(getattr(gp, name).view(torch.uint8)
                           if t.dtype == torch.int8 else getattr(gp, name),
                           t.view(torch.uint8) if t.dtype == torch.int8 else t), name
