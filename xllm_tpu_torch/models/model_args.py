"""HF config.json -> ModelConfig.

Counterpart of the reference's per-family model-args loaders
(reference xllm/core/framework/hf_model_loader.h:32-59 and the
REGISTER_MODEL_ARGS blocks in xllm/models/*, model_registry.h:150-247).
"""

from __future__ import annotations

import json
import os

from xllm_tpu_torch.config import ModelConfig

# HF architectures string -> our model_type key
_ARCH_MAP = {
    "Qwen2ForCausalLM": "qwen2",
    "Qwen3ForCausalLM": "qwen3",
    "Qwen3MoeForCausalLM": "qwen3_moe",
    "LlamaForCausalLM": "llama",
    "MistralForCausalLM": "llama",
    "DeepseekV2ForCausalLM": "deepseek_v2",
    "DeepseekV3ForCausalLM": "deepseek_v2",
    "DeepseekV32ForCausalLM": "deepseek_v32",
    "Glm5ForCausalLM": "glm_moe_dsa",
    "Glm4ForCausalLM": "glm4",
    "Glm4MoeForCausalLM": "glm4_moe",
    "MiniMaxM2ForCausalLM": "minimax_m2",
    "MiMoForCausalLM": "mimo",
    "Qwen3NextForCausalLM": "qwen3_next",
    "Qwen2VLForConditionalGeneration": "qwen2_vl",
    "Qwen3VLForConditionalGeneration": "qwen3_vl",
    "Qwen3VLMoeForConditionalGeneration": "qwen3_vl_moe",
    "Qwen2_5_VLForConditionalGeneration": "qwen2_5_vl",
    "Glm4vForConditionalGeneration": "glm4v",
    "Glm4vMoeForConditionalGeneration": "glm4v_moe",
}


def model_config_from_hf_dict(cfg: dict, model_path: str = "") -> ModelConfig:
    archs = cfg.get("architectures", [])
    model_type = cfg.get("model_type", "")
    # qwen3.5 nests the LM config under text_config (reference
    # LOAD_ARG_TEXT_OR_ROOT, qwen3_5.h:69-180); flatten it over the root
    if model_type in ("qwen3_5", "qwen3_5_text", "qwen3_5_moe_text") or any(
        a.startswith("Qwen3_5") for a in archs
    ):
        merged = dict(cfg)
        merged.update(cfg.get("text_config", {}) or {})
        merged["model_type"] = "qwen3_5"
        cfg = merged
        model_type = "qwen3_5"
    for a in archs:
        if a in _ARCH_MAP:
            model_type = _ARCH_MAP[a]
            break
    if model_type in ("qwen3_vl", "qwen3_vl_moe") or any(
        a in ("Qwen3VLForConditionalGeneration",
              "Qwen3VLMoeForConditionalGeneration") for a in archs
    ):
        # qwen3-vl nests the LM under text_config; flatten it over the
        # root (vision_config stays nested)
        merged = dict(cfg)
        merged.update(cfg.get("text_config", {}) or {})
        cfg = merged
        model_type = (
            "qwen3_vl_moe"
            if "moe" in str(cfg.get("model_type", "")) or any(
                "Moe" in a for a in archs)
            else "qwen3_vl"
        )
    if model_type in ("glm4v", "glm4v_moe") or any(
        a in ("Glm4vForConditionalGeneration",
              "Glm4vMoeForConditionalGeneration") for a in archs
    ):
        # glm4v nests the LM under text_config too; the text config
        # carries None placeholders for the multimodal token ids, which
        # must not clobber the top-level values
        merged = dict(cfg)
        merged.update({
            k: v
            for k, v in (cfg.get("text_config", {}) or {}).items()
            if v is not None
        })
        cfg = merged
        model_type = (
            "glm4v_moe"
            if "moe" in str(cfg.get("model_type", "")) or any(
                "Moe" in a for a in archs)
            else "glm4v"
        )
    eos = cfg.get("eos_token_id", [])
    if isinstance(eos, int):
        eos = [eos]

    mc = ModelConfig(
        model_path=model_path,
        model_type=model_type,
        dtype=str(cfg.get("torch_dtype", "bfloat16")),
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg.get("intermediate_size", 0),
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg.get(
            "num_key_value_heads", cfg["num_attention_heads"]
        ),
        head_dim=cfg.get("head_dim", 0) or 0,
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
        rope_theta=cfg.get("rope_theta", 10000.0),
        rope_scaling=cfg.get("rope_scaling"),
        max_position_embeddings=cfg.get("max_position_embeddings", 32768),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        # mimo defaults attention_bias=true (reference mimo.h LOAD_ARG_OR)
        attention_bias=model_type in ("qwen2", "mimo")
        if "attention_bias" not in cfg
        else bool(cfg.get("attention_bias")),
        qk_norm=model_type in ("qwen3", "qwen3_moe")
        or bool(cfg.get("use_qk_norm", False)),
        partial_rotary_factor=cfg.get("partial_rotary_factor")
        or (
            # minimax-m2 convention: explicit rotary_dim out of head_dim
            cfg["rotary_dim"] / (cfg.get("head_dim") or 128)
            if cfg.get("rotary_dim")
            else 1.0
        ),
        use_sandwich_norms=model_type == "glm4",
        sliding_window=cfg.get("sliding_window")
        if cfg.get("use_sliding_window", False)
        else None,
        num_experts=cfg.get("num_experts", 0)
        or cfg.get("n_routed_experts", 0)
        or cfg.get("num_local_experts", 0),
        num_experts_per_tok=cfg.get("num_experts_per_tok", 0),
        moe_intermediate_size=cfg.get("moe_intermediate_size", 0),
        norm_topk_prob=cfg.get("norm_topk_prob", False),
        decoder_sparse_step=cfg.get("decoder_sparse_step", 1),
        mlp_only_layers=cfg.get("mlp_only_layers", []) or [],
        q_lora_rank=cfg.get("q_lora_rank") or 0,
        kv_lora_rank=cfg.get("kv_lora_rank") or 0,
        qk_nope_head_dim=cfg.get("qk_nope_head_dim") or 0,
        qk_rope_head_dim=cfg.get("qk_rope_head_dim") or 0,
        v_head_dim=cfg.get("v_head_dim") or 0,
        first_k_dense_replace=cfg.get("first_k_dense_replace") or 0,
        n_shared_experts=cfg.get("n_shared_experts") or 0,
        routed_scaling_factor=cfg.get("routed_scaling_factor") or 1.0,
        scoring_func=cfg.get("scoring_func", "softmax"),
        n_group=cfg.get("n_group") or 1,
        topk_group=cfg.get("topk_group") or 1,
        eos_token_ids=eos,
    )
    if model_type in ("deepseek_v32", "glm_moe_dsa") or cfg.get(
        "index_topk"
    ):
        # DSA (reference deepseek_v32.h:224-232, glm5.h:21-43 shares the
        # arch): lightning indexer dims + top-k selection size
        mc.index_topk = cfg.get("index_topk", 2048)
        mc.index_n_heads = cfg.get("index_n_heads", 64)
        mc.index_head_dim = cfg.get("index_head_dim", 128)
    if model_type == "glm4_moe":
        # sigmoid routing + correction bias are hardcoded in the HF
        # Glm4MoeTopkRouter; partial rope uses the llama rotate-half
        # convention (not glm4-dense's interleaved pairs)
        mc.scoring_func = "sigmoid"
        mc.rope_interleaved = False
    if model_type in ("qwen3_next", "qwen3_5"):
        mc.qk_norm = True
        mc.full_attention_interval = cfg.get("full_attention_interval", 4)
        mc.linear_conv_kernel_dim = cfg.get("linear_conv_kernel_dim", 4)
        mc.linear_key_head_dim = cfg.get("linear_key_head_dim", 128)
        mc.linear_num_key_heads = cfg.get("linear_num_key_heads", 16)
        mc.linear_value_head_dim = cfg.get("linear_value_head_dim", 128)
        mc.linear_num_value_heads = cfg.get("linear_num_value_heads", 32)
        mc.shared_expert_intermediate_size = cfg.get(
            "shared_expert_intermediate_size", 0
        )
        if not cfg.get("partial_rotary_factor"):
            mc.partial_rotary_factor = 0.25
    if model_type in ("qwen3_vl", "qwen3_vl_moe"):
        # qwen3 text backbone (qk_norm, no attention bias) + v3 tower +
        # DeepStack (reference xllm/models/vlm/qwen3_vl.h)
        mc.qk_norm = True
        mc.attention_bias = False
        mc.vision = dict(cfg.get("vision_config", {}) or {})
        rs = cfg.get("rope_scaling") or {}
        mc.mrope_section = list(rs.get("mrope_section", []) or [])
        mc.image_token_id = cfg.get("image_token_id", -1)
        mc.video_token_id = cfg.get("video_token_id", -1)
        mc.vision_start_token_id = cfg.get("vision_start_token_id", -1)
    if model_type in ("glm4v", "glm4v_moe"):
        # glm4v: glm4 text backbone (sandwich norms, q/k/v bias, fused
        # gate_up, partial-INTERLEAVED M-RoPE); glm4v_moe (GLM-4.5V):
        # glm4_moe backbone (sigmoid noaux routing, chunked rotate-half
        # partial M-RoPE, no sandwich norms) — HF modeling_glm4v[_moe]
        if model_type == "glm4v":
            mc.use_sandwich_norms = True
            mc.attention_bias = True
            mc.rope_interleaved = True
        else:
            mc.scoring_func = "sigmoid"
            mc.rope_interleaved = False
        if not cfg.get("partial_rotary_factor"):
            mc.partial_rotary_factor = 0.5
        mc.vision = dict(cfg.get("vision_config", {}) or {})
        rs = cfg.get("rope_scaling") or {}
        mc.mrope_section = list(rs.get("mrope_section", []) or [])
        mc.image_token_id = cfg.get("image_token_id", -1)
        mc.video_token_id = cfg.get("video_token_id", -1)
        mc.vision_start_token_id = cfg.get("video_start_token_id", -1)
    if model_type in ("qwen2_vl", "qwen2_5_vl"):
        # VLM extras: vision tower config + M-RoPE sections + marker tokens.
        # HF nests the tower under "vision_config"; mrope sections live in
        # rope_scaling.mrope_section (qwen2-vl convention).
        vc = dict(cfg.get("vision_config", {}) or {})
        mc.vision = vc
        mc.attention_bias = True  # qwen2 LM backbone
        rs = cfg.get("rope_scaling") or {}
        mc.mrope_section = list(rs.get("mrope_section", []) or [])
        mc.image_token_id = cfg.get("image_token_id", -1)
        mc.video_token_id = cfg.get("video_token_id", -1)
        mc.vision_start_token_id = cfg.get("vision_start_token_id", -1)
    return mc


def load_model_config(model_path: str) -> ModelConfig:
    with open(os.path.join(model_path, "config.json")) as f:
        cfg = json.load(f)
    return model_config_from_hf_dict(cfg, model_path)
