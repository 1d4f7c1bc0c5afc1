"""Carry the JAX model's parameter tree into the port.

The JAX ``DenseDecoderModel.init_params`` (and its HF loader) produce a
nested dict: ``embed_tokens [V, D]``, ``norm [D]``, optional ``lm_head
[D, V]``, and ``layers`` holding every per-layer tensor stacked on a
leading L axis (``qkv_proj_w [L, D, Hkv*(G+2)*dh]`` packed group-major,
``o_proj_w [L, Hq*dh, D]``, ...). The port's modules keep the same names
and layouts, so the carry is a copy: layer i of each stack goes to
``model.layers[i]``. Arrays may be numpy (bfloat16 numpy arrays included)
or torch tensors.

A MoE tree (``xllm_tpu/models/moe_decoder.py``) holds the MoE layers'
stacks under ``layers`` (router, expert stacks, the f32 ``router_bias``
of sigmoid routing, optional ``shared_*`` projections, and the int32 EPLB
slot map ``expert_placement``) and the ``first_k_dense_replace`` dense
layers under ``dense_layers``; they go to ``model.layers[n_dense:]`` and
``model.layers[:n_dense]``. EPLB is not ported: the placement must be the
identity, which is checked here, once, on the host.

An MLA tree (``xllm_tpu/models/mla_decoder.py``) names its groups
``dense_layers`` (the first ``first_k_dense_replace`` layers, or every
layer of a model without experts) and ``moe_layers``; its attention keys
are ``kv_a_proj_w``, ``kv_a_norm``, ``kv_b_nope_w [H, kvr, nope]``,
``kv_b_v_w [H, kvr, vh]``, ``o_proj_w`` and either ``q_proj_w`` or
``q_a_proj_w`` / ``q_a_norm`` / ``q_b_proj_w``.

A hybrid tree (``xllm_tpu/models/qwen3_next.py``) holds every layer's
tensors under ``groups``, stacked ``[G, I1, ...]`` (the linear sublayers'
``lin_*``, with the f32 ``lin_A_log`` and ``lin_dt_bias``), ``[G, ...]``
(the full-attention layers' ``full_*``) and ``[G, interval, ...]`` (every
layer's MLP); the port's ``Qwen3NextModel`` keeps the stacks as they are
(``model.groups``), so they are copied whole.

A quantized tree (the JAX runner's ``_quantize_params``) holds int8 or
float8_e4m3fn ``*_proj_w`` stacks beside f32 ``*_scale`` stacks (under fp8
also the MoE groups' ``experts_gate_up`` / ``experts_down`` with their
``[L, E, N]`` scales); it loads into a model built with the same ``quant``
method, byte for byte. The MTP draft head's tree (``load_mtp_head_params``)
is unquantized and loads into ``models/mtp_head.MTPHead``. numpy has
no float8 type of its own: a JAX float8 array arrives as an ml_dtypes array
and is carried through its bytes, so the port never imports ml_dtypes.
"""

from __future__ import annotations

import numpy as np
import torch

from xllm_tpu_torch.config import ModelConfig


# ml_dtypes types of a JAX array, by name -> (bytes as numpy, torch dtype)
_BYTE_VIEWS = {"bfloat16": (np.uint16, torch.bfloat16),
               "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name in _BYTE_VIEWS:
        raw, dtype = _BYTE_VIEWS[a.dtype.name]
        return torch.from_numpy(np.ascontiguousarray(a).view(raw).copy()).view(dtype)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a)  # a JAX array's numpy view is read-only
    return torch.from_numpy(a)


@torch.no_grad()
def load_param_tree(model, tree: dict) -> None:
    """Copy a JAX-layout parameter tree into ``model`` in place (cast to
    the model's dtype, moved to its device)."""
    put_param(model.embed_tokens, tree["embed_tokens"])
    put_param(model.norm, tree["norm"])
    if "lm_head" in tree:
        put_param(model.lm_head, tree["lm_head"])
    if getattr(model, "is_hybrid", False):
        stacks = tree["groups"]
        names = {n for n, _ in model.groups.named_parameters()}
        if set(stacks) != names:
            raise ValueError(f"groups tensors {sorted(stacks)} != model's {sorted(names)}")
        for name, stack in stacks.items():
            put_param(getattr(model.groups, name), stack)
        return
    for group, layers in layer_groups(model).items():
        stacks = dict(tree[group])
        placement = stacks.pop("expert_placement", None)
        if placement is not None:
            placement = as_tensor(placement).cpu().numpy()
            if not (placement == np.arange(placement.shape[-1])).all():
                raise NotImplementedError("EPLB placements are not ported yet")
        names = {n for n, _ in layers[0].named_parameters()}
        if set(stacks) != names:
            raise ValueError(
                f"{group} tensors {sorted(stacks)} != model's {sorted(names)}"
            )
        for name, stack in stacks.items():
            stack = as_tensor(stack)
            for i, layer in enumerate(layers):
                put_param(getattr(layer, name), stack[i])


@torch.no_grad()
def load_mtp_head_params(head, tree: dict) -> None:
    """Copy the JAX ``MTPHead`` parameter tree (``enorm``, ``hnorm``,
    ``eh_proj``, ``norm`` and the one-layer stacks under ``layers``, each
    ``[1, ...]``) into the port's ``MTPHead`` in place."""
    stacks = tree["layers"]
    names = {n for n, _ in head.layer.named_parameters()}
    if set(stacks) != names:
        raise ValueError(f"head layer tensors {sorted(stacks)} != model's {sorted(names)}")
    for name in ("enorm", "hnorm", "eh_proj", "norm"):
        put_param(getattr(head, name), tree[name])
    for name, stack in stacks.items():
        put_param(getattr(head.layer, name), as_tensor(stack)[0])


def layer_groups(model) -> dict:
    """The JAX tree's layer groups -> the model's layers they hold (groups
    without layers left out): ``dense_layers`` the first ``model.n_dense``,
    ``layers`` (``moe_layers`` in an MLA tree: ``model.moe_group``) the
    rest."""
    n_dense = getattr(model, "n_dense", 0)
    groups = {"dense_layers": model.layers[:n_dense],
              getattr(model, "moe_group", "layers"): model.layers[n_dense:]}
    return {g: layers for g, layers in groups.items() if len(layers)}


def put_param(param: torch.Tensor, value) -> None:
    """``param`` <- ``value`` (cast to its dtype, moved to its device)."""
    value = as_tensor(value)
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(value.shape)} does not fit {tuple(param.shape)}")
    if param.dtype in (torch.int8, torch.float8_e4m3fn):
        # quantized weights carry their bytes; a cast would change them
        if value.dtype != param.dtype:
            raise ValueError(f"a {param.dtype} weight cannot load {value.dtype} values")
        param.view(torch.uint8).copy_(value.view(torch.uint8).to(param.device))
        return
    param.copy_(value.to(device=param.device, dtype=param.dtype))


def random_param_tree(cfg: ModelConfig, seed: int) -> dict:
    """A JAX-layout parameter tree of f32 numpy arrays from ``seed``, with
    the shapes and init rule of the JAX ``init_params`` (norms 1, biases 0,
    weights N(0, 0.02); for a MoE config the router bias 0 and the identity
    expert placement); the same tree loads into either package."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape, np.float32) * 0.02).astype(np.float32)

    if cfg.kv_lora_rank > 0:
        return _random_mla_tree(cfg, w)
    from xllm_tpu_torch.models.registry import HYBRID_FAMILIES

    if cfg.model_type in HYBRID_FAMILIES:
        return _random_hybrid_tree(cfg, w)
    hq, hkv, dh = cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim
    g = hq // hkv
    L, D, I, V = (cfg.num_hidden_layers, cfg.hidden_size,
                  cfg.intermediate_size, cfg.vocab_size)
    layers = {
        "input_layernorm": np.ones((L, D), np.float32),
        "post_attention_layernorm": np.ones((L, D), np.float32),
        "qkv_proj_w": w(L, D, hkv * (g + 2) * dh),
        "o_proj_w": w(L, hq * dh, D),
        "gate_proj_w": w(L, D, I),
        "up_proj_w": w(L, D, I),
        "down_proj_w": w(L, I, D),
    }
    if cfg.attention_bias:
        layers["qkv_proj_b"] = np.zeros((L, hkv * (g + 2) * dh), np.float32)
    if cfg.qk_norm:
        layers["q_norm"] = np.ones((L, dh), np.float32)
        layers["k_norm"] = np.ones((L, dh), np.float32)
    if cfg.use_sandwich_norms:
        layers["post_self_attn_layernorm"] = np.ones((L, D), np.float32)
        layers["post_mlp_layernorm"] = np.ones((L, D), np.float32)
    tree = {
        "embed_tokens": w(V, D),
        "layers": layers,
        "norm": np.ones((D,), np.float32),
    }
    if cfg.num_experts > 0:
        nd = cfg.first_k_dense_replace
        if nd > 0:
            tree["dense_layers"] = {k: v[:nd] for k, v in layers.items()}
        moe = tree["layers"] = {
            k: v[nd:] for k, v in layers.items()
            if k not in ("gate_proj_w", "up_proj_w", "down_proj_w")
        }
        _add_experts(moe, cfg, L - nd, w)
    if not cfg.tie_word_embeddings:
        tree["lm_head"] = w(D, V)
    return tree


def _add_experts(stacks: dict, cfg: ModelConfig, n: int, w) -> None:
    """The MoE stacks of ``n`` layers: router (f32 zero bias for sigmoid
    routing), experts, shared experts, identity placement."""
    D, E, MI = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size
    stacks["router_w"] = w(n, D, E)
    if cfg.scoring_func == "sigmoid":
        stacks["router_bias"] = np.zeros((n, E), np.float32)
    stacks["experts_gate_up"] = w(n, E, D, 2 * MI)
    stacks["experts_down"] = w(n, E, MI, D)
    if cfg.n_shared_experts > 0:
        SI = cfg.n_shared_experts * MI
        stacks["shared_gate_proj_w"] = w(n, D, SI)
        stacks["shared_up_proj_w"] = w(n, D, SI)
        stacks["shared_down_proj_w"] = w(n, SI, D)
    stacks["expert_placement"] = np.tile(np.arange(E, dtype=np.int32), (n, 1))


def _random_mla_tree(cfg: ModelConfig, w) -> dict:
    """The JAX ``MlaDecoderModel.init_params`` tree's shapes and rule."""
    L, D, I, V = (cfg.num_hidden_layers, cfg.hidden_size,
                  cfg.intermediate_size, cfg.vocab_size)
    H, qr, kvr = cfg.num_attention_heads, cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    n_dense = cfg.first_k_dense_replace if cfg.num_experts > 0 else L

    def attn(n):
        p = {
            "input_layernorm": np.ones((n, D), np.float32),
            "post_attention_layernorm": np.ones((n, D), np.float32),
            "kv_a_proj_w": w(n, D, kvr + rope),
            "kv_a_norm": np.ones((n, kvr), np.float32),
            "kv_b_nope_w": w(n, H, kvr, nope),
            "kv_b_v_w": w(n, H, kvr, vh),
            "o_proj_w": w(n, H * vh, D),
        }
        if qr > 0:
            p["q_a_proj_w"] = w(n, D, qr)
            p["q_a_norm"] = np.ones((n, qr), np.float32)
            p["q_b_proj_w"] = w(n, qr, H * (nope + rope))
        else:
            p["q_proj_w"] = w(n, D, H * (nope + rope))
        return p

    tree = {"embed_tokens": w(V, D), "norm": np.ones((D,), np.float32)}
    if not cfg.tie_word_embeddings:
        tree["lm_head"] = w(D, V)
    if n_dense > 0:
        dense = tree["dense_layers"] = attn(n_dense)
        dense["gate_proj_w"] = w(n_dense, D, I)
        dense["up_proj_w"] = w(n_dense, D, I)
        dense["down_proj_w"] = w(n_dense, I, D)
    if L > n_dense:
        tree["moe_layers"] = moe = attn(L - n_dense)
        _add_experts(moe, cfg, L - n_dense, w)
    return tree


def _random_hybrid_tree(cfg: ModelConfig, w) -> dict:
    """The JAX ``Qwen3NextModel.init_params`` tree's shapes and rule: norms,
    the gated norm and ``lin_dt_bias`` 1, ``lin_A_log`` 0 (both f32), the
    conv N(0, 0.3), every other weight N(0, 0.02)."""
    from xllm_tpu_torch.models import qwen3_next as qn

    groups = {}
    for name, shape in qn.Qwen3NextModel(cfg, device="meta").stack_shapes().items():
        if name in qn.INIT_ZEROS:
            groups[name] = np.zeros(shape, np.float32)
        elif name in qn.INIT_ONES:
            groups[name] = np.ones(shape, np.float32)
        elif name == "lin_conv_w":
            groups[name] = w(*shape) * np.float32(qn.CONV_SCALE / 0.02)
        else:
            groups[name] = w(*shape)
    D = cfg.hidden_size
    tree = {"embed_tokens": w(cfg.vocab_size, D), "norm": np.ones((D,), np.float32),
            "groups": groups}
    if not cfg.tie_word_embeddings:
        tree["lm_head"] = w(D, cfg.vocab_size)
    return tree
