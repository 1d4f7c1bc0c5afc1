"""DeepSeek-style MLA decoder (deepseek v2/v3, kimi-k2, glm4-moe-lite).

Counterpart of ``xllm_tpu/models/mla_decoder.py`` ``MlaDecoderModel`` and
``Glm4MoeLiteModel`` without DSA (``index_topk > 0`` raises: the lightning
indexer is not ported yet). As there:

- the paged cache holds the absorbed latent per token, ``[c_kv (kv_lora_rank,
  rms-normed) | k_pe (rope dims, roped)]``, padded to ``dk_pad`` lanes (a
  multiple of 128 above 128) with zeros, in the layout ``[L, NB, 1, bs,
  dk_pad]``; the v cache is a one-element dummy;
- W_UK is absorbed into q and W_UV applied to the latent output by per-head
  products against ``kv_b_nope_w [H, kvr, nope]`` / ``kv_b_v_w [H, kvr,
  vh]``, each summed in f32 and rounded once (``ops/linear.bmm_round_once``);
- the first ``first_k_dense_replace`` layers (every layer when there are no
  experts) keep the dense MLP, the rest run the MoE block (routed experts x
  ``routed_scaling_factor`` plus the shared experts, ``moe_decoder.py``);
- the softmax scale is ``(qk_nope + qk_rope)^-0.5 x mscale^2`` (YaRN);
- quantized (``quant="int8" | "fp8_e4m3"``) with the JAX runner's
  eligibility: every ``*_proj_w`` (q / q_a / q_b / kv_a / o, the dense
  MLP, the shared experts) is int8 or float8_e4m3fn with its ``*_scale``
  and goes through ``_linear``; ``kv_b_nope_w`` / ``kv_b_v_w`` and the
  router never are; the routed experts only under fp8 (``moe_decoder``).
  The latent cache may be float8_e4m3fn (``kv_cache_dtype="fp8_e4m3"``);
  an int8 latent cache raises, as in the JAX runner.

The JAX ``lax.scan`` over the ``dense_layers`` and ``moe_layers`` stacks is
one Python loop over ``MlaLayer`` modules; ``weights.py`` carries the two
stacks in.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from xllm_tpu_torch.config import ModelConfig
from xllm_tpu_torch.models.decoder import DenseDecoderModel, _param, make_proj
from xllm_tpu_torch.models.moe_decoder import MoeDecoderModel, add_experts
from xllm_tpu_torch.ops.linear import bmm_round_once
from xllm_tpu_torch.ops.mla import (
    mla_decode_attention_write,
    mla_prefill_attention_write,
    mla_prefill_attention_write_batched,
)
from xllm_tpu_torch.ops.norms import rms_norm
from xllm_tpu_torch.ops.rope import (
    apply_rope,
    apply_rope_interleaved,
    rope_inv_freq,
    rope_mscale,
)
from xllm_tpu_torch.runtime.forward_params import (
    BatchedPrefillInput,
    DecodeInput,
    PrefillInput,
)


def _dense_layers(cfg: ModelConfig) -> int:
    """Layers with the dense MLP: the first ``first_k_dense_replace``, or
    all of them in a model without experts."""
    return cfg.first_k_dense_replace if cfg.num_experts > 0 else cfg.num_hidden_layers


class MlaLayer(nn.Module):
    """One layer's parameters, named as the JAX tree's keys: the MLA
    attention, then the dense MLP or (``moe=True``) the expert block."""

    def __init__(self, cfg: ModelConfig, dtype, device, moe: bool, quant: str = "") -> None:
        super().__init__()
        h, d = cfg.num_attention_heads, cfg.hidden_size
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        nope, rope, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        kw = dict(dtype=dtype, device=device)
        proj = make_proj(self, dtype, device, quant)
        self.input_layernorm = _param(d, **kw)
        self.post_attention_layernorm = _param(d, **kw)
        proj("kv_a_proj_w", d, kvr + rope)
        self.kv_a_norm = _param(kvr, **kw)
        self.kv_b_nope_w = _param(h, kvr, nope, **kw)
        self.kv_b_v_w = _param(h, kvr, vh, **kw)
        proj("o_proj_w", h * vh, d)
        if qr > 0:
            proj("q_a_proj_w", d, qr)
            self.q_a_norm = _param(qr, **kw)
            proj("q_b_proj_w", qr, h * (nope + rope))
        else:
            proj("q_proj_w", d, h * (nope + rope))
        if not moe:
            i = cfg.intermediate_size
            proj("gate_proj_w", d, i)
            proj("up_proj_w", d, i)
            proj("down_proj_w", i, d)
            return
        add_experts(self, cfg, dtype, device, quant, proj)


class MlaDecoderModel(DenseDecoderModel):
    # the latent cache has its own layout and no int8 scales (as the JAX
    # model: the runner raises for an int8 KV, and keeps the split layout,
    # with a warning, when an interleaved one is asked for)
    supports_int8_kv = False
    supports_interleaved_kv = False
    moe_group = "moe_layers"  # the JAX tree's key of the MoE layer stacks
    # rope on the qk_rope dims: "interleaved" (deepseek complex pairs) or
    # "neox" (glm4-moe-lite's rotate-half)
    mla_rope_style = "interleaved"

    def __init__(self, cfg: ModelConfig, device="cpu", quant: str = "") -> None:
        if cfg.kv_lora_rank <= 0:
            raise ValueError("MlaDecoderModel requires kv_lora_rank > 0")
        if cfg.index_topk > 0:
            raise NotImplementedError(
                "DSA (index_topk > 0: deepseek-v3.2 / glm5 sparse attention) "
                "is not ported yet"
            )
        super().__init__(cfg, device=device, quant=quant)
        self.n_dense = _dense_layers(cfg)
        self.dk = cfg.kv_lora_rank + cfg.qk_rope_head_dim
        self.dk_pad = -(-self.dk // 128) * 128 if self.dk > 128 else self.dk
        self.dv = cfg.kv_lora_rank
        qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        self.scale = qk_dim**-0.5 * rope_mscale(cfg.rope_scaling) ** 2
        self.inv_freq = rope_inv_freq(
            cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_scaling
        ).to(self.device)

    def _make_layer(self, layer_idx: int) -> nn.Module:
        moe = layer_idx >= _dense_layers(self.cfg)
        return MlaLayer(self.cfg, self.dtype, self.device, moe=moe, quant=self.quant)

    # ------------------------------------------------------------------
    # latent KV cache
    # ------------------------------------------------------------------
    def kv_cache_shape(self, num_blocks: int, block_size: int) -> tuple[int, ...]:
        return (self.cfg.num_hidden_layers, num_blocks, 1, block_size, self.dk_pad)

    def kv_bytes_per_token(self, bytes_per_el: int | None = None) -> int:
        if bytes_per_el is None:
            bytes_per_el = self.dtype.itemsize
        return self.cfg.num_hidden_layers * self.dk_pad * bytes_per_el

    def new_kv_cache(self, num_blocks: int, block_size: int, dtype=None):
        dt = dtype or self.dtype
        cache = torch.zeros(self.kv_cache_shape(num_blocks, block_size), dtype=dt,
                            device=self.device)
        # the v slot is unused: latent pages serve both K and V
        return cache, torch.zeros((1,), dtype=dt, device=self.device)

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _mla_qkv(self, lp: MlaLayer, h: torch.Tensor, positions: torch.Tensor):
        """normed hidden [T, D] -> (q_eff [T, H, dk_pad], lat_new [T, dk_pad])."""
        c = self.cfg
        t = h.shape[0]
        nope, rope, kvr = c.qk_nope_head_dim, c.qk_rope_head_dim, c.kv_lora_rank
        dt = h.dtype
        if c.q_lora_rank > 0:
            qa = rms_norm(self._linear(lp, "q_a_proj_w", h, dt), lp.q_a_norm, c.rms_norm_eps)
            q = self._linear(lp, "q_b_proj_w", qa, dt)
        else:
            q = self._linear(lp, "q_proj_w", h, dt)
        q = q.reshape(t, c.num_attention_heads, nope + rope)
        q_nope, q_pe = q[..., :nope], q[..., nope:]
        kv_a = self._linear(lp, "kv_a_proj_w", h, dt)
        c_kv = rms_norm(kv_a[:, :kvr], lp.kv_a_norm, c.rms_norm_eps)
        k_pe = kv_a[:, kvr:].reshape(t, 1, rope)
        rope_fn = apply_rope if self.mla_rope_style == "neox" else apply_rope_interleaved
        q_pe, k_pe = rope_fn(q_pe, k_pe, positions, self.inv_freq)
        # absorb W_UK into q: [H, T, nope] x [H, nope, kvr] -> [T, H, kvr]
        q_lat = bmm_round_once(q_nope.transpose(0, 1),
                               lp.kv_b_nope_w.transpose(1, 2)).transpose(0, 1)
        q_eff = torch.cat([q_lat, q_pe], dim=-1)
        lat_new = torch.cat([c_kv, k_pe[:, 0]], dim=-1)
        pad = self.dk_pad - self.dk
        if pad:
            q_eff = F.pad(q_eff, (0, pad))
            lat_new = F.pad(lat_new, (0, pad))
        return q_eff, lat_new

    def _mla_out(self, lp: MlaLayer, out_lat: torch.Tensor) -> torch.Tensor:
        """[T, H, kvr] latent attention output -> [T, D]."""
        t = out_lat.shape[0]
        out = bmm_round_once(out_lat.transpose(0, 1), lp.kv_b_v_w).transpose(0, 1)
        return self._linear(lp, "o_proj_w", out.reshape(t, -1), out_lat.dtype)

    def _mlp(self, lp: MlaLayer, x: torch.Tensor) -> torch.Tensor:
        if hasattr(lp, "router_w"):
            return self._moe_block(lp, x)
        return super()._mlp(lp, x)

    _moe_block = MoeDecoderModel._moe_block

    def _run_layers(self, x, positions, attn_fn):
        """attn_fn: (q_eff, lat_new, layer_idx) -> out_lat [T, H, dv]. ->
        the pre-final-norm states [T, D]."""
        c = self.cfg
        for layer_idx, lp in enumerate(self.layers):
            h = rms_norm(x, lp.input_layernorm, c.rms_norm_eps)
            q_eff, lat_new = self._mla_qkv(lp, h, positions)
            x = x + self._mla_out(lp, attn_fn(q_eff, lat_new, layer_idx))
            h = rms_norm(x, lp.post_attention_layernorm, c.rms_norm_eps)
            x = x + self._mlp(lp, h)
        return x

    def _prefill_attn_fn(self, k_all, v_all, inp: BatchedPrefillInput):
        p, s = inp.token_ids.shape

        def attn_fn(q_eff, lat_new, layer_idx):
            out, _ = mla_prefill_attention_write_batched(
                q_eff.reshape(p, s, *q_eff.shape[1:]),
                lat_new.reshape(p, s, -1), k_all, layer_idx, inp.slot_mapping,
                inp.block_tables, inp.q_offsets, inp.kv_lens, self.scale, self.dv,
            )
            return out.reshape(p * s, *out.shape[2:])

        return attn_fn

    def _chunk_attn_fn(self, k_all, v_all, inp: PrefillInput):
        """``prefill`` (one chunk; the dense model's, with its clamped row
        window) runs this latent step: K11f or K11g, then K11e."""

        def attn_fn(q_eff, lat_new, layer_idx):
            out, _ = mla_prefill_attention_write(
                q_eff, lat_new, k_all, layer_idx, inp.slot_mapping, inp.block_table,
                inp.q_offset, inp.kv_len, self.scale, self.dv,
            )
            return out

        return attn_fn

    def _decode_attn_fn(self, k_all, v_all, inp: DecodeInput):
        def attn_fn(q_eff, lat_new, layer_idx):
            out, _ = mla_decode_attention_write(
                q_eff, lat_new, k_all, layer_idx, inp.slot_mapping,
                inp.block_tables, inp.seq_lens, self.scale, self.dv,
            )
            return out

        return attn_fn


class Glm4MoeLiteModel(MlaDecoderModel):
    """glm4-moe-lite: the MLA architecture with GLM's rotate-half rope on
    the qk_rope dims; everything else differs only in config."""

    mla_rope_style = "neox"
