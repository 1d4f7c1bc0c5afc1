"""Dense decoder-only transformer (llama / mistral / qwen2 / qwen3 / glm4 families).

Counterpart of ``xllm_tpu/models/decoder.py`` ``DenseDecoderModel`` as an
``nn.Module``. Weights keep the JAX package's layout, so the HF loader
mapping and ``weights.py`` carry over unchanged:

- projections are ``[in, out]`` and apply as ``x @ w``;
- ``qkv_proj_w`` packs Q/K/V group-major, out dim = Hkv groups x (G q-heads
  + 1 K + 1 V) x head_dim, so a tensor-parallel shard of the out dim would
  hold whole GQA groups.

The JAX ``lax.scan`` over stacked layers becomes a Python loop over
``DecoderLayer`` modules; the paged cache keeps its leading L axis, so the
loop passes ``layer_idx`` into the attention kernels, which update the
cache in place. Dense projections, norms, rope and the lm_head are plain
PyTorch (the JAX package left them to XLA).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from xllm_tpu_torch.config import ModelConfig
from xllm_tpu_torch.ops.attention import (
    decode_attention_write,
    prefill_attention_write_batched,
)
from xllm_tpu_torch.ops.linear import linear_f32
from xllm_tpu_torch.ops.norms import rms_norm
from xllm_tpu_torch.ops.rope import (
    apply_rope,
    apply_rope_partial,
    apply_rope_partial_interleaved_cos,
    rope_inv_freq,
    rope_mscale,
)
from xllm_tpu_torch.runtime.forward_params import BatchedPrefillInput, DecodeInput

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.bfloat16,  # as the JAX package: fp16 checkpoints run in bf16
}


def _param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(
        torch.empty(shape, dtype=dtype, device=device), requires_grad=False
    )


class DecoderLayer(nn.Module):
    """One layer's parameters, named as the JAX parameter tree's keys.
    ``dense_mlp=False`` leaves out the dense MLP (a MoE layer)."""

    def __init__(self, cfg: ModelConfig, dtype, device, dense_mlp: bool = True) -> None:
        super().__init__()
        hq, hkv, dh = cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim
        g = hq // hkv
        d, i = cfg.hidden_size, cfg.intermediate_size
        kw = dict(dtype=dtype, device=device)
        self.input_layernorm = _param(d, **kw)
        self.post_attention_layernorm = _param(d, **kw)
        self.qkv_proj_w = _param(d, hkv * (g + 2) * dh, **kw)
        self.o_proj_w = _param(hq * dh, d, **kw)
        if dense_mlp:
            self.gate_proj_w = _param(d, i, **kw)
            self.up_proj_w = _param(d, i, **kw)
            self.down_proj_w = _param(i, d, **kw)
        if cfg.attention_bias:
            self.qkv_proj_b = _param(hkv * (g + 2) * dh, **kw)
        if cfg.qk_norm:
            self.q_norm = _param(dh, **kw)
            self.k_norm = _param(dh, **kw)
        if cfg.use_sandwich_norms:
            self.post_self_attn_layernorm = _param(d, **kw)
            self.post_mlp_layernorm = _param(d, **kw)


class DenseDecoderModel(nn.Module):
    kv_layout = "split"
    supports_batched_prefill = True

    def __init__(self, cfg: ModelConfig, device="cpu") -> None:
        super().__init__()
        if cfg.num_attention_heads % cfg.num_kv_heads:
            raise ValueError("num_attention_heads must be a multiple of num_kv_heads")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = _DTYPES[cfg.dtype]
        self.scale = cfg.head_dim**-0.5 * rope_mscale(cfg.rope_scaling) ** 2
        # sliding-window attention (mistral/qwen2); 0 = full attention
        self.window = int(cfg.sliding_window or 0)
        kw = dict(dtype=self.dtype, device=self.device)
        self.embed_tokens = _param(cfg.vocab_size, cfg.hidden_size, **kw)
        self.layers = nn.ModuleList(
            self._make_layer(i) for i in range(cfg.num_hidden_layers)
        )
        self.norm = _param(cfg.hidden_size, **kw)
        if not cfg.tie_word_embeddings:
            self.lm_head = _param(cfg.hidden_size, cfg.vocab_size, **kw)
        # partial rope (glm4, glm4-moe, minimax-m2) rotates the first
        # rotary_dim dims of each head, with frequencies of that width
        self.rotary_dim = int(cfg.head_dim * cfg.partial_rotary_factor)
        self.register_buffer(
            "inv_freq",
            rope_inv_freq(self.rotary_dim, cfg.rope_theta, cfg.rope_scaling).to(
                self.device
            ),
            persistent=False,
        )

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def _make_layer(self, layer_idx: int) -> nn.Module:
        return DecoderLayer(self.cfg, self.dtype, self.device)

    @torch.no_grad()
    def init_random_(self, seed: int) -> None:
        """Random init from ``seed`` (tests / synthetic runs): norms 1,
        biases (the MoE router's too) 0, every other weight N(0, 0.02)
        drawn in f32 and cast, as the JAX ``init_params`` does (its bits
        differ: another RNG)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("norm") or leaf.endswith("layernorm"):
                p.fill_(1.0)
            elif leaf.endswith(("_b", "_bias")):
                p.zero_()
            else:
                w = torch.randn(
                    p.shape, generator=gen, device=self.device,
                    dtype=torch.float32,
                )
                p.copy_(w * 0.02)

    # ------------------------------------------------------------------
    # KV cache
    # ------------------------------------------------------------------
    def kv_cache_shape(self, num_blocks: int, block_size: int) -> tuple[int, ...]:
        c = self.cfg
        return (c.num_hidden_layers, num_blocks, c.num_kv_heads, block_size,
                c.head_dim)

    def kv_bytes_per_token(self, bytes_per_el: int | None = None) -> int:
        """Per-token KV bytes across all layers (capacity estimation)."""
        c = self.cfg
        if bytes_per_el is None:
            bytes_per_el = self.dtype.itemsize
        return c.num_hidden_layers * 2 * c.num_kv_heads * c.head_dim * bytes_per_el

    def new_kv_cache(
        self, num_blocks: int, block_size: int, dtype=None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        shape = self.kv_cache_shape(num_blocks, block_size)
        dt = dtype or self.dtype
        return (
            torch.zeros(shape, dtype=dt, device=self.device),
            torch.zeros(shape, dtype=dt, device=self.device),
        )

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _mlp(self, lp: DecoderLayer, x: torch.Tensor) -> torch.Tensor:
        # gate and up stay in f32 through SiLU x up; one rounding before
        # the down projection (the JAX _linear's preferred_element_type)
        gate = linear_f32(x, lp.gate_proj_w)
        up = linear_f32(x, lp.up_proj_w)
        act = (F.silu(gate) * up).to(x.dtype)
        return torch.matmul(act, lp.down_proj_w)

    def _attn_qkv(
        self, lp: DecoderLayer, x: torch.Tensor, positions: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        c = self.cfg
        t = x.shape[0]
        hkv, dh = c.num_kv_heads, c.head_dim
        g = c.num_attention_heads // hkv
        if c.attention_bias:
            # the bias joins the f32 product; one rounding after it
            qkv = (linear_f32(x, lp.qkv_proj_w) + lp.qkv_proj_b).to(x.dtype)
        else:
            qkv = torch.matmul(x, lp.qkv_proj_w)
        # group-major fused layout: [T, hkv, g+2, dh]
        qkv = qkv.reshape(t, hkv, g + 2, dh)
        q = qkv[:, :, :g].reshape(t, c.num_attention_heads, dh)
        k = qkv[:, :, g]
        v = qkv[:, :, g + 1]
        if c.qk_norm:
            q = rms_norm(q, lp.q_norm, c.rms_norm_eps)
            k = rms_norm(k, lp.k_norm, c.rms_norm_eps)
        if c.partial_rotary_factor < 1.0:
            partial = (apply_rope_partial_interleaved_cos if c.rope_interleaved
                       else apply_rope_partial)
            q, k = partial(q, k, positions, self.inv_freq, self.rotary_dim)
        else:
            q, k = apply_rope(q, k, positions, self.inv_freq)
        return q, k, v

    def _run_layers(
        self,
        x: torch.Tensor,  # [T, D]
        positions: torch.Tensor,  # [T]
        attn_fn,  # (q, k, v, layer_idx) -> attn [T, Hq, D]
    ) -> torch.Tensor:
        c = self.cfg
        t = x.shape[0]
        for layer_idx, lp in enumerate(self.layers):
            h = rms_norm(x, lp.input_layernorm, c.rms_norm_eps)
            q, k, v = self._attn_qkv(lp, h, positions)
            attn = attn_fn(q, k, v, layer_idx).reshape(
                t, c.num_attention_heads * c.head_dim
            )
            attn_out = torch.matmul(attn, lp.o_proj_w)
            if c.use_sandwich_norms:
                attn_out = rms_norm(
                    attn_out, lp.post_self_attn_layernorm, c.rms_norm_eps
                )
            x = x + attn_out
            h = rms_norm(x, lp.post_attention_layernorm, c.rms_norm_eps)
            mlp_out = self._mlp(lp, h)
            if c.use_sandwich_norms:
                mlp_out = rms_norm(mlp_out, lp.post_mlp_layernorm, c.rms_norm_eps)
            x = x + mlp_out
        return rms_norm(x, self.norm, c.rms_norm_eps)

    def prefill_batched(
        self,
        k_all: torch.Tensor,
        v_all: torch.Tensor,
        inp: BatchedPrefillInput,
        num_logits: int = 1,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (hidden [P, num_logits, D], k_all, v_all); the caches are
        updated in place. P chunks from P sequences in one pass."""
        c = self.cfg
        p, s = inp.token_ids.shape
        attn_fn = self._prefill_attn_fn(k_all, v_all, inp)
        x = self.embed_tokens[inp.token_ids.reshape(-1).long()]
        x = self._run_layers(x, inp.positions.reshape(-1), attn_fn)
        x = x.reshape(p, s, -1)
        idx = (
            inp.logits_idx.long()[:, None]
            - (num_logits - 1)
            + torch.arange(num_logits, device=x.device)[None, :]
        ).clamp(min=0)  # [P, num_logits]
        hidden = torch.gather(x, 1, idx[..., None].expand(-1, -1, c.hidden_size))
        return hidden, k_all, v_all

    def decode(
        self,
        k_all: torch.Tensor,
        v_all: torch.Tensor,
        inp: DecodeInput,
        token_ids: torch.Tensor,  # [B] (gathered from the last_tokens ring)
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (hidden [B, D], k_all, v_all); the caches are updated in place."""
        x = self.embed_tokens[token_ids.long()]
        x = self._run_layers(x, inp.positions, self._decode_attn_fn(k_all, v_all, inp))
        return x, k_all, v_all

    def _prefill_attn_fn(self, k_all, v_all, inp: BatchedPrefillInput):
        """The attention step ``_run_layers`` calls in a prefill pass."""
        p, s = inp.token_ids.shape

        def attn_fn(q, k, v, layer_idx):
            out, _, _ = prefill_attention_write_batched(
                q.reshape(p, s, *q.shape[1:]),
                k.reshape(p, s, *k.shape[1:]),
                v.reshape(p, s, *v.shape[1:]),
                k_all, v_all, layer_idx, inp.slot_mapping, inp.block_tables,
                inp.q_offsets, inp.kv_lens, self.scale, window=self.window,
            )
            return out.reshape(p * s, *out.shape[2:])

        return attn_fn

    def _decode_attn_fn(self, k_all, v_all, inp: DecodeInput):
        """The attention step ``_run_layers`` calls in a decode pass."""

        def attn_fn(q, k, v, layer_idx):
            out, _, _ = decode_attention_write(
                q, k, v, k_all, v_all, layer_idx, inp.slot_mapping,
                inp.block_tables, inp.seq_lens, self.scale, window=self.window,
            )
            return out

        return attn_fn

    def compute_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """[N, D] -> [N, V] in the model dtype."""
        head = (
            self.embed_tokens.t()
            if self.cfg.tie_word_embeddings
            else self.lm_head
        )
        return torch.matmul(hidden, head)
