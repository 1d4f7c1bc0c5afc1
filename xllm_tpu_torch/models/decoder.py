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

Quantization (``quant="int8" | "fp8_e4m3"``): every ``*_proj_w`` is stored
in int8 or float8_e4m3fn with an f32 per-column ``*_scale``, and its product
goes through ``ops.quant.quant_matmul`` (``_linear``). With an int8 KV cache
(``set_kv_scales``) the per-layer-per-head scales stay outside the attention
kernels, as in the JAX model: s_k folds into q, the new K/V rows are
quantized to int8 codes before the kernels, and s_v multiplies the output.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from xllm_tpu_torch.config import ModelConfig
from xllm_tpu_torch.ops.attention import (
    decode_attention_write,
    prefill_attention_write,
    prefill_attention_write_batched,
)
from xllm_tpu_torch.ops.cuda.quant_matmul import matmul_bf16
from xllm_tpu_torch.ops.linear import linear_f32
from xllm_tpu_torch.ops.norms import rms_norm
from xllm_tpu_torch.ops.quant import quant_matmul, to_e4m3
from xllm_tpu_torch.ops.rope import (
    apply_rope,
    apply_rope_partial,
    apply_rope_partial_interleaved_cos,
    rope_inv_freq,
    rope_mscale,
)
from xllm_tpu_torch.runtime.forward_params import (
    BatchedPrefillInput,
    DecodeInput,
    PrefillInput,
)

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.bfloat16,  # as the JAX package: fp16 checkpoints run in bf16
}


def _param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(
        torch.empty(shape, dtype=dtype, device=device), requires_grad=False
    )


QUANT_WEIGHT_DTYPES = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}


def make_proj(layer: nn.Module, dtype, device, quant: str):
    """-> proj(name, k, n): adds the ``[k, n]`` projection ``name`` to
    ``layer``; with ``quant`` in int8 or float8_e4m3fn beside its f32
    ``<name>_scale [n]``."""

    def proj(name: str, k: int, n: int) -> None:
        if not quant:
            setattr(layer, name, _param(k, n, dtype=dtype, device=device))
            return
        setattr(layer, name, _param(k, n, dtype=QUANT_WEIGHT_DTYPES[quant], device=device))
        setattr(layer, name + "_scale", _param(n, dtype=torch.float32, device=device))

    return proj


class DecoderLayer(nn.Module):
    """One layer's parameters, named as the JAX parameter tree's keys.
    ``dense_mlp=False`` leaves out the dense MLP (a MoE layer). With
    ``quant`` set, each ``*_proj_w`` is int8 or float8_e4m3fn and has an
    f32 ``*_scale`` [out]."""

    def __init__(self, cfg: ModelConfig, dtype, device, dense_mlp: bool = True,
                 quant: str = "") -> None:
        super().__init__()
        hq, hkv, dh = cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim
        g = hq // hkv
        d, i = cfg.hidden_size, cfg.intermediate_size
        kw = dict(dtype=dtype, device=device)

        self.proj = make_proj(self, dtype, device, quant)
        self.input_layernorm = _param(d, **kw)
        self.post_attention_layernorm = _param(d, **kw)
        self.proj("qkv_proj_w", d, hkv * (g + 2) * dh)
        self.proj("o_proj_w", hq * dh, d)
        if dense_mlp:
            self.proj("gate_proj_w", d, i)
            self.proj("up_proj_w", d, i)
            self.proj("down_proj_w", i, d)
        if cfg.attention_bias:
            self.qkv_proj_b = _param(hkv * (g + 2) * dh, **kw)
        if cfg.qk_norm:
            self.q_norm = _param(dh, **kw)
            self.k_norm = _param(dh, **kw)
        if cfg.use_sandwich_norms:
            self.post_self_attn_layernorm = _param(d, **kw)
            self.post_mlp_layernorm = _param(d, **kw)


class DenseDecoderModel(nn.Module):
    # "split": separate K and V caches [L, NB, Hkv, bs, D]. "interleaved":
    # ONE cache [L, NB, 2, Hkv, bs, D], a page's K and V together (K8), the
    # v cache a rank-1 placeholder. "interleaved_rm": interleaved with
    # row-major tail pages, a sequence's incomplete last page holding its
    # rows token-major (K9). The runner resolves the layout
    # (``ModelRunner.initialize_kv_cache``) before the cache is made.
    kv_layout = "split"
    supports_batched_prefill = True
    supports_int8_kv = True  # the per-head scales fold outside the kernels
    supports_interleaved_kv = True  # the GQA cache takes the interleaved layouts

    def __init__(self, cfg: ModelConfig, device="cpu", quant: str = "") -> None:
        super().__init__()
        if cfg.num_attention_heads % cfg.num_kv_heads:
            raise ValueError("num_attention_heads must be a multiple of num_kv_heads")
        if quant and quant not in QUANT_WEIGHT_DTYPES:
            raise ValueError(f"quant must be one of {sorted(QUANT_WEIGHT_DTYPES)}, not {quant!r}")
        self.cfg = cfg
        self.quant = quant
        self.device = torch.device(device)
        self.dtype = _DTYPES[cfg.dtype]
        # int8-KV per-layer-per-head scales (s_k, s_v), each [L, Hkv] f32;
        # set by the runner for an int8 cache (set_kv_scales)
        self.kv_scales = None
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
        return DecoderLayer(self.cfg, self.dtype, self.device, quant=self.quant)

    @torch.no_grad()
    def init_random_(self, seed: int) -> None:
        """Random init from ``seed`` (tests / synthetic runs): norms 1,
        biases (the MoE router's too) 0, every other weight N(0, 0.02)
        drawn in f32 and cast, as the JAX ``init_params`` does (its bits
        differ: another RNG). Quantized weights are drawn directly in their
        dtype, as the JAX ``_init_params_quantized``: int8 uniform in
        [-127, 127] with scale 0.02 / 127, fp8 N(0, 0.02) cast with scale 1."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("norm") or leaf.endswith("layernorm"):
                p.fill_(1.0)
            elif leaf.endswith(("_b", "_bias")):
                p.zero_()
            elif leaf.endswith("_scale"):
                p.fill_(0.02 / 127.0 if self.quant == "int8" else 1.0)
            elif p.dtype == torch.int8:
                p.copy_(torch.randint(-127, 128, p.shape, generator=gen,
                                      device=self.device, dtype=torch.int8))
            elif p.dtype == torch.float8_e4m3fn:
                w = torch.randn(p.shape, generator=gen, device=self.device)
                p.view(torch.uint8).copy_(to_e4m3(w * 0.02).view(torch.uint8))
            else:
                w = torch.randn(
                    p.shape, generator=gen, device=self.device,
                    dtype=torch.float32,
                )
                p.copy_(w * 0.02)

    # ------------------------------------------------------------------
    # KV cache
    # ------------------------------------------------------------------
    @property
    def _rm_tail(self) -> bool:
        return self.kv_layout == "interleaved_rm"

    def kv_cache_shape(self, num_blocks: int, block_size: int) -> tuple[int, ...]:
        c = self.cfg
        if self.kv_layout.startswith("interleaved"):
            return (c.num_hidden_layers, num_blocks, 2, c.num_kv_heads, block_size,
                    c.head_dim)
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
        if self.kv_layout.startswith("interleaved"):
            # the v cache is a rank-1 placeholder: K and V share the array
            return (torch.zeros(shape, dtype=dt, device=self.device),
                    torch.zeros((1,), dtype=dt, device=self.device))
        return (
            torch.zeros(shape, dtype=dt, device=self.device),
            torch.zeros(shape, dtype=dt, device=self.device),
        )

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    @staticmethod
    def _linear(lp: nn.Module, name: str, x: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """x [T, K] @ ``lp.<name>`` -> [T, N] in ``out_dtype``, from f32 sums
        rounded once (the JAX ``_linear`` and its callers' astype).

        - int8 / fp8 weights: ``quant_matmul`` with ``lp.<name>_scale``
          (the dequant default, or K5 / K6 under ``XLLM_QMM_KERNEL=pallas``);
        - bf16 weights under ``XLLM_BF16_MM=pallas`` or ``=stacked`` and at
          most 256 rows: K7. The JAX package's "stacked" form keeps the
          weight stack out of its layer scan and indexes the layer inside
          the kernel; the port has no layer scan, so both values launch the
          same per-layer kernel;
        - otherwise PyTorch's product."""
        w = getattr(lp, name)
        if w.dtype in QUANT_WEIGHT_DTYPES.values():
            y = quant_matmul(x, w, getattr(lp, name + "_scale"))
        elif (os.environ.get("XLLM_BF16_MM") in ("pallas", "stacked")
              and w.dtype == torch.bfloat16 and x.shape[0] <= 256):
            y = matmul_bf16(x, w)
        elif out_dtype == torch.float32:
            return linear_f32(x, w)
        else:
            return torch.matmul(x, w)  # f32 sums, rounded once to x's dtype
        return y.to(out_dtype)

    def _mlp(self, lp: DecoderLayer, x: torch.Tensor) -> torch.Tensor:
        # gate and up stay in f32 through SiLU x up; one rounding before
        # the down projection (the JAX _linear's preferred_element_type)
        gate = self._linear(lp, "gate_proj_w", x)
        up = self._linear(lp, "up_proj_w", x)
        act = (F.silu(gate) * up).to(x.dtype)
        return self._linear(lp, "down_proj_w", act, x.dtype)

    def _attn_qkv(
        self, lp: DecoderLayer, x: torch.Tensor, positions: torch.Tensor,
        inv_freq: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``inv_freq``: the rope frequencies (default the model's; the
        MTP head passes its own, which an MLA target does not share)."""
        c = self.cfg
        if inv_freq is None:
            inv_freq = self.inv_freq
        t = x.shape[0]
        hkv, dh = c.num_kv_heads, c.head_dim
        g = c.num_attention_heads // hkv
        if c.attention_bias:
            # the bias joins the f32 product; one rounding after it
            qkv = (self._linear(lp, "qkv_proj_w", x) + lp.qkv_proj_b).to(x.dtype)
        else:
            qkv = self._linear(lp, "qkv_proj_w", x, x.dtype)
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
            q, k = partial(q, k, positions, inv_freq, self.rotary_dim)
        else:
            q, k = apply_rope(q, k, positions, inv_freq)
        return q, k, v

    def _run_layers(
        self,
        x: torch.Tensor,  # [T, D]
        positions: torch.Tensor,  # [T]
        attn_fn,  # (q, k, v, layer_idx) -> attn [T, Hq, D]
    ) -> torch.Tensor:
        """-> the pre-final-norm states [T, D] (the MTP head's input); the
        callers apply ``self.norm``."""
        c = self.cfg
        t = x.shape[0]
        for layer_idx, lp in enumerate(self.layers):
            h = rms_norm(x, lp.input_layernorm, c.rms_norm_eps)
            q, k, v = self._attn_qkv(lp, h, positions)
            attn = attn_fn(q, k, v, layer_idx).reshape(
                t, c.num_attention_heads * c.head_dim
            )
            attn_out = self._linear(lp, "o_proj_w", attn, x.dtype)
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
        return x

    def prefill(
        self,
        k_all: torch.Tensor,
        v_all: torch.Tensor,
        inp: PrefillInput,
        num_logits: int = 1,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One sequence's prompt chunk (prompt scoring, embeddings) ->
        (hidden of the last ``num_logits`` real rows [num_logits, D], k_all,
        v_all); the caches are updated in place.

        The rows start at ``logits_idx - (num_logits - 1)`` clamped into
        ``[0, S - num_logits]``, as JAX's ``dynamic_slice_in_dim`` clamps
        (scoring asks for all ``S`` rows, so the start clamps to 0), and
        are gathered on the device: nothing syncs."""
        x = self.embed_tokens[inp.token_ids.long()]
        x = self._run_layers(x, inp.positions, self._chunk_attn_fn(k_all, v_all, inp))
        x = rms_norm(x, self.norm, self.cfg.rms_norm_eps)
        s = x.shape[0]
        if not 0 < num_logits <= s:
            raise ValueError(f"num_logits {num_logits} outside [1, {s}]")
        start = (inp.logits_idx.long() - (num_logits - 1)).clamp(0, s - num_logits)
        rows = start.reshape(1) + torch.arange(num_logits, device=x.device)
        return x[rows], k_all, v_all

    def prefill_batched(
        self,
        k_all: torch.Tensor,
        v_all: torch.Tensor,
        inp: BatchedPrefillInput,
        num_logits: int = 1,
        return_hidden: bool = False,
    ) -> tuple:
        """-> (hidden [P, num_logits, D], k_all, v_all[, pre]); the caches
        are updated in place. P chunks from P sequences in one pass.
        ``num_logits`` > 1 is the speculative verify pass: rows
        ``[logits_idx - num_logits + 1, logits_idx]`` of each chunk feed the
        rejection sampler. ``return_hidden`` also returns ``pre`` [P, S, D],
        every row's pre-final-norm state (the MTP head applies its own
        norm)."""
        c = self.cfg
        p, s = inp.token_ids.shape
        attn_fn = self._prefill_attn_fn(k_all, v_all, inp)
        x = self.embed_tokens[inp.token_ids.reshape(-1).long()]
        pre = self._run_layers(x, inp.positions.reshape(-1), attn_fn).reshape(p, s, -1)
        x = rms_norm(pre, self.norm, c.rms_norm_eps)
        idx = (
            inp.logits_idx.long()[:, None]
            - (num_logits - 1)
            + torch.arange(num_logits, device=x.device)[None, :]
        ).clamp(min=0)  # [P, num_logits]
        hidden = torch.gather(x, 1, idx[..., None].expand(-1, -1, c.hidden_size))
        if return_hidden:
            return hidden, k_all, v_all, pre
        return hidden, k_all, v_all

    def decode(
        self,
        k_all: torch.Tensor,
        v_all: torch.Tensor,
        inp: DecodeInput,
        token_ids: torch.Tensor,  # [B] (gathered from the last_tokens ring)
        return_hidden: bool = False,
    ) -> tuple:
        """-> (hidden [B, D], k_all, v_all[, pre]); the caches are updated in
        place. ``return_hidden`` also returns ``pre`` [B, D], the
        pre-final-norm states (the MTP head's input)."""
        x = self.embed_tokens[token_ids.long()]
        pre = self._run_layers(x, inp.positions, self._decode_attn_fn(k_all, v_all, inp))
        x = rms_norm(pre, self.norm, self.cfg.rms_norm_eps)
        if return_hidden:
            return x, k_all, v_all, pre
        return x, k_all, v_all

    def _prefill_attn_fn(self, k_all, v_all, inp: BatchedPrefillInput):
        """The attention step ``_run_layers`` calls in a prefill pass."""
        p, s = inp.token_ids.shape

        def attn_fn(q, k, v, layer_idx):
            q, k, v = self._kv_quant_in(q, k, v, layer_idx)
            out, _, _ = prefill_attention_write_batched(
                q.reshape(p, s, *q.shape[1:]),
                k.reshape(p, s, *k.shape[1:]),
                v.reshape(p, s, *v.shape[1:]),
                k_all, v_all, layer_idx, inp.slot_mapping, inp.block_tables,
                inp.q_offsets, inp.kv_lens, self.scale, window=self.window,
                rowmajor_tail=self._rm_tail,
            )
            return self._kv_quant_out(out.reshape(p * s, *out.shape[2:]), layer_idx)

        return attn_fn

    def _chunk_attn_fn(self, k_all, v_all, inp: PrefillInput):
        """The attention step ``_run_layers`` calls in a single-chunk pass."""

        def attn_fn(q, k, v, layer_idx):
            q, k, v = self._kv_quant_in(q, k, v, layer_idx)
            out, _, _ = prefill_attention_write(
                q, k, v, k_all, v_all, layer_idx, inp.slot_mapping, inp.block_table,
                inp.q_offset, inp.kv_len, self.scale, window=self.window,
                rowmajor_tail=self._rm_tail,
            )
            return self._kv_quant_out(out, layer_idx)

        return attn_fn

    def _decode_attn_fn(self, k_all, v_all, inp: DecodeInput):
        """The attention step ``_run_layers`` calls in a decode pass."""

        def attn_fn(q, k, v, layer_idx):
            q, k, v = self._kv_quant_in(q, k, v, layer_idx)
            out, _, _ = decode_attention_write(
                q, k, v, k_all, v_all, layer_idx, inp.slot_mapping,
                inp.block_tables, inp.seq_lens, self.scale, window=self.window,
                rowmajor_tail=self._rm_tail,
            )
            return self._kv_quant_out(out, layer_idx)

        return attn_fn

    # ------------------------------------------------------------------
    # int8 KV (scales applied outside the attention kernels)
    # ------------------------------------------------------------------
    def _kv_quant_in(self, q, k, v, layer_idx: int):
        """Fold s_k into q and quantize the new K/V rows to int8 codes:
        (q * s_k) . (k / s_k) == q . k, so the kernels see one code space
        for the cached pages and the new rows."""
        if self.kv_scales is None:
            return q, k, v
        sk, sv = (s[layer_idx] for s in self.kv_scales)
        g = self.cfg.num_attention_heads // self.cfg.num_kv_heads
        q = (q.float() * sk.repeat_interleave(g)[None, :, None]).to(q.dtype)

        def quant(x, s):
            codes = torch.round(x.float() / s[None, :, None])
            return torch.clamp(codes, -127, 127).to(torch.int8)

        return q, quant(k, sk), quant(v, sv)

    def _kv_quant_out(self, out, layer_idx: int):
        """out = sum p (v / s_v): multiply s_v back per kv head."""
        if self.kv_scales is None:
            return out
        g = self.cfg.num_attention_heads // self.cfg.num_kv_heads
        sv = self.kv_scales[1][layer_idx].repeat_interleave(g)
        return (out.float() * sv[None, :, None]).to(out.dtype)

    def set_kv_scales(self, s_k, s_v) -> None:
        """Install per-layer-per-head int8-KV scales ([L, Hkv] f32, or
        scalars)."""
        shape = (self.cfg.num_hidden_layers, self.cfg.num_kv_heads)
        self.kv_scales = tuple(
            torch.broadcast_to(torch.as_tensor(s, dtype=torch.float32), shape)
            .contiguous().to(self.device)
            for s in (s_k, s_v)
        )

    def compute_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """[N, D] -> [N, V] in the model dtype."""
        head = (
            self.embed_tokens.t()
            if self.cfg.tie_word_embeddings
            else self.lm_head
        )
        return torch.matmul(hidden, head)
