"""Qwen3-Next / Qwen3.5: hybrid GatedDeltaNet / full-attention MoE decoder.

Counterpart of ``xllm_tpu/models/qwen3_next.py`` ``Qwen3NextModel``. The
parameters keep the JAX tree's group-stacked layout, so ``weights.py``
carries them with a copy:

- the repeating layer pattern (``full_attention_interval - 1`` linear
  layers, then one full-attention layer) forms G = L / interval groups; the
  linear sublayers' tensors are stacked ``[G, I1, ...]`` (``lin_*``), the
  full-attention layer's ``[G, ...]`` (``full_*``), the MLPs of every layer
  ``[G, interval, ...]`` (the full-attention layer's last). The JAX
  two-level ``lax.scan`` becomes two Python loops over views of the stacks;
- the full-attention layers use the paged cache with its layer axis = the
  group index, through ``ops/attention``'s fused writers and kernels (K1
  for decode, K2 / K4 then K3 for prefill); the q projection carries a
  sigmoid output gate (``full_q_w`` is ``Hq * dh * 2`` wide, each head's
  [q | gate]), rope rotates the first ``partial_rotary_factor * dh`` lanes;
- the linear layers keep per-sequence state in the v cache, a tuple
  ``(v_pages, conv_st [G, I1, slots + 1, conv_dim, K-1], rec_st [G, I1,
  slots + 1, Hv, Dk, Dv])``, both f32, indexed by the engine's stable
  per-sequence slot ids (the ring that feeds ``last_tokens``) with a trash
  row for padded rows. Chunk 0 of a prompt (``q_offset == 0``) resets the
  slot, later chunks resume it, and a RECOMPUTE preemption replays the
  prompt into a fresh slot. The recurrence is ``ops/gdn.py``;
- qwen3-next's "centered" RMSNorm (stored w, applied as 1 + w) is folded
  at load time (``models/loader.py`` adds 1); the runtime uses the plain
  ``rms_norm``;
- the MLP is the routed experts (``ops/moe.py``, K10) plus a shared expert
  scaled by a sigmoid gate, or a dense MLP when ``num_experts`` is 0;
- quantized (``quant="int8" | "fp8_e4m3"``) with the JAX runner's
  catch-all: the ``*_proj_w`` stacks (the shared expert's, or the dense
  MLP's) are stored quantized with their ``*_scale`` and go through
  ``quant_matmul``; under fp8 also the routed expert stacks (K10 upcasts
  them). Every other tensor stays in the model dtype.

As in the JAX package, this family takes no int8 KV, no interleaved layout
and no single-sequence prefill pass (prompt scoring and embeddings), and
the engine refuses speculative decoding, beam search and context
parallelism and turns the prefix cache off: the recurrent state cannot
rewind, fork, or be rebuilt from shared pages.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from xllm_tpu_torch.config import ModelConfig
from xllm_tpu_torch.models.decoder import (
    _DTYPES,
    QUANT_WEIGHT_DTYPES,
    DenseDecoderModel,
    _param,
)
from xllm_tpu_torch.ops.attention import (
    decode_attention_write,
    prefill_attention_write_batched,
)
from xllm_tpu_torch.ops.gdn import gated_rms_norm, gdn_gate_params, gdn_scan
from xllm_tpu_torch.ops.linear import linear_f32
from xllm_tpu_torch.ops.moe import moe_mlp
from xllm_tpu_torch.ops.norms import rms_norm
from xllm_tpu_torch.ops.quant import quant_eligible, to_e4m3
from xllm_tpu_torch.ops.rope import apply_rope_partial, rope_inv_freq, rope_mscale
from xllm_tpu_torch.runtime.forward_params import BatchedPrefillInput, DecodeInput

# JAX's init rule: ones, zeros and the conv's scale; every other weight N(0, 0.02)
INIT_ONES = ("lin_input_layernorm", "lin_post_layernorm", "lin_norm_w", "lin_dt_bias",
         "full_input_layernorm", "full_post_layernorm", "full_q_norm", "full_k_norm", "norm")
INIT_ZEROS = ("lin_A_log",)
CONV_SCALE = 0.3


class _Slice:
    """One layer's view of the stacks: ``getattr(view, name)`` is
    ``stacks.<name>[idx]`` (a view, no copy), or AttributeError."""

    def __init__(self, stacks: nn.Module, idx: tuple) -> None:
        self._stacks, self._idx = stacks, idx

    def __getattr__(self, name: str):
        return getattr(self._stacks, name)[self._idx]


class Qwen3NextModel(DenseDecoderModel):
    supports_int8_kv = False  # the GQA int8-KV scale folding does not apply
    supports_interleaved_kv = False  # the hybrid cache keeps the split layout
    supports_batched_prefill = True
    is_hybrid = True  # the engine refuses spec / beam / CP, turns the prefix cache off

    def __init__(self, cfg: ModelConfig, device="cpu", quant: str = "") -> None:
        nn.Module.__init__(self)
        c = cfg
        if quant and quant not in QUANT_WEIGHT_DTYPES:
            raise ValueError(f"quant must be one of {sorted(QUANT_WEIGHT_DTYPES)}, not {quant!r}")
        if c.num_hidden_layers % c.full_attention_interval:
            raise ValueError("num_hidden_layers must be a multiple of full_attention_interval")
        self.cfg, self.quant = cfg, quant
        self.device = torch.device(device)
        self.dtype = _DTYPES[c.dtype]
        self.kv_scales = None
        self.scale = c.head_dim ** -0.5 * rope_mscale(c.rope_scaling) ** 2
        self.interval = c.full_attention_interval
        self.n_groups = c.num_hidden_layers // self.interval
        self.n_lin = self.interval - 1
        self.hk, self.hv = c.linear_num_key_heads, c.linear_num_value_heads
        self.dk_lin, self.dv_lin = c.linear_key_head_dim, c.linear_value_head_dim
        self.key_dim = self.hk * self.dk_lin
        self.value_dim = self.hv * self.dv_lin
        self.conv_dim = 2 * self.key_dim + self.value_dim
        self.conv_k = c.linear_conv_kernel_dim
        self.qkvz_dim = 2 * self.key_dim + 2 * self.value_dim
        self.num_state_slots = 256  # set by the runner (max_slots) before the cache
        kw = dict(dtype=self.dtype, device=self.device)
        self.embed_tokens = _param(c.vocab_size, c.hidden_size, **kw)
        self.norm = _param(c.hidden_size, **kw)
        if not c.tie_word_embeddings:
            self.lm_head = _param(c.hidden_size, c.vocab_size, **kw)
        self.groups = nn.Module()  # the stacks, named as the JAX tree's ``groups`` keys
        for name, shape in self.stack_shapes().items():
            dt = torch.float32 if name in ("lin_A_log", "lin_dt_bias") else self.dtype
            if quant and quant_eligible(name, quant):
                dt = QUANT_WEIGHT_DTYPES[quant]
                setattr(self.groups, name + "_scale",
                        _param(*shape[:-2], shape[-1], dtype=torch.float32, device=self.device))
            setattr(self.groups, name, _param(*shape, dtype=dt, device=self.device))
        self.rotary_dim = int(c.head_dim * c.partial_rotary_factor)
        self.register_buffer(
            "inv_freq",
            rope_inv_freq(self.rotary_dim, c.rope_theta, c.rope_scaling).to(self.device),
            persistent=False,
        )

    def stack_shapes(self) -> dict[str, tuple[int, ...]]:
        """The JAX ``init_params`` tree's ``groups`` stacks and their shapes."""
        c = self.cfg
        G, I1, I = self.n_groups, self.n_lin, self.interval
        D, dh, hq, hkv = c.hidden_size, c.head_dim, c.num_attention_heads, c.num_kv_heads
        s = {
            "lin_input_layernorm": (G, I1, D),
            "lin_post_layernorm": (G, I1, D),
            "lin_qkvz_w": (G, I1, D, self.qkvz_dim),
            "lin_ba_w": (G, I1, D, 2 * self.hv),
            "lin_conv_w": (G, I1, self.conv_dim, self.conv_k),
            "lin_dt_bias": (G, I1, self.hv),
            "lin_A_log": (G, I1, self.hv),
            "lin_norm_w": (G, I1, self.dv_lin),
            "lin_out_w": (G, I1, self.value_dim, D),
            "full_input_layernorm": (G, D),
            "full_post_layernorm": (G, D),
            "full_q_w": (G, D, hq * dh * 2),
            "full_k_w": (G, D, hkv * dh),
            "full_v_w": (G, D, hkv * dh),
            "full_o_w": (G, hq * dh, D),
            "full_q_norm": (G, dh),
            "full_k_norm": (G, dh),
        }
        if c.num_experts > 0:
            E, MI = c.num_experts, c.moe_intermediate_size
            SI = c.shared_expert_intermediate_size or MI
            s.update(router_w=(G, I, D, E), experts_gate_up=(G, I, E, D, 2 * MI),
                     experts_down=(G, I, E, MI, D), shared_gate_proj_w=(G, I, D, SI),
                     shared_up_proj_w=(G, I, D, SI), shared_down_proj_w=(G, I, SI, D),
                     shared_gate_w=(G, I, D))
        else:
            Isz = c.intermediate_size
            s.update(gate_proj_w=(G, I, D, Isz), up_proj_w=(G, I, D, Isz),
                     down_proj_w=(G, I, Isz, D))
        return s

    @torch.no_grad()
    def init_random_(self, seed: int) -> None:
        """Random init from ``seed`` with the JAX ``init_params`` rule (its
        bits differ: another RNG): norms, the gated norm and ``lin_dt_bias``
        1, ``lin_A_log`` 0, the conv N(0, 0.3), every other weight N(0,
        0.02), drawn in f32 one layer slice at a time and cast. Quantized
        stacks as ``DenseDecoderModel.init_random_``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in INIT_ONES:
                p.fill_(1.0)
            elif leaf in INIT_ZEROS:
                p.zero_()
            elif leaf.endswith("_scale"):
                p.fill_(0.02 / 127.0 if self.quant == "int8" else 1.0)
            else:
                scale = CONV_SCALE if leaf == "lin_conv_w" else 0.02
                for part in (p.view(-1, *p.shape[2:]) if p.ndim >= 4 else p[None]):
                    if part.dtype == torch.int8:
                        part.copy_(torch.randint(-127, 128, part.shape, generator=gen,
                                                 device=self.device, dtype=torch.int8))
                        continue
                    w = torch.randn(part.shape, generator=gen, device=self.device,
                                    dtype=torch.float32) * scale
                    if part.dtype == torch.float8_e4m3fn:
                        part.view(torch.uint8).copy_(to_e4m3(w).view(torch.uint8))
                    else:
                        part.copy_(w)

    # ------------------------------------------------------------------
    # caches: paged KV for the G full layers + the linear-state tensors
    # ------------------------------------------------------------------
    def kv_cache_shape(self, num_blocks: int, block_size: int) -> tuple[int, ...]:
        c = self.cfg
        return (self.n_groups, num_blocks, c.num_kv_heads, block_size, c.head_dim)

    def kv_bytes_per_token(self, bytes_per_el: int | None = None) -> int:
        """Per-token KV bytes of the G full-attention layers."""
        if bytes_per_el is None:
            bytes_per_el = self.dtype.itemsize
        c = self.cfg
        return self.n_groups * 2 * c.num_kv_heads * c.head_dim * bytes_per_el

    def state_bytes(self) -> int:
        """Bytes of the linear-state tensors (every slot and the trash row)."""
        per = self.conv_dim * (self.conv_k - 1) + self.hv * self.dk_lin * self.dv_lin
        return self.n_groups * self.n_lin * (self.num_state_slots + 1) * per * 4

    def new_kv_cache(self, num_blocks: int, block_size: int, dtype=None):
        dt = dtype or self.dtype
        shape = self.kv_cache_shape(num_blocks, block_size)
        k = torch.zeros(shape, dtype=dt, device=self.device)
        v_pages = torch.zeros(shape, dtype=dt, device=self.device)
        s = self.num_state_slots + 1  # + the trash row
        g, i = self.n_groups, self.n_lin
        conv_st = torch.zeros((g, i, s, self.conv_dim, self.conv_k - 1),
                              dtype=torch.float32, device=self.device)
        rec_st = torch.zeros((g, i, s, self.hv, self.dk_lin, self.dv_lin),
                             dtype=torch.float32, device=self.device)
        return k, (v_pages, conv_st, rec_st)

    def set_kv_scales(self, s_k, s_v) -> None:
        raise NotImplementedError("int8 KV needs the GQA decoder's scale folding; the "
                                  "hybrid family lacks it")

    # ------------------------------------------------------------------
    # layer bodies
    # ------------------------------------------------------------------
    def _lin_layer(self, lp, x, rows, slots, reset, lens, conv_st, rec_st):
        """One GatedDeltaNet layer over [P, S] rows; ``conv_st`` / ``rec_st``
        are this layer's [slots + 1, ...] states, updated in place."""
        c = self.cfg
        p, s = rows
        h = rms_norm(x, lp.lin_input_layernorm, c.rms_norm_eps)
        qkvz = linear_f32(h, lp.lin_qkvz_w).reshape(p, s, self.hk, -1)
        ba = linear_f32(h, lp.lin_ba_w).reshape(p, s, self.hk, -1)
        r = self.hv // self.hk
        dk, dv = self.dk_lin, self.dv_lin
        q = qkvz[..., :dk]
        k = qkvz[..., dk:2 * dk]
        v = qkvz[..., 2 * dk:2 * dk + r * dv]
        z = qkvz[..., 2 * dk + r * dv:].reshape(p, s, self.hv, dv)
        b = ba[..., :r].reshape(p, s, self.hv)
        a = ba[..., r:].reshape(p, s, self.hv)
        # conv input: concat of flattened q | k | v (head-major)
        x_qkv = torch.cat([q.reshape(p, s, self.key_dim), k.reshape(p, s, self.key_dim),
                           v.reshape(p, s, self.value_dim)], dim=-1)
        g, beta = gdn_gate_params(a, b, lp.lin_A_log, lp.lin_dt_bias)
        valid = torch.arange(s, device=x.device)[None, :] < lens[:, None]
        keep = ~reset
        tail0 = torch.where(keep[:, None, None], conv_st[slots], 0.0)
        st0 = torch.where(keep[:, None, None, None], rec_st[slots], 0.0)
        out, tail, st = gdn_scan(
            x_qkv, g, beta, valid, lp.lin_conv_w, tail0, st0,
            num_k_heads=self.hk, num_v_heads=self.hv, head_k_dim=dk, head_v_dim=dv,
        )
        conv_st[slots] = tail
        rec_st[slots] = st
        out = gated_rms_norm(out, z, lp.lin_norm_w, c.rms_norm_eps)
        out = out.reshape(p * s, self.value_dim).to(x.dtype)
        return x + self._linear(lp, "lin_out_w", out, x.dtype)

    def _full_attn_layer(self, lp, x, positions, attn_fn, gidx: int):
        c = self.cfg
        t = x.shape[0]
        dh, hq = c.head_dim, c.num_attention_heads
        h = rms_norm(x, lp.full_input_layernorm, c.rms_norm_eps)
        qg = linear_f32(h, lp.full_q_w).reshape(t, hq, 2 * dh)
        q, gate = qg[..., :dh], qg[..., dh:]
        k = linear_f32(h, lp.full_k_w).reshape(t, c.num_kv_heads, dh)
        v = linear_f32(h, lp.full_v_w).reshape(t, c.num_kv_heads, dh).to(x.dtype)
        q = rms_norm(q.to(x.dtype), lp.full_q_norm, c.rms_norm_eps)
        k = rms_norm(k.to(x.dtype), lp.full_k_norm, c.rms_norm_eps)
        q, k = apply_rope_partial(q, k, positions, self.inv_freq, self.rotary_dim)
        attn = attn_fn(q, k, v, gidx).reshape(t, hq * dh)
        attn = attn * torch.sigmoid(gate.reshape(t, hq * dh)).to(x.dtype)
        return x + self._linear(lp, "full_o_w", attn, x.dtype)

    def _mlp_next(self, lp, h):
        """One layer's MLP: routed experts + the gated shared expert, or dense."""
        c = self.cfg
        if c.num_experts > 0:
            routed = moe_mlp(
                h, lp.router_w, lp.experts_gate_up, lp.experts_down, c.num_experts_per_tok,
                c.norm_topk_prob, gate_up_scale=getattr(lp, "experts_gate_up_scale", None),
                down_scale=getattr(lp, "experts_down_scale", None),
            )
            gate = F.silu(self._linear(lp, "shared_gate_proj_w", h))
            up = self._linear(lp, "shared_up_proj_w", h)
            shared = self._linear(lp, "shared_down_proj_w", (gate * up).to(h.dtype))
            sg = torch.sigmoid(h.float() @ lp.shared_gate_w.float())[:, None]
            return (routed.float() + sg * shared).to(h.dtype)
        gate = F.silu(self._linear(lp, "gate_proj_w", h))
        up = self._linear(lp, "up_proj_w", h)
        return self._linear(lp, "down_proj_w", (gate * up).to(h.dtype), h.dtype)

    def _run_layers(self, x, positions, attn_fn, v_all, rows, slots, reset, lens):
        """The prefill / decode body: x [P * S, D] at ``positions``, rows =
        (P, S), slots / reset / lens [P] -> the pre-final-norm states [P * S,
        D]; the caches and the states in ``v_all`` are updated in place."""
        c = self.cfg
        _, conv_all, rec_all = v_all
        st, slots = self.groups, slots.long()
        for gi in range(self.n_groups):
            for li in range(self.n_lin):
                lp = _Slice(st, (gi, li))
                x = self._lin_layer(lp, x, rows, slots, reset, lens, conv_all[gi, li],
                                    rec_all[gi, li])
                h = rms_norm(x, lp.lin_post_layernorm, c.rms_norm_eps)
                x = x + self._mlp_next(lp, h)
            fp = _Slice(st, gi)
            x = self._full_attn_layer(fp, x, positions, attn_fn, gi)
            h = rms_norm(x, fp.full_post_layernorm, c.rms_norm_eps)
            x = x + self._mlp_next(_Slice(st, (gi, self.n_lin)), h)
        return x

    # ------------------------------------------------------------------
    def prefill(self, *args, **kwargs):
        raise NotImplementedError(
            "hybrid linear-attention models have no single-sequence prefill pass "
            "(prompt scoring, embeddings), as in the JAX package")

    def prefill_batched(self, k_all, v_all, inp: BatchedPrefillInput, num_logits: int = 1,
                        return_hidden: bool = False) -> tuple:
        """-> (hidden [P, num_logits, D], k_all, v_all[, pre]); the caches
        and states are updated in place. A chunk with ``q_offset == 0``
        resets its state slot (``hist_slots``)."""
        c = self.cfg
        p, s = inp.token_ids.shape
        v_pages = v_all[0]

        def attn_fn(q, k, v, gidx):
            out, _, _ = prefill_attention_write_batched(
                q.reshape(p, s, *q.shape[1:]), k.reshape(p, s, *k.shape[1:]),
                v.reshape(p, s, *v.shape[1:]), k_all, v_pages, gidx, inp.slot_mapping,
                inp.block_tables, inp.q_offsets, inp.kv_lens, self.scale,
            )
            return out.reshape(p * s, *out.shape[2:])

        x = self.embed_tokens[inp.token_ids.reshape(-1).long()]
        lens = torch.clamp(inp.kv_lens - inp.q_offsets, min=0)
        reset = inp.q_offsets == 0
        pre = self._run_layers(x, inp.positions.reshape(-1), attn_fn, v_all, (p, s),
                               inp.hist_slots, reset, lens).reshape(p, s, -1)
        x = rms_norm(pre, self.norm, c.rms_norm_eps)
        idx = (inp.logits_idx.long()[:, None] - (num_logits - 1)
               + torch.arange(num_logits, device=x.device)[None, :]).clamp(min=0)
        hidden = torch.gather(x, 1, idx[..., None].expand(-1, -1, c.hidden_size))
        if return_hidden:
            return hidden, k_all, v_all, pre
        return hidden, k_all, v_all

    def decode(self, k_all, v_all, inp: DecodeInput, token_ids: torch.Tensor,
               return_hidden: bool = False) -> tuple:
        """-> (hidden [B, D], k_all, v_all[, pre]); one token a row, each
        row's state at ``slot_ids``."""
        b = token_ids.shape[0]
        v_pages = v_all[0]

        def attn_fn(q, k, v, gidx):
            out, _, _ = decode_attention_write(
                q, k, v, k_all, v_pages, gidx, inp.slot_mapping, inp.block_tables,
                inp.seq_lens, self.scale,
            )
            return out

        x = self.embed_tokens[token_ids.long()]
        lens = (inp.seq_lens > 0).to(torch.int32)  # one real token a row
        reset = torch.zeros(b, dtype=torch.bool, device=x.device)
        pre = self._run_layers(x, inp.positions, attn_fn, v_all, (b, 1), inp.slot_ids,
                               reset, lens)
        x = rms_norm(pre, self.norm, self.cfg.rms_norm_eps)
        if return_hidden:
            return x, k_all, v_all, pre
        return x, k_all, v_all
