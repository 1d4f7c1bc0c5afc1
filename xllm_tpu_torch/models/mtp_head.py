"""MTP (multi-token prediction) draft head for speculative decoding.

Counterpart of ``xllm_tpu/models/mtp_head.py`` ``MTPHead`` as an
``nn.Module``: ``enorm`` / ``hnorm`` / ``eh_proj``, one dense decoder layer
(``layer``, a ``DecoderLayer`` in the model dtype whatever the target's
quantization) and ``norm``, sharing the target's ``embed_tokens`` and
lm_head. The head keeps its own one-layer paged cache ``[1, NB, Hkv, bs,
D]`` in the model dtype (whatever the target's KV dtype), addressed by the
target's block tables: positions align one to one.

- ``prefill_batched`` advances the head's cache over a prompt chunk (or
  rewrites it over a verify chunk with the emitted tokens) through
  ``ops/attention.prefill_attention_write_batched``: K2 or K4 writes, K3
  attends. Nothing reads its output, so the layer stops at the attention
  (the JAX program's output is dead code past it too).
- ``draft_tokens`` runs k single-token head decodes through
  ``ops/attention.decode_attention_write`` (K1), each taking the argmax of
  the target's logits on the device: a Python loop in place of JAX's
  ``lax.scan``, with no host read.

The head's rope uses frequencies of the target's rotary width from the
config (an MLA target's own rope covers only its qk_rope dims).
"""

from __future__ import annotations

import torch
from torch import nn

from xllm_tpu_torch.config import ModelConfig
from xllm_tpu_torch.models.decoder import DecoderLayer, DenseDecoderModel, _param
from xllm_tpu_torch.ops.attention import decode_attention_write, prefill_attention_write_batched
from xllm_tpu_torch.ops.norms import rms_norm
from xllm_tpu_torch.ops.rope import rope_inv_freq
from xllm_tpu_torch.runtime.forward_params import BatchedPrefillInput


class MTPHead(nn.Module):
    """One-layer draft transformer fed by [norm(embed); norm(hidden)]."""

    def __init__(self, cfg: ModelConfig, target: DenseDecoderModel) -> None:
        super().__init__()
        self.cfg = cfg
        # a plain reference: the target's parameters are not the head's
        object.__setattr__(self, "target", target)
        self.device = target.device
        self.dtype = target.dtype
        self.scale = cfg.head_dim**-0.5
        d = cfg.hidden_size
        kw = dict(dtype=self.dtype, device=self.device)
        self.enorm = _param(d, **kw)
        self.hnorm = _param(d, **kw)
        self.eh_proj = _param(2 * d, d, **kw)
        self.layer = DecoderLayer(cfg, self.dtype, self.device)
        self.norm = _param(d, **kw)
        self.register_buffer(
            "inv_freq",
            rope_inv_freq(target.rotary_dim, cfg.rope_theta, cfg.rope_scaling).to(self.device),
            persistent=False,
        )

    @torch.no_grad()
    def init_random_(self, seed: int) -> None:
        """Norms 1, biases 0, weights N(0, 0.02) from ``seed`` (the target's
        rule; the runner passes ``config.seed + 1``, as the JAX runner keys
        its head), drawn on the CPU so that every device gets the same
        head."""
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("norm") or leaf.endswith("layernorm"):
                p.fill_(1.0)
            elif leaf.endswith("_b"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)

    def new_kv_cache(self, num_blocks: int, block_size: int) -> tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        shape = (1, num_blocks, c.num_kv_heads, block_size, c.head_dim)
        return (torch.zeros(shape, dtype=self.dtype, device=self.device),
                torch.zeros(shape, dtype=self.dtype, device=self.device))

    # ------------------------------------------------------------------
    def _input(self, tokens: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
        """[T] tokens, [T, D] hidden -> eh_proj([enorm(embed); hnorm(hidden)])
        in the model dtype, from f32 sums rounded once."""
        eps = self.cfg.rms_norm_eps
        emb = rms_norm(self.target.embed_tokens[tokens.long()], self.enorm, eps)
        h = rms_norm(hidden, self.hnorm, eps)
        return torch.matmul(torch.cat([emb, h], dim=-1), self.eh_proj)

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor):
        h = rms_norm(x, self.layer.input_layernorm, self.cfg.rms_norm_eps)
        return self.target._attn_qkv(self.layer, h, positions, self.inv_freq)

    def _rest(self, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        """The layer past its attention, then the head's final norm."""
        c, t, lp = self.cfg, self.target, self.layer
        attn = attn.reshape(x.shape[0], c.num_attention_heads * c.head_dim)
        x = x + t._linear(lp, "o_proj_w", attn, x.dtype)
        h = rms_norm(x, lp.post_attention_layernorm, c.rms_norm_eps)
        x = x + DenseDecoderModel._mlp(t, lp, h)
        return rms_norm(x, self.norm, c.rms_norm_eps)

    # ------------------------------------------------------------------
    def prefill_batched(
        self,
        dk_cache: torch.Tensor,
        dv_cache: torch.Tensor,
        hidden: torch.Tensor,  # [P, S, D] the target's pre-norm states
        inp: BatchedPrefillInput,
        tokens_next: torch.Tensor | None = None,  # [P, S] explicit t+1 tokens
    ) -> None:
        """Advance the head's cache over a chunk, in place.

        Row j of the head's input pairs hidden j with token j + 1. A prompt
        chunk shifts its own tokens left (the last row repeats itself: its
        row is rewritten by the next dispatch before anything reads it); a
        verify chunk passes the rejection sampler's tokens."""
        p, s = inp.token_ids.shape
        if tokens_next is None:
            tokens_next = torch.cat([inp.token_ids[:, 1:], inp.token_ids[:, -1:]], dim=1)
        x = self._input(tokens_next.reshape(-1), hidden.reshape(p * s, -1))
        q, k, v = self._qkv(x, inp.positions.reshape(-1))
        prefill_attention_write_batched(
            q.reshape(p, s, *q.shape[1:]), k.reshape(p, s, *k.shape[1:]),
            v.reshape(p, s, *v.shape[1:]), dk_cache, dv_cache, 0, inp.slot_mapping,
            inp.block_tables, inp.q_offsets, inp.kv_lens, self.scale,
        )

    def draft_tokens(
        self,
        dk_cache: torch.Tensor,
        dv_cache: torch.Tensor,
        last_hidden: torch.Tensor,  # [B, D] the target's state before the last token
        last_tokens: torch.Tensor,  # [B] the sampled, not yet computed token
        positions: torch.Tensor,  # [B] position of last_tokens (num_tokens - 1)
        slot_mapping_k: torch.Tensor,  # [B, k] slots of the k draft positions
        block_tables: torch.Tensor,  # [B, NB]
        seq_lens: torch.Tensor,  # [B] num_tokens (0 = padded row)
        k: int,
    ) -> torch.Tensor:
        """Draft k tokens per row autoregressively -> [B, k] int32.

        Step j combines embed(tok_j) with hidden_{j-1}, writes its row at
        position ``positions + j`` and takes the argmax of the target's
        logits as tok_{j+1}. Padded rows stay at seq_len 0."""
        live = seq_lens > 0
        hidden, tok = last_hidden.to(self.dtype), last_tokens
        drafts = []
        for j in range(k):
            x = self._input(tok, hidden)
            q, k_new, v_new = self._qkv(x, positions + j)
            attn, _, _ = decode_attention_write(
                q, k_new, v_new, dk_cache, dv_cache, 0, slot_mapping_k[:, j].contiguous(),
                block_tables, torch.where(live, seq_lens + j, 0).int(), self.scale,
            )
            hidden = self._rest(x, attn).to(self.dtype)
            tok = torch.argmax(self.target.compute_logits(hidden), dim=-1).int()
            drafts.append(tok)
        return torch.stack(drafts, dim=1)

