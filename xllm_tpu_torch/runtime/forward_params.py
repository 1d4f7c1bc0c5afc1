"""Forward inputs (counterpart of ``xllm_tpu/runtime/forward_params.py``).

Plain dataclasses. The input builder fills them with numpy arrays on the
host; the runner ships them to the device in one copy and hands the model
the same dataclasses holding tensors. Rows and tokens are padded to the
engine's buckets; padded rows carry ``kv_len``/``seq_len`` 0, the kernels'
contract for "nothing here".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class PrefillInput:
    """One sequence's prompt chunk, padded to a token bucket (prompt
    scoring and embeddings). ``kv_len`` counts all KV tokens of the
    sequence including this chunk; ``positions[0] == q_offset``."""

    token_ids: Any  # [S] int32
    positions: Any  # [S] int32 (padding repeats the last position)
    slot_mapping: Any  # [S] int32 (padding -> 0 = null block)
    block_table: Any  # [NB] int32
    kv_len: Any  # [] int32
    q_offset: Any  # [] int32 absolute position of token 0
    logits_idx: Any  # [] int32 row of the last real token


@dataclass
class BatchedPrefillInput:
    """P prompt chunks, one per sequence, in one dispatch."""

    token_ids: Any  # [P, S] int32
    positions: Any  # [P, S] int32
    slot_mapping: Any  # [P, S] int32 (pad -> 0 = null block)
    block_tables: Any  # [P, NB] int32
    kv_lens: Any  # [P] int32 (incl. chunk; 0 = padded row)
    q_offsets: Any  # [P] int32 chunk start position
    logits_idx: Any  # [P] int32 row of last real token in chunk
    sample_slots: Any  # [P] int32 last_tokens ring slot (pad/mid -> trash)
    hist_slots: Any  # [P] int32 token-history ring row (pad -> trash row)
    hist_pos: Any = None  # [P, S] int32 absolute token index (pad -> HIST_PAD)


@dataclass
class DecodeInput:
    """One decode step for a padded batch of sequences (1 token each).

    Token values are not part of the input: each row's input token is read
    on the device from the runner's ``last_tokens`` ring via ``slot_ids``,
    so the host can dispatch step i+1 before it has step i's tokens.
    """

    slot_ids: Any  # [B] int32 index into last_tokens (pad -> trash)
    positions: Any  # [B] int32 rope position
    slot_mapping: Any  # [B] int32
    block_tables: Any  # [B, NB] int32
    seq_lens: Any  # [B] int32 (0 for padded rows)
    hist_positions: Any = None  # [B] int32 token index for the history ring


@dataclass
class SamplingInput:
    """Per-row sampling parameters for the sampler."""

    temperature: Any  # [N] f32 (0 = greedy)
    top_k: Any  # [N] int32 (0 = disabled)
    top_p: Any  # [N] f32 (1.0 = disabled)
    key: Any  # torch.Generator the unseeded rows draw their noise from
    seeds: Any = None  # [N] int32 (-1 = unseeded)
    steps: Any = None  # [N] int32 tokens generated so far
    repetition_penalty: Any = None  # [N] f32 (1.0 = off)
    frequency_penalty: Any = None  # [N] f32
    presence_penalty: Any = None  # [N] f32
    hist_len: Any = None  # [N] int32 valid history length
