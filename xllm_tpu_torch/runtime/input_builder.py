"""Host-side forward-input assembly (numpy, allocation-light).

Copy of the parts of ``xllm_tpu/runtime/input_builder.py`` that the served
dense path uses: batched prefill, the single chunk of prompt scoring and
embeddings, decode (with its incremental ``DecodeStepCache``) and sampling
inputs, padded to the same buckets so that both packages batch identically
and the kernels see the padded rows (``seq_len``/``kv_len`` 0) their
contract covers. Left out with the features that raise in this slice: the
VLM fields and the context-parallel zigzag of batched prefill, the
single-sequence speculative-verify builder (the JAX engine takes it only
for a family without batched prefill, and the port has none), and the
decode page maps that only the TPU kernel's global page ring read.
"""

from __future__ import annotations

import numpy as np

from xllm_tpu_torch.framework.request import Sequence
from xllm_tpu_torch.runtime.forward_params import (
    BatchedPrefillInput,
    DecodeInput,
    PrefillInput,
    SamplingInput,
)
from xllm_tpu_torch.utils import next_bucket


def build_prefill_input(
    seq: Sequence,
    num_new_tokens: int,
    block_size: int,
    token_buckets: list[int],
    num_block_table_cols: int,
) -> tuple[PrefillInput, bool]:
    """One sequence's prompt chunk -> (input, samples_token):
    ``samples_token`` is True when the chunk reaches the last known token."""
    start = seq.num_computed_tokens
    end = start + num_new_tokens
    assert end <= seq.num_tokens
    s_pad = next_bucket(token_buckets, num_new_tokens)

    token_ids = np.zeros(s_pad, np.int32)
    token_ids[:num_new_tokens] = seq.token_ids[start:end]
    positions = np.full(s_pad, max(end - 1, 0), np.int32)
    positions[:num_new_tokens] = np.arange(start, end, dtype=np.int32)
    pos = np.arange(start, end)
    blocks = np.asarray(seq.block_ids, np.int64)
    slot_mapping = np.zeros(s_pad, np.int32)
    slot_mapping[:num_new_tokens] = blocks[pos // block_size] * block_size + pos % block_size
    block_table = np.zeros(num_block_table_cols, np.int32)
    block_table[: len(seq.block_ids)] = seq.block_ids

    inp = PrefillInput(
        token_ids=token_ids,
        positions=positions,
        slot_mapping=slot_mapping,
        block_table=block_table,
        kv_len=np.asarray(end, np.int32),
        q_offset=np.asarray(start, np.int32),
        logits_idx=np.asarray(num_new_tokens - 1, np.int32),
    )
    return inp, end == seq.num_tokens


def group_prefill_items(
    items: list[tuple[Sequence, int]],
    token_buckets: list[int],
    row_buckets: list[int],
    max_tokens_per_dispatch: int,
) -> list[list[tuple[Sequence, int]]]:
    """Partition prompt chunks into same-S-bucket groups for one dispatch
    each (groups bound the padded P x S cost)."""
    by_bucket: dict[int, list[tuple[Sequence, int]]] = {}
    for seq, n in items:
        s_b = next_bucket(token_buckets, n)
        by_bucket.setdefault(s_b, []).append((seq, n))
    groups = []
    max_rows = row_buckets[-1]
    for s_b, members in sorted(by_bucket.items()):
        cap = max(1, min(max_rows, max_tokens_per_dispatch // s_b))
        for i in range(0, len(members), cap):
            groups.append(members[i : i + cap])
    return groups


def _assign_rows(
    items: list, row_buckets: list[int], dp_size: int
) -> tuple[list[int], int]:
    """Rank-major row layout: row = rank * rows_per_rank + j (dp_size == 1
    collapses to the plain bucket layout)."""
    if dp_size <= 1:
        p_pad = next_bucket(row_buckets, len(items))
        if len(items) > p_pad:
            raise ValueError(
                f"{len(items)} rows exceed the largest row bucket "
                f"{row_buckets[-1]}; callers must split dispatches"
            )
        return list(range(len(items))), p_pad
    counts = [0] * dp_size
    for seq in items:
        rank = max(seq.dp_rank, 0)
        counts[rank] += 1
    rows_per_rank = next_bucket(row_buckets, max(max(counts), 1))
    if max(counts) > rows_per_rank:
        raise ValueError(
            f"{max(counts)} rows on one DP rank exceed the largest row "
            f"bucket {row_buckets[-1]}; callers must split dispatches"
        )
    rows = []
    fill = [0] * dp_size
    for seq in items:
        rank = max(seq.dp_rank, 0)
        rows.append(rank * rows_per_rank + fill[rank])
        fill[rank] += 1
    return rows, rows_per_rank * dp_size


HIST_PAD = 1 << 30  # history-ring column of padded tokens (never stored)


def build_batched_prefill_input(
    items: list[tuple[Sequence, int]],
    block_size: int,
    token_buckets: list[int],
    row_buckets: list[int],
    num_block_table_cols: int,
    trash_slot: int,
    dp_size: int = 1,
) -> tuple[BatchedPrefillInput, list[bool], list[int]]:
    """Build one dispatch's worth of prompt chunks (one row per sequence).

    Returns (input, samples_flags, rows): samples_flags[i] is True when
    item i's chunk reaches the last known token; rows[i] is item i's row
    in the padded batch.
    """
    rows, p_pad = _assign_rows([seq for seq, _ in items], row_buckets, dp_size)
    s_pad = next_bucket(token_buckets, max(n for _, n in items))

    token_ids = np.zeros((p_pad, s_pad), np.int32)
    positions = np.zeros((p_pad, s_pad), np.int32)
    slot_mapping = np.zeros((p_pad, s_pad), np.int32)
    block_tables = np.zeros((p_pad, num_block_table_cols), np.int32)
    kv_lens = np.zeros(p_pad, np.int32)
    q_offsets = np.zeros(p_pad, np.int32)
    logits_idx = np.zeros(p_pad, np.int32)
    sample_slots = np.full(p_pad, trash_slot, np.int32)
    hist_slots = np.full(p_pad, trash_slot, np.int32)
    hist_pos = np.full((p_pad, s_pad), HIST_PAD, np.int32)
    samples_flags = []
    for (seq, n), i in zip(items, rows):
        start = seq.num_computed_tokens
        end = start + n
        assert end <= seq.num_tokens
        token_ids[i, :n] = seq.token_ids[start:end]
        positions[i, :n] = np.arange(start, end, dtype=np.int32)
        positions[i, n:] = max(end - 1, 0)
        hist_pos[i, :n] = np.arange(start, end, dtype=np.int32)
        for j, pos in enumerate(range(start, end)):
            slot_mapping[i, j] = seq.block_ids[pos // block_size] * block_size + (
                pos % block_size
            )
        nb = len(seq.block_ids)
        block_tables[i, :nb] = seq.block_ids
        kv_lens[i] = end
        q_offsets[i] = start
        logits_idx[i] = n - 1
        hist_slots[i] = seq.slot_id
        samples = end == seq.num_tokens
        samples_flags.append(samples)
        if samples:
            sample_slots[i] = seq.slot_id
    inp = BatchedPrefillInput(
        token_ids=token_ids,
        positions=positions,
        slot_mapping=slot_mapping,
        block_tables=block_tables,
        kv_lens=kv_lens,
        q_offsets=q_offsets,
        logits_idx=logits_idx,
        sample_slots=sample_slots,
        hist_slots=hist_slots,
        hist_pos=hist_pos,
    )
    return inp, samples_flags, rows


def build_batched_verify_input(
    pairs: list[tuple[Sequence, list[int]]],
    spec_k: int,
    block_size: int,
    row_buckets: list[int],
    num_block_table_cols: int,
    trash_slot: int,
) -> tuple[BatchedPrefillInput, np.ndarray, np.ndarray, list[int]]:
    """Batched speculative-verify chunks: row i = [last_token, drafts_i...].

    Every row has S = spec_k + 1 positions whatever its draft's length
    (short drafts are padded with zeros; ``draft_lens`` 0 is an exact
    decode through the verify pass). ``kv_lens = start + S`` and
    ``q_offsets = start``, where ``start`` is the last sampled token's
    position; padded rows keep ``kv_len`` 0 and the trash slot. Returns
    (input, draft_tokens [P, k], draft_lens [P], rows)."""
    rows, p_pad = _assign_rows([seq for seq, _ in pairs], row_buckets, 1)
    s = spec_k + 1

    token_ids = np.zeros((p_pad, s), np.int32)
    positions = np.zeros((p_pad, s), np.int32)
    slot_mapping = np.zeros((p_pad, s), np.int32)
    block_tables = np.zeros((p_pad, num_block_table_cols), np.int32)
    kv_lens = np.zeros(p_pad, np.int32)
    q_offsets = np.zeros(p_pad, np.int32)
    logits_idx = np.full(p_pad, s - 1, np.int32)
    sample_slots = np.full(p_pad, trash_slot, np.int32)
    hist_slots = np.full(p_pad, trash_slot, np.int32)
    draft_tokens = np.zeros((p_pad, spec_k), np.int32)
    draft_lens = np.zeros(p_pad, np.int32)
    for (seq, draft), i in zip(pairs, rows):
        start = seq.num_computed_tokens
        assert start == seq.num_tokens - 1, "verify needs sample-then-compute"
        assert len(draft) <= spec_k
        draft_lens[i] = len(draft)
        draft = list(draft) + [0] * (spec_k - len(draft))
        token_ids[i] = [seq.token_ids[start], *draft]
        pos = np.arange(start, start + s)
        positions[i] = pos
        blocks = np.asarray(seq.block_ids, np.int64)
        slot_mapping[i] = blocks[pos // block_size] * block_size + pos % block_size
        block_tables[i, : len(seq.block_ids)] = seq.block_ids
        kv_lens[i] = start + s
        q_offsets[i] = start
        sample_slots[i] = seq.slot_id
        hist_slots[i] = seq.slot_id
        draft_tokens[i] = draft
    inp = BatchedPrefillInput(
        token_ids=token_ids,
        positions=positions,
        slot_mapping=slot_mapping,
        block_tables=block_tables,
        kv_lens=kv_lens,
        q_offsets=q_offsets,
        logits_idx=logits_idx,
        sample_slots=sample_slots,
        hist_slots=hist_slots,
    )
    return inp, draft_tokens, draft_lens, rows


def build_decode_input(
    seqs: list[Sequence],
    block_size: int,
    batch_buckets: list[int],
    num_block_table_cols: int,
    trash_slot: int,
    nb_buckets: list[int] | None = None,
    dp_size: int = 1,
) -> tuple[DecodeInput, list[int]]:
    """Padded rows point at the trash slot of the last_tokens ring.
    Returns (input, rows): rows[j] is seqs[j]'s row.

    Block-table columns are bucketed to the batch's max in-use blocks
    (``nb_buckets``) so the tables track live context length instead of
    max_model_len.
    """
    if nb_buckets:
        max_nb = max((len(s.block_ids) for s in seqs), default=1)
        num_block_table_cols = next_bucket(nb_buckets, max_nb)
    rows, b_pad = _assign_rows(seqs, batch_buckets, dp_size)
    slot_ids = np.full(b_pad, trash_slot, np.int32)
    positions = np.zeros(b_pad, np.int32)
    slot_mapping = np.zeros(b_pad, np.int32)
    block_tables = np.zeros((b_pad, num_block_table_cols), np.int32)
    seq_lens = np.zeros(b_pad, np.int32)
    hist_positions = np.zeros(b_pad, np.int32)
    for seq, i in zip(seqs, rows):
        pos = seq.num_tokens - 1
        slot_ids[i] = seq.slot_id
        positions[i] = pos + seq.rope_offset
        hist_positions[i] = pos  # history ring keys on the token index
        slot_mapping[i] = seq.block_ids[pos // block_size] * block_size + (
            pos % block_size
        )
        nb = len(seq.block_ids)
        block_tables[i, :nb] = seq.block_ids
        seq_lens[i] = seq.num_tokens
    inp = DecodeInput(
        slot_ids=slot_ids,
        positions=positions,
        slot_mapping=slot_mapping,
        block_tables=block_tables,
        seq_lens=seq_lens,
        hist_positions=hist_positions,
    )
    return inp, rows


class DecodeStepCache:
    """Incremental decode-input assembly across consecutive steps.

    In steady-state decode the batch composition is stable and each
    sequence advances exactly one token per step, so almost every field
    of DecodeInput/SamplingInput is a +1 of the previous step's value; the
    update is a handful of vectorized numpy ops instead of a per-sequence
    Python build.

    Safety: callers gate usage (ModelRunner) — no sliding window (that
    path may mutate block tables without changing their length). Any
    deviation from the expected one-token advance, membership change, or
    per-row block-count change beyond append falls back to the full
    builders.

    All updates are out-of-place: the previous step's arrays may still
    back an in-flight copy.
    """

    def __init__(self) -> None:
        self.sig = None

    def invalidate(self) -> None:
        self.sig = None

    def build(
        self,
        seqs: list[Sequence],
        block_size: int,
        batch_buckets: list[int],
        num_block_table_cols: int,
        trash_slot: int,
        nb_buckets: list[int] | None,
        key,
    ):
        """-> (DecodeInput, rows, SamplingInput, use_penalties)."""
        ncols = num_block_table_cols
        if nb_buckets:
            max_nb = max((len(s.block_ids) for s in seqs), default=1)
            ncols = next_bucket(nb_buckets, max_nb)
        sig = (tuple(s.seq_id for s in seqs), ncols)
        if sig == self.sig:
            hit = self._try_update(seqs, block_size, key)
            if hit is not None:
                return hit
        return self._full_build(
            seqs, block_size, batch_buckets, num_block_table_cols,
            trash_slot, nb_buckets, key, sig,
        )

    def _full_build(
        self, seqs, block_size, batch_buckets, num_block_table_cols,
        trash_slot, nb_buckets, key, sig,
    ):
        inp, rows = build_decode_input(
            seqs, block_size, batch_buckets, num_block_table_cols,
            trash_slot, nb_buckets,
        )
        b_pad = inp.slot_ids.shape[0]
        si, use_penalties = build_sampling_input(seqs, b_pad, rows, key)
        self.sig = sig
        self.rows = rows
        self.inp = inp
        self.si = si
        self.use_penalties = use_penalties
        self.ntok = [s.num_tokens for s in seqs]
        self.nb = [len(s.block_ids) for s in seqs]
        live_inc = np.zeros(b_pad, np.int32)
        live_inc[rows] = 1
        self.live_inc = live_inc
        self.seeded_inc = (si.seeds >= 0).astype(np.int32)
        return inp, rows, si, use_penalties

    def _try_update(self, seqs, block_size, key):
        ntok, nb = self.ntok, self.nb
        grown: list[int] = []
        for j, s in enumerate(seqs):
            if s.num_tokens != ntok[j] + 1:
                return None
            d = len(s.block_ids) - nb[j]
            if d == 1:
                grown.append(j)
            elif d != 0:
                return None
        prev, psi, rows = self.inp, self.si, self.rows
        positions = prev.positions + self.live_inc
        seq_lens = prev.seq_lens + self.live_inc
        hist_positions = prev.hist_positions + self.live_inc
        slot_mapping = prev.slot_mapping + self.live_inc
        block_tables = prev.block_tables
        if grown:
            block_tables = block_tables.copy()
            for j in grown:
                s, i = seqs[j], rows[j]
                bids = s.block_ids
                block_tables[i, : len(bids)] = bids
                pos = s.num_tokens - 1
                slot_mapping[i] = bids[pos // block_size] * block_size + (
                    pos % block_size
                )
                self.nb[j] = len(bids)
        for j, s in enumerate(seqs):
            self.ntok[j] = s.num_tokens
        inp = DecodeInput(
            slot_ids=prev.slot_ids,
            positions=positions,
            slot_mapping=slot_mapping,
            block_tables=block_tables,
            seq_lens=seq_lens,
            hist_positions=hist_positions,
        )
        si = SamplingInput(
            temperature=psi.temperature,
            top_k=psi.top_k,
            top_p=psi.top_p,
            key=key,
            seeds=psi.seeds,
            steps=psi.steps + self.seeded_inc,
            repetition_penalty=psi.repetition_penalty,
            frequency_penalty=psi.frequency_penalty,
            presence_penalty=psi.presence_penalty,
            hist_len=psi.hist_len + self.live_inc,
        )
        self.inp, self.si = inp, si
        return inp, rows, si, self.use_penalties


def build_sampling_arrays(
    seqs: list[Sequence], n_pad: int, rows: list[int] | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (temperature, top_k, top_p) padded to n_pad (pad rows = greedy)."""
    temperature = np.zeros(n_pad, np.float32)
    top_k = np.zeros(n_pad, np.int32)
    top_p = np.ones(n_pad, np.float32)
    if rows is None:
        rows = range(len(seqs))
    for seq, i in zip(seqs, rows):
        sp = seq.sampling_params
        temperature[i] = sp.temperature
        top_k[i] = max(sp.top_k, 0)
        top_p[i] = sp.top_p
    return temperature, top_k, top_p


def build_sampling_input(
    seqs: list[Sequence],
    n_pad: int,
    rows: list[int] | None,
    key,
) -> tuple[SamplingInput, bool]:
    """Full per-row sampling state -> (SamplingInput, use_penalties)."""
    temperature, top_k, top_p = build_sampling_arrays(seqs, n_pad, rows)
    seeds = np.full(n_pad, -1, np.int32)
    steps = np.zeros(n_pad, np.int32)
    rep = np.ones(n_pad, np.float32)
    freq = np.zeros(n_pad, np.float32)
    pres = np.zeros(n_pad, np.float32)
    hist_len = np.zeros(n_pad, np.int32)
    use_penalties = False
    if rows is None:
        rows = range(len(seqs))
    for seq, i in zip(seqs, rows):
        sp = seq.sampling_params
        if sp.seed is not None:
            seeds[i] = sp.seed & 0x7FFFFFFF
            steps[i] = seq.num_generated_tokens
        rep[i] = sp.repetition_penalty
        freq[i] = sp.frequency_penalty
        pres[i] = sp.presence_penalty
        hist_len[i] = seq.num_tokens
        if (
            sp.repetition_penalty != 1.0
            or sp.frequency_penalty != 0.0
            or sp.presence_penalty != 0.0
        ):
            use_penalties = True
    si = SamplingInput(
        temperature=temperature,
        top_k=top_k,
        top_p=top_p,
        key=key,
        seeds=seeds,
        steps=steps,
        repetition_penalty=rep,
        frequency_penalty=freq,
        presence_penalty=pres,
        hist_len=hist_len,
    )
    return si, use_penalties
