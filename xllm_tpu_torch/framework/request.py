"""Request / Sequence state machine.

Counterpart of the reference request model (reference
xllm/core/framework/request/request.h:38, sequence.h:107,
sequences_group.h:35, stopping_checker.h:27): a Request owns n Sequences
(a SequencesGroup); each Sequence tracks prompt+generated tokens, per-token
KV-compute progress (for chunked prefill), its paged-KV block ids, and
finish state. Host-only logic, fully unit-testable without a device.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field

from xllm_tpu_torch.framework.sampling_params import SamplingParams


class FinishReason(str, enum.Enum):
    STOP = "stop"  # eos or stop string / stop token id
    LENGTH = "length"  # max_tokens or max_model_len reached
    ABORT = "abort"


class SequenceStatus(enum.Enum):
    WAITING = 0
    RUNNING = 1
    PREEMPTED = 2
    FINISHED = 3


@dataclass
class StoppingChecker:
    """Decides when a sequence is done.

    Counterpart of reference StoppingChecker
    (xllm/core/framework/request/stopping_checker.h:27).
    """

    max_new_tokens: int
    max_model_len: int
    eos_token_ids: tuple[int, ...] = ()
    stop_token_ids: tuple[int, ...] = ()
    stop_strings: tuple[str, ...] = ()
    ignore_eos: bool = False
    min_new_tokens: int = 0

    def check(
        self, last_token_id: int, num_prompt: int, num_total: int
    ) -> FinishReason | None:
        num_new = num_total - num_prompt
        if num_new < self.min_new_tokens:
            if num_total >= self.max_model_len:
                return FinishReason.LENGTH
            return None
        if not self.ignore_eos and last_token_id in self.eos_token_ids:
            return FinishReason.STOP
        if last_token_id in self.stop_token_ids:
            return FinishReason.STOP
        if num_new >= self.max_new_tokens or num_total >= self.max_model_len:
            return FinishReason.LENGTH
        return None

    def check_stop_strings(self, text: str) -> int:
        """Return truncation offset if a stop string occurs in text, else -1."""
        best = -1
        for s in self.stop_strings:
            idx = text.find(s)
            if idx != -1 and (best == -1 or idx < best):
                best = idx
        return best


class Sequence:
    """One decoding stream: prompt tokens + generated tokens + paged-KV state.

    KV bookkeeping mirrors reference Sequence/SequenceKVState
    (xllm/core/framework/request/sequence.h:107, sequence_kv_state.h):
    ``num_computed_tokens`` counts tokens whose KV is in cache (advanced per
    chunk for chunked prefill), ``block_ids`` is the block table.
    """

    _next_id = 0

    def __init__(
        self,
        prompt_token_ids: list[int],
        sampling_params: SamplingParams,
        stopping: StoppingChecker,
        request_id: str = "",
    ) -> None:
        self.seq_id = Sequence._next_id
        Sequence._next_id += 1
        self.request_id = request_id
        self.prompt_token_ids = list(prompt_token_ids)
        self.token_ids: list[int] = list(prompt_token_ids)
        self.sampling_params = sampling_params
        self.stopping = stopping
        self.status = SequenceStatus.WAITING
        self.finish_reason: FinishReason | None = None

        # paged KV state
        self.block_ids: list[int] = []
        self.num_computed_tokens = 0  # tokens with KV in device cache
        self.num_cached_tokens = 0  # prefix-cache hit length (<= computed)

        # async schedule-overlap state (reference async_schedule fake tokens,
        # xllm/core/runtime/worker_impl.h:126): generated tokens are appended
        # as placeholders at dispatch and given their real value at fixup
        # once the device tokens arrive on host.
        self.slot_id = -1  # index into the runner's last_tokens ring
        # beam search: held sequences are invisible to the scheduler until
        # the BeamRunner activates them (reference SequencesGroup beams)
        self.on_hold = False
        self.beam_score = 0.0
        # VLM state (reference MMData plumbing, mm_handler.h:31): merged
        # vision embeddings + their token positions, M-RoPE position ids
        # for the prompt, and the rope offset for generated tokens
        self.mm_embeds = None  # np [n_mm, D]
        self.mm_deepstack = None  # np [K, n_mm, D] (qwen3-vl DeepStack)
        self.mm_positions = None  # np [n_mm] ascending prompt positions
        self.mrope_positions = None  # np [3, num_prompt_tokens]
        self.rope_offset = 0
        # attention-DP rank owning this sequence's KV blocks (reference
        # per-DP-rank BlockManagerPool, block_manager_pool.h:27); assigned
        # by the pool on first allocation, -1 = unassigned
        self.dp_rank = -1
        self.num_fixed_tokens = len(prompt_token_ids)

        # incremental detokenization state (reference incremental_decoder.h:28)
        self.output_text = ""
        self.num_detokenized_tokens = len(prompt_token_ids)

        # logprobs accumulation
        self.output_logprobs: list[float] = []
        self.output_top_logprobs: list[dict[int, float]] = []
        # embedding output (pooled last hidden state, embed requests only)
        self.embedding: list[float] | None = None

    # ---- token state ----
    @property
    def num_prompt_tokens(self) -> int:
        return len(self.prompt_token_ids)

    @property
    def num_tokens(self) -> int:
        return len(self.token_ids)

    @property
    def num_generated_tokens(self) -> int:
        return len(self.token_ids) - len(self.prompt_token_ids)

    @property
    def is_finished(self) -> bool:
        return self.status == SequenceStatus.FINISHED

    @property
    def in_prefill(self) -> bool:
        """True while some known tokens still need their KV computed."""
        return self.num_computed_tokens < self.num_tokens - 1 or (
            self.num_generated_tokens == 0
        )

    def append_token(self, token_id: int, logprob: float | None = None) -> None:
        self.token_ids.append(token_id)
        self.num_fixed_tokens = len(self.token_ids)
        if logprob is not None:
            self.output_logprobs.append(logprob)

    # ---- async schedule-overlap plumbing ----
    PLACEHOLDER = -1

    def append_placeholder(self) -> None:
        """Reserve a generated-token position whose value is still on device."""
        self.token_ids.append(self.PLACEHOLDER)

    @property
    def has_unfixed_tokens(self) -> bool:
        return self.num_fixed_tokens < len(self.token_ids)

    def fixup_token(self, token_id: int, logprob: float) -> None:
        """Give the oldest placeholder its real value (device->host arrived)."""
        idx = self.num_fixed_tokens
        assert idx < len(self.token_ids), "fixup without placeholder"
        self.token_ids[idx] = token_id
        self.output_logprobs.append(logprob)
        self.num_fixed_tokens = idx + 1

    def trim_unfixed(self) -> None:
        """Drop overrun placeholders past the stop point (finish during fixup)."""
        del self.token_ids[self.num_fixed_tokens :]
        self.num_computed_tokens = min(self.num_computed_tokens, len(self.token_ids))

    def maybe_finish(self, last_token_id: int, max_model_len: int) -> bool:
        # length checks count only FIXED tokens — trailing placeholders are
        # in-flight dispatches whose values would be lost to trim_unfixed()
        reason = self.stopping.check(
            last_token_id, self.num_prompt_tokens, self.num_fixed_tokens
        )
        if reason is not None:
            self.finish(reason)
            return True
        return False

    def finish(self, reason: FinishReason) -> None:
        self.status = SequenceStatus.FINISHED
        self.finish_reason = reason

    # ---- preemption (reference continuous_scheduler.cpp:612 evict path) ----
    def reset_kv(self) -> None:
        """Drop all device KV state; the sequence recomputes from scratch."""
        self.block_ids = []
        self.num_computed_tokens = 0
        self.num_cached_tokens = 0

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"Sequence(id={self.seq_id}, tokens={self.num_tokens}, "
            f"computed={self.num_computed_tokens}, status={self.status.name})"
        )


class Request:
    """One API request, owning ``n`` sequences (the SequencesGroup).

    Counterpart of reference Request (xllm/core/framework/request/request.h:38)
    + SequencesGroup (sequences_group.h:35).
    """

    def __init__(
        self,
        request_id: str,
        prompt_token_ids: list[int],
        sampling_params: SamplingParams,
        eos_token_ids: tuple[int, ...] = (),
        max_model_len: int = 1 << 30,
        arrival_time: float | None = None,
        prompt: str = "",
        priority: int = 0,
        offline: bool = False,
        embed: bool = False,
    ) -> None:
        self.request_id = request_id
        self.prompt = prompt
        self.embed = embed
        self.prompt_token_ids = list(prompt_token_ids)
        self.sampling_params = sampling_params
        self.arrival_time = arrival_time if arrival_time is not None else time.time()
        self.priority = priority
        self.offline = offline
        self.aborted = False
        stopping = StoppingChecker(
            max_new_tokens=sampling_params.max_tokens,
            max_model_len=max_model_len,
            eos_token_ids=tuple(eos_token_ids),
            stop_token_ids=tuple(sampling_params.stop_token_ids or ()),
            stop_strings=tuple(sampling_params.stop or ()),
            ignore_eos=sampling_params.ignore_eos,
            min_new_tokens=sampling_params.min_tokens,
        )
        self.sequences = [
            Sequence(prompt_token_ids, sampling_params, stopping, request_id)
            for _ in range(sampling_params.best_of)
        ]
        # first-token / per-token latency metrics
        self.first_scheduled_time: float | None = None
        self.first_token_time: float | None = None

    @property
    def is_finished(self) -> bool:
        return self.aborted or all(s.is_finished for s in self.sequences)

    def abort(self) -> None:
        self.aborted = True
        for seq in self.sequences:
            if not seq.is_finished:
                seq.finish(FinishReason.ABORT)


@dataclass(slots=True)
class RequestOutput:
    """Streamed/final output for one request (reference request_output.h)."""

    request_id: str
    prompt: str
    outputs: list[SequenceOutput] = field(default_factory=list)
    finished: bool = False
    usage: dict | None = None
    embedding: list[float] | None = None


@dataclass(slots=True)
class SequenceOutput:
    index: int
    text: str
    token_ids: list[int]
    finish_reason: str | None = None
    logprobs: list[float] | None = None
    top_logprobs: list[dict[int, float]] | None = None
