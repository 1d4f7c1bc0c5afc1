"""LLMEngine: scheduler + block manager + model runner glue.

Counterpart of ``xllm_tpu/engine.py`` ``LLMEngine`` for the served paths:
continuous batching with chunked, batched prefill and decode over the
split paged KV cache; embed requests, whose final prompt chunk runs the
single-chunk pass and returns a pooled vector; prompt scoring
(``score_prompt``), chunk by chunk on a throwaway sequence; and speculative
decoding (``speculative.method``): suffix / ngram drafts from the host's
n-gram indexes, or MTP / Eagle3 drafts from the runner's draft head, each
verified for a bucketful of sequences in one synchronous pass that yields
1 to k+1 tokens a sequence; multi-position sampling (``sample_slots``, the
server's ``/v1/sample``); and the scheduler policies: ``policy="mix"``
(``scheduler/mix.py``) and ``ttft_budget_ms``, both fed by a
``ProfileManager`` fitted from step wall times, and forward interruption
(``interruption_bus``, consumed at the step boundary); the hybrid
linear-attention family (qwen3-next, qwen3.5) under the JAX engine's rules
(no speculative decoding, beam search or context parallelism; the prefix
cache off). Below the block
manager sit the host KV tier (``cache.num_host_blocks``) and the global
KV store (``cache.kv_store_url``); ``disagg/`` serves an engine as a
prefill or a decode instance.

Async schedule overlap, as in the JAX engine: sampled tokens stay on the
device in the runner's ``last_tokens`` ring and feed the next step
directly; the host appends PLACEHOLDER tokens at dispatch and fixes them
up ``overlap_depth`` steps later. On the card each step's tokens start a
non-blocking copy into pinned host memory and record a CUDA event;
``_process_pending`` waits on that event only when it needs the values.
"""

from __future__ import annotations

import time
import uuid
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from xllm_tpu_torch.common.interruption import InterruptionBus
from xllm_tpu_torch.config import EngineConfig
from xllm_tpu_torch.framework.block_manager import BlockManager
from xllm_tpu_torch.framework.host_kv import HierarchyController, HostKVPool
from xllm_tpu_torch.framework.request import (
    FinishReason,
    Request,
    RequestOutput,
    Sequence,
    SequenceOutput,
    StoppingChecker,
)
from xllm_tpu_torch.framework.sampling_params import SamplingParams
from xllm_tpu_torch.framework.suffix_cache import GlobalSuffixCache, SuffixProposer
from xllm_tpu_torch.framework.tokenizer import IncrementalDecoder, Tokenizer
from xllm_tpu_torch.models.registry import HYBRID_FAMILIES
from xllm_tpu_torch.runtime.input_builder import group_prefill_items
from xllm_tpu_torch.runtime.model_runner import ModelRunner
from xllm_tpu_torch.scheduler.continuous import ContinuousScheduler
from xllm_tpu_torch.scheduler.mix import MixScheduler
from xllm_tpu_torch.scheduler.profile import ProfileManager
from xllm_tpu_torch.utils import get_logger

logger = get_logger(__name__)


@dataclass
class _Pending:
    """One dispatched step whose sampled tokens are still in flight."""

    seqs: list[Sequence]
    tokens: torch.Tensor  # int32, host (pinned) once `ready` has fired
    logprobs: torch.Tensor  # f32
    rows: list[int] | None = None  # seqs[j] <- tokens[rows[j]] (None = 1:1)
    top_ids: torch.Tensor | None = None  # [N, K] alternatives (top_logprobs)
    top_lps: torch.Tensor | None = None
    ready: torch.cuda.Event | None = None  # None: already on the host


def _copy_to_host_async(tensors):
    """Start device->host copies into pinned memory. -> (host tensors,
    event that fires when they have landed; None for CPU tensors)."""
    if all(t is None or t.device.type == "cpu" for t in tensors):
        return list(tensors), None
    hosts = []
    for t in tensors:
        if t is None:
            hosts.append(None)
            continue
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        hosts.append(h)
    ev = torch.cuda.Event()
    ev.record()
    return hosts, ev


class LLMEngine:
    def __init__(
        self,
        config: EngineConfig,
        tokenizer: Tokenizer | None = None,
        runner: ModelRunner | None = None,
        device="cuda",
    ) -> None:
        self.config = config
        self.tokenizer = tokenizer
        if tokenizer is None and config.model.model_path:
            try:
                self.tokenizer = Tokenizer.from_path(config.model.model_path)
            except Exception as e:  # tokenizer-less (token id I/O only) is fine
                logger.warning("no tokenizer loaded: %s", e)

        self.hybrid = config.model.model_type in HYBRID_FAMILIES
        if self.hybrid:
            # linear-attention state cannot rewind (spec rejection), fork
            # (beam), be rebuilt from shared pages (prefix cache), or split
            # its token scan across cp ranks: the JAX engine's rules
            if config.speculative.method:
                raise NotImplementedError(
                    "speculative decoding is unsupported for hybrid "
                    "linear-attention models")
            if config.parallel.cp_size > 1:
                raise NotImplementedError(
                    "context parallelism is unsupported for hybrid models")
            config.cache.enable_prefix_cache = False
        self.runner = runner or ModelRunner(config, device=device)
        if not self.runner.weights_loaded:
            self.runner.load_model()
        if self.runner.k_cache is None:
            self.runner.initialize_kv_cache()
        self.block_manager = self._make_block_manager()
        # boundary gate for per-fixup prefix-cache registration (0 = off)
        self._cache_gate_bs = (
            config.cache.block_size
            if config.cache.enable_prefix_cache else 0
        )
        # step-time models feed latency-aware budgeting (the mix policy's
        # step budget, ``ttft_budget_ms``'s prefill cap), fitted from the
        # engine step's wall time
        self.profile_manager = None
        sc = config.scheduler
        if sc.policy == "mix" or sc.ttft_budget_ms > 0:
            self.profile_manager = ProfileManager()
        if sc.policy == "mix":
            self.scheduler = MixScheduler(sc, self.block_manager, self.profile_manager)
        else:
            self.scheduler = ContinuousScheduler(sc, self.block_manager,
                                                 self.profile_manager)
        # forward interruption: a published signal is consumed at the next
        # step boundary, which preempts the running offline requests
        self.interruption_bus = InterruptionBus()
        self._decoders: dict[int, IncrementalDecoder] = {}
        # detokenize in the step loop; AsyncLLMEngine clears it and
        # detokenizes on its response thread instead (except sequences with
        # stop strings, whose stopping decision needs the text here)
        self.inline_detok = True
        self._active_requests: dict[str, Request] = {}
        # async schedule-overlap state
        self._pending: deque[_Pending] = deque()
        self.overlap_depth = (
            config.scheduler.overlap_depth
            if config.scheduler.enable_schedule_overlap
            else 0
        )
        self.overlap_depth_prefill = min(
            config.scheduler.overlap_depth_prefill, self.overlap_depth
        )
        self._step_no = 0
        self._last_prefill_step = -(1 << 30)
        self._free_slots = list(range(self.runner.max_slots - 1, -1, -1))
        # speculative decoding: verification is synchronous (the multi-token
        # yield takes the overlap's place), so overlap_depth is 0
        method = config.speculative.method
        self.spec_k = 0
        self.spec_model_based = method in ("mtp", "eagle3")
        if method in ("suffix", "ngram", "mtp", "eagle3"):
            self.spec_k = max(config.speculative.num_speculative_tokens, 1)
            self.overlap_depth = self.overlap_depth_prefill = 0
        self._proposers: dict[int, SuffixProposer] = {}
        # [drafted sequence-steps, plain sequence-steps, accepted draft tokens]
        self.spec_stats = [0, 0, 0]
        # cross-request drafts over finished generations (suffix / ngram)
        self._global_suffix = (GlobalSuffixCache() if method in ("suffix", "ngram")
                               else None)

    def _make_block_manager(self) -> BlockManager:
        """The block manager, with the host KV tier below it when
        ``cache.num_host_blocks > 0`` (a ``HierarchyController``) and the
        global store below that when ``cache.kv_store_url`` is set too (a
        ``GlobalKVController``), as the JAX engine builds it."""
        config = self.config
        hierarchy = None
        if config.cache.num_host_blocks > 0:
            runner = self.runner
            runner.init_host_kv(config.cache.num_host_blocks)
            pool = HostKVPool(config.cache.num_host_blocks)
            if config.cache.kv_store_url:
                from xllm_tpu_torch.disagg.kv_store import GlobalKVController, KVStoreClient

                hierarchy = GlobalKVController(
                    pool, swap_out=runner.swap_out_block, swap_in=runner.swap_in_block,
                    store=KVStoreClient(config.cache.kv_store_url),
                    read_host=runner.read_host_block, write_host=runner.write_host_block,
                )
            else:
                hierarchy = HierarchyController(pool, swap_out=runner.swap_out_block,
                                                swap_in=runner.swap_in_block)
        return BlockManager(
            num_blocks=self.runner.num_blocks,
            block_size=config.cache.block_size,
            enable_prefix_cache=config.cache.enable_prefix_cache,
            hierarchy=hierarchy,
        )

    # ------------------------------------------------------------------
    # request intake
    # ------------------------------------------------------------------
    def add_request(
        self,
        prompt: str | None = None,
        prompt_token_ids: list[int] | None = None,
        sampling_params: SamplingParams | None = None,
        request_id: str | None = None,
        embed: bool = False,
        priority: int = 0,
        offline: bool = False,
        images: list | None = None,
        videos: list | None = None,
    ) -> Request:
        if images or videos:
            raise NotImplementedError(
                "image and video inputs are not ported yet (ROADMAP item 13)")
        if prompt_token_ids is None:
            if prompt is None or self.tokenizer is None:
                raise ValueError("need prompt_token_ids or (prompt + tokenizer)")
            prompt_token_ids = self.tokenizer.encode(prompt)
        if not prompt_token_ids:
            raise ValueError("prompt must contain at least one token")
        max_len = self.config.scheduler.max_model_len
        if len(prompt_token_ids) + 1 > max_len:
            raise ValueError(
                f"prompt length {len(prompt_token_ids)} exceeds max_model_len "
                f"{max_len} (need room for at least one generated token)"
            )
        sampling_params = sampling_params or SamplingParams()
        if sampling_params.use_beam_search and self.hybrid:
            raise ValueError(
                "beam search is unsupported for hybrid linear-attention "
                "models (state cannot fork)")
        if sampling_params.use_beam_search:
            raise NotImplementedError(
                "beam search is not ported yet (ROADMAP item 11)")
        if embed and self.hybrid:
            raise NotImplementedError(
                "embeddings need the single-sequence prefill pass, which hybrid "
                "linear-attention models do not have")
        if embed:  # one pooled vector, no generated token
            sampling_params = SamplingParams(max_tokens=1)
        request_id = request_id or f"req-{uuid.uuid4().hex[:16]}"
        req = Request(
            request_id=request_id,
            prompt_token_ids=prompt_token_ids,
            sampling_params=sampling_params,
            eos_token_ids=tuple(self.config.model.eos_token_ids),
            max_model_len=max_len,
            prompt=prompt or "",
            embed=embed,
            priority=priority,
            offline=offline,
        )
        self.scheduler.add_request(req)
        self._active_requests[request_id] = req
        if self.tokenizer is not None:
            for seq in req.sequences:
                self._decoders[seq.seq_id] = IncrementalDecoder(
                    self.tokenizer, seq.num_prompt_tokens
                )
        return req

    def score_prompt(self, prompt_token_ids: list[int]) -> np.ndarray:
        """Per-token logprobs of a prompt under the model (scoring,
        perplexity; the OpenAI echo+logprobs semantics) -> lp [n - 1] f32,
        lp[i] = log p(token[i + 1] | tokens[: i + 1]).

        A throwaway sequence takes blocks from the pool, is scored chunk by
        chunk (chunks of ``max_tokens_per_chunk_for_prefill`` rounded down to
        whole pages, at least one), and always frees them. Each chunk reads
        its result back, so the steps still in flight (``overlap_depth``)
        have run first on the card's one stream; their blocks are not
        touched."""
        n = len(prompt_token_ids)
        if n < 2:
            raise ValueError("scoring needs at least 2 tokens")
        max_len = self.config.scheduler.max_model_len
        if n > max_len:
            raise ValueError("prompt exceeds max_model_len")
        seq = Sequence(
            list(prompt_token_ids), SamplingParams(max_tokens=1),
            StoppingChecker(max_new_tokens=1, max_model_len=max_len),
            request_id="score",
        )
        chunk = self.config.scheduler.max_tokens_per_chunk_for_prefill
        bs = self.config.cache.block_size
        chunk = max(bs, chunk - chunk % bs)
        lps: list[np.ndarray] = []
        try:
            while seq.num_computed_tokens < n:
                m = min(chunk, n - seq.num_computed_tokens)
                if not self.block_manager.allocate(seq, m):
                    raise RuntimeError("KV pool exhausted during scoring")
                lps.append(self.runner.run_score_chunk(seq, m))
                seq.num_computed_tokens += m
        finally:
            self.block_manager.free(seq)
        return np.concatenate(lps)[: n - 1]

    def sample_slots(
        self,
        prompt_token_ids: list[int],
        slot_positions: list[int],
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = -1,
        num_top: int = 0,
    ) -> list[dict]:
        """Multi-position sampling (``/v1/sample``): the slot at position
        p draws from the logits after ``prompt[:p]``, every slot from ONE
        batched prefill pass over the prompt. Synchronous; runs between
        engine steps (the async engine's ``call``). -> one dict a slot:
        {token_id, logprob[, top_ids, top_logprobs]}."""
        n = len(prompt_token_ids)
        if not slot_positions:
            return []
        if any(p < 1 or p >= n for p in slot_positions):
            # p = 0 has no prefix to condition on
            raise ValueError("slot position out of range (must be in [1, n))")
        max_chunk = max(self.config.scheduler.prefill_token_buckets)
        if n > max_chunk:
            raise ValueError(
                f"prompt length {n} exceeds the single-dispatch sample "
                f"limit {max_chunk}"
            )
        seq = Sequence(
            prompt_token_ids=list(prompt_token_ids),
            sampling_params=SamplingParams(max_tokens=1, ignore_eos=True),
            stopping=StoppingChecker(
                max_new_tokens=1,
                max_model_len=self.config.scheduler.max_model_len,
                ignore_eos=True,
            ),
        )
        seq.slot_id = self.runner.trash_slot
        if not self.block_manager.allocate(seq, n):
            raise RuntimeError("KV pool exhausted for sample request")
        try:
            rows = np.asarray([p - 1 for p in slot_positions], np.int32)
            tokens, lps, top_ids, top_lps = self.runner.run_sample_slots(
                seq, rows, temperature, top_k, top_p, seed, num_top
            )
            # the pass wrote every prompt token's KV: computed, so freeing
            # may donate the blocks to the prefix cache
            seq.num_computed_tokens = n
        finally:
            self.block_manager.free(seq)
        out = []
        for j in range(len(slot_positions)):
            item = {"token_id": int(tokens[j]), "logprob": float(lps[j])}
            if top_ids is not None:
                item["top_ids"] = [int(t) for t in top_ids[j]]
                item["top_logprobs"] = [float(x) for x in top_lps[j]]
            out.append(item)
        return out

    def abort_request(self, request_id: str) -> None:
        req = self._active_requests.pop(request_id, None)
        if req is not None:
            self.scheduler.abort_request(req)
            for seq in req.sequences:
                self._release_slot(seq)
                self._decoders.pop(seq.seq_id, None)
                self._proposers.pop(seq.seq_id, None)

    def has_unfinished(self) -> bool:
        return self.scheduler.has_unfinished() or bool(self._pending)

    # ------------------------------------------------------------------
    # slot pool for the device last_tokens ring
    # ------------------------------------------------------------------
    def _assign_slot(self, seq: Sequence) -> None:
        if seq.slot_id < 0:
            if not self._free_slots:
                raise RuntimeError(
                    "last_tokens ring exhausted (finished sequences "
                    "holding slots through the fixup lag); raise "
                    "max_seqs_per_batch headroom"
                )
            seq.slot_id = self._free_slots.pop()

    def _release_slot(self, seq: Sequence) -> None:
        if seq.slot_id >= 0:
            self._free_slots.append(seq.slot_id)
            seq.slot_id = -1

    def _defer(self, seqs, tokens, logprobs, rows=None, tops=(None, None)):
        (tokens, logprobs, top_ids, top_lps), ready = _copy_to_host_async(
            (tokens, logprobs, tops[0], tops[1])
        )
        self._pending.append(
            _Pending(list(seqs), tokens, logprobs, rows, top_ids, top_lps, ready)
        )

    # ------------------------------------------------------------------
    # the engine step
    # ------------------------------------------------------------------
    def step(self) -> list[RequestOutput]:
        t_step0 = time.perf_counter() if self.profile_manager else 0.0
        if (self.config.scheduler.enable_forward_interruption
                and self.interruption_bus.consume()):
            for req in self.scheduler.handle_prefill_interruption():
                for seq in req.sequences:
                    self._release_slot(seq)
        out = self.scheduler.schedule()
        for req in out.preempted_requests:
            for seq in req.sequences:
                self._release_slot(seq)

        # an embed request's final chunk runs the single-chunk pass and
        # finishes the request; every other chunk rides the batched prefill
        embed_done: list[Sequence] = []
        batched_items: list[tuple[Sequence, int]] = []
        for seq, n in out.prefill_items:
            self._assign_slot(seq)
            req = self._active_requests.get(seq.request_id)
            if (req is not None and req.embed
                    and seq.num_computed_tokens + n >= seq.num_tokens):
                vec = self.runner.run_prefill_embed(seq, n)
                seq.num_computed_tokens += n
                seq.embedding = vec.tolist()
                seq.finish(FinishReason.STOP)
                embed_done.append(seq)
                continue
            batched_items.append((seq, n))
        if batched_items:
            sc = self.config.scheduler
            for group in group_prefill_items(
                batched_items,
                sc.prefill_token_buckets,
                sc.prefill_row_buckets,
                sc.max_tokens_per_batch,
            ):
                tokens, logprobs, flags, rows, tops = (
                    self.runner.run_prefill_batched(group)
                )
                sampling_seqs, sample_rows = [], []
                for i, (seq, n) in enumerate(group):
                    seq.num_computed_tokens += n
                    if self._cache_gate_bs:
                        self.block_manager.cache_computed_blocks(seq)
                    if flags[i]:
                        seq.append_placeholder()
                        sampling_seqs.append(seq)
                        sample_rows.append(rows[i])
                if sampling_seqs:
                    self._defer(sampling_seqs, tokens, logprobs, sample_rows, tops)

        decode_seqs, verified = out.decode_seqs, []
        if self.spec_k and decode_seqs:
            decode_seqs, verified = self._spec_step(decode_seqs)
        if decode_seqs:
            window = self.config.model.sliding_window or 0
            for seq in decode_seqs:
                self._assign_slot(seq)
                if window > 0:
                    # recycle pages that fell out of the attention window
                    self.block_manager.release_out_of_window(seq, window)
            tokens, logprobs, rows, tops = self.runner.run_decode(decode_seqs)
            for seq in decode_seqs:
                seq.num_computed_tokens += 1
                seq.append_placeholder()
            self._defer(decode_seqs, tokens, logprobs, rows, tops)

        touched: list[Sequence] = verified + embed_done
        self._step_no += 1
        if out.prefill_items:
            self._last_prefill_step = self._step_no
        depth = self.overlap_depth if not out.is_empty else 0
        if (
            depth > self.overlap_depth_prefill
            and self._step_no - self._last_prefill_step < self.overlap_depth
        ):
            # while prefills are in flight, drain shallower so first tokens
            # do not inherit the full decode-depth lag
            depth = self.overlap_depth_prefill
        while len(self._pending) > depth:
            touched.extend(self._process_pending(self._pending.popleft()))

        for req in self.scheduler.free_finished():
            for seq in req.sequences:
                self._release_slot(seq)
        # early-finished sequences of still-running requests (n > 1 /
        # best_of) release their ring slots once their fixups are in
        for req in self.scheduler.running:
            for seq in req.sequences:
                if (
                    seq.is_finished
                    and seq.slot_id >= 0
                    and not seq.has_unfixed_tokens
                ):
                    self._release_slot(seq)
        if self.profile_manager is not None and not out.is_empty:
            # only unmixed steps feed the models, so each stays clean; under
            # schedule overlap the step blocks on an earlier step's
            # read-back, so steady-state wall time tracks device time
            dt = time.perf_counter() - t_step0
            if out.prefill_items and not out.decode_seqs:
                self.profile_manager.observe_prefill(
                    sum(n for _, n in out.prefill_items), dt)
            elif out.decode_seqs and not out.prefill_items:
                self.profile_manager.observe_decode(len(out.decode_seqs), dt)
        return self._build_outputs(touched)

    # ------------------------------------------------------------------
    # speculative decoding
    # ------------------------------------------------------------------
    def _spec_step(self, seqs: list[Sequence]) -> tuple[list[Sequence], list[Sequence]]:
        """Draft and verify every running sequence that can take k + 1
        tokens, in dispatches of at most the largest row bucket (each one
        synchronous) -> (sequences left to plain decode, verified ones)."""
        plain, jobs = [], []
        for seq in seqs:
            self._assign_slot(seq)
            if self.spec_model_based:
                draft = [] if self._spec_capacity(seq) else None
                self.spec_stats[0 if draft is not None else 1] += 1
            else:
                draft = self._propose_draft(seq)
                self.spec_stats[0 if draft else 1] += 1
            if draft is None:
                plain.append(seq)
            else:
                jobs.append((seq, draft))
        verified = []
        max_rows = self.config.scheduler.prefill_row_buckets[-1]
        for lo in range(0, len(jobs), max_rows):
            grp = jobs[lo : lo + max_rows]
            if self.spec_model_based:
                tokens, num_acc, rows = self.runner.run_verify_mtp(
                    [seq for seq, _ in grp], self.spec_k)
            else:
                tokens, num_acc, rows = self.runner.run_verify_batched(grp, self.spec_k)
            for (seq, _), i in zip(grp, rows):
                self._apply_verified(seq, tokens[i, : num_acc[i]])
                verified.append(seq)
        return plain, verified

    def _spec_eligible(self, seq: Sequence) -> bool:
        """Penalized rows (the rejection sampler has no penalty pass) and
        sequences too near max_model_len for k + 1 positions take plain
        decode."""
        sp = seq.sampling_params
        return (sp.repetition_penalty == 1.0 and sp.frequency_penalty == 0.0
                and sp.presence_penalty == 0.0
                and seq.num_fixed_tokens == seq.num_tokens
                and seq.num_tokens + self.spec_k + 1 <= self.config.scheduler.max_model_len)

    def _spec_capacity(self, seq: Sequence) -> bool:
        """An MTP step's bounds and its k + 1 positions' blocks."""
        if not self._spec_eligible(seq):
            return False
        if seq.num_generated_tokens + self.spec_k + 1 > seq.stopping.max_new_tokens:
            return False
        return self.block_manager.allocate(seq, self.spec_k + 1)

    def _propose_draft(self, seq: Sequence) -> list[int] | None:
        """spec_k draft tokens from the suffix proposers (fewer near
        max_new_tokens; [] when nothing matches: the row rides the verify
        pass as an exact decode), or None for plain decode. The verify chunk
        writes spec_k + 1 positions whatever the draft's length."""
        if not self._spec_eligible(seq):
            return None
        k = min(self.spec_k, seq.stopping.max_new_tokens - seq.num_generated_tokens - 1)
        if k < 0 or not self.block_manager.allocate(seq, self.spec_k + 1):
            return None
        prop = self._proposers.get(seq.seq_id)
        if prop is None:
            prop = self._proposers[seq.seq_id] = SuffixProposer()
        prop.extend(seq.token_ids, seq.num_fixed_tokens)
        draft = prop.propose(seq.token_ids, k)
        if not draft and self._global_suffix is not None:
            draft = self._global_suffix.propose(seq.token_ids, k)
        if not draft:
            return []
        while len(draft) < k:  # pad a short draft by repeating its tail
            draft.append(draft[-1])
        return draft

    def _apply_verified(self, seq: Sequence, tokens) -> None:
        """Append a verify pass's emitted tokens (accepted drafts and one
        bonus or corrected token), stopping where the sequence finishes."""
        self.spec_stats[2] += max(len(tokens) - 1, 0)
        for tok in tokens:
            seq.append_token(int(tok), 0.0)
            seq.num_computed_tokens += 1
            if not seq.is_finished:
                seq.maybe_finish(int(tok), self.config.scheduler.max_model_len)
            if seq.is_finished:
                break
        # sample-then-compute: the last token's KV is written by the next pass
        seq.num_computed_tokens = min(seq.num_computed_tokens, seq.num_tokens - 1)
        dec = self._decoders.get(seq.seq_id)
        if dec is not None and (self.inline_detok or seq.stopping.stop_strings):
            delta = dec.decode_new(seq.token_ids)
            if delta:
                seq.output_text += delta
                if seq.stopping.stop_strings:
                    cut = seq.stopping.check_stop_strings(seq.output_text)
                    if cut >= 0:
                        seq.output_text = seq.output_text[:cut]
                        seq.finish(FinishReason.STOP)
        if not seq.is_finished and self._cache_gate_bs:
            self.block_manager.cache_computed_blocks(seq)

    def _process_pending(self, entry: _Pending) -> list[Sequence]:
        """Fix up placeholders with arrived tokens; run stop logic."""
        if entry.ready is not None:
            entry.ready.synchronize()
        tokens = entry.tokens.numpy()
        logprobs = entry.logprobs.numpy()
        top_ids = entry.top_ids.numpy() if entry.top_ids is not None else None
        top_lps = entry.top_lps.numpy() if entry.top_lps is not None else None
        rows = entry.rows if entry.rows is not None else range(len(entry.seqs))
        touched = []
        for seq, row in zip(entry.seqs, rows):
            if seq.is_finished and not seq.has_unfixed_tokens:
                continue  # overrun step of an already-stopped sequence
            if top_ids is not None and seq.sampling_params.logprobs:
                k = seq.sampling_params.logprobs
                seq.output_top_logprobs.append(
                    {
                        int(t): float(lp)
                        for t, lp in zip(top_ids[row][:k], top_lps[row][:k])
                    }
                )
            self._fixup_token(seq, int(tokens[row]), float(logprobs[row]))
            touched.append(seq)
        return touched

    def _fixup_token(self, seq: Sequence, token: int, logprob: float) -> None:
        seq.fixup_token(token, logprob)
        if not seq.is_finished:
            seq.maybe_finish(token, self.config.scheduler.max_model_len)
            dec = self._decoders.get(seq.seq_id)
            if dec is not None and (self.inline_detok or seq.stopping.stop_strings):
                delta = dec.decode_new(seq.token_ids[: seq.num_fixed_tokens])
                if delta:
                    seq.output_text += delta
                    if seq.stopping.stop_strings:
                        cut = seq.stopping.check_stop_strings(seq.output_text)
                        if cut >= 0:
                            seq.output_text = seq.output_text[:cut]
                            seq.finish(FinishReason.STOP)
        if seq.is_finished:
            seq.trim_unfixed()
        elif self._cache_gate_bs and (
            min(seq.num_computed_tokens, seq.num_fixed_tokens)
            % self._cache_gate_bs == 0
        ):
            # prefix-cache registration catches up from its chain cursor,
            # so calling it only at block boundaries is exact
            self.block_manager.cache_computed_blocks(seq)

    # ------------------------------------------------------------------
    def _build_outputs(self, touched: list[Sequence]) -> list[RequestOutput]:
        by_req: dict[str, list[Sequence]] = {}
        for seq in touched:
            by_req.setdefault(seq.request_id, []).append(seq)
        outputs = []
        for rid in by_req:
            req = self._active_requests.get(rid)
            if req is None:
                continue
            req_done = req.is_finished and not any(
                s.has_unfixed_tokens for s in req.sequences
            )
            ro = RequestOutput(
                request_id=rid,
                prompt=req.prompt,
                finished=req_done,
                outputs=[
                    SequenceOutput(
                        index=i,
                        text=seq.output_text,
                        token_ids=seq.token_ids[
                            seq.num_prompt_tokens : seq.num_fixed_tokens
                        ],
                        finish_reason=(
                            seq.finish_reason.value if seq.finish_reason else None
                        ),
                        logprobs=(
                            seq.output_logprobs
                            if seq.sampling_params.logprobs is not None
                            else None
                        ),
                        top_logprobs=(
                            seq.output_top_logprobs
                            if seq.sampling_params.logprobs
                            else None
                        ),
                    )
                    for i, seq in enumerate(req.sequences)
                ],
            )
            if req.embed and req.sequences[0].embedding is not None:
                ro.embedding = req.sequences[0].embedding
            if req_done:
                ro.usage = {
                    "prompt_tokens": req.sequences[0].num_prompt_tokens,
                    "completion_tokens": sum(
                        s.num_generated_tokens for s in req.sequences
                    ),
                }
                self._active_requests.pop(rid, None)
                for seq in req.sequences:
                    self._decoders.pop(seq.seq_id, None)
                    self._proposers.pop(seq.seq_id, None)
                    if self._global_suffix is not None and not req.aborted:
                        # finished generations feed the cross-request drafts
                        self._global_suffix.add(seq.token_ids[: seq.num_fixed_tokens])
            outputs.append(ro)
        return outputs

    # ------------------------------------------------------------------
    # offline blocking generation
    # ------------------------------------------------------------------
    def generate_all(self, timeout_s: float = 3600.0) -> list[RequestOutput]:
        deadline = time.time() + timeout_s
        finals: dict[str, RequestOutput] = {}
        while self.has_unfinished():
            if time.time() > deadline:
                raise TimeoutError("generate_all timed out")
            for ro in self.step():
                if ro.finished:
                    finals[ro.request_id] = ro
        return list(finals.values())
