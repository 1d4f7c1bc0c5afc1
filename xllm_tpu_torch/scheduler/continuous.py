"""Continuous-batching scheduler with chunked prefill and preemption.

Counterpart of the reference's ContinuousScheduler
(reference xllm/core/scheduler/continuous_scheduler.cpp:
step :1242, prepare_batch :988, handle_prefill_requests :390,
handle_decode_requests :612) merged with its ChunkedPrefillScheduler
(chunked_prefill_scheduler.h:34) — on TPU one scheduler covers both because
prefill is already chunk-shaped for the jit buckets.

Per step it emits:
  * prefill items: (sequence, num_new_tokens) prompt chunks, bounded by
    ``max_tokens_per_chunk_for_prefill``
  * the decode batch: every running sequence whose prompt KV is complete
Preemption: when decode cannot get a block, the most-recently-arrived
running request is evicted back to waiting with its KV dropped (recomputed
on resume — the reference's RECOMPUTE preemption path).

Pure host logic, unit-tested with a fake runner (SURVEY.md §4).
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field

from xllm_tpu_torch.config import SchedulerConfig
from xllm_tpu_torch.framework.block_manager import BlockManager
from xllm_tpu_torch.framework.request import Request, Sequence, SequenceStatus
from xllm_tpu_torch.utils import get_logger

logger = get_logger(__name__)


@dataclass
class SchedulerOutput:
    prefill_items: list[tuple[Sequence, int]] = field(default_factory=list)
    decode_seqs: list[Sequence] = field(default_factory=list)
    preempted_requests: list[Request] = field(default_factory=list)

    @property
    def is_empty(self) -> bool:
        return not self.prefill_items and not self.decode_seqs


class ContinuousScheduler:
    def __init__(
        self,
        config: SchedulerConfig,
        block_manager: BlockManager,
        profile_manager=None,
    ):
        self.config = config
        self.block_manager = block_manager
        # latency-aware budgeting (reference ProfileManager-driven TTFT
        # budgets, scheduler/profile/profile_manager.h:33-145)
        self.profile_manager = profile_manager
        # priority queue (reference RequestPriorityQueue,
        # request_priority_queue.h + online/offline split,
        # continuous_scheduler.cpp:390-612): online before offline, higher
        # ``priority`` first, FIFO within a class; preempted requests
        # re-enter by their original key
        self._waiting_heap: list[list] = []
        self._seq_counter = itertools.count()
        self.running: list[Request] = []
        # sticky: any n>1/best_of>1 request ever seen turns the secondary
        # prefill pass (2b) on; single-sequence workloads skip it
        self._has_multi_seq = False

    def _queue_key(self, request: Request, seq_no: int | None = None):
        if seq_no is None:
            seq_no = next(self._seq_counter)
        return (request.offline, -request.priority, seq_no)

    @property
    def waiting(self) -> list[Request]:
        """Live view in service order (tests/metrics convenience)."""
        return [
            e[1]
            for e in sorted(self._waiting_heap, key=lambda e: e[0])
            if e[1] is not None
        ]

    def _peek_waiting(self) -> Request | None:
        while self._waiting_heap and self._waiting_heap[0][1] is None:
            heapq.heappop(self._waiting_heap)
        return self._waiting_heap[0][1] if self._waiting_heap else None

    def _pop_waiting(self) -> Request:
        while True:
            key, req = heapq.heappop(self._waiting_heap)
            if req is not None:
                req._queue_key = key  # remember for priority-preserving requeue
                return req

    def _push_waiting(self, request: Request, key=None) -> None:
        if key is None:
            key = getattr(request, "_queue_key", None) or self._queue_key(request)
        heapq.heappush(self._waiting_heap, [key, request])

    # ------------------------------------------------------------------
    def add_request(self, request: Request) -> None:
        request._queue_key = self._queue_key(request)
        if len(request.sequences) > 1:
            self._has_multi_seq = True
        self._push_waiting(request)

    def abort_request(self, request: Request) -> None:
        request.abort()
        if request in self.running:
            for seq in request.sequences:
                self.block_manager.free(seq)
            self.running.remove(request)
        else:
            for e in self._waiting_heap:
                if e[1] is request:
                    e[1] = None  # tombstone
                    break
            # a waiting request may hold prefix-cache refs taken by a
            # failed admission attempt (match_prefix before a budget
            # break) — release them or they leak
            for seq in request.sequences:
                if seq.block_ids:
                    self.block_manager.free(seq)

    def has_unfinished(self) -> bool:
        return any(e[1] is not None for e in self._waiting_heap) or bool(
            self.running
        )

    @property
    def num_running_seqs(self) -> int:
        return sum(
            1 for r in self.running for s in r.sequences if not s.is_finished
        )

    # ------------------------------------------------------------------
    def _chunk_tokens(self, seq: Sequence, budget: int) -> int:
        """Prompt tokens to schedule for this seq under ``budget``.

        Non-final chunks are rounded down to block_size multiples so every
        chunk starts page-aligned — the contract of the full-page KV writer
        (ops/cuda/kv_write.py, as of the Pallas writer it replaces).
        """
        remaining = seq.num_tokens - seq.num_computed_tokens
        n = min(remaining, budget)
        if n < remaining:
            bs = self.block_manager.block_size
            n = (n // bs) * bs
        return n

    def schedule(self) -> SchedulerOutput:
        out = SchedulerOutput()
        budget = self.config.max_tokens_per_chunk_for_prefill
        if (
            self.profile_manager is not None
            and self.config.ttft_budget_ms > 0
        ):
            cap = self.profile_manager.max_prefill_tokens_for_ttft(
                self.config.ttft_budget_ms / 1e3
            )
            if cap is not None:
                budget = min(budget, max(cap, self.block_manager.block_size))

        # admission anti-starvation: when requests are waiting, reserve one
        # page of budget so a stream of long running prefills cannot starve
        # admissions forever (reference bounds this with per-step handling
        # budgets, continuous_scheduler.cpp:390 prefill loop)
        reserve = (
            self.block_manager.block_size
            if self._peek_waiting() is not None
            else 0
        )

        # 1. single pass over running sequences: continue chunked
        #    prefills AND collect decode candidates (reference splits
        #    these into handle_prefill_requests/handle_decode_requests,
        #    continuous_scheduler.cpp:390,612 — one pass halves the
        #    steady-state host cost of the O(batch) property walk)
        decode_cands: list[Sequence] = []
        for req in self.running:
            for seq in req.sequences:
                if seq.status is SequenceStatus.FINISHED or seq.on_hold:
                    continue
                if not seq.in_prefill:
                    if not getattr(seq, "beam_request", False):
                        decode_cands.append(seq)
                    continue
                if seq.has_unfixed_tokens:
                    continue  # awaiting async fixup
                if budget - reserve <= 0:
                    continue
                n = self._chunk_tokens(seq, budget - reserve)
                if n <= 0:
                    continue
                if not self.block_manager.allocate(seq, n):
                    continue  # pool exhausted; decode preemption may help
                out.prefill_items.append((seq, n))
                budget -= n

        # 2. admit waiting requests under seq + token budgets
        while self._peek_waiting() is not None and budget > 0:
            req = self._peek_waiting()
            # count the WHOLE incoming request (n/best_of sequences): the
            # engine's ring-slot pool is sized to max_seqs_per_batch and
            # every sequence of an admitted request eventually takes one
            if (
                self.num_running_seqs + len(req.sequences)
                > self.config.max_seqs_per_batch
            ):
                break
            seq = req.sequences[0]
            if seq.has_unfixed_tokens:
                break  # preempted seq awaiting async fixup before re-prefill
            if self.config.enable_zero_eviction:
                # admit only when the pool can hold the request's whole
                # projected footprint (prompt + max new tokens) ON TOP of
                # what running requests may still grow into, so nothing is
                # ever evicted mid-stream (reference ZeroEvictionScheduler,
                # zero_eviction_scheduler.h:22-35)
                bs = self.block_manager.block_size

                def projected_blocks(s) -> int:
                    remaining = s.stopping.max_new_tokens - s.num_generated_tokens
                    proj = min(
                        s.num_tokens + max(remaining, 0),
                        self.config.max_model_len,
                    )
                    return -(-proj // bs)

                need = sum(projected_blocks(s) for s in req.sequences)
                reserved = sum(
                    projected_blocks(s) - len(s.block_ids)
                    for r in self.running
                    for s in r.sequences
                    if not s.is_finished
                )
                if self.block_manager.num_free_blocks - reserved < need:
                    break
            # prefix-cache hit shortens the chunk
            # (reference prefill path prefix match, continuous_scheduler.cpp:390)
            self.block_manager.match_prefix(seq)
            n = self._chunk_tokens(seq, budget)
            if n <= 0:
                break  # leftover budget under one page; retry next step
            if not self.block_manager.allocate(seq, n):
                # roll back the prefix refs; retry next step
                self.block_manager.free(seq)
                break
            self._pop_waiting()
            req.sequences[0].status = SequenceStatus.RUNNING
            out.prefill_items.append((seq, n))
            budget -= n
            # remaining best_of sequences join as separate prefills later
            for extra in req.sequences[1:]:
                extra.status = SequenceStatus.RUNNING
            self.running.append(req)

        # 2b. chunks for secondary (best_of>1) sequences of admitted
        #     requests (skipped entirely for single-sequence workloads)
        if self._has_multi_seq:
            for req in self.running:
                for seq in req.sequences[1:]:
                    if seq.is_finished or not seq.in_prefill or budget <= 0:
                        continue
                    if seq.on_hold:
                        continue
                    if seq.num_computed_tokens == 0 and not seq.block_ids:
                        self.block_manager.match_prefix(seq)
                    n = self._chunk_tokens(seq, budget)
                    if n <= 0 or any(s is seq for s, _ in out.prefill_items):
                        continue
                    if not self.block_manager.allocate(seq, n):
                        break
                    out.prefill_items.append((seq, n))
                    budget -= n

        # 3. decode batch with preemption over the candidates collected
        #    in pass 1 (reference handle_decode_requests,
        #    continuous_scheduler.cpp:612)
        bm = self.block_manager
        bs = bm.block_size
        for seq in decode_cands:
            if seq.status is not SequenceStatus.RUNNING:
                continue  # preempted / finished earlier in this loop
            stop = seq.stopping
            ntok = len(seq.token_ids)
            if (
                ntok >= stop.max_model_len
                or ntok - len(seq.prompt_token_ids) >= stop.max_new_tokens
            ):
                # placeholders already reach a stop bound; the lagged
                # fixup will finish the sequence — don't overrun further
                continue
            # fast path: capacity for one more token already allocated
            if seq.num_computed_tokens + 1 <= len(seq.block_ids) * bs:
                out.decode_seqs.append(seq)
                continue
            while not bm.allocate(seq, 1):
                victim = self._pick_victim()
                if victim is None:
                    logger.warning(
                        "decode OOM and no preemption victim; seq %d waits",
                        seq.seq_id,
                    )
                    break
                self._preempt(victim, out)
                if seq.status is not SequenceStatus.RUNNING:
                    break  # the victim was our own request
            else:
                out.decode_seqs.append(seq)

        if len(out.decode_seqs) > self.config.max_seqs_per_batch:
            out.decode_seqs = out.decode_seqs[: self.config.max_seqs_per_batch]
        return out

    # ------------------------------------------------------------------
    def _pick_victim(self) -> Request | None:
        """Lowest-service-class, latest-arrived running request: offline
        before online, low priority before high, latest arrival first —
        possibly the requester itself (reference online-preempts-offline
        policy, continuous_scheduler.cpp:390-612 decode OOM path)."""
        best = None
        best_key = None
        for idx, req in enumerate(self.running):
            if req.is_finished:
                continue
            if getattr(req.sequences[0], "beam_request", False):
                # mid-beam state lives in the BeamRunner and cannot be
                # RECOMPUTE-restarted by the scheduler alone
                continue
            key = (req.offline, -req.priority, idx)
            # max over (offline desc, priority asc, arrival desc)
            if best_key is None or key > best_key:
                best, best_key = req, key
        return best

    def _preempt(self, req: Request, out: SchedulerOutput) -> None:
        logger.info("preempting request %s (recompute)", req.request_id)
        for seq in req.sequences:
            if not seq.is_finished:
                self.block_manager.free(seq)
                seq.status = SequenceStatus.PREEMPTED
        self.running.remove(req)
        self._push_waiting(req)  # original key -> priority-preserving
        out.preempted_requests.append(req)
        # drop any already-scheduled items of the preempted request
        out.prefill_items = [
            (s, n) for s, n in out.prefill_items if s.request_id != req.request_id
        ]
        out.decode_seqs = [
            s for s in out.decode_seqs if s.request_id != req.request_id
        ]

    # ------------------------------------------------------------------
    def handle_prefill_interruption(self) -> list[Request]:
        """Preempt every running OFFLINE request back to the waiting heap
        (reference PDOOCScheduler::handle_prefill_interruption,
        pd_ooc_scheduler.cpp:432-465): online prompts take the next chunk
        budget immediately instead of waiting for offline prefills to
        drain. Returns the preempted requests (the engine releases their
        ring slots)."""
        out = SchedulerOutput()
        for req in [r for r in self.running if r.offline]:
            self._preempt(req, out)
        if out.preempted_requests:
            logger.info(
                "forward interruption: preempted %d offline requests",
                len(out.preempted_requests),
            )
        return out.preempted_requests

    # ------------------------------------------------------------------
    def free_finished(self) -> list[Request]:
        """Release finished requests; returns them for response processing."""
        done = []
        for req in list(self.running):
            for seq in req.sequences:
                if seq.is_finished and seq.block_ids:
                    self.block_manager.free(seq)
            if req.is_finished:
                self.running.remove(req)
                done.append(req)
        return done
