"""MixScheduler: one priority queue mixing prefill and decode (ProSched).

Counterpart of ``xllm_tpu/scheduler/mix.py``, itself the counterpart of
the reference's MixScheduler
(reference xllm/core/scheduler/mix_scheduler.h:29-90,
mix_scheduler.cpp: prepare_batch + handle_running_queue_requests +
get_max_chunk). Unlike the ContinuousScheduler's decode-first ordering,
every piece of work — a running decode, a running prefill chunk, a
waiting admission — competes in ONE service-class order
``(offline, -priority, arrival)``; a per-step latency budget (from the
ProfileManager's fitted step-time models, the reference's PerfModel)
bounds how much work the step takes, and prefill chunks shrink to the
largest size whose predicted cost fits the remaining budget (the
reference's ``get_max_chunk`` quadratic solve becomes a binary search on
the fitted polynomial).

High-priority prefills can therefore crowd low-priority decodes out of a
step (they simply don't advance that round), which is the ProSched
multi-priority behavior the reference gates this scheduler on.

Pure host logic; the emitted SchedulerOutput is identical in shape to
the ContinuousScheduler's, so the engine step is unchanged.

One deviation from the JAX scheduler: ``_live_cap`` lets the first unit
of a still-empty step take one page when the fitted model predicts that a
page alone exceeds the budget; the JAX walk schedules nothing there, and
its engine spins on empty steps forever.
"""

from __future__ import annotations

import heapq

from xllm_tpu_torch.framework.request import Request, SequenceStatus
from xllm_tpu_torch.scheduler.continuous import ContinuousScheduler, SchedulerOutput
from xllm_tpu_torch.utils import get_logger

logger = get_logger(__name__)


class MixScheduler(ContinuousScheduler):
    def __init__(self, config, block_manager, profile_manager=None):
        super().__init__(config, block_manager, profile_manager)
        # decode cost is charged marginally as the batch grows; prefill
        # per-chunk. Until the models fit, the latency budget is inactive
        # (token/seq budgets still apply) — same warm-up behavior as the
        # reference's TimePredictor before profiling data exists.

    # -- latency helpers --------------------------------------------------
    def _latency_budget_s(self) -> float:
        ms = getattr(self.config, "step_latency_budget_ms", 0.0)
        return ms / 1e3 if ms and ms > 0 else float("inf")

    def _prefill_cost_s(self, n_tokens: int) -> float:
        if self.profile_manager is None:
            return 0.0
        t = self.profile_manager.predict_prefill_s(n_tokens)
        return t if t is not None else 0.0

    def _decode_marginal_cost_s(self, batch_after: int) -> float:
        if self.profile_manager is None:
            return 0.0
        t1 = self.profile_manager.predict_tpot_s(batch_after)
        t0 = self.profile_manager.predict_tpot_s(max(batch_after - 1, 0))
        if t1 is None or t0 is None:
            return 0.0
        return max(t1 - t0, 0.0)

    def _max_chunk_for_latency(self, latency_left_s: float, cap: int) -> int:
        """Largest chunk whose predicted prefill time fits the remaining
        latency budget (reference get_max_chunk, mix_scheduler.cpp)."""
        if (
            self.profile_manager is None
            or latency_left_s == float("inf")
            or self.profile_manager.predict_prefill_s(1) is None
        ):
            return cap
        lo, hi, best = 1, cap, 0
        while lo <= hi:
            mid = (lo + hi) // 2
            if self._prefill_cost_s(mid) <= latency_left_s:
                best, lo = mid, mid + 1
            else:
                hi = mid - 1
        return best

    def _live_cap(self, cap: int, token_budget: int, out) -> int:
        """Liveness: the first unit of a step that is still empty may take
        one page even when the fitted model predicts that a page alone
        exceeds the budget. Without it (the JAX scheduler) such a step stays
        empty, empty steps feed the model no sample, and the engine spins
        forever; with a cap of a page or more nothing changes."""
        bs = self.block_manager.block_size
        if cap < bs and not out.prefill_items and not out.decode_seqs:
            return min(bs, token_budget)
        return cap

    # -- the mixed-queue step ---------------------------------------------
    def schedule(self) -> SchedulerOutput:
        out = SchedulerOutput()
        token_budget = self.config.max_tokens_per_chunk_for_prefill
        latency_left = self._latency_budget_s()

        # one ordered walk over ALL work: running requests keep their
        # original queue key; waiting requests compete with their own
        # (mix_scheduler.cpp single running_queue_, no P/D split)
        units: list[tuple[tuple, bool, Request]] = []
        for req in self.running:
            key = getattr(req, "_queue_key", None) or self._queue_key(req, 0)
            units.append((key, False, req))
        for e in sorted(self._waiting_heap, key=lambda e: e[0]):
            if e[1] is not None:
                units.append((tuple(e[0]), True, e[1]))
        units.sort(key=lambda u: u[0])

        decode_batch = 0
        for key, is_waiting, req in units:
            if latency_left <= 0 or req.is_finished:
                continue
            if not is_waiting and req not in self.running:
                # preempted mid-walk by a higher-class decode below —
                # its blocks are freed; do not schedule stray work
                continue
            if is_waiting:
                admitted = self._try_admit(
                    req, token_budget, latency_left, out
                )
                if admitted is None:
                    continue
                n, cost = admitted
                token_budget -= n
                latency_left -= cost
                continue
            for seq in req.sequences:
                if seq.is_finished or seq.on_hold:
                    continue
                if seq.in_prefill:
                    if seq.has_unfixed_tokens or token_budget <= 0:
                        continue
                    if any(s is seq for s, _ in out.prefill_items):
                        continue
                    cap = self._live_cap(self._max_chunk_for_latency(
                        latency_left, token_budget
                    ), token_budget, out)
                    if seq.num_computed_tokens == 0 and not seq.block_ids:
                        self.block_manager.match_prefix(seq)
                    n = self._chunk_tokens(seq, cap)
                    if n <= 0:
                        continue
                    if not self.block_manager.allocate(seq, n):
                        continue
                    out.prefill_items.append((seq, n))
                    token_budget -= n
                    latency_left -= self._prefill_cost_s(n)
                else:
                    if getattr(seq, "beam_request", False):
                        continue
                    if (
                        seq.num_tokens >= seq.stopping.max_model_len
                        or seq.num_generated_tokens
                        >= seq.stopping.max_new_tokens
                    ):
                        continue
                    cost = self._decode_marginal_cost_s(decode_batch + 1)
                    if cost > latency_left and decode_batch > 0:
                        continue  # out of latency budget: skip this round
                    if len(out.decode_seqs) >= self.config.max_seqs_per_batch:
                        continue
                    ok = self.block_manager.allocate(seq, 1)
                    while not ok:
                        victim = self._pick_victim_lower(key)
                        if victim is None:
                            break
                        self._preempt(victim, out)
                        ok = self.block_manager.allocate(seq, 1)
                    if not ok:
                        continue
                    out.decode_seqs.append(seq)
                    decode_batch += 1
                    latency_left -= cost

        return out

    # -- admission of a waiting request ------------------------------------
    def _try_admit(self, req, token_budget, latency_left, out):
        if token_budget <= 0:
            return None
        if (
            self.num_running_seqs + len(req.sequences)
            > self.config.max_seqs_per_batch
        ):
            return None
        seq = req.sequences[0]
        if seq.has_unfixed_tokens:
            return None
        self.block_manager.match_prefix(seq)
        cap = self._live_cap(
            self._max_chunk_for_latency(latency_left, token_budget), token_budget, out
        )
        n = self._chunk_tokens(seq, cap)
        if n <= 0:
            return None
        if not self.block_manager.allocate(seq, n):
            self.block_manager.free(seq)
            return None
        # remove this exact request from the heap (a tombstone would
        # collide with a later priority-preserving requeue of the same key)
        for e in self._waiting_heap:
            if e[1] is req:
                req._queue_key = tuple(e[0])
                self._waiting_heap.remove(e)
                heapq.heapify(self._waiting_heap)
                break
        for s in req.sequences:
            s.status = SequenceStatus.RUNNING
        self.running.append(req)
        out.prefill_items.append((seq, n))
        return n, self._prefill_cost_s(n)

    def _pick_victim_lower(self, requester_key) -> Request | None:
        """Preempt only strictly lower-service-class running requests —
        in a mixed priority queue a request never preempts its own class
        mid-walk (higher classes were already served)."""
        best, best_key = None, None
        for idx, req in enumerate(self.running):
            if req.is_finished:
                continue
            if getattr(req.sequences[0], "beam_request", False):
                # mid-beam state lives in the BeamRunner and cannot be
                # RECOMPUTE-restarted by the scheduler alone
                continue
            key = (req.offline, -req.priority)
            if key <= tuple(requester_key[:2]):
                continue  # same or higher class
            full = (req.offline, -req.priority, idx)
            if best_key is None or full > best_key:
                best, best_key = req, full
        return best
