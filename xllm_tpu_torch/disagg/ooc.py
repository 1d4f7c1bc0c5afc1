"""PD-OOC: online/offline co-location on disaggregated PD instances. A
copy of ``xllm_tpu/disagg/ooc.py``.

Counterpart of the reference's PDOOCScheduler + PerfModel
(reference xllm/core/scheduler/pd_ooc_scheduler.h:44-120,
pd_ooc_scheduler.cpp:46,337-340, perf_model.h:50). Semantics preserved:

- the PREFILL node keeps separate online/offline queues and dispatches
  all-online or all-offline batches — a step is ONLINE_PREFILL,
  OFFLINE_PREFILL, or IDLE (`StepStatus` enum, pd_ooc_scheduler.h:43).
  Online prompts always go first; offline prompts prefill only when no
  online work is waiting or in flight. Finished offline handoffs park in
  a backlog instead of being pushed.
- the DECODE node PULLS offline work (the reference's pull signal,
  `decode_send_pull_signal`/`check_able_to_pull`) only when its measured
  step latency leaves headroom under the online TPOT budget — the
  PerfModel here is the engine's ProfileManager step-time fit.
- on pressure, offline requests are preempted first: accepted offline
  handoffs carry `offline=True`, so the continuous scheduler's
  service-class preemption (online-preempts-offline,
  continuous_scheduler.cpp:390-612 analog) applies unchanged.
"""

from __future__ import annotations

import collections
import enum

from xllm_tpu_torch.disagg.pd import (
    AsyncPrefillInstance,
    DecodeInstance,
    PrefillHandoff,
)
from xllm_tpu_torch.framework.request import Request
from xllm_tpu_torch.scheduler.profile import ProfileManager


class StepStatus(enum.Enum):
    ONLINE_PREFILL = "online_prefill"
    OFFLINE_PREFILL = "offline_prefill"
    DECODE = "decode"
    IDLE = "idle"


class OOCPrefillNode:
    """Prefill-role node with online/offline queue separation."""

    def __init__(self, prefill: AsyncPrefillInstance,
                 max_inflight: int = 8):
        self.prefill = prefill
        self.max_inflight = max_inflight
        self._online: collections.deque = collections.deque()
        self._offline: collections.deque = collections.deque()
        # finished offline handoffs, awaiting a decode-side pull
        self.offline_backlog: collections.deque = collections.deque()
        self._inflight_kind: dict[str, bool] = {}  # rid -> offline?
        self.last_status = StepStatus.IDLE

    # -- intake ---------------------------------------------------------
    def submit_online(self, prompt_token_ids, sampling_params, on_ready,
                      request_id=None):
        self._online.append(
            (prompt_token_ids, sampling_params, on_ready, request_id)
        )

    def submit_offline(self, prompt_token_ids, sampling_params,
                       request_id=None):
        self._offline.append(
            (prompt_token_ids, sampling_params, None, request_id)
        )

    # -- the decode node's pull (reference write_pull_signal ->
    #    prefill_send_multi_generations path) ---------------------------
    def pull_offline(self, n: int) -> list[PrefillHandoff]:
        out = []
        while self.offline_backlog and len(out) < n:
            out.append(self.offline_backlog.popleft())
        return out

    def requeue(self, handoff: PrefillHandoff) -> None:
        """Return a pulled handoff the decode side could not install."""
        self.offline_backlog.appendleft(handoff)

    # -- dispatch loop ---------------------------------------------------
    def _dispatch(self) -> None:
        """All-online or all-offline admission for this step."""
        inflight_online = sum(
            0 if off else 1 for off in self._inflight_kind.values()
        )
        inflight_offline = len(self._inflight_kind) - inflight_online
        if self._online or inflight_online:
            # ONLINE step: admit online only; offline waits even if the
            # engine has room (all-online-or-all-offline batches)
            if (
                self._online
                and inflight_offline
                and self.prefill.engine.config.scheduler
                .enable_forward_interruption
            ):
                # online work arrived mid-OFFLINE_PREFILL: publish an
                # interruption so the engine preempts the offline chunks
                # at the next step boundary instead of draining them
                # (reference pd_ooc_scheduler.cpp:885-888 publish site)
                self.prefill.engine.interruption_bus.publish(True)
            while self._online and len(self._inflight_kind) < self.max_inflight:
                if inflight_offline and not self.prefill.engine.config \
                        .scheduler.enable_forward_interruption:
                    break  # finish draining offline work first
                p, sp, cb, rid = self._online.popleft()
                rid = self.prefill.submit(p, sp, cb, request_id=rid)
                self._inflight_kind[rid] = False
            self.last_status = StepStatus.ONLINE_PREFILL
        elif self._offline or inflight_offline:
            while self._offline and len(self._inflight_kind) < self.max_inflight:
                p, sp, _, rid = self._offline.popleft()
                rid = self.prefill.submit(
                    p, sp, self._offline_done, request_id=rid, offline=True
                )
                self._inflight_kind[rid] = True
            self.last_status = StepStatus.OFFLINE_PREFILL
        else:
            self.last_status = StepStatus.IDLE

    def _offline_done(self, handoff: PrefillHandoff) -> None:
        self.offline_backlog.append(handoff)

    def pump(self) -> None:
        self._dispatch()
        before = set(self.prefill._inflight) | set(self.prefill._extracting)
        self.prefill.pump()
        after = set(self.prefill._inflight) | set(self.prefill._extracting)
        for rid in before - after:
            self._inflight_kind.pop(rid, None)


class OOCDecodeNode:
    """Decode-role node that pulls offline work only under latency slack."""

    def __init__(
        self,
        decode: DecodeInstance,
        tpot_budget_s: float,
        headroom: float = 0.8,
        profile: ProfileManager | None = None,
        max_pull: int = 2,
    ):
        self.decode = decode
        self.tpot_budget_s = tpot_budget_s
        self.headroom = headroom
        self.profile = profile or ProfileManager()
        self.max_pull = max_pull
        self.pulls = 0

    # -- PerfModel quota (reference check_able_to_pull + the batch-
    #    composition solve, pd_ooc_scheduler.cpp:337-340, perf_model.h:50)
    def pull_quota(self) -> int:
        """How many offline sequences this step may pull: the fitted
        step-time model is INVERTED against the online TPOT budget —
        quota = (largest batch whose predicted step time fits the
        budget) - (current batch), capped by the per-step burst limit.
        Offline throughput is thereby maximized subject to the online
        latency constraint, not a fixed heuristic count."""
        eng = self.decode.engine
        batch = sum(len(r.sequences) for r in eng.scheduler.running)
        max_batch = self.profile.max_decode_batch_for_tpot(
            self.tpot_budget_s * self.headroom
        )
        if max_batch is None:
            # no fitted model yet: pull only when idle
            return self.max_pull if batch == 0 else 0
        return max(0, min(max_batch - batch, self.max_pull))

    def able_to_pull(self) -> bool:
        return self.pull_quota() > 0

    def accept(self, handoff: PrefillHandoff, offline: bool = False) -> Request:
        req = self.decode.accept(handoff)
        req.offline = offline
        if offline:
            req.priority = -1
        return req

    def pump(self, prefill_node: OOCPrefillNode) -> None:
        """One decode step; pull offline handoffs when there is slack."""
        import time

        quota = self.pull_quota()
        if quota > 0:
            for h in prefill_node.pull_offline(quota):
                try:
                    self.accept(h, offline=True)
                except RuntimeError:
                    # at capacity (slots/blocks): requeue and stop pulling
                    prefill_node.requeue(h)
                    break
                self.pulls += 1
        eng = self.decode.engine
        if eng.has_unfinished():
            batch = sum(len(r.sequences) for r in eng.scheduler.running)
            t0 = time.perf_counter()
            eng.step()
            self.profile.observe_decode(batch, time.perf_counter() - t0)
