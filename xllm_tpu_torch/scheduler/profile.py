"""Step-time prediction for latency-aware scheduling.

A copy of ``xllm_tpu/scheduler/profile.py`` (pure Python; the port imports nothing
of the JAX package).

Counterpart of the reference's ProfileManager + TimePredictor
(reference xllm/core/scheduler/profile/profile_manager.h:33-145,
time_predictor.h:23-38, flags --enable_profile_step_time /
--enable_latency_aware_schedule): fits small polynomial models of step
time from observed (tokens, batch) samples and predicts TTFT/TPOT so the
scheduler can budget admissions against latency targets.
"""

from __future__ import annotations

import numpy as np


class TimePredictor:
    """Least-squares polynomial fit of step time vs a scalar feature."""

    def __init__(self, degree: int = 2):
        self.degree = degree
        self._coef: np.ndarray | None = None
        self._samples: list[tuple[float, float]] = []

    def add_sample(self, feature: float, seconds: float) -> None:
        self._samples.append((feature, seconds))

    @property
    def num_samples(self) -> int:
        return len(self._samples)

    def fit(self) -> bool:
        if len(self._samples) < self.degree + 1:
            return False
        x = np.asarray([s[0] for s in self._samples])
        y = np.asarray([s[1] for s in self._samples])
        self._coef = np.polyfit(x, y, self.degree)
        return True

    def predict(self, feature: float) -> float | None:
        if self._coef is None:
            return None
        return float(max(np.polyval(self._coef, feature), 0.0))


class ProfileManager:
    """Online prefill/decode timing models + latency budgeting.

    prefill time ~ poly(chunk tokens); decode time ~ poly(batch size).
    ``max_prefill_tokens_for_ttft`` inverts the prefill model against a
    TTFT budget, the scheduler's knob for latency-aware admission.
    """

    def __init__(self, refit_every: int = 32):
        self.prefill = TimePredictor(degree=2)
        self.decode = TimePredictor(degree=1)
        self.refit_every = refit_every
        self._since_fit = 0

    def observe_prefill(self, num_tokens: int, seconds: float) -> None:
        self.prefill.add_sample(float(num_tokens), seconds)
        self._maybe_fit()

    def observe_decode(self, batch: int, seconds: float) -> None:
        self.decode.add_sample(float(batch), seconds)
        self._maybe_fit()

    def _maybe_fit(self) -> None:
        self._since_fit += 1
        if self._since_fit >= self.refit_every:
            self.prefill.fit()
            self.decode.fit()
            self._since_fit = 0

    def predict_prefill_s(self, num_tokens: int) -> float | None:
        return self.prefill.predict(float(num_tokens))

    def predict_tpot_s(self, batch: int) -> float | None:
        return self.decode.predict(float(batch))

    def max_prefill_tokens_for_ttft(
        self, ttft_budget_s: float, hi: int = 1 << 16
    ) -> int | None:
        """Largest chunk whose predicted prefill time fits the budget."""
        return self._invert(self.prefill, ttft_budget_s, hi)

    def max_decode_batch_for_tpot(
        self, tpot_budget_s: float, hi: int = 4096
    ) -> int | None:
        """Largest decode batch whose predicted step time fits the TPOT
        budget — the PerfModel inversion the PD-OOC scheduler solves its
        offline pull quota against (reference perf_model.h:50,
        pd_ooc_scheduler.cpp:337-340)."""
        return self._invert(self.decode, tpot_budget_s, hi)

    @staticmethod
    def _invert(
        predictor: TimePredictor, budget_s: float, hi: int
    ) -> int | None:
        if predictor.predict(1.0) is None:
            return None
        lo, best = 1, 0
        while lo <= hi:
            mid = (lo + hi) // 2
            t = predictor.predict(float(mid))
            if t is not None and t <= budget_s:
                best = mid
                lo = mid + 1
            else:
                hi = mid - 1
        return best or None
