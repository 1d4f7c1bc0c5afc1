"""Per-request sampling parameters.

Counterpart of the reference's RequestSamplingParam
(reference xllm/core/framework/request/request_params.h and
xllm/core/framework/sampling/sampling_params.h): greedy/temperature,
top-k/top-p, penalties, logprobs, beam width, stop conditions.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SamplingParams:
    n: int = 1
    best_of: int | None = None
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1  # -1 = disabled
    max_tokens: int = 16
    min_tokens: int = 0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    repetition_penalty: float = 1.0
    stop: list[str] = field(default_factory=list)
    stop_token_ids: list[int] = field(default_factory=list)
    ignore_eos: bool = False
    logprobs: int | None = None  # number of top logprobs to return
    echo: bool = False
    seed: int | None = None
    # beam search (reference beam_searcher.cpp:21) — engine-level, later round
    use_beam_search: bool = False

    def __post_init__(self) -> None:
        if self.best_of is None:
            self.best_of = self.n
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not 0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if self.top_k == 0 or self.top_k < -1:
            raise ValueError("top_k must be -1 (disabled) or positive")
        if self.n < 1 or self.best_of < self.n:
            raise ValueError("require n >= 1 and best_of >= n")

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0
