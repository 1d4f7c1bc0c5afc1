"""Global concurrency rate limiter.

A copy of ``xllm_tpu/common/rate_limiter.py`` (pure Python; the port imports nothing
of the JAX package).

Counterpart of the reference RateLimiter
(reference xllm/core/common/rate_limiter.h, checked before enqueue at
chat_service_impl.cpp:648).
"""

from __future__ import annotations

import threading


class RateLimiter:
    def __init__(self, max_concurrency: int = 0):
        """max_concurrency <= 0 means unlimited."""
        self.max_concurrency = max_concurrency
        self._count = 0
        self._lock = threading.Lock()

    def try_acquire(self) -> bool:
        with self._lock:
            if 0 < self.max_concurrency <= self._count:
                return False
            self._count += 1
            return True

    def release(self) -> None:
        with self._lock:
            self._count = max(0, self._count - 1)

    @property
    def running(self) -> int:
        return self._count
