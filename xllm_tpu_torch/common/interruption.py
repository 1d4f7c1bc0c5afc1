"""Forward-interruption bus: preempt offline work the moment online
requests arrive. A copy of ``xllm_tpu/common/interruption.py``.

Counterpart of the reference's InterruptionBus +
ForwardInterruptedException (reference xllm/core/common/
interruption_bus.h:22-35; publish site pd_ooc_scheduler.cpp:885-888;
handling pd_ooc_scheduler.cpp:432-465; flag --enable_forward_interruption,
options.h:118-119). Semantics: a queued pass on the card cannot be
aborted mid-flight, but prefill is CHUNKED, so the interruption boundary
is the next engine step — the engine consumes the latched signal before
scheduling and preempts every running offline request (RECOMPUTE requeue)
so online prompts take the very next chunk budget. The worst-case
interruption latency is one chunk's compute, which chunked prefill
already bounds.
"""

from __future__ import annotations

import threading
from typing import Callable


class InterruptionBus:
    """Thread-safe publish/subscribe with a latched pending flag."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._observers: list[Callable[[bool], None]] = []
        self._pending = False

    def subscribe(self, func: Callable[[bool], None]) -> None:
        with self._lock:
            self._observers.append(func)

    def publish(self, interruption: bool = True) -> None:
        with self._lock:
            if interruption:
                self._pending = True
            observers = list(self._observers)
        for fn in observers:
            fn(interruption)

    def consume(self) -> bool:
        """Return-and-clear the latched flag (engine step entry)."""
        with self._lock:
            pending, self._pending = self._pending, False
            return pending

    @property
    def pending(self) -> bool:
        return self._pending
