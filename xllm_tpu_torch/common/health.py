"""Health check manager.

A copy of ``xllm_tpu/common/health.py`` (pure Python; the port imports nothing
of the JAX package).

Counterpart of the reference HealthCheckManager
(reference xllm/core/common/health_check_manager.h:34-106 + the /health
reporter, server/xllm_server.cpp:148-149): components register health-check
callables; a background thread polls them; any failure flips the reported
status so load balancers drain the instance.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from xllm_tpu_torch.utils import get_logger

logger = get_logger(__name__)


class HealthCheckManager:
    def __init__(self, interval_s: float = 3.0):
        self.interval_s = interval_s
        self._checks: dict[str, Callable[[], bool]] = {}
        self._lock = threading.Lock()
        self._healthy = True
        self._failed: list[str] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def register(self, name: str, check: Callable[[], bool]) -> None:
        with self._lock:
            self._checks[name] = check

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="health-check"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def run_checks_once(self) -> bool:
        with self._lock:
            checks = dict(self._checks)
        failed = []
        for name, check in checks.items():
            try:
                if not check():
                    failed.append(name)
            except Exception as e:
                logger.warning("health check %s raised: %s", name, e)
                failed.append(name)
        self._failed = failed
        healthy = not failed
        if healthy != self._healthy:
            logger.warning(
                "health transition -> %s (failed: %s)",
                "healthy" if healthy else "UNHEALTHY",
                failed,
            )
        self._healthy = healthy
        return healthy

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.run_checks_once()

    @property
    def healthy(self) -> bool:
        return self._healthy

    @property
    def failed_checks(self) -> list[str]:
        return list(self._failed)
