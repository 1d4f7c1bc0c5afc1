"""Prometheus metrics registry.

Counterpart of ``xllm_tpu/common/metrics.py``, with the same names, labels
and buckets, exported at /metrics in prometheus text format. Without
``prometheus_client`` installed every metric is a no-op and ``render()``
returns an empty body, as in the JAX package.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

try:
    from prometheus_client import (
        CollectorRegistry,
        Counter,
        Gauge,
        Histogram,
        generate_latest,
    )

    _HAVE_PROM = True
except ImportError:  # pragma: no cover
    _HAVE_PROM = False

REGISTRY = CollectorRegistry() if _HAVE_PROM else None

_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _make(cls, name, doc, **kw):
    if not _HAVE_PROM:  # pragma: no cover
        return _Null()
    return cls(name, doc, registry=REGISTRY, **kw)


class _Null:  # pragma: no cover
    def inc(self, *a, **k): ...
    def dec(self, *a, **k): ...
    def set(self, *a, **k): ...
    def observe(self, *a, **k): ...
    def labels(self, *a, **k): return self


# ---- server level ----
REQUESTS_TOTAL = _make(Counter, "xllm_requests_total", "API requests", labelnames=["endpoint", "status"])
REQUESTS_RUNNING = _make(Gauge, "xllm_requests_running", "in-flight requests")
REQUEST_LATENCY = _make(Histogram, "xllm_request_latency_seconds", "end-to-end request latency", buckets=_LATENCY_BUCKETS)
TTFT = _make(Histogram, "xllm_time_to_first_token_seconds", "time to first token", buckets=_LATENCY_BUCKETS)
TPOT = _make(Histogram, "xllm_time_per_output_token_seconds", "per-token latency", buckets=_LATENCY_BUCKETS)

# ---- engine level ----
GENERATED_TOKENS = _make(Counter, "xllm_generated_tokens_total", "tokens generated")
PROMPT_TOKENS = _make(Counter, "xllm_prompt_tokens_total", "prompt tokens processed")
ENGINE_STEPS = _make(Counter, "xllm_engine_steps_total", "engine steps")
PREEMPTIONS = _make(Counter, "xllm_preemptions_total", "sequences preempted")
KV_BLOCKS_USED = _make(Gauge, "xllm_kv_blocks_used", "paged KV blocks in use")
KV_BLOCKS_TOTAL = _make(Gauge, "xllm_kv_blocks_total", "paged KV blocks total")
PREFIX_CACHE_HIT_TOKENS = _make(Counter, "xllm_prefix_cache_hit_tokens_total", "prompt tokens served from prefix cache")
SCHEDULE_LATENCY = _make(Histogram, "xllm_schedule_latency_seconds", "scheduler step latency", buckets=_LATENCY_BUCKETS)


@contextmanager
def observe_latency(hist):
    """Scoped latency observation."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        hist.observe(time.perf_counter() - t0)


def render() -> bytes:
    """Prometheus text exposition for the /metrics endpoint."""
    if not _HAVE_PROM:  # pragma: no cover
        return b""
    return generate_latest(REGISTRY)
