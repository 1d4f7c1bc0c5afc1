"""Small shared helpers (reference xllm/core/util/ equivalents)."""

from __future__ import annotations

import logging
import os


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def next_bucket(buckets: list[int], x: int) -> int:
    """Smallest bucket >= x; buckets must be sorted ascending.

    The jit-shape equivalent of the reference's graph bucket selection
    (reference xllm/core/runtime/acl_graph_executor_impl.h:67-77).
    """
    for b in buckets:
        if b >= x:
            return b
    return buckets[-1]


_LOG_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logging.getLogger("xllm_tpu_torch").handlers:
        root = logging.getLogger("xllm_tpu_torch")
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_LOG_FORMAT))
        root.addHandler(handler)
        root.setLevel(os.environ.get("XLLM_LOG_LEVEL", "INFO"))
    return logger
