"""Streaming reasoning-content splitter.

A copy of ``xllm_tpu/parser/reasoning_parser.py`` (pure Python; the port imports nothing
of the JAX package).

Counterpart of the reference ReasoningParser
(reference xllm/parser/reasoning_parser.h:26): splits `<think>...</think>`
style segments out of a token stream into `reasoning_content`, leaving the
rest as `content`. Streaming-safe: text arriving in arbitrary chunks is
buffered just enough to disambiguate partial tags.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ReasoningDelta:
    reasoning: str = ""
    content: str = ""


class ReasoningParser:
    """Incremental `<think>` splitter.

    ``force_reasoning``: models (deepseek-r1, qwen3 with enable_thinking)
    that start generation inside an implicit think block.
    """

    def __init__(
        self,
        open_tag: str = "<think>",
        close_tag: str = "</think>",
        force_reasoning: bool = False,
    ):
        self.open_tag = open_tag
        self.close_tag = close_tag
        self.in_reasoning = force_reasoning
        self._buf = ""
        self._done = False  # only one think block is recognized

    def _possible_tag_prefix(self, s: str, tag: str) -> int:
        """Length of the longest suffix of s that is a proper prefix of tag."""
        for n in range(min(len(tag) - 1, len(s)), 0, -1):
            if s.endswith(tag[:n]):
                return n
        return 0

    def feed(self, delta: str) -> ReasoningDelta:
        self._buf += delta
        out = ReasoningDelta()
        while self._buf:
            tag = self.close_tag if self.in_reasoning else self.open_tag
            if self._done:
                out.content += self._buf
                self._buf = ""
                break
            idx = self._buf.find(tag)
            if idx != -1:
                seg = self._buf[:idx]
                if self.in_reasoning:
                    out.reasoning += seg
                    self.in_reasoning = False
                    self._done = True
                else:
                    out.content += seg
                    self.in_reasoning = True
                self._buf = self._buf[idx + len(tag) :]
                continue
            hold = self._possible_tag_prefix(self._buf, tag)
            emit, self._buf = (
                self._buf[: len(self._buf) - hold],
                self._buf[len(self._buf) - hold :],
            )
            if self.in_reasoning:
                out.reasoning += emit
            else:
                out.content += emit
            break
        return out

    def finish(self) -> ReasoningDelta:
        """Flush any held-back partial tag at end of stream."""
        out = ReasoningDelta()
        if self._buf:
            if self.in_reasoning:
                out.reasoning = self._buf
            else:
                out.content = self._buf
            self._buf = ""
        return out
