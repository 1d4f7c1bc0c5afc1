"""Suffix-match draft-token proposers (model-free speculative decoding).

Counterpart of ``xllm_tpu/framework/suffix_cache.py``: drafts are proposed
by matching a sequence's recent tokens against its own history (prompt +
generation) and, on a miss, against a global cache of finished
generations. Each keeps a hash map from n-grams (``min_match`` to
``max_match`` tokens) to the position after their latest occurrence:
O(1) append, O(match length) lookup.

Pure Python. The JAX engine takes its C++ index when that is built; the
JAX package's tests hold the two equal, so the proposals here are the
same.
"""

from __future__ import annotations

import numpy as np


def _index_ngrams(index: dict, tokens, start: int, end: int, min_match: int,
                  max_match: int) -> None:
    """Map every n-gram ending at each position in [max(start, min_match),
    end) to that position."""
    for stop in range(max(start, min_match), end):
        for n in range(min_match, max_match + 1):
            if stop - n < 0:
                break
            index[tuple(int(t) for t in tokens[stop - n : stop])] = stop


class SuffixProposer:
    """Per-sequence n-gram index proposing continuation drafts."""

    def __init__(self, min_match: int = 2, max_match: int = 4):
        self.min_match = min_match
        self.max_match = max_match
        # ngram tuple -> last position AFTER the ngram occurrence
        self._index: dict[tuple, int] = {}
        self._len = 0

    def extend(self, token_ids: list[int], upto: int) -> None:
        """Index token_ids[:upto] (append-only; call with growing upto)."""
        _index_ngrams(self._index, token_ids, self._len, upto, self.min_match,
                      self.max_match)
        self._len = max(self._len, upto)

    def propose(self, token_ids: list[int], k: int) -> list[int]:
        """Draft up to k tokens continuing the current suffix."""
        n_tok = len(token_ids)
        for n in range(min(self.max_match, n_tok), self.min_match - 1, -1):
            pos = self._index.get(tuple(token_ids[n_tok - n : n_tok]))
            if pos is not None and pos < n_tok:
                return list(token_ids[pos : pos + k])
        return []


class GlobalSuffixCache:
    """Cross-request draft source over FINISHED generations.

    Finished sequences are appended to one token stream with an impossible
    token (``SEP``) between them, so n-grams never span generations, and
    indexed as ``SuffixProposer`` indexes its history; drafts are read
    from the stream and stop at a separator. When the stream would pass
    ``max_tokens`` the index restarts empty (an epoch reset bounds the
    memory)."""

    SEP = -7

    def __init__(self, min_match: int = 2, max_match: int = 4,
                 max_tokens: int = 500_000):
        self.min_match = min_match
        self.max_match = max_match
        self.max_tokens = max_tokens
        self._reset()

    def _reset(self) -> None:
        self._stream = np.zeros(0, np.int32)
        self._n = 0
        self._index: dict[tuple, int] = {}

    def add(self, token_ids: list[int]) -> None:
        """Index one finished generation (prompt + response)."""
        if not token_ids:
            return
        if self._n + len(token_ids) + 1 > self.max_tokens:
            self._reset()
        new = np.asarray(list(token_ids) + [self.SEP], np.int32)
        if self._n + len(new) > len(self._stream):
            grown = np.zeros(max(len(self._stream) * 2, self._n + len(new), 4096), np.int32)
            grown[: self._n] = self._stream[: self._n]
            self._stream = grown
        self._stream[self._n : self._n + len(new)] = new
        old_n = self._n
        self._n += len(new)
        _index_ngrams(self._index, self._stream, old_n, self._n, self.min_match,
                      self.max_match)

    def propose(self, token_ids: list[int], k: int) -> list[int]:
        """Draft from earlier generations continuing this suffix."""
        if self._n == 0:
            return []
        n_tok = len(token_ids)
        draft: list[int] = []
        for n in range(min(self.max_match, n_tok), self.min_match - 1, -1):
            pos = self._index.get(tuple(token_ids[n_tok - n : n_tok]))
            if pos is not None:
                draft = [int(t) for t in self._stream[pos : pos + k]]
                break
        out = []
        for t in draft:
            if t == self.SEP:
                break
            out.append(t)
        return out
