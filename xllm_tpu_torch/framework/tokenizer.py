"""Tokenizer wrapper + incremental detokenization.

Counterpart of the reference's tokenizer stack
(reference xllm/core/framework/tokenizer/tokenizer.h:28, fast_tokenizer.h:21,
tokenizer_factory.*) and IncrementalDecoder
(xllm/core/framework/request/incremental_decoder.h:28). The HF ``tokenizers``
runtime covers the fast/BPE path; sentencepiece/tiktoken models load through
it via tokenizer.json.
"""

from __future__ import annotations

import os


class Tokenizer:
    """Thin wrapper over HF tokenizers with the ops the engine needs."""

    def __init__(self, hf_tokenizer) -> None:
        self._tok = hf_tokenizer

    @classmethod
    def from_path(cls, model_path: str) -> "Tokenizer":
        tok_json = os.path.join(model_path, "tokenizer.json")
        if os.path.exists(tok_json):
            from tokenizers import Tokenizer as HFTokenizer

            return cls(HFTokenizer.from_file(tok_json))
        # fall back to transformers (covers sentencepiece models)
        from transformers import AutoTokenizer

        return cls(AutoTokenizer.from_pretrained(model_path))

    def encode(self, text: str) -> list[int]:
        enc = self._tok.encode(text)
        return enc.ids if hasattr(enc, "ids") else list(enc)

    def decode(self, token_ids: list[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(token_ids, skip_special_tokens=skip_special_tokens)

    @property
    def vocab_size(self) -> int:
        if hasattr(self._tok, "get_vocab_size"):
            return self._tok.get_vocab_size()
        return len(self._tok)


class IncrementalDecoder:
    """Streams text out of a growing token list without re-decoding history.

    Same prefix/read-offset technique as the reference IncrementalDecoder
    (xllm/core/framework/request/incremental_decoder.h:28): keep a window of
    already-emitted tokens, re-decode [prefix:] and emit only the part after
    the previously emitted text, holding back when the tail is an incomplete
    UTF-8/BPE piece (detected via the replacement char).
    """

    def __init__(self, tokenizer: Tokenizer, prompt_len: int) -> None:
        self._tok = tokenizer
        self.prefix_offset = max(prompt_len - 5, 0)
        self.read_offset = prompt_len

    def decode_new(self, token_ids: list[int]) -> str:
        prefix_text = self._tok.decode(
            token_ids[self.prefix_offset : self.read_offset]
        )
        new_text = self._tok.decode(token_ids[self.prefix_offset :])
        if len(new_text) <= len(prefix_text) or new_text.endswith("�"):
            return ""
        delta = new_text[len(prefix_text) :]
        self.prefix_offset = self.read_offset
        self.read_offset = len(token_ids)
        return delta
