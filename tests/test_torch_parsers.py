"""The output parsers: ``xllm_tpu_torch.parser`` vs ``xllm_tpu.parser``.

Pure Python on both sides, so every result must be identical, not close:
the inputs of ``tests/test_parsers.py`` and ``tests/test_stream_tool_calls.py``
through every detector name of ``_DETECTORS`` (one shot), the streaming
tool-call parser under every chunking (each ``feed``'s content and deltas,
then ``finish``'s), the reasoning splitter (forced open or not) under every
chunking, ``parse_partial_json`` on every prefix of the fuzz documents of
``tests/test_parsers.py``, and hypothesis fuzz of ``parse_partial_json``
and the streaming parser on random prefixes and chunkings. Tool-call ids
are drawn from ``uuid4`` and are compared by shape only.
"""

import json
import re

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from xllm_tpu.parser import function_call as jfc
from xllm_tpu.parser import reasoning_parser as jrp
from xllm_tpu_torch.parser import function_call as tfc
from xllm_tpu_torch.parser import reasoning_parser as trp
from torch_threads import one_torch_thread  # noqa: F401

FORMATS = sorted(jfc._DETECTORS)

TEXTS = {
    "hermes": ('let me check.\n<tool_call>\n{"name": "get_weather", '
               '"arguments": {"city": "Paris"}}\n</tool_call>'),
    "hermes2": ('<tool_call>{"name": "a", "arguments": {}}</tool_call>'
                '<tool_call>{"name": "b", "arguments": {"x": 1}}</tool_call>'),
    "one": ('Let me check the weather.\n<tool_call>\n{"name": "get_weather", '
            '"arguments": {"city": "Paris", "unit": "celsius"}}\n</tool_call>'),
    "two": ('<tool_call>{"name": "a", "arguments": {"x": 1}}</tool_call>'
            "between\n"
            '<tool_call>{"name": "b", "arguments": {"y": [1, 2, 3]}}</tool_call>'
            "after"),
    "truncated": '<tool_call>{"name": "f", "arguments": {"a": "xyz',
    "coder": ("<tool_call><function=search><parameter=query>tpu kernels</parameter>"
              "<parameter=limit>5</parameter></function></tool_call>"),
    "llama": '{"name": "lookup", "parameters": {"id": 7}}',
    "llama2": '{"name": "f", "parameters": {"k": 1}}',
    "plain": "hello world, no tools here <not a marker>",
    "just_text": "just text",
    "deepseek": ("let me check｜x"
                 "<｜tool▁calls▁begin｜>"
                 "<｜tool▁call▁begin｜>function"
                 "<｜tool▁sep｜>get_weather\n"
                 '```json\n{"city": "Beijing"}\n```'
                 "<｜tool▁call▁end｜>"
                 "<｜tool▁calls▁end｜>"),
    "deepseek2": ("thinking done. "
                  "<｜tool▁calls▁begin｜>"
                  "<｜tool▁call▁begin｜>function<｜tool▁sep｜>get_weather\n"
                  '```json\n{"city": "Beijing", "days": 2}\n```'
                  "<｜tool▁call▁end｜>"
                  "<｜tool▁calls▁end｜> after."),
    "glm": ("<tool_call>get_weather\n"
            "<arg_key>city</arg_key>\n<arg_value>Beijing</arg_value>\n"
            "<arg_key>days</arg_key>\n<arg_value>3</arg_value>\n"
            "</tool_call>"),
    "glm2": ("check this "
             "<tool_call>lookup\n"
             "<arg_key>q</arg_key>\n<arg_value>tpu</arg_value>\n"
             "<arg_key>n</arg_key>\n<arg_value>3</arg_value>\n"
             "</tool_call> done"),
    "kimi": ("thinking...<|tool_calls_section_begin|>"
             "<|tool_call_begin|>functions.search:0"
             '<|tool_call_argument_begin|>{"q": "tpu"}<|tool_call_end|>'
             "<|tool_calls_section_end|>done"),
}
SIZES = [[1], [3], [4], [5], [7], [9], [13], [1000], [2, 5, 11]]

REASONING = [
    "<think>step one</think>the answer",
    "<think>reasoning</think>answer",
    "inner monologue</think>done",
    "a < b and <thin air",
    "no tags at all",
    "<think>unterminated reasoning",
    "<think></think>",
    "pre <think>mid</think> post <think>again</think>",
]

_ID = re.compile(r"^call_[0-9a-f]+$")


def norm_delta(d: dict) -> dict:
    """A streamed delta with its uuid id checked and blanked."""
    d = json.loads(json.dumps(d))
    if "id" in d:
        assert _ID.match(d["id"]), d["id"]
        d["id"] = "call_"
    return d


def one_shot(fc, fmt: str, text: str):
    r = fc.get_detector(fmt).parse(text)
    return r.content, [(c.name, c.arguments) for c in r.tool_calls]


def streamed(fc, fmt: str, text: str, sizes) -> tuple[list, bool]:
    p = fc.StreamingToolCallParser(fmt)
    steps, i, s = [], 0, 0
    while i < len(text):
        n = sizes[s % len(sizes)]
        s += 1
        c, deltas = p.feed(text[i:i + n])
        steps.append((c, [norm_delta(d) for d in deltas]))
        i += n
    c, deltas = p.finish()
    steps.append((c, [norm_delta(d) for d in deltas]))
    return steps, p.emitted_any


def reasoned(rp, text: str, sizes, force: bool) -> list:
    p = rp.ReasoningParser(force_reasoning=force)
    out, i, s = [], 0, 0
    while i < len(text):
        n = sizes[s % len(sizes)]
        s += 1
        d = p.feed(text[i:i + n])
        out.append((d.reasoning, d.content))
        i += n
    d = p.finish()
    out.append((d.reasoning, d.content))
    return out


@pytest.mark.parametrize("fmt", FORMATS)
def test_detectors_match_jax(fmt):
    for text in TEXTS.values():
        assert one_shot(tfc, fmt, text) == one_shot(jfc, fmt, text), text


def test_unknown_detector_raises_alike():
    for fc in (tfc, jfc):
        with pytest.raises(ValueError, match="unknown tool-call format"):
            fc.get_detector("nope")
    assert sorted(tfc._DETECTORS) == FORMATS


@pytest.mark.parametrize("fmt", FORMATS)
def test_streaming_parser_matches_jax(fmt):
    for name, text in TEXTS.items():
        for sizes in SIZES:
            got = streamed(tfc, fmt, text, sizes)
            assert got == streamed(jfc, fmt, text, sizes), (name, sizes)


def test_streamed_calls_reassemble_the_one_shot_calls():
    """The property of ``tests/test_stream_tool_calls.py`` on the port:
    any chunking gives the one-shot detector's calls."""
    for fmt, text in (("hermes", TEXTS["one"]), ("hermes", TEXTS["two"]),
                      ("deepseek_v3", TEXTS["deepseek2"]), ("glm45", TEXTS["glm2"])):
        want = [(n, json.loads(a)) for n, a in one_shot(tfc, fmt, text)[1]]
        for sizes in SIZES:
            calls = {}
            for _, deltas in streamed(tfc, fmt, text, sizes)[0]:
                for d in deltas:
                    slot = calls.setdefault(d["index"], ["", ""])
                    if "id" in d:
                        slot[0] = d["function"]["name"]
                    slot[1] += d.get("function", {}).get("arguments", "")
            got = [(n, json.loads(a)) for n, a in (calls[i] for i in sorted(calls))]
            assert got == want, (fmt, sizes)


@pytest.mark.parametrize("force", [False, True], ids=["plain", "forced"])
def test_reasoning_parser_matches_jax(force):
    for text in REASONING:
        for sizes in SIZES:
            assert (reasoned(trp, text, sizes, force)
                    == reasoned(jrp, text, sizes, force)), (text, sizes)
    d = trp.ReasoningParser().feed("<think>step one</think>the answer")
    assert (d.reasoning, d.content) == ("step one", "the answer")


def _fuzz_docs() -> list[str]:
    """``tests/test_parsers.py``'s fuzz documents (numpy seed 17)."""
    rng = np.random.default_rng(17)

    def rand_value(depth=0):
        kind = rng.integers(0, 7 if depth < 3 else 5)
        if kind == 0:
            return None
        if kind == 1:
            return bool(rng.integers(0, 2))
        if kind == 2:
            return int(rng.integers(-10**6, 10**6))
        if kind == 3:
            return round(float(rng.normal() * 100), 6)
        if kind == 4:
            chars = ' abc"\\\n\tüñ{}[],:'
            n = int(rng.integers(0, 12))
            return "".join(chars[i] for i in rng.integers(0, len(chars), n))
        if kind == 5:
            return [rand_value(depth + 1) for _ in range(rng.integers(0, 4))]
        return {f"k{i}": rand_value(depth + 1) for i in range(rng.integers(0, 4))}

    return [json.dumps({"name": rand_value(), "args": rand_value()}) for _ in range(60)]


def test_partial_json_matches_jax_on_every_prefix():
    docs = _fuzz_docs() + [
        '{"a": 1, "b": [2, 3]}', '{"a": 1, "b"', '{"a": {"b": [1, 2',
        '{"name": "get_w', '{"a": 1,',
        json.dumps({"name": "fn_x", "arguments": {"a": [1, 2.5, "x\"y"],
                                                  "b": {"c": None, "d": True}}}),
    ]
    for doc in docs:
        for cut in range(len(doc) + 1):
            assert tfc.parse_partial_json(doc[:cut]) == jfc.parse_partial_json(doc[:cut])


_json = st.recursive(
    st.none() | st.booleans() | st.integers(-10**9, 10**9)
    | st.floats(allow_nan=False, allow_infinity=False) | st.text(max_size=12),
    lambda inner: st.lists(inner, max_size=4) | st.dictionaries(st.text(max_size=6), inner,
                                                                 max_size=4),
    max_leaves=12,
)
_FUZZ = settings(max_examples=150, deadline=None, database=None,
                 suppress_health_check=[HealthCheck.too_slow])


@_FUZZ
@given(value=_json, cut=st.floats(0.0, 1.0), junk=st.text(max_size=4))
def test_partial_json_fuzz_matches_jax(value, cut, junk):
    doc = json.dumps(value) + junk
    prefix = doc[: int(len(doc) * cut)]
    assert tfc.parse_partial_json(prefix) == jfc.parse_partial_json(prefix)


_PIECES = st.sampled_from([
    "<tool_call>", "</tool_call>", '{"name": "f", ', '"arguments": ', '{"k": [1, "a"]}', "}",
    "\n", "text ", "<", "<tool", "<｜tool▁calls▁begin｜>", "<｜tool▁call▁begin｜>function",
    "<｜tool▁sep｜>g\n", '```json\n{"x": 2}\n```', "<｜tool▁call▁end｜>",
    "<｜tool▁calls▁end｜>", "<arg_key>q</arg_key>", "<arg_value>3</arg_value>",
    "<|tool_calls_section_begin|>", "<|tool_call_begin|>functions.s:0",
    "<|tool_call_argument_begin|>", "<|tool_call_end|>", "<|tool_calls_section_end|>",
    "<function=f>", "<parameter=a>", "</parameter>", "</function>", "<think>", "</think>",
])


@_FUZZ
@given(pieces=st.lists(_PIECES | st.text(max_size=5), max_size=14),
       sizes=st.lists(st.integers(1, 9), min_size=1, max_size=4),
       fmt=st.sampled_from(FORMATS), cut=st.floats(0.0, 1.0))
def test_streaming_parser_fuzz_matches_jax(pieces, sizes, fmt, cut):
    text = "".join(pieces)
    text = text[: max(1, int(len(text) * cut))] if text else text
    assert streamed(tfc, fmt, text, sizes) == streamed(jfc, fmt, text, sizes)
    assert one_shot(tfc, fmt, text) == one_shot(jfc, fmt, text)
    for force in (False, True):
        assert reasoned(trp, text, sizes, force) == reasoned(jrp, text, sizes, force)
