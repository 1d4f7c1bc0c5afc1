"""Tool/function-call detection in model output.

A copy of ``xllm_tpu/parser/function_call.py`` (pure Python; the port imports nothing
of the JAX package).

Counterpart of the reference's per-family function-call detectors +
streaming partial-JSON parser (reference
xllm/function_call/function_call_parser.h:29, qwen25_detector, deepseekv3
detectors, partial_json_parser/). Formats covered:

- hermes/qwen: ``<tool_call>\n{"name": ..., "arguments": {...}}\n</tool_call>``
- qwen3-coder XML-ish: ``<function=NAME><parameter=K>V</parameter></function>``
- llama3 JSON: a bare ``{"name": ..., "parameters": {...}}`` body
"""

from __future__ import annotations

import json
import re
import uuid
from dataclasses import dataclass, field


@dataclass
class ToolCall:
    name: str
    arguments: str  # JSON-encoded arguments string (OpenAI schema)
    id: str = field(default_factory=lambda: "call_" + uuid.uuid4().hex[:24])


@dataclass
class ParseResult:
    content: str  # normal text outside tool calls
    tool_calls: list[ToolCall]


def parse_partial_json(s: str) -> tuple[object | None, int]:
    """Best-effort parse of a possibly-truncated JSON document.

    Returns (value, consumed_chars) — value is None when nothing parseable
    yet. Completes truncated objects/strings the way the reference's
    partial_json_parser does (tests/function_call/partial_json_parser).
    """
    s = s.lstrip()
    if not s:
        return None, 0
    try:
        v = json.loads(s)
        return v, len(s)
    except json.JSONDecodeError:
        pass
    # close any open strings/brackets
    stack: list[str] = []
    in_str = False
    esc = False
    for ch in s:
        if in_str:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
            continue
        if ch == '"':
            in_str = True
        elif ch in "{[":
            stack.append("}" if ch == "{" else "]")
        elif ch in "}]":
            if stack:
                stack.pop()
    fixed = s + ('"' if in_str else "")
    # drop trailing dangling tokens: `"key":`, `, "key"`, lone `,` or `:`
    fixed = re.sub(r'[,:]\s*$', "", fixed)
    fixed = re.sub(r'"[^"]*"\s*:\s*$', "", fixed)
    fixed = re.sub(r',\s*"[^"]*"\s*$', "", fixed)
    fixed = re.sub(r",\s*$", "", fixed)
    fixed += "".join(reversed(stack))
    try:
        return json.loads(fixed), len(s)
    except json.JSONDecodeError:
        return None, 0


class BaseDetector:
    def parse(self, text: str) -> ParseResult:  # pragma: no cover - interface
        raise NotImplementedError


class HermesDetector(BaseDetector):
    """``<tool_call>{json}</tool_call>`` (qwen2.5/qwen3, hermes format).

    Reference qwen25_detector (xllm/function_call/).
    """

    _RE = re.compile(r"<tool_call>\s*(.*?)\s*</tool_call>", re.DOTALL)

    def parse(self, text: str) -> ParseResult:
        calls = []
        for m in self._RE.finditer(text):
            try:
                obj = json.loads(m.group(1))
                calls.append(
                    ToolCall(
                        name=obj.get("name", ""),
                        arguments=json.dumps(obj.get("arguments", {})),
                    )
                )
            except json.JSONDecodeError:
                obj, used = parse_partial_json(m.group(1))
                if isinstance(obj, dict) and obj.get("name"):
                    calls.append(
                        ToolCall(
                            name=obj["name"],
                            arguments=json.dumps(obj.get("arguments", {})),
                        )
                    )
        content = self._RE.sub("", text).strip()
        return ParseResult(content=content, tool_calls=calls)


class QwenCoderXMLDetector(BaseDetector):
    """``<function=NAME><parameter=K>V</parameter>...</function>``.

    Reference qwen3_coder_detector.
    """

    _FN = re.compile(r"<function=([\w\-.]+)>(.*?)</function>", re.DOTALL)
    _PARAM = re.compile(r"<parameter=([\w\-.]+)>\s*(.*?)\s*</parameter>", re.DOTALL)

    def parse(self, text: str) -> ParseResult:
        calls = []
        for m in self._FN.finditer(text):
            args = {}
            for pm in self._PARAM.finditer(m.group(2)):
                val = pm.group(2)
                try:
                    args[pm.group(1)] = json.loads(val)
                except json.JSONDecodeError:
                    args[pm.group(1)] = val
            calls.append(ToolCall(name=m.group(1), arguments=json.dumps(args)))
        content = self._FN.sub("", text)
        content = re.sub(r"</?tool_call>", "", content).strip()
        return ParseResult(content=content, tool_calls=calls)


class LlamaJsonDetector(BaseDetector):
    """Bare ``{"name": ..., "parameters": {...}}`` body (llama3-style)."""

    def parse(self, text: str) -> ParseResult:
        stripped = text.strip()
        if stripped.startswith("{"):
            obj, used = parse_partial_json(stripped)
            if isinstance(obj, dict) and "name" in obj:
                args = obj.get("parameters", obj.get("arguments", {}))
                return ParseResult(
                    content="",
                    tool_calls=[
                        ToolCall(name=obj["name"], arguments=json.dumps(args))
                    ],
                )
        return ParseResult(content=text, tool_calls=[])


class DeepseekV3Detector(BaseDetector):
    """DeepSeek-V3/R1 tool-call markup (reference deepseek_v3_detector):

    ``<tool_calls_begin><tool_call_begin>function<tool_sep>NAME
    ```json\n{...}\n```<tool_call_end>...<tool_calls_end>`` with the
    unicode bar-delimited token spellings.
    """

    _CALL = re.compile(
        r"<\uFF5Ctool\u2581call\u2581begin\uFF5C>function"
        r"<\uFF5Ctool\u2581sep\uFF5C>([\w\-.]+)\s*```json\s*(.*?)\s*```"
        r"\s*<\uFF5Ctool\u2581call\u2581end\uFF5C>",
        re.DOTALL,
    )
    _SECTION = re.compile(
        r"<\uFF5Ctool\u2581calls\u2581begin\uFF5C>.*?"
        r"(<\uFF5Ctool\u2581calls\u2581end\uFF5C>|$)",
        re.DOTALL,
    )

    def parse(self, text: str) -> ParseResult:
        calls = []
        for m in self._CALL.finditer(text):
            raw = m.group(2)
            try:
                args = json.loads(raw)
            except json.JSONDecodeError:
                args, _ = parse_partial_json(raw)
                if args is None:
                    continue
            calls.append(ToolCall(name=m.group(1), arguments=json.dumps(args)))
        content = self._SECTION.sub("", text).strip()
        return ParseResult(content=content, tool_calls=calls)


class Glm45Detector(BaseDetector):
    """GLM-4.5 arg_key/arg_value markup (reference glm45_detector):

    ``<tool_call>NAME\n<arg_key>K</arg_key>\n<arg_value>V</arg_value>...
    </tool_call>``
    """

    _BLOCK = re.compile(r"<tool_call>\s*(.*?)\s*</tool_call>", re.DOTALL)
    _KV = re.compile(
        r"<arg_key>\s*(.*?)\s*</arg_key>\s*<arg_value>\s*(.*?)\s*</arg_value>",
        re.DOTALL,
    )

    def parse(self, text: str) -> ParseResult:
        calls = []
        for m in self._BLOCK.finditer(text):
            body = m.group(1)
            name = body.split("\n", 1)[0].split("<arg_key>", 1)[0].strip()
            if not name:
                continue
            args = {}
            for km in self._KV.finditer(body):
                val = km.group(2)
                try:
                    args[km.group(1)] = json.loads(val)
                except json.JSONDecodeError:
                    args[km.group(1)] = val
            calls.append(ToolCall(name=name, arguments=json.dumps(args)))
        content = self._BLOCK.sub("", text).strip()
        return ParseResult(content=content, tool_calls=calls)


class KimiK2Detector(BaseDetector):
    """Kimi-K2 sectioned tool calls (reference kimi_k2_detector):

    ``<|tool_calls_section_begin|><|tool_call_begin|>functions.NAME:IDX
    <|tool_call_argument_begin|>{json}<|tool_call_end|>...
    <|tool_calls_section_end|>``
    """

    _CALL = re.compile(
        r"<\|tool_call_begin\|>\s*functions\.([\w\-.]+):\d+\s*"
        r"<\|tool_call_argument_begin\|>\s*(.*?)\s*<\|tool_call_end\|>",
        re.DOTALL,
    )
    _SECTION = re.compile(
        r"<\|tool_calls_section_begin\|>.*?"
        r"(<\|tool_calls_section_end\|>|$)",
        re.DOTALL,
    )

    def parse(self, text: str) -> ParseResult:
        calls = []
        for m in self._CALL.finditer(text):
            raw = m.group(2)
            try:
                args = json.loads(raw)
            except json.JSONDecodeError:
                args, _ = parse_partial_json(raw)
                if args is None:
                    continue
            calls.append(ToolCall(name=m.group(1), arguments=json.dumps(args)))
        content = self._SECTION.sub("", text).strip()
        return ParseResult(content=content, tool_calls=calls)


_DETECTORS = {
    "hermes": HermesDetector,
    "qwen25": HermesDetector,
    "qwen3": HermesDetector,
    "qwen3_coder": QwenCoderXMLDetector,
    "llama3_json": LlamaJsonDetector,
    "deepseek_v3": DeepseekV3Detector,
    "deepseek_r1": DeepseekV3Detector,
    "glm45": Glm45Detector,
    "glm47": Glm45Detector,
    "kimi_k2": KimiK2Detector,
}


def get_detector(format_name: str) -> BaseDetector:
    """Reference FunctionCallParser factory (function_call_parser.h:29)."""
    cls = _DETECTORS.get(format_name)
    if cls is None:
        raise ValueError(
            f"unknown tool-call format {format_name!r}; known: {sorted(_DETECTORS)}"
        )
    return cls()


def _held_suffix(s: str, marker: str) -> int:
    """Length of the longest tail of ``s`` that is a proper prefix of
    ``marker`` (text that must be held back — the marker may be arriving
    split across chunks)."""
    for n in range(min(len(marker) - 1, len(s)), 0, -1):
        if s.endswith(marker[:n]):
            return n
    return 0


_NAME_RE = re.compile(r'"name"\s*:\s*"((?:[^"\\]|\\.)*)"')
_ARGS_RE = re.compile(r'"arguments"\s*:\s*')
_DS_SEP = "<｜tool▁sep｜>"
_DS_NAME_RE = re.compile(
    r"function" + re.escape(_DS_SEP) + r"([\w\-.]+)"
)
_JSON_FENCE_RE = re.compile(r"```json\s*")

# (start marker, end marker, mode, extra markers swallowed from content)
# mode "json": args = value of the "arguments" key, raw-streamed
# mode "fenced": args = raw JSON between ```json fences (deepseek)
# mode "per_call": args parsed from the whole call at its end marker
#   (glm's <arg_key>/<arg_value> XML is not prefix-stable JSON text)
_STREAM_PROFILES = {
    "hermes": ("<tool_call>", "</tool_call>", "json", ()),
    "qwen25": ("<tool_call>", "</tool_call>", "json", ()),
    "qwen3": ("<tool_call>", "</tool_call>", "json", ()),
    "deepseek_v3": (
        "<｜tool▁call▁begin｜>",
        "<｜tool▁call▁end｜>",
        "fenced",
        ("<｜tool▁calls▁begin｜>",
         "<｜tool▁calls▁end｜>"),
    ),
    "deepseek_r1": (
        "<｜tool▁call▁begin｜>",
        "<｜tool▁call▁end｜>",
        "fenced",
        ("<｜tool▁calls▁begin｜>",
         "<｜tool▁calls▁end｜>"),
    ),
    "glm45": ("<tool_call>", "</tool_call>", "per_call", ()),
    "glm47": ("<tool_call>", "</tool_call>", "per_call", ()),
}


class StreamingToolCallParser:
    """Incremental tool-call deltas on the SSE path.

    Counterpart of the reference's StreamOutputParser
    (xllm/api_service/stream_output_parser.h:30): as the model streams,
    text outside tool-call markers is emitted as content deltas; inside
    a call, the name is emitted once (with id/type, OpenAI streaming
    schema) as soon as it is complete, then the RAW argument text is
    emitted in fragments. Raw-text fragments (not re-serialized partial
    JSON) make the concatenation exactly the model's argument object —
    the same prefix-stability trick the reference's incremental
    partial-JSON tracking achieves.

    Marker formats stream true increments: hermes/qwen (JSON args),
    deepseek v3/r1 (```json-fenced args), glm4.5/4.7 (name streams
    immediately; the arg_key/arg_value XML args are emitted at the
    call's end marker, since that markup is not prefix-stable JSON).
    Formats without streamable markers (llama3_json bare JSON,
    qwen3_coder XML, kimi_k2 sections) fall back to buffering and
    emitting the complete calls in the final chunk before [DONE]
    (still a valid OpenAI stream).
    """

    def __init__(self, format_name: str):
        self.format = format_name
        self.detector = get_detector(format_name)
        prof = _STREAM_PROFILES.get(format_name)
        self.streamable = prof is not None
        self.start, self.end, self.mode, self.swallow = prof or (
            "", "", "", ())
        self.buf = ""  # unconsumed raw text (outside-call scan buffer)
        self.call_buf = ""  # raw text of the call being streamed
        self.in_call = False
        self.index = -1  # current tool-call index
        self.name_sent = False
        self.args_at = -1  # offset of the arguments value in call_buf
        self.args_sent = 0  # raw argument chars emitted
        self.args_done = False
        self.emitted_any = False
        self._fallback_text = ""

    # -- helpers -------------------------------------------------------
    def _args_progress(self) -> tuple[int, bool]:
        """-> (emittable_end, value_complete) for the arguments value.

        Walks the raw JSON value at ``args_at`` tracking bracket depth /
        string state; emittable_end is how far the value extends so far
        (never past its balanced close)."""
        s = self.call_buf
        i = self.args_at
        depth = 0
        in_str = esc = False
        started = False
        while i < len(s):
            ch = s[i]
            if in_str:
                if esc:
                    esc = False
                elif ch == "\\":
                    esc = True
                elif ch == '"':
                    in_str = False
                    if started and depth == 0:
                        return i + 1, True
            elif ch == '"':
                in_str = True
                started = True
            elif ch in "{[":
                depth += 1
                started = True
            elif ch in "}]":
                depth -= 1
                if started and depth == 0:
                    return i + 1, True
            elif not started and not ch.isspace():
                started = True  # number / literal value
            elif started and depth == 0 and ch in ",}":
                return i, True  # bare value terminated by wrapper
            i += 1
        return len(s), False

    def _emit_name(self, name: str) -> dict:
        self.name_sent = True
        return {
            "index": self.index,
            "id": "call_" + uuid.uuid4().hex[:24],
            "type": "function",
            "function": {"name": name, "arguments": ""},
        }

    def _call_deltas(self, call_ended: bool = False) -> list[dict]:
        """Deltas newly available from call_buf."""
        out: list[dict] = []
        if self.mode == "per_call":
            # glm45-class: name is the call body's first line; the
            # arg_key/arg_value args parse only at the end marker
            if not self.name_sent:
                head = self.call_buf.split("<arg_key>", 1)[0]
                if "\n" in head or "<arg_key>" in self.call_buf or (
                    call_ended
                ):
                    name = head.split("\n", 1)[0].strip()
                    if name:
                        out.append(self._emit_name(name))
            if call_ended and self.name_sent and not self.args_done:
                r = self.detector.parse(
                    self.start + self.call_buf + self.end
                )
                if r.tool_calls:
                    out.append({
                        "index": self.index,
                        "function": {
                            "arguments": r.tool_calls[0].arguments
                        },
                    })
                self.args_done = True
            if out:
                self.emitted_any = True
            return out
        if not self.name_sent:
            if self.mode == "fenced":
                m = _DS_NAME_RE.search(self.call_buf)
                # the name is complete once the json fence follows
                if m and _JSON_FENCE_RE.search(self.call_buf, m.end()):
                    out.append(self._emit_name(m.group(1)))
            else:
                m = _NAME_RE.search(self.call_buf)
                if m:
                    out.append(self._emit_name(m.group(1)))
        if self.name_sent and self.args_at < 0:
            m = (
                _JSON_FENCE_RE.search(self.call_buf)
                if self.mode == "fenced"
                else _ARGS_RE.search(self.call_buf)
            )
            if m:
                self.args_at = m.end()
                self.args_sent = 0
        if self.args_at >= 0 and not self.args_done:
            if self.mode == "fenced":
                close = self.call_buf.find("```", self.args_at)
                if close >= 0:
                    end, complete = close, True
                else:
                    end, complete = len(self.call_buf), False
                safe = end
                if not complete:
                    safe = min(
                        end - _held_suffix(self.call_buf[:end], self.end),
                        end - _held_suffix(self.call_buf[:end], "```"),
                    )
            else:
                end, complete = self._args_progress()
                # hold back a possible split end-marker in the raw tail
                safe = end
                if not complete:
                    safe = end - _held_suffix(
                        self.call_buf[:end], self.end
                    )
            frag = self.call_buf[self.args_at + self.args_sent: safe]
            if frag:
                self.args_sent += len(frag)
                out.append({
                    "index": self.index,
                    "function": {"arguments": frag},
                })
            if complete:
                self.args_done = True
        if out:
            self.emitted_any = True
        return out

    # -- public --------------------------------------------------------
    def feed(self, delta: str) -> tuple[str, list[dict]]:
        """Consume a text delta -> (content_delta, tool_call_deltas)."""
        if not self.streamable:
            self._fallback_text += delta
            return "", []
        self.buf += delta
        content_out: list[str] = []
        deltas: list[dict] = []
        markers = (self.start,) + self.swallow
        while True:
            if not self.in_call:
                # earliest of the start marker and any swallowed
                # section markers (deepseek's calls_begin/calls_end)
                hits = [
                    (pos, m)
                    for m in markers
                    if (pos := self.buf.find(m)) >= 0
                ]
                if hits:
                    pos, m = min(hits)
                    content_out.append(self.buf[:pos])
                    self.buf = self.buf[pos + len(m):]
                    if m != self.start:
                        continue  # section marker: swallow silently
                    self.in_call = True
                    self.index += 1
                    self.call_buf = ""
                    self.name_sent = False
                    self.args_at = -1
                    self.args_done = False
                    continue
                hold = max(
                    (_held_suffix(self.buf, m) for m in markers),
                    default=0,
                )
                emit = self.buf[: len(self.buf) - hold]
                if emit:
                    content_out.append(emit)
                    self.buf = self.buf[len(emit):]
                return "".join(content_out), deltas
            # inside a call: move text into call_buf up to the end marker
            pos = self.buf.find(self.end)
            if pos >= 0:
                self.call_buf += self.buf[:pos]
                self.buf = self.buf[pos + len(self.end):]
                deltas.extend(self._call_deltas(call_ended=True))
                self.in_call = False
                continue
            hold = _held_suffix(self.buf, self.end)
            self.call_buf += self.buf[: len(self.buf) - hold]
            self.buf = self.buf[len(self.buf) - hold:]
            deltas.extend(self._call_deltas())
            return "".join(content_out), deltas

    def finish(self) -> tuple[str, list[dict]]:
        """End of stream -> (content_delta, tool_call_deltas)."""
        if not self.streamable:
            r = self.detector.parse(self._fallback_text)
            deltas = []
            for i, c in enumerate(r.tool_calls):
                deltas.append({
                    "index": i, "id": c.id, "type": "function",
                    "function": {"name": c.name, "arguments": ""},
                })
                deltas.append({
                    "index": i, "function": {"arguments": c.arguments},
                })
            if deltas:
                self.emitted_any = True
            return (r.content, deltas)
        if self.in_call:
            # truncated call: flush whatever argument text is available
            deltas = self._call_deltas(call_ended=True)
            self.in_call = False
            return "", deltas
        leftover, self.buf = self.buf, ""
        return leftover, []
