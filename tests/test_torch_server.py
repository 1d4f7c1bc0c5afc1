"""The OpenAI server: ``xllm_tpu_torch.server`` on the CPU vs ``xllm_tpu.server``.

Both servers load the same checkpoint through their own loaders: the tiny
f32 qwen3 and word-level tokenizer of ``tests/test_api_server.py``, with a
safetensors checkpoint (written here from a seed) in the same directory.
JAX's server runs through aiohttp's ``TestClient``; the port's runs on a
real socket at port 0 (its stdlib transport, ``server/http.py``) and is
driven with ``http.client``. Every endpoint case of ``test_api_server.py``
runs against both: the JSON bodies must be equal after dropping ``id``,
``created`` and tool-call ids (token ids and text exact, logprobs and
embeddings within 1e-5), and so must the SSE event sequences. The chat
path's reasoning split and tool calls are driven through both servers'
``_pump_stream`` / ``_postprocess_chat_text`` with scripted generations
(``tests/test_stream_tool_api.py``'s method: random weights never write
a tool call).

Then the port alone: the transport (two requests on one connection, a
chunked body, ``Expect: 100-continue``, 404 / 405 as aiohttp gives them,
413 at aiohttp's 1 MiB, ``TCP_NODELAY``, a client that closes mid-stream, whose request is
aborted), the 501 refusals, the registry and the health manager, and the
command line (``python -m xllm_tpu_torch.server.api --device cpu``: it
answers, then exits 0 on SIGINT).
"""

import asyncio
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from safetensors.numpy import save_file

import xllm_tpu.config as jcfg
import xllm_tpu_torch.config as tcfg
from test_api_server import _make_tokenizer_dir
from xllm_tpu.framework.chat_template import ChatTemplate as JTemplate
from xllm_tpu.framework.request import RequestOutput as JOut
from xllm_tpu.framework.request import SequenceOutput as JSeqOut
from xllm_tpu.models.model_args import load_model_config as jload_config
from xllm_tpu.server.api import APIServer as JServer
from xllm_tpu_torch.common.health import HealthCheckManager
from xllm_tpu_torch.framework.chat_template import ChatTemplate as TTemplate
from xllm_tpu_torch.framework.request import RequestOutput as TOut
from xllm_tpu_torch.framework.request import SequenceOutput as TSeqOut
from xllm_tpu_torch.models.model_args import load_model_config as tload_config
from xllm_tpu_torch.server import http as web
from xllm_tpu_torch.server.api import APIServer as TServer
from xllm_tpu_torch.server.api import check_unported, parse_args
from xllm_tpu_torch.server.registry import InstanceClient, make_registry_app
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
HF = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, head_dim=16,
          max_position_embeddings=128, rms_norm_eps=1e-6, rope_theta=10000.0)


# ---------------------------------------------------------------------------
# the checkpoint and the two servers
# ---------------------------------------------------------------------------
def write_checkpoint(d: str, seed: int = 0) -> None:
    """config.json and model.safetensors of the tiny f32 qwen3 (HF names)."""
    rng = np.random.default_rng(seed)
    c = HF
    D, L, H, K, Dh, I, V = (c["hidden_size"], c["num_hidden_layers"],
                            c["num_attention_heads"], c["num_key_value_heads"],
                            c["head_dim"], c["intermediate_size"], c["vocab_size"])

    def w(*shape, norm=False):
        x = rng.standard_normal(shape).astype(np.float32)
        return (1.0 + 0.1 * x) if norm else 0.05 * x

    t = {"model.embed_tokens.weight": w(V, D), "model.norm.weight": w(D, norm=True),
         "lm_head.weight": w(V, D)}
    for i in range(L):
        p = f"model.layers.{i}."
        t.update({
            p + "input_layernorm.weight": w(D, norm=True),
            p + "post_attention_layernorm.weight": w(D, norm=True),
            p + "self_attn.q_proj.weight": w(H * Dh, D),
            p + "self_attn.k_proj.weight": w(K * Dh, D),
            p + "self_attn.v_proj.weight": w(K * Dh, D),
            p + "self_attn.o_proj.weight": w(D, H * Dh),
            p + "self_attn.q_norm.weight": w(Dh, norm=True),
            p + "self_attn.k_norm.weight": w(Dh, norm=True),
            p + "mlp.gate_proj.weight": w(I, D),
            p + "mlp.up_proj.weight": w(I, D),
            p + "mlp.down_proj.weight": w(D, I),
        })
    save_file(t, os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(dict(HF, architectures=["Qwen3ForCausalLM"], model_type="qwen3",
                       torch_dtype="float32", tie_word_embeddings=False,
                       eos_token_id=0), f)


def config(c, load, model_dir: str, profile_dir: str):
    return c.EngineConfig(
        model=load(model_dir),
        cache=c.CacheConfig(block_size=16, num_blocks=32),
        scheduler=c.SchedulerConfig(
            max_seqs_per_batch=4, max_tokens_per_batch=256, decode_batch_buckets=[4],
            prefill_token_buckets=[32, 64], max_model_len=128,
        ),
        profile_dir=profile_dir,
    )


class JaxClient:
    """JAX's server through aiohttp's TestClient on a private loop."""

    def __init__(self, api):
        from aiohttp.test_utils import TestClient, TestServer

        self.api = api
        self.loop = asyncio.new_event_loop()
        self.client = TestClient(TestServer(api.app()), loop=self.loop)
        self.loop.run_until_complete(self.client.start_server())

    def request(self, method: str, path: str, body=None) -> tuple[int, bytes]:
        async def go():
            kw = {} if body is None else {"json": body}
            r = await self.client.request(method, path, **kw)
            return r.status, await r.read()

        return self.loop.run_until_complete(go())

    def close(self):
        self.loop.run_until_complete(self.client.close())
        self.loop.close()


class PortServer:
    """The port's server on 127.0.0.1:0, its event loop in a thread."""

    def __init__(self, api, app=None):
        self.api = api
        self.app = api.app() if app is None else app
        self.loop = asyncio.new_event_loop()
        self.runner = web.AppRunner(self.app)
        ready = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self.runner.setup())
            self.site = web.TCPSite(self.runner, "127.0.0.1", 0)
            self.loop.run_until_complete(self.site.start())
            ready.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert ready.wait(60)
        self.port = self.site.port

    def conn(self) -> http.client.HTTPConnection:
        return http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)

    def request(self, method: str, path: str, body=None, headers=None) -> tuple[int, bytes]:
        c = self.conn()
        data = None if body is None else json.dumps(body).encode()
        h = {"Content-Type": "application/json"} if body is not None else {}
        c.request(method, path, body=data, headers={**h, **(headers or {})})
        r = c.getresponse()
        out = r.status, r.read()
        c.close()
        return out

    def close(self):
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(), self.loop).result(60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = _make_tokenizer_dir(tmp_path_factory.mktemp("model"))
    write_checkpoint(d)
    return d


@pytest.fixture(scope="module")
def pair(model_dir, tmp_path_factory):
    trace = str(tmp_path_factory.mktemp("trace"))
    j = JaxClient(JServer(config(jcfg, jload_config, model_dir, trace),
                          served_model_name="tiny"))
    t = PortServer(TServer(config(tcfg, tload_config, model_dir, trace),
                           served_model_name="tiny", device="cpu"))
    yield j, t
    t.close()
    j.close()


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------
def decode(raw: bytes):
    """A JSON body, or an SSE body as [(event, data)]."""
    text = raw.decode()
    try:
        return json.loads(text)
    except ValueError:
        pass
    events, name = [], None
    for line in text.splitlines():
        if line.startswith("event: "):
            name = line[7:]
        elif line.startswith("data: "):
            data = line[6:]
            events.append((name, data if data == "[DONE]" else json.loads(data)))
            name = None
    return events


def scrub(x):
    """Drop ``id`` and ``created`` (tool-call ids included) at every depth."""
    if isinstance(x, dict):
        return {k: scrub(v) for k, v in x.items() if k not in ("id", "created")}
    if isinstance(x, (list, tuple)):
        return [scrub(v) for v in x]
    return x


def assert_same(a, b, path="$"):
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), (path, a, b)
        assert abs(a - b) <= TOL, (path, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a, b)
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def both(pair, method, path, body=None, status=200):
    """The same request to both servers -> the port's decoded body, after
    asserting that the statuses and the scrubbed bodies are equal."""
    j, t = pair
    js, jb = j.request(method, path, body)
    ts, tb = t.request(method, path, body)
    assert ts == js == status, (path, ts, js, tb[:300], jb[:300])
    got, want = decode(tb), decode(jb)
    assert_same(scrub(got), scrub(want))
    return got


# ---------------------------------------------------------------------------
# the endpoint cases of tests/test_api_server.py, on both servers
# ---------------------------------------------------------------------------
def test_health_and_models(pair):
    assert both(pair, "GET", "/health") == {"status": "ok"}
    data = both(pair, "GET", "/v1/models")
    assert data["data"][0]["id"] == "tiny"


def test_completions_non_stream(pair):
    data = both(pair, "POST", "/v1/completions", {
        "prompt": "w1 w2 w3 w4", "max_tokens": 8, "temperature": 0, "ignore_eos": True,
        "logprobs": 2})
    assert data["object"] == "text_completion"
    assert data["usage"]["completion_tokens"] == 8
    assert data["choices"][0]["finish_reason"] == "length"
    assert len(data["choices"][0]["logprobs"]["top_logprobs"]) == 8


def test_completions_token_ids_and_errors(pair):
    data = both(pair, "POST", "/v1/completions", {
        "prompt": [5, 6, 7], "max_tokens": 4, "temperature": 0, "ignore_eos": True,
        "logprobs": 0})
    assert data["usage"]["completion_tokens"] == 4
    assert len(data["choices"][0]["logprobs"]["tokens"]) == 4
    both(pair, "POST", "/v1/completions", {}, status=400)
    both(pair, "POST", "/v1/completions", {"prompt": [1] * 500, "max_tokens": 4}, status=400)
    both(pair, "POST", "/v1/completions", {"prompt": {"x": 1}}, status=400)


def test_completions_stream(pair):
    events = both(pair, "POST", "/v1/completions", {
        "prompt": "w1 w2", "max_tokens": 6, "temperature": 0, "ignore_eos": True,
        "stream": True, "stream_options": {"include_usage": True}})
    assert events[-1] == (None, "[DONE]")
    assert any(e["choices"] and e["choices"][0]["text"] for _, e in events[:-1])
    assert events[-2][1]["usage"]["completion_tokens"] == 6


def test_stream_concatenates_to_non_stream(pair):
    body = {"prompt": [9, 8, 7, 6], "max_tokens": 10, "temperature": 0, "ignore_eos": True}
    full = both(pair, "POST", "/v1/completions", body)
    events = both(pair, "POST", "/v1/completions", dict(body, stream=True))
    text = "".join(e["choices"][0]["text"] for _, e in events[:-1] if e["choices"])
    assert text == full["choices"][0]["text"]


def test_chat_completions(pair):
    body = {"messages": [{"role": "user", "content": "w3 w4 w5"}], "max_tokens": 5,
            "temperature": 0, "ignore_eos": True}
    data = both(pair, "POST", "/v1/chat/completions", body)
    assert data["object"] == "chat.completion"
    assert data["choices"][0]["message"]["role"] == "assistant"
    assert data["usage"]["completion_tokens"] == 5
    events = both(pair, "POST", "/v1/chat/completions", dict(body, stream=True))
    assert events[0][1]["choices"][0]["delta"] == {"role": "assistant", "content": ""}
    text = "".join(e["choices"][0]["delta"].get("content", "") for _, e in events[1:-1])
    assert text == data["choices"][0]["message"]["content"]
    # multi-part text content joins as in JAX
    both(pair, "POST", "/v1/chat/completions", dict(body, messages=[
        {"role": "user", "content": [{"type": "text", "text": "w3 w4"},
                                     {"type": "text", "text": " w5"}]}]))
    both(pair, "POST", "/v1/chat/completions", {"messages": []}, status=400)


def test_chat_with_template(pair):
    """``test_anthropic_messages_with_template``'s template, set on both
    servers (the same ChatTemplate as a tokenizer_config.json entry)."""
    j, t = pair
    tmpl = "{% for m in messages %}{{ m['content'] }} {% endfor %}"
    old = j.api.chat_template, t.api.chat_template
    j.api.chat_template, t.api.chat_template = JTemplate(tmpl), TTemplate(tmpl)
    try:
        data = both(pair, "POST", "/v1/messages", {
            "model": "tiny", "max_tokens": 6, "system": "w9 w9", "temperature": 0,
            "messages": [{"role": "user", "content": [{"type": "text", "text": "w3 w4 w5"}]}],
            "ignore_eos": True})
        assert data["type"] == "message" and data["content"][0]["type"] == "text"
        assert data["stop_reason"] in ("end_turn", "max_tokens")
        events = both(pair, "POST", "/v1/messages", {
            "model": "tiny", "max_tokens": 5, "stream": True, "temperature": 0,
            "messages": [{"role": "user", "content": "w3 w4"}]})
        names = [n for n, _ in events]
        assert names[:2] == ["message_start", "content_block_start"]
        assert names[-1] == "message_stop" and "content_block_delta" in names
        both(pair, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "w7 w8"}], "max_tokens": 4,
            "temperature": 0, "ignore_eos": True})
    finally:
        j.api.chat_template, t.api.chat_template = old


def test_anthropic_messages(pair):
    data = both(pair, "POST", "/v1/messages", {
        "model": "tiny", "max_tokens": 8, "temperature": 0,
        "messages": [{"role": "user", "content": "w3 w4"}]})
    assert data["type"] == "message" and data["role"] == "assistant"


def test_metrics_names(pair):
    j, t = pair
    names = []
    for client in (j, t):
        status, body = client.request("GET", "/metrics")
        assert status == 200
        names.append({ln.split()[2] for ln in body.decode().splitlines()
                      if ln.startswith("# TYPE")})
    assert names[0] == names[1]
    assert "xllm_generated_tokens_total" in names[1]


def test_profile_endpoints(pair):
    both(pair, "POST", "/stop_profile", status=409)
    started = both(pair, "POST", "/start_profile")
    assert started["status"] == "profiling"
    both(pair, "POST", "/start_profile", status=409)
    both(pair, "POST", "/v1/completions", {"prompt": [3, 4], "max_tokens": 3,
                                           "temperature": 0, "ignore_eos": True})
    assert both(pair, "POST", "/stop_profile") == {"status": "stopped"}
    both(pair, "POST", "/stop_profile", status=409)
    traces = sorted(Path(started["dir"]).glob("xllm_trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_embeddings_endpoint(pair):
    data = both(pair, "POST", "/v1/embeddings", {"input": ["w1 w2 w3", "w4 w5"]})
    assert len(data["data"]) == 2
    vec = data["data"][0]["embedding"]
    assert len(vec) == 64 and abs(sum(v * v for v in vec) - 1.0) < 1e-3
    both(pair, "POST", "/v1/embeddings", {"input": [4, 5, 6]})
    both(pair, "POST", "/v1/embeddings", {}, status=400)


def test_rerank_both_modes(pair):
    docs = ["w3 w4 w5 w6", "w90 w91 w92", "w3 w4"]
    data = both(pair, "POST", "/v1/rerank", {"query": "w3 w4 w5", "documents": docs,
                                            "top_n": 2, "return_documents": True})
    assert len(data["results"]) == 2 and "document" in data["results"][0]
    both(pair, "POST", "/v1/rerank", {"query": "w3 w4 w5", "documents": docs,
                                      "mode": "embedding"})
    both(pair, "POST", "/v1/rerank", {"query": "w1"}, status=400)
    both(pair, "POST", "/v1/rerank", {"query": "w1", "documents": ["w2"], "mode": "x"},
         status=400)


def test_sample_endpoint(pair):
    body = both(pair, "POST", "/v1/sample", {
        "prompt": "w1 w2 w9 w3 w4 w9 w5", "selector": {"type": "literal", "value": "w9"},
        "temperature": 0.0, "top_logprobs": 3})
    assert body["object"] == "sample_completion" and len(body["choices"]) == 2
    for c in body["choices"]:
        assert c["finish_reason"] == "selector_match"
        assert len(c["logprobs"]["token_ids"]) == 3
    both(pair, "POST", "/v1/sample", {"prompt": "w1 w2 w9 w3 w4 w9 w5",
                                      "selector": {"value": "w9"}, "temperature": 0.0})
    both(pair, "POST", "/v1/sample", {"prompt": "w1"}, status=400)
    both(pair, "POST", "/v1/sample", {"prompt": "w1", "selector": {"type": "regex",
                                                                   "value": "x"}}, status=400)
    assert both(pair, "POST", "/v1/sample", {"prompt": "w1 w2",
                                             "selector": {"value": "w9"}})["choices"] == []


def test_completions_echo_and_scoring(pair):
    body = {"prompt": "w1 w2 w3", "max_tokens": 4, "echo": True, "temperature": 0.0}
    full = both(pair, "POST", "/v1/completions", body)
    assert full["choices"][0]["text"].startswith("w1 w2 w3")
    events = both(pair, "POST", "/v1/completions", dict(body, stream=True))
    assert events[0][1]["choices"][0]["text"] == "w1 w2 w3"
    scored = both(pair, "POST", "/v1/completions", {
        "prompt": "w1 w2 w3 w4 w5", "max_tokens": 0, "echo": True, "logprobs": 1})
    lp = scored["choices"][0]["logprobs"]
    assert lp["token_logprobs"][0] is None and len(lp["tokens"]) == 5
    both(pair, "POST", "/v1/completions", {"prompt": [7, 8, 9], "max_tokens": 0,
                                           "echo": True, "logprobs": 1})


def test_stream_overlong_prompt_is_clean_400(pair):
    body = both(pair, "POST", "/v1/completions", {
        "model": "tiny", "prompt": "w1 " * 300, "stream": True, "max_tokens": 4}, status=400)
    assert "error" in body


def test_rate_limit_429(pair):
    """max_concurrency 1: a second request while a stream is open gets
    429 on both servers."""
    j, t = pair
    stream = {"prompt": [1, 2, 3], "max_tokens": 40, "temperature": 0,
              "ignore_eos": True, "stream": True}
    for api in (j.api, t.api):
        api.rate_limiter.max_concurrency = 1
    try:
        async def jax_side():
            r1 = await j.client.post("/v1/completions", json=stream)
            r2 = await j.client.post("/v1/completions", json={"prompt": [4], "max_tokens": 1})
            body2 = await r2.read()
            await r1.read()
            return r1.status, r2.status, body2

        jr = j.loop.run_until_complete(jax_side())
        c1 = t.conn()
        c1.request("POST", "/v1/completions", body=json.dumps(stream).encode())
        r1 = c1.getresponse()
        s2, b2 = t.request("POST", "/v1/completions", {"prompt": [4], "max_tokens": 1})
        r1.read()
        c1.close()
        assert (r1.status, s2) == jr[:2] == (200, 429)
        assert json.loads(b2) == json.loads(jr[2])
    finally:
        for api in (j.api, t.api):
            api.rate_limiter.max_concurrency = 0


# scripted generations for the chat parsers (tests/test_stream_tool_api.py)
SCRIPTS = {
    "tool": ('calling now <tool_call>\n{"name": "search", "arguments": '
             '{"q": "tpu pallas", "k": 3}}\n</tool_call>'),
    "think": "<think>let me see</think>the answer is w4",
    "think_tool": ('<think>plan</think>ok <tool_call>{"name": "a", "arguments": {}}'
                   '</tool_call>'),
    "plain": "nothing special here",
}


def scripted(Out, SeqOut, text: str, step: int) -> list:
    outs = []
    for end in range(step, len(text) + step, step):
        done = end >= len(text)
        outs.append(Out(request_id="r1", prompt="", finished=done, outputs=[SeqOut(
            index=0, text=text[:end], token_ids=[1] * (end // 4),
            finish_reason="stop" if done else None)]))
    return outs


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_chat_parsers_match_jax(name):
    """The chat path's reasoning split and tool calls, streamed (every
    chunking) and whole, on both servers' handlers."""
    text = SCRIPTS[name]
    runs = {}
    for tag, cls, Out, SeqOut in (("jax", JServer, JOut, JSeqOut),
                                  ("torch", TServer, TOut, TSeqOut)):
        srv = object.__new__(cls)
        srv.model_name, srv.tool_call_parser, srv.reasoning_parser = "tiny", "hermes", True
        res = [scrub(srv._postprocess_chat_text(text))]
        for step in (1, 3, 7, 1000):
            sent = []

            async def send(payload, sent=sent):
                sent.append(payload)

            async def agen(items):
                for it in items:
                    yield it

            asyncio.run(srv._pump_stream(agen(scripted(Out, SeqOut, text, step)), True,
                                         "r1", 0, "chat.completion.chunk", send, {}, 0.0))
            res.append(scrub(sent))
        runs[tag] = res
    assert runs["torch"] == runs["jax"]
    if "tool" in name:
        assert runs["torch"][0]["tool_calls"]
    if "think" in name:
        assert runs["torch"][0]["reasoning_content"]


def test_engine_step_failure_fails_streams(model_dir, tmp_path):
    """An engine step that raises ends every open request with a 500 on
    both servers (streamed or not), instead of hanging them."""
    def boom():
        raise RuntimeError("injected step failure")

    j = JaxClient(JServer(config(jcfg, jload_config, model_dir, str(tmp_path)),
                          served_model_name="tiny2"))
    j.api.engine.engine.step = boom
    t = PortServer(TServer(config(tcfg, tload_config, model_dir, str(tmp_path)),
                           served_model_name="tiny2", device="cpu"))
    t.api.engine.engine.step = boom
    try:
        for body in ({"prompt": "w1 w2 w3", "max_tokens": 8},
                     {"prompt": "w1 w2 w3", "max_tokens": 8, "stream": True}):
            assert t.request("POST", "/v1/completions", body)[0] == 500
            assert j.request("POST", "/v1/completions", body)[0] == 500
    finally:
        t.close()
        j.close()


# ---------------------------------------------------------------------------
# the port alone: transport, refusals, registry, health, command line
# ---------------------------------------------------------------------------
def test_transport_keep_alive_and_chunked_body(pair):
    _, t = pair
    c = t.conn()
    for _ in range(2):  # two requests on one connection
        c.request("GET", "/health")
        r = c.getresponse()
        assert r.status == 200 and json.loads(r.read()) == {"status": "ok"}
    sock = c.sock
    body = json.dumps({"prompt": [5, 6, 7], "max_tokens": 2, "temperature": 0,
                       "ignore_eos": True}).encode()
    c.request("POST", "/v1/completions", body=iter([body[:7], body[7:]]),
              encode_chunked=True, headers={"Content-Type": "application/json"})
    r = c.getresponse()
    assert r.status == 200 and json.loads(r.read())["usage"]["completion_tokens"] == 2
    assert c.sock is sock  # the same connection throughout
    c.close()


def test_transport_expect_continue(pair):
    _, t = pair
    body = b'{"prompt": [5, 6], "max_tokens": 1, "ignore_eos": true}'
    with socket.create_connection(("127.0.0.1", t.port), timeout=60) as s:
        s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nExpect: 100-continue\r\n"
                  b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n" % len(body))
        assert s.recv(64) == b"HTTP/1.1 100 Continue\r\n\r\n"
        s.sendall(body)
        f = s.makefile("rb")
        assert f.readline().startswith(b"HTTP/1.1 200")


def test_transport_errors_match_aiohttp(pair):
    """404, 405, 413 at aiohttp's 1 MiB, and a malformed request line."""
    j, t = pair
    assert t.request("GET", "/nope")[0] == j.request("GET", "/nope")[0] == 404
    assert t.request("GET", "/v1/completions")[0] == j.request("GET", "/v1/completions")[0] == 405
    big = {"prompt": "w1 " * (1 << 19)}  # 1.5 MiB of JSON
    assert t.request("POST", "/v1/completions", big)[0] == 413
    # aiohttp raises its 413 inside ``request.json()``, which JAX's handler
    # turns into a 400: the same body is refused by both
    status, raw = j.request("POST", "/v1/completions", big)
    assert (status, json.loads(raw)["error"]["message"]) == (400, "invalid JSON body")
    assert t.request("POST", "/v1/completions", {"prompt": [1] * 100_000})[0] == 400
    with socket.create_connection(("127.0.0.1", t.port), timeout=60) as s:
        s.sendall(b"NOT A REQUEST\r\n\r\n")
        assert s.makefile("rb").readline().startswith(b"HTTP/1.1 400")


def test_transport_sets_tcp_nodelay(pair):
    _, t = pair

    async def nodelay(request):
        sock = request.transport.get_extra_info("socket")
        return web.json_response(sock.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY))

    t.app.router.add_get("/_nodelay", nodelay)
    status, body = t.request("GET", "/_nodelay")
    assert status == 200 and json.loads(body) != 0


def test_client_disconnect_aborts_its_request(pair):
    _, t = pair
    eng = t.api.engine.engine
    aborted = []
    inner = eng.abort_request

    def record(rid):
        aborted.append(rid)
        inner(rid)

    eng.abort_request = record
    try:
        body = json.dumps({"prompt": [1, 2], "max_tokens": 120, "temperature": 0,
                           "ignore_eos": True, "stream": True}).encode()
        s = socket.create_connection(("127.0.0.1", t.port), timeout=60)
        s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n\r\n%s"
                  % (len(body), body))
        f = s.makefile("rb")
        while not f.readline().startswith(b"data: "):
            pass
        f.close()
        s.close()
        deadline = time.time() + 20
        while time.time() < deadline and (not aborted or eng.has_unfinished()):
            time.sleep(0.02)
        assert aborted and not eng.has_unfinished()
        assert eng.block_manager.num_used_blocks == 0
    finally:
        eng.abort_request = inner
    assert t.request("GET", "/health")[0] == 200


def test_unported_paths_answer_501(pair):
    _, t = pair
    for method, path, body, item in (
        ("GET", "/v1/weights", None, "item 9"),
        ("POST", "/v1/update_weights", {"model_path": "/x"}, "item 9"),
        ("POST", "/v1/chat/completions", {"messages": [{"role": "user", "content": [
            {"type": "text", "text": "w1"},
            {"type": "image_url", "image_url": {"url": "data:image/png;base64,AAAA"}}]}]},
         "item 13"),
        ("POST", "/v1/chat/completions", {"messages": [{"role": "user", "content": [
            {"type": "video", "frames": []}]}]}, "item 13"),
    ):
        status, raw = t.request(method, path, body)
        assert status == 501, (path, status, raw)
        assert item in json.loads(raw)["error"]["message"]
    for argv, item in ((["--tp", "2"], "item 15"), (["--dp", "2"], "item 15"),
                       (["--num-nodes", "2"], "item 15"), (["--warmup"], "item 5")):
        with pytest.raises(NotImplementedError, match=item):
            check_unported(parse_args(["--model", "x", *argv]))


def test_registry_register_heartbeat_expiry():
    srv = PortServer(None, make_registry_app(ttl_s=0.5))
    try:
        status, raw = srv.request("POST", "/registry/register",
                                  {"address": "http://a:1", "model": "m", "role": "prefill"})
        iid = json.loads(raw)["instance_id"]

        def live(q=""):
            return len(json.loads(srv.request("GET", "/registry/instances" + q)[1])[
                "instances"])

        assert live() == 1 and live("?role=decode") == 0 and live("?role=prefill") == 1
        time.sleep(0.3)
        assert srv.request("POST", f"/registry/heartbeat/{iid}")[0] == 200
        time.sleep(0.3)
        assert live() == 1  # the heartbeat kept it past the ttl
        time.sleep(0.6)
        assert live() == 0  # expired without heartbeats
        assert srv.request("POST", "/registry/heartbeat/unknown")[0] == 404
        # the serving side's client registers, then deregisters
        client = InstanceClient(f"http://127.0.0.1:{srv.port}", "http://b:2", "m",
                                heartbeat_interval_s=0.1)
        client.start()
        assert live() == 1
        client.stop()
        assert live() == 0
    finally:
        srv.close()


def test_health_manager_flips_on_failure():
    hm = HealthCheckManager(interval_s=0.05)
    ok = {"v": True}
    hm.register("probe", lambda: ok["v"])
    assert hm.run_checks_once() is True and hm.healthy
    ok["v"] = False
    assert hm.run_checks_once() is False
    assert hm.failed_checks == ["probe"]
    ok["v"] = True
    assert hm.run_checks_once() is True


def test_command_line_serves_and_stops_on_sigint(model_dir, pair, tmp_path):
    _, t = pair
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    err = open(tmp_path / "stderr.txt", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "xllm_tpu_torch.server.api", "--model", model_dir,
         "--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--num-blocks", "32",
         "--block-size", "16", "--max-seqs", "4", "--max-model-len", "128"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        port = None
        deadline = time.time() + 120
        while port is None and time.time() < deadline:
            line = proc.stdout.readline()
            assert line, (tmp_path / "stderr.txt").read_text()[-3000:]
            if "Running on http://" in line:
                port = int(line.split("Running on http://", 1)[1].split()[0].rsplit(":", 1)[1])
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.request("GET", "/health")
        r = c.getresponse()
        assert r.status == 200 and json.loads(r.read()) == {"status": "ok"}
        body = {"prompt": [5, 6, 7], "max_tokens": 6, "temperature": 0, "ignore_eos": True}
        c.request("POST", "/v1/completions", body=json.dumps(body))
        r = c.getresponse()
        got = json.loads(r.read())
        c.close()
        want = json.loads(t.request("POST", "/v1/completions", dict(body, logprobs=0))[1])
        assert got["choices"][0]["text"] == want["choices"][0]["text"]
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        err.close()
