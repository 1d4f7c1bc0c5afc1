"""OpenAI-compatible HTTP server.

Counterpart of ``xllm_tpu/server/api.py``: the same handlers and endpoints,
on ``server/http.py``, a small HTTP/1.1 transport on the standard
library's asyncio that takes aiohttp's place (the card's machine has no
aiohttp). Endpoints:

    POST /v1/completions        (stream + non-stream; echo; prompt scoring)
    POST /v1/chat/completions   (stream + non-stream, chat template,
                                 reasoning split, tool calls)
    POST /v1/embeddings, /v1/rerank, /v1/sample, /v1/messages (Anthropic)
    GET  /v1/models
    GET  /health                (engine thread watchdog)
    GET  /metrics               (prometheus; empty without prometheus_client)
    POST /start_profile, /stop_profile (torch.profiler, a Chrome trace)

Not ported, each answering 501 with its ROADMAP item: ``/v1/weights`` and
``/v1/update_weights`` (item 9), image or video chat content (item 13).
The command line refuses ``--num-nodes`` > 1, ``--tp`` / ``--dp`` > 1
(item 15) and ``--warmup`` (item 5: CUDA-graph decode).

Every engine call goes through the async engine (``generate`` or
``call``), so no handler blocks the event loop.

Run: python -m xllm_tpu_torch.server.api --model /path/to/hf-model [--port 8000]
(on the card; ``--device cpu`` runs the plain PyTorch path on the CPU)
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import os
import time
import uuid

from xllm_tpu_torch.common import metrics
from xllm_tpu_torch.common.health import HealthCheckManager
from xllm_tpu_torch.common.rate_limiter import RateLimiter
from xllm_tpu_torch.config import (
    CacheConfig,
    EngineConfig,
    ParallelConfig,
    QuantConfig,
    SchedulerConfig,
    SpeculativeConfig,
)
from xllm_tpu_torch.framework.chat_template import ChatTemplate
from xllm_tpu_torch.framework.sampling_params import SamplingParams
from xllm_tpu_torch.models.model_args import load_model_config
from xllm_tpu_torch.parser.function_call import StreamingToolCallParser, get_detector
from xllm_tpu_torch.parser.reasoning_parser import ReasoningParser
from xllm_tpu_torch.server import http as web
from xllm_tpu_torch.server.async_engine import AsyncLLMEngine
from xllm_tpu_torch.server.registry import InstanceClient
from xllm_tpu_torch.utils import get_logger

logger = get_logger(__name__)


def _error(status: int, message: str, etype: str = "invalid_request_error"):
    return web.json_response(
        {"error": {"message": message, "type": etype}}, status=status
    )


def _unported(message: str):
    """501 for a path the port has not taken over yet."""
    return _error(501, message, "not_implemented")


_MEDIA_PARTS = ("image_url", "video_url", "video")


def _sampling_from_body(body: dict, max_model_len: int) -> SamplingParams:
    stop = body.get("stop") or []
    if isinstance(stop, str):
        stop = [stop]
    return SamplingParams(
        max_tokens=int(body.get("max_tokens") or body.get("max_completion_tokens") or 512),
        temperature=float(body.get("temperature", 1.0)),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", -1)),
        n=int(body.get("n", 1)),
        best_of=int(body.get("best_of", body.get("n", 1))),
        stop=stop,
        ignore_eos=bool(body.get("ignore_eos", False)),
        logprobs=body.get("logprobs"),
        seed=body.get("seed"),
        frequency_penalty=float(body.get("frequency_penalty", 0.0)),
        presence_penalty=float(body.get("presence_penalty", 0.0)),
        repetition_penalty=float(body.get("repetition_penalty", 1.0)),
        use_beam_search=bool(body.get("use_beam_search", False)),
    )


class APIServer:
    def __init__(
        self,
        config: EngineConfig,
        served_model_name: str = "",
        tool_call_parser: str = "",
        reasoning_parser: bool = False,
        device="cuda",
        engine=None,
    ):
        """``engine``: an ``LLMEngine`` to serve (else one is built from
        ``config`` on ``device``)."""
        self.config = config
        self.engine = AsyncLLMEngine(config, engine=engine, device=device)
        self.model_name = served_model_name or config.model.model_path or "xllm-tpu"
        self.rate_limiter = RateLimiter(0)
        self.tool_call_parser = tool_call_parser
        self.reasoning_parser = reasoning_parser
        self.chat_template: ChatTemplate | None = None
        if config.model.model_path:
            try:
                self.chat_template = ChatTemplate.from_model_path(
                    config.model.model_path
                )
            except Exception as e:
                logger.warning("no chat template: %s", e)

    # ------------------------------------------------------------------
    def app(self) -> web.Application:
        app = web.Application()
        app["api_server"] = self  # embedding hosts reach the engine
        app.router.add_post("/v1/completions", self.completions)
        app.router.add_post("/v1/chat/completions", self.chat_completions)
        app.router.add_post("/v1/embeddings", self.embeddings)
        app.router.add_post("/v1/rerank", self.rerank)
        app.router.add_post("/v1/sample", self.sample)
        app.router.add_post("/v1/messages", self.anthropic_messages)
        app.router.add_get("/v1/models", self.models)
        app.router.add_get("/health", self.health)
        app.router.add_get("/metrics", self.metrics_endpoint)
        # online profiling: a torch.profiler trace (host ops and the card's
        # kernels) written as a Chrome trace into --profile-dir
        app.router.add_post("/start_profile", self.start_profile)
        app.router.add_post("/stop_profile", self.stop_profile)
        # RL weight sync: not ported (501, ROADMAP item 9)
        app.router.add_get("/v1/weights", self.get_weights)
        app.router.add_post("/v1/update_weights", self.update_weights)
        app.on_startup.append(self._on_start)
        app.on_cleanup.append(self._on_stop)
        return app

    async def _on_start(self, app):
        self.engine.start()
        # watchdog: engine loop thread aliveness + device reachability
        # (reference HealthCheckManager polls registered checks every 3s)
        self.health_manager = HealthCheckManager()
        self.health_manager.register(
            "engine_thread",
            lambda: self.engine._thread is not None
            and self.engine._thread.is_alive(),
        )
        self.health_manager.start()

    async def _on_stop(self, app):
        if getattr(self, "health_manager", None) is not None:
            self.health_manager.stop()
        self.engine.stop()

    # ------------------------------------------------------------------
    async def health(self, request: web.Request) -> web.Response:
        hm = getattr(self, "health_manager", None)
        if hm is not None and not hm.healthy:
            return web.json_response(
                {"status": "unhealthy", "failed": hm.failed_checks},
                status=503,
            )
        return web.json_response({"status": "ok"})

    async def metrics_endpoint(self, request: web.Request) -> web.Response:
        return web.Response(
            body=metrics.render(), content_type="text/plain", charset="utf-8"
        )

    # ------------------------------------------------------------------
    # Online profiling: POST /start_profile starts a torch.profiler trace
    # of the host's ops and (on the card) its kernels; /stop_profile stops
    # it and writes a Chrome trace into profile_dir. Both run on the
    # engine thread, between steps, so the trace holds whole steps.
    _profiling = False
    _profiler = None

    async def get_weights(self, request: web.Request) -> web.Response:
        return _unported("weight export is not ported yet (ROADMAP item 9)")

    async def update_weights(self, request: web.Request) -> web.Response:
        return _unported("weight updates are not ported yet (ROADMAP item 9)")

    @staticmethod
    def _start_profiler(eng):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if eng.runner.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    @staticmethod
    def _stop_profiler(eng, prof, path: str) -> None:
        prof.stop()
        prof.export_chrome_trace(path)

    async def start_profile(self, request: web.Request) -> web.Response:
        if self._profiling:
            return web.json_response(
                {"error": "profiler already running"}, status=409
            )
        trace_dir = self.config.profile_dir
        try:
            os.makedirs(trace_dir, exist_ok=True)
            self._profiler = await self.engine.call(self._start_profiler)
        except Exception as e:  # pragma: no cover - backend specific
            return web.json_response({"error": str(e)}, status=500)
        self._profiling = True
        logger.info("profiler started -> %s", trace_dir)
        return web.json_response({"status": "profiling", "dir": trace_dir})

    async def stop_profile(self, request: web.Request) -> web.Response:
        if not self._profiling:
            return web.json_response(
                {"error": "profiler not running"}, status=409
            )
        path = os.path.join(
            self.config.profile_dir, f"xllm_trace_{os.getpid()}_{time.time_ns()}.json"
        )
        try:
            await self.engine.call(self._stop_profiler, self._profiler, path)
        finally:
            self._profiling = False
            self._profiler = None
        logger.info("profiler stopped -> %s", path)
        return web.json_response({"status": "stopped"})

    async def models(self, request: web.Request) -> web.Response:
        return web.json_response(
            {
                "object": "list",
                "data": [
                    {
                        "id": self.model_name,
                        "object": "model",
                        "created": int(time.time()),
                        "owned_by": "xllm-tpu",
                    }
                ],
            }
        )

    # ------------------------------------------------------------------
    async def embeddings(self, request: web.Request) -> web.Response:
        """OpenAI /v1/embeddings (reference EmbeddingServiceImpl)."""
        try:
            body = await request.json()
        except Exception:
            return _error(400, "invalid JSON body")
        inputs = body.get("input")
        if inputs is None:
            return _error(400, "missing 'input'")
        if isinstance(inputs, str):
            inputs = [inputs]
        if inputs and isinstance(inputs[0], int):
            inputs = [inputs]
        data = []
        total_tokens = 0
        try:
            for i, item in enumerate(inputs):
                kwargs = (
                    {"prompt_token_ids": item}
                    if isinstance(item, list)
                    else {"prompt": item}
                )
                final = None
                async for out in self.engine.generate(embed=True, **kwargs):
                    final = out
                data.append(
                    {
                        "object": "embedding",
                        "index": i,
                        "embedding": final.embedding or [],
                    }
                )
                if final.usage:
                    total_tokens += final.usage.get("prompt_tokens", 0)
        except ValueError as e:
            return _error(400, str(e))
        metrics.REQUESTS_TOTAL.labels("embeddings", "200").inc()
        return web.json_response(
            {
                "object": "list",
                "data": data,
                "model": self.model_name,
                "usage": {
                    "prompt_tokens": total_tokens,
                    "total_tokens": total_tokens,
                },
            }
        )

    async def completions(self, request: web.Request) -> web.StreamResponse:
        try:
            body = await request.json()
        except Exception:
            return _error(400, "invalid JSON body")
        prompt = body.get("prompt")
        if prompt is None:
            return _error(400, "missing 'prompt'")
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            kwargs = {"prompt_token_ids": prompt}
        elif isinstance(prompt, str):
            kwargs = {"prompt": prompt}
        else:
            return _error(400, "'prompt' must be a string or token id list")
        if (
            bool(body.get("echo"))
            and body.get("logprobs") is not None
            and int(body.get("max_tokens", 16) or 0) == 0
        ):
            # OpenAI prompt-scoring form: echo + logprobs + max_tokens=0
            # returns the prompt with its own per-token logprobs
            return await self._score_response(body, kwargs)
        return await self._run(
            request, body, kwargs, chat=False, endpoint="completions"
        )

    async def _score_response(self, body: dict, kwargs: dict):
        if "prompt_token_ids" in kwargs:
            ids = list(kwargs["prompt_token_ids"])
            toks = [str(t) for t in ids]
            text = ""
        else:
            if self.engine.tokenizer is None:
                return _error(400, "server has no tokenizer")
            text = kwargs["prompt"]
            ids = self.engine.tokenizer.encode(text)
            toks = [str(t) for t in ids]
        try:
            # runs inside the engine loop thread (no races with serving)
            lps = await self.engine.call("score_prompt", ids)
        except ValueError as e:
            return _error(400, str(e))
        metrics.REQUESTS_TOTAL.labels("completions", "200").inc()
        return web.json_response({
            "id": "cmpl-" + uuid.uuid4().hex[:24],
            "object": "text_completion",
            "created": int(time.time()),
            "model": self.model_name,
            "choices": [{
                "index": 0,
                "text": text,
                "finish_reason": "length",
                "logprobs": {
                    "tokens": toks,
                    # the first prompt token has no conditioning context
                    "token_logprobs": [None] + [float(x) for x in lps],
                    "top_logprobs": None,
                    "text_offset": [],
                },
            }],
            "usage": {"prompt_tokens": len(ids), "completion_tokens": 0,
                      "total_tokens": len(ids)},
        })

    async def sample(self, request: web.Request) -> web.Response:
        """Multi-position sampling (reference /v1/sample,
        sample_service_impl.cpp:130-230): one prompt forward; every
        occurrence of the selector literal samples from the logits at the
        position before it (sample_slot.cpp:49-52)."""
        try:
            body = await request.json()
        except Exception:
            return _error(400, "invalid JSON body")
        prompt = body.get("prompt")
        if not prompt:
            return _error(400, "prompt is required")
        selector = body.get("selector") or {}
        if selector.get("type", "literal") != "literal":
            return _error(400, "selector.type must be literal")
        literal = selector.get("value", "")
        if not literal:
            return _error(400, "selector.value is required")
        tok = self.engine.tokenizer
        if tok is None:
            return _error(400, "server has no tokenizer")
        lit_ids = tok.encode(literal)
        if len(lit_ids) != 1:
            return _error(
                400, "selector.value must map to exactly one token"
            )
        prompt_ids = tok.encode(prompt)
        positions = [i for i, t in enumerate(prompt_ids) if t == lit_ids[0]]
        num_top = int(body.get("top_logprobs", 0) or 0)
        created = int(time.time())
        rid = "sample-" + uuid.uuid4().hex[:24]
        choices = []
        if positions:
            try:
                slots = await self.engine.call(
                    "sample_slots",
                    prompt_ids,
                    positions,
                    temperature=float(body.get("temperature", 0.0) or 0.0),
                    top_k=int(body.get("top_k", 0) or 0),
                    top_p=float(body.get("top_p", 1.0) or 1.0),
                    seed=int(body.get("seed", -1)),
                    num_top=num_top,
                )
            except ValueError as e:
                return _error(400, str(e))
            for j, s in enumerate(slots):
                lp = {
                    "tokens": [tok.decode([s["token_id"]])],
                    "token_ids": [s["token_id"]],
                    "token_logprobs": [s["logprob"]],
                }
                if "top_ids" in s:
                    lp = {
                        "tokens": [tok.decode([t]) for t in s["top_ids"]],
                        "token_ids": s["top_ids"],
                        "token_logprobs": s["top_logprobs"],
                    }
                choices.append({
                    "index": j,
                    "text": tok.decode([s["token_id"]]),
                    "logprobs": lp,
                    "finish_reason": "selector_match",
                })
        return web.json_response({
            "id": rid,
            "object": "sample_completion",
            "created": created,
            "model": self.model_name,
            "choices": choices,
            "usage": {
                "prompt_tokens": len(prompt_ids),
                "completion_tokens": len(choices),
                "total_tokens": len(prompt_ids) + len(choices),
            },
        })

    async def rerank(self, request: web.Request) -> web.Response:
        """Jina/Cohere-style /v1/rerank (reference RerankServiceImpl,
        xllm/api_service/rerank_service_impl.cpp). Default mode scores
        each (query, document) PAIR through the model like the
        reference: relevance = mean log-likelihood of the document
        tokens conditioned on the query (score_prompt). ``"mode":
        "embedding"`` keeps the cheaper cosine-of-pooled-embeddings
        scoring (one forward per text instead of per pair; a documented
        deviation from the reference's cross-scoring)."""
        try:
            body = await request.json()
        except Exception:
            return _error(400, "invalid JSON body")
        query = body.get("query")
        documents = body.get("documents") or []
        if not query or not documents:
            return _error(400, "need 'query' and non-empty 'documents'")
        top_n = int(body.get("top_n", len(documents)))
        mode = body.get("mode", "model")

        async def embed_one(text):
            final = None
            async for out in self.engine.generate(prompt=text, embed=True):
                final = out
            return final.embedding or []

        async def score_pair(doc):
            tok = self.engine.tokenizer
            if tok is None:
                raise ValueError("model-scored rerank needs a tokenizer")
            q_ids = tok.encode(query)
            d_ids = tok.encode(doc)
            ids = q_ids + d_ids
            lps = await self.engine.call("score_prompt", ids)
            # lp[i] = log p(ids[i+1] | ids[:i+1]); document tokens are
            # positions len(q_ids)..end -> their lps start at len(q_ids)-1
            doc_lps = lps[max(len(q_ids) - 1, 0):]
            return float(sum(doc_lps) / max(len(doc_lps), 1))

        try:
            if mode == "model":
                scores = await asyncio.gather(
                    *(score_pair(d) for d in documents)
                )
                results = [
                    {"index": i, "relevance_score": s}
                    for i, s in enumerate(scores)
                ]
            elif mode == "embedding":
                # submit query + all documents concurrently so the
                # engine's continuous batching packs them into a few
                # steps instead of one round-trip per document
                embeds = await asyncio.gather(
                    embed_one(query), *(embed_one(d) for d in documents)
                )
                qv, dvs = embeds[0], embeds[1:]
                qn = math.sqrt(sum(a * a for a in qv))
                results = []
                for i, dv in enumerate(dvs):
                    num = sum(a * b for a, b in zip(qv, dv))
                    den = qn * math.sqrt(sum(b * b for b in dv))
                    score = num / den if den else 0.0
                    results.append({"index": i, "relevance_score": score})
            else:
                return _error(400, f"unknown rerank mode {mode!r}")
        except ValueError as e:
            return _error(400, str(e))
        results.sort(key=lambda r: r["relevance_score"], reverse=True)
        if bool(body.get("return_documents", False)):
            for r in results:
                r["document"] = {"text": documents[r["index"]]}
        metrics.REQUESTS_TOTAL.labels("rerank", "200").inc()
        return web.json_response(
            {"model": self.model_name, "results": results[:top_n]}
        )

    async def anthropic_messages(self, request: web.Request) -> web.StreamResponse:
        """Anthropic /v1/messages (reference AnthropicServiceImpl,
        server/xllm_server.cpp:40-49 maps it beside the OpenAI routes).
        Non-streaming and streaming (SSE message_start/content_block_delta
        events)."""
        try:
            body = await request.json()
        except Exception:
            return _error(400, "invalid JSON body")
        messages = body.get("messages") or []
        if body.get("system"):
            messages = [{"role": "system", "content": body["system"]}] + messages
        # anthropic content blocks -> plain text
        norm = []
        for m in messages:
            content = m.get("content")
            if isinstance(content, list):
                content = "".join(
                    b.get("text", "") for b in content if b.get("type") == "text"
                )
            norm.append({"role": m.get("role", "user"), "content": content})
        if self.chat_template is None:
            return _error(400, "server has no chat template")
        try:
            prompt = self.chat_template.apply(norm, add_generation_prompt=True)
        except Exception as e:
            return _error(400, f"chat template error: {e}")
        sp = SamplingParams(
            max_tokens=int(body.get("max_tokens", 512)),
            temperature=float(body.get("temperature", 1.0)),
            top_p=float(body.get("top_p", 1.0)),
            top_k=int(body.get("top_k", -1)),
            stop=body.get("stop_sequences") or [],
        )
        request_id = "msg_" + uuid.uuid4().hex[:24]
        stream = bool(body.get("stream", False))
        gen = self.engine.generate(
            prompt=prompt, sampling_params=sp, request_id=request_id
        )
        if not stream:
            final = None
            async for out in gen:
                final = out
            seq = final.outputs[0]
            stop_reason = (
                "end_turn" if seq.finish_reason == "stop" else "max_tokens"
            )
            metrics.REQUESTS_TOTAL.labels("messages", "200").inc()
            return web.json_response(
                {
                    "id": request_id,
                    "type": "message",
                    "role": "assistant",
                    "model": self.model_name,
                    "content": [{"type": "text", "text": seq.text}],
                    "stop_reason": stop_reason,
                    "usage": {
                        "input_tokens": (final.usage or {}).get(
                            "prompt_tokens", 0
                        ),
                        "output_tokens": (final.usage or {}).get(
                            "completion_tokens", 0
                        ),
                    },
                }
            )
        resp = web.StreamResponse(
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
            }
        )
        await resp.prepare(request)

        async def ev(name, payload):
            await resp.write(
                f"event: {name}\ndata: {json.dumps(payload)}\n\n".encode()
            )

        await ev("message_start", {
            "type": "message_start",
            "message": {
                "id": request_id, "type": "message", "role": "assistant",
                "model": self.model_name, "content": [],
            },
        })
        await ev("content_block_start", {
            "type": "content_block_start", "index": 0,
            "content_block": {"type": "text", "text": ""},
        })
        sent = 0
        final = None
        async for out in gen:
            final = out
            text = out.outputs[0].text
            if len(text) > sent:
                await ev("content_block_delta", {
                    "type": "content_block_delta", "index": 0,
                    "delta": {"type": "text_delta", "text": text[sent:]},
                })
                sent = len(text)
        await ev("content_block_stop",
                 {"type": "content_block_stop", "index": 0})
        stop_reason = (
            "end_turn"
            if final and final.outputs[0].finish_reason == "stop"
            else "max_tokens"
        )
        await ev("message_delta", {
            "type": "message_delta",
            "delta": {"stop_reason": stop_reason},
            "usage": {
                "output_tokens": (final.usage or {}).get("completion_tokens", 0)
                if final else 0
            },
        })
        await ev("message_stop", {"type": "message_stop"})
        await resp.write_eof()
        metrics.REQUESTS_TOTAL.labels("messages", "200").inc()
        return resp

    async def chat_completions(self, request: web.Request) -> web.StreamResponse:
        try:
            body = await request.json()
        except Exception:
            return _error(400, "invalid JSON body")
        messages = body.get("messages")
        if not messages:
            return _error(400, "missing 'messages'")
        if self.chat_template is None:
            return _error(400, "server has no chat template; use /v1/completions")
        if self._has_media(messages):
            return _unported(
                "image and video inputs are not ported yet (ROADMAP item 13)"
            )
        try:
            prompt = self.chat_template.apply(
                self._text_messages(messages), add_generation_prompt=True,
                tools=body.get("tools"),
            )
        except Exception as e:
            return _error(400, f"chat template error: {e}")
        gen_kwargs: dict = {"prompt": prompt}
        return await self._run(
            request, body, gen_kwargs, chat=True, endpoint="chat"
        )

    # ------------------------------------------------------------------
    @staticmethod
    def _has_media(messages: list) -> bool:
        return any(
            isinstance(m.get("content"), list)
            and any(b.get("type") in _MEDIA_PARTS for b in m["content"])
            for m in messages
        )

    @staticmethod
    def _text_messages(messages: list) -> list:
        """OpenAI multi-part text content joined into one string, as the
        JAX server's ``_extract_images`` leaves it."""
        norm = []
        for m in messages:
            content = m.get("content")
            if isinstance(content, list):
                m = dict(m, content="".join(
                    b.get("text", "") for b in content if b.get("type") == "text"
                ))
            norm.append(m)
        return norm

    # ------------------------------------------------------------------
    async def _run(
        self,
        request: web.Request,
        body: dict,
        gen_kwargs: dict,
        chat: bool,
        endpoint: str,
    ) -> web.StreamResponse:
        if not self.rate_limiter.try_acquire():
            metrics.REQUESTS_TOTAL.labels(endpoint, "429").inc()
            return _error(429, "too many requests", "rate_limit_exceeded")
        request_id = (
            ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
        )
        created = int(time.time())
        sp = _sampling_from_body(body, self.config.scheduler.max_model_len)
        stream = bool(body.get("stream", False))
        # service class (reference online/offline + priority request fields,
        # request_priority_queue.h): offline requests yield to online under
        # load and are the first preemption victims
        if "priority" in body:
            gen_kwargs["priority"] = int(body["priority"])
        if "offline" in body:
            gen_kwargs["offline"] = bool(body["offline"])
        try:
            gen = self.engine.generate(
                sampling_params=sp, request_id=request_id, **gen_kwargs
            )
            echo = not chat and bool(body.get("echo"))
            if stream:
                return await self._stream_response(
                    request, gen, request_id, created, chat, endpoint,
                    include_usage=bool(
                        (body.get("stream_options") or {}).get("include_usage")
                    ),
                    echo=echo,
                )
            return await self._full_response(
                gen, request_id, created, chat, endpoint, echo=echo
            )
        except ValueError as e:
            metrics.REQUESTS_TOTAL.labels(endpoint, "400").inc()
            return _error(400, str(e))
        except NotImplementedError as e:  # an unported request option
            metrics.REQUESTS_TOTAL.labels(endpoint, "501").inc()
            return _unported(str(e))
        finally:
            self.rate_limiter.release()

    def _postprocess_chat_text(self, text: str) -> dict:
        """Split reasoning + detect tool calls (reference StreamOutputParser
        + FunctionCallParser on the non-stream path)."""
        msg: dict = {"role": "assistant", "content": text}
        if self.reasoning_parser:
            p = ReasoningParser()
            d = p.feed(text)
            f = p.finish()
            reasoning = d.reasoning + f.reasoning
            if reasoning:
                msg["reasoning_content"] = reasoning
                msg["content"] = d.content + f.content
        if self.tool_call_parser:
            r = get_detector(self.tool_call_parser).parse(msg["content"])
            if r.tool_calls:
                msg["content"] = r.content or None
                msg["tool_calls"] = [
                    {
                        "id": c.id,
                        "type": "function",
                        "function": {"name": c.name, "arguments": c.arguments},
                    }
                    for c in r.tool_calls
                ]
        return msg

    async def _echo_first(self, gen, request_id, created, obj, send):
        """Yield-through generator that emits the prompt text as the first
        stream chunk (OpenAI completions `echo`)."""
        first = True
        async for out in gen:
            if first:
                first = False
                await send({
                    "id": request_id, "object": obj, "created": created,
                    "model": self.model_name,
                    "choices": [{
                        "index": 0, "text": out.prompt or "",
                        "finish_reason": None, "logprobs": None,
                    }],
                })
            yield out

    async def _full_response(
        self, gen, request_id, created, chat, endpoint, echo=False
    ):
        final = None
        async for out in gen:
            final = out
        metrics.REQUESTS_TOTAL.labels(endpoint, "200").inc()
        choices = []
        for o in final.outputs:
            if chat:
                msg = self._postprocess_chat_text(o.text)
                finish = o.finish_reason
                if msg.get("tool_calls") and finish == "stop":
                    finish = "tool_calls"
                choices.append(
                    {
                        "index": o.index,
                        "message": msg,
                        "finish_reason": finish,
                    }
                )
            else:
                logprobs = None
                if o.logprobs is not None:
                    top = None
                    if o.top_logprobs:
                        top = [
                            {str(t): lp for t, lp in alts.items()}
                            for alts in o.top_logprobs
                        ]
                    logprobs = {
                        "tokens": [str(t) for t in o.token_ids],
                        "token_logprobs": o.logprobs,
                        "top_logprobs": top,
                        "text_offset": [],
                    }
                choices.append(
                    {
                        "index": o.index,
                        # OpenAI echo: the prompt text precedes the
                        # completion (completions endpoint only)
                        "text": (
                            (final.prompt or "") + o.text if echo else o.text
                        ),
                        "finish_reason": o.finish_reason,
                        "logprobs": logprobs,
                    }
                )
        usage = final.usage or {}
        return web.json_response(
            {
                "id": request_id,
                "object": "chat.completion" if chat else "text_completion",
                "created": created,
                "model": self.model_name,
                "choices": choices,
                "usage": {
                    "prompt_tokens": usage.get("prompt_tokens", 0),
                    "completion_tokens": usage.get("completion_tokens", 0),
                    "total_tokens": usage.get("prompt_tokens", 0)
                    + usage.get("completion_tokens", 0),
                },
            }
        )

    async def _stream_response(
        self, request, gen, request_id, created, chat, endpoint,
        include_usage, echo=False,
    ):
        # surface intake errors (overlong prompt, invalid params) BEFORE
        # committing to 200 + SSE headers: add_request raises on the
        # generator's first iteration
        try:
            first = await gen.__anext__()
        except StopAsyncIteration:
            first = None
        except ValueError as e:
            return _error(400, str(e))
        except NotImplementedError as e:
            return _unported(str(e))

        inner = gen

        async def _chained():
            if first is not None:
                yield first
            async for o in inner:
                yield o

        gen = _chained()
        resp = web.StreamResponse(
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "Connection": "keep-alive",
            }
        )
        await resp.prepare(request)
        obj = "chat.completion.chunk" if chat else "text_completion"

        async def send(payload: dict) -> None:
            await resp.write(f"data: {json.dumps(payload)}\n\n".encode())

        if chat:
            await send(
                {
                    "id": request_id, "object": obj, "created": created,
                    "model": self.model_name,
                    "choices": [
                        {"index": 0, "delta": {"role": "assistant", "content": ""},
                         "finish_reason": None}
                    ],
                }
            )
        sent_text_len: dict[int, int] = {}
        final = None
        last_t = time.monotonic()
        echo_pending = echo
        try:
            if echo_pending:
                # OpenAI echo on streaming completions: the prompt text is
                # the first data chunk
                gen, _orig = self._echo_first(gen, request_id, created,
                                              obj, send), gen
            final = await self._pump_stream(
                gen, chat, request_id, created, obj, send,
                sent_text_len, last_t,
            )
        except (ConnectionResetError, asyncio.CancelledError, OSError):
            # client went away mid-stream: stop generating for it
            # (reference disconnect -> abort path in the brpc Call wrappers)
            self.engine.abort(request_id)
            metrics.REQUESTS_TOTAL.labels(endpoint, "499").inc()
            raise
        if include_usage and final is not None and final.usage:
            await send(
                {
                    "id": request_id, "object": obj, "created": created,
                    "model": self.model_name, "choices": [],
                    "usage": {
                        "prompt_tokens": final.usage["prompt_tokens"],
                        "completion_tokens": final.usage["completion_tokens"],
                        "total_tokens": final.usage["prompt_tokens"]
                        + final.usage["completion_tokens"],
                    },
                }
            )
        await resp.write(b"data: [DONE]\n\n")
        metrics.REQUESTS_TOTAL.labels(endpoint, "200").inc()
        await resp.write_eof()
        return resp

    async def _pump_stream(
        self, gen, chat, request_id, created, obj, send, sent_text_len, last_t
    ):
        final = None
        # streaming <think> splitter per choice (reference StreamOutputParser
        # + reasoning_parser.h:26 on the stream path)
        reasoners: dict[int, object] = {}
        if chat and self.reasoning_parser:

            def reasoner(i):
                if i not in reasoners:
                    reasoners[i] = ReasoningParser()
                return reasoners[i]

        # incremental tool-call deltas per choice (reference
        # stream_output_parser.h:30 partial-JSON tool-call tracking);
        # consumes the CONTENT channel (after the reasoning split)
        toolers: dict[int, object] = {}
        if chat and self.tool_call_parser:

            def tooler(i):
                if i not in toolers:
                    toolers[i] = StreamingToolCallParser(self.tool_call_parser)
                return toolers[i]

        async for out in gen:
            final = out
            for o in out.outputs:
                prev = sent_text_len.get(o.index, 0)
                delta = o.text[prev:]
                if not delta and not (out.finished and o.finish_reason):
                    continue
                sent_text_len[o.index] = len(o.text)
                now = time.monotonic()
                metrics.TPOT.observe(now - last_t)
                last_t = now
                if chat:
                    d: dict = {}
                    if self.reasoning_parser:
                        r = reasoner(o.index)
                        rd = r.feed(delta)
                        if out.finished:
                            tail = r.finish()
                            rd.reasoning += tail.reasoning
                            rd.content += tail.content
                        if rd.reasoning:
                            d["reasoning_content"] = rd.reasoning
                        content_delta = rd.content
                    else:
                        content_delta = delta
                    if self.tool_call_parser:
                        t = tooler(o.index)
                        text_out, tc = t.feed(content_delta)
                        if out.finished:
                            tail_text, tail_tc = t.finish()
                            text_out += tail_text
                            tc = tc + tail_tc
                        if text_out:
                            d["content"] = text_out
                        if tc:
                            d["tool_calls"] = tc
                    elif content_delta:
                        d["content"] = content_delta
                    finish = o.finish_reason if out.finished else None
                    if (
                        finish == "stop"
                        and o.index in toolers
                        and toolers[o.index].emitted_any
                    ):
                        finish = "tool_calls"
                    choice = {
                        "index": o.index,
                        "delta": d,
                        "finish_reason": finish,
                    }
                else:
                    choice = {
                        "index": o.index,
                        "text": delta,
                        "finish_reason": o.finish_reason if out.finished else None,
                    }
                await send(
                    {
                        "id": request_id, "object": obj, "created": created,
                        "model": self.model_name, "choices": [choice],
                    }
                )
        return final


def build_config(args) -> EngineConfig:
    """CLI flags -> EngineConfig."""
    model_cfg = load_model_config(args.model)
    return EngineConfig(
        model=model_cfg,
        cache=CacheConfig(
            block_size=args.block_size,
            num_blocks=args.num_blocks,
            memory_utilization=args.memory_utilization,
            enable_prefix_cache=not args.no_prefix_cache,
        ),
        scheduler=SchedulerConfig(
            max_seqs_per_batch=args.max_seqs,
            max_tokens_per_batch=args.max_tokens_per_batch,
            max_tokens_per_chunk_for_prefill=args.max_prefill_chunk,
            max_model_len=args.max_model_len,
            enable_schedule_overlap=not args.no_schedule_overlap,
            policy=args.scheduler_policy,
            step_latency_budget_ms=args.step_latency_budget_ms,
        ),
        parallel=ParallelConfig(tp_size=args.tp, dp_size=args.dp),
        speculative=SpeculativeConfig(
            method=args.speculative_method,
            num_speculative_tokens=args.num_speculative_tokens,
        ),
        quant=QuantConfig(method=args.quantization),
        # EngineConfig's default (<tempdir>/xllm_trace) unless given
        **({"profile_dir": args.profile_dir} if args.profile_dir else {}),
    )


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX server's flags, and ``--device``."""
    p = argparse.ArgumentParser("xllm_tpu_torch.server.api")
    p.add_argument("--model", required=True)
    p.add_argument("--served-model-name", default="")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--block-size", type=int, default=64)
    p.add_argument("--num-blocks", type=int, default=0)
    p.add_argument("--memory-utilization", type=float, default=0.9)
    p.add_argument("--max-seqs", type=int, default=256)
    p.add_argument("--max-tokens-per-batch", type=int, default=8192)
    p.add_argument("--max-prefill-chunk", type=int, default=2048)
    p.add_argument("--max-model-len", type=int, default=0)
    p.add_argument("--max-concurrency", type=int, default=0)
    p.add_argument("--no-prefix-cache", action="store_true")
    p.add_argument("--no-schedule-overlap", action="store_true")
    p.add_argument("--scheduler-policy", default="continuous",
                   choices=["continuous", "mix"],
                   help="mix = one priority queue for P+D under a latency "
                        "budget (scheduler/mix.py)")
    p.add_argument("--step-latency-budget-ms", type=float, default=0.0)
    p.add_argument("--warmup", action="store_true",
                   help="not ported (CUDA-graph decode, ROADMAP item 5)")
    p.add_argument(
        "--tool-call-parser", default="",
        help="hermes|qwen25|qwen3|qwen3_coder|llama3_json|deepseek_v3|glm45|kimi_k2",
    )
    p.add_argument("--reasoning-parser", action="store_true",
                   help="split <think> blocks into reasoning_content")
    p.add_argument("--speculative-method", default="",
                   help="''|suffix|ngram|mtp|eagle3")
    p.add_argument("--num-speculative-tokens", type=int, default=4)
    p.add_argument("--quantization", default="", help="''|int8|fp8_e4m3")
    p.add_argument("--profile-dir", default=None,
                   help="where /stop_profile writes its Chrome trace "
                        "(default <tempdir>/xllm_trace)")
    p.add_argument("--registry-url", default="",
                   help="instance registry to register/heartbeat with")
    p.add_argument("--instance-role", default="mixed",
                   help="mixed|prefill|decode (PD disaggregation role)")
    p.add_argument("--num-nodes", type=int, default=1)
    p.add_argument("--node-rank", type=int, default=0)
    p.add_argument("--coordinator-address", default="")
    return p.parse_args(argv)


def check_unported(args) -> None:
    """The flags whose paths are not ported raise, naming their ROADMAP
    item."""
    if args.num_nodes > 1 or args.tp > 1 or args.dp > 1:
        raise NotImplementedError(
            "multi-node, tensor- and data-parallel serving are not ported yet "
            "(ROADMAP item 15)"
        )
    if args.warmup:
        raise NotImplementedError(
            "--warmup is CUDA-graph decode in the port, not ported yet "
            "(ROADMAP item 5)"
        )


def main(argv=None) -> None:
    args = parse_args(argv)
    check_unported(args)
    config = build_config(args)
    logger.info("engine config:\n%s", config.to_json())
    server = APIServer(
        config,
        args.served_model_name,
        tool_call_parser=args.tool_call_parser,
        reasoning_parser=args.reasoning_parser,
        device=args.device,
    )
    server.rate_limiter.max_concurrency = args.max_concurrency
    client = None
    if args.registry_url:
        client = InstanceClient(
            args.registry_url,
            address=f"http://{args.host}:{args.port}",
            model=server.model_name,
            role=args.instance_role,
        )
        client.start()
    try:
        web.run_app(server.app(), host=args.host, port=args.port)
    finally:
        if client is not None:
            client.stop()


if __name__ == "__main__":
    main()
