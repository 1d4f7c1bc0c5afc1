"""HTTP transport for disaggregated PD (prefill node -> decode node). A port
of ``xllm_tpu/disagg/service.py`` on the stdlib HTTP transport
(``server/http.py``): the prefill front posts the handoff with urllib in an
executor thread where the JAX package opens an ``aiohttp.ClientSession``;
the handlers and their bodies are JAX's.

Counterpart of the reference's brpc DisaggPD services
(reference xllm/core/distributed_runtime/disagg_pd_service_impl.cpp,
disagg_pd.proto): the decode node exposes POST /disagg/generate taking the
binary PrefillHandoff; the prefill node runs the prompt, ships the
handoff, and relays the completion back to its client (the reference's
first-generation dispatch + response relay).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import threading
import urllib.request

import torch

from xllm_tpu_torch.disagg.pd import DecodeInstance, PrefillHandoff, PrefillInstance
from xllm_tpu_torch.server import http as web

HANDOFF_MAX_SIZE = 1 << 30  # the decode app's client_max_size (JAX's)


def engine_device(engine):
    """The engine's device as the current one of the calling thread (an
    executor thread starts on device 0); the engine's work stays on that
    device's default stream, shared by every thread."""
    dev = engine.runner.device
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def make_decode_app(decode: DecodeInstance) -> web.Application:
    """Decode-role server. One engine, steps driven per accepted request."""
    lock = threading.Lock()

    async def generate(request: web.Request) -> web.Response:
        raw = await request.read()
        handoff = PrefillHandoff.from_bytes(raw)

        def run():
            with lock, engine_device(decode.engine):  # engine is single-threaded
                req = decode.accept(handoff)
                eng = decode.engine
                final = None
                while eng.has_unfinished():
                    for ro in eng.step():
                        if ro.request_id == req.request_id and ro.finished:
                            final = ro
                if req.is_finished and final is None:
                    return {"token_ids": [], "finish_reason": "stop"}
                o = final.outputs[0]
                return {
                    "token_ids": o.token_ids,
                    "text": o.text,
                    "finish_reason": o.finish_reason,
                }

        result = await asyncio.get_running_loop().run_in_executor(None, run)
        return web.json_response(result)

    async def health(request: web.Request) -> web.Response:
        return web.json_response({"status": "ok", "role": "decode"})

    app = web.Application(client_max_size=HANDOFF_MAX_SIZE)
    app.router.add_post("/disagg/generate", generate)
    app.router.add_get("/health", health)
    return app


def post_handoff(decode_url: str, handoff: PrefillHandoff, timeout_s: float = 600.0) -> dict:
    """POST a handoff to a decode node's /disagg/generate -> its JSON."""
    req = urllib.request.Request(
        decode_url + "/disagg/generate", data=handoff.to_bytes(),
        headers={"Content-Type": "application/octet-stream"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode())


def make_prefill_app(prefill: PrefillInstance, decode_url: str) -> web.Application:
    """Prefill-role front: /v1/completions -> local prefill -> remote decode."""
    lock = threading.Lock()

    async def completions(request: web.Request) -> web.Response:
        from xllm_tpu_torch.server.api import _error, _sampling_from_body

        body = await request.json()
        prompt = body.get("prompt")
        if not isinstance(prompt, list) or not prompt:
            return _error(400, "PD front takes 'prompt' as a token id list")
        sp = _sampling_from_body(
            body, prefill.engine.config.scheduler.max_model_len
        )

        def do_prefill():
            with lock, engine_device(prefill.engine):
                return prefill.prefill(prompt, sp)

        loop = asyncio.get_running_loop()
        handoff = await loop.run_in_executor(None, do_prefill)
        result = await loop.run_in_executor(None, post_handoff, decode_url, handoff)
        return web.json_response(
            {
                "id": handoff.request_id,
                "object": "text_completion",
                "choices": [
                    {
                        "index": 0,
                        "text": result.get("text", ""),
                        "token_ids": result["token_ids"],
                        "finish_reason": result["finish_reason"],
                    }
                ],
            }
        )

    async def health(request: web.Request) -> web.Response:
        return web.json_response({"status": "ok", "role": "prefill"})

    app = web.Application()
    app.router.add_post("/v1/completions", completions)
    app.router.add_get("/health", health)
    return app
