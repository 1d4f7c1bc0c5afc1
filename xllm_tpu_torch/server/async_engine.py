"""Async engine front: background step loop + asyncio streaming.

Counterpart of ``xllm_tpu/server/async_engine.py``: one thread owns the
engine and steps it continuously; results cross into the asyncio world
through per-request queues, and a response thread detokenizes off the step
loop. ``generate(embed=True)`` serves embeddings, and ``call("score_prompt",
ids)`` runs prompt scoring on the engine thread between steps: the paths of
the OpenAI server's ``/v1/embeddings``, ``/v1/rerank`` and echo+logprobs;
``call("sample_slots", ...)`` that of ``/v1/sample``. It imports no HTTP
framework.
"""

from __future__ import annotations

import asyncio
import functools
import queue as _queue
import threading
import time
from dataclasses import dataclass, field

from xllm_tpu_torch.common import metrics
from xllm_tpu_torch.config import EngineConfig
from xllm_tpu_torch.engine import LLMEngine
from xllm_tpu_torch.framework.request import RequestOutput
from xllm_tpu_torch.framework.sampling_params import SamplingParams
from xllm_tpu_torch.utils import get_logger

logger = get_logger(__name__)


@dataclass
class _Stream:
    loop: asyncio.AbstractEventLoop
    queue: asyncio.Queue = field(default_factory=asyncio.Queue)
    first_token_at: float | None = None
    started_at: float = field(default_factory=time.monotonic)
    # response-thread detok state (AsyncResponseProcessor): the expanded
    # prompt ids and whether the engine keeps detok inline (stop strings)
    prompt_ids: list | None = None
    inline_detok: bool = False

    def push(self, item) -> None:
        self.loop.call_soon_threadsafe(self.queue.put_nowait, item)


class AsyncLLMEngine:
    """Thread-owned LLMEngine with an asyncio streaming facade."""

    def __init__(self, config: EngineConfig, engine: LLMEngine | None = None,
                 device="cuda"):
        self.engine = engine or LLMEngine(config, device=device)
        self._intake: _queue.Queue = _queue.Queue()
        self._streams: dict[str, _Stream] = {}
        self._streams_lock = threading.Lock()
        self._stopped = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        # decoupled response processing: the engine thread skips detok
        # (except stop-string sequences) and hands outputs to a response
        # thread that detokenizes + pushes to the asyncio streams — host
        # detok cost leaves the TPOT-critical step loop
        self._resp_q: _queue.Queue = _queue.Queue()
        self._resp_thread: threading.Thread | None = None
        if self.engine.tokenizer is not None:
            self.engine.inline_detok = False
        metrics.KV_BLOCKS_TOTAL.set(
            getattr(self.engine.block_manager, "num_blocks", 0) - 1
        )

    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True, name="engine")
        self._thread.start()
        self._resp_thread = threading.Thread(
            target=self._response_loop, daemon=True, name="responses"
        )
        self._resp_thread.start()

    def stop(self) -> None:
        self._stopped.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._resp_q.put(None)  # sentinel
        if self._resp_thread is not None:
            self._resp_thread.join(timeout=10)

    @property
    def tokenizer(self):
        return self.engine.tokenizer

    # ------------------------------------------------------------------
    async def generate(
        self,
        prompt: str | None = None,
        prompt_token_ids: list[int] | None = None,
        sampling_params: SamplingParams | None = None,
        request_id: str | None = None,
        embed: bool = False,
        priority: int = 0,
        offline: bool = False,
        images: list | None = None,
        videos: list | None = None,
    ):
        """Async generator of cumulative RequestOutputs (last has finished=True)."""
        if self._stopped.is_set():
            raise RuntimeError("engine loop stopped")
        loop = asyncio.get_running_loop()
        stream = _Stream(loop)
        done = loop.create_future()
        self._intake.put(
            ("add", dict(
                prompt=prompt,
                prompt_token_ids=prompt_token_ids,
                sampling_params=sampling_params,
                request_id=request_id,
                embed=embed,
                priority=priority,
                offline=offline,
                images=images,
                videos=videos,
            ), stream, done)
        )
        self._wake.set()
        req_id = await done  # raises on intake error (e.g. overlong prompt)
        finished = False
        try:
            while True:
                out: RequestOutput | Exception = await stream.queue.get()
                if isinstance(out, Exception):
                    finished = True  # engine already dropped the request
                    raise out
                if stream.first_token_at is None and any(
                    o.token_ids for o in out.outputs
                ):
                    stream.first_token_at = time.monotonic()
                    metrics.TTFT.observe(stream.first_token_at - stream.started_at)
                yield out
                if out.finished:
                    finished = True
                    metrics.REQUEST_LATENCY.observe(
                        time.monotonic() - stream.started_at
                    )
                    return
        finally:
            if not finished:
                # consumer went away mid-generation (client disconnect /
                # task cancellation on ANY endpoint) — stop generating
                # for a dead client and release its KV/slots
                metrics.REQUESTS_RUNNING.dec()
                self.abort(req_id)
            with self._streams_lock:
                self._streams.pop(req_id, None)

    async def call(self, method, *args, **kwargs):
        """Run an engine method on the engine thread (e.g. sample_slots,
        score_prompt) serialized against steps. ``method`` is the engine's
        method name, or a callable that takes the engine first (the
        server's profiler start and stop)."""
        loop = asyncio.get_running_loop()
        done = loop.create_future()
        self._intake.put(("call", (method, args, kwargs, loop), None, done))
        self._wake.set()
        return await done

    def abort(self, request_id: str) -> None:
        self._intake.put(("abort", request_id, None, None))
        self._wake.set()

    # ------------------------------------------------------------------
    def _loop(self) -> None:
        logger.info("engine loop started")
        eng = self.engine
        while not self._stopped.is_set():
            # intake
            drained = 0
            while True:
                try:
                    kind, payload, stream, done = self._intake.get_nowait()
                except _queue.Empty:
                    break
                drained += 1
                if kind == "abort":
                    eng.abort_request(payload)
                    continue
                if kind == "call":
                    # run an engine method on the engine thread (between
                    # steps) and resolve the caller's future
                    method, args, kwargs, loop = payload
                    try:
                        fn = (getattr(eng, method) if isinstance(method, str)
                              else functools.partial(method, eng))
                        result = fn(*args, **kwargs)
                        loop.call_soon_threadsafe(done.set_result, result)
                    except Exception as e:
                        loop.call_soon_threadsafe(done.set_exception, e)
                    continue
                try:
                    req = eng.add_request(**payload)
                    # response-thread detok needs the EXPANDED prompt
                    # (VLM placeholder expansion) and the inline flag
                    stream.prompt_ids = list(
                        req.sequences[0].prompt_token_ids
                    )
                    stream.inline_detok = bool(
                        eng.inline_detok
                        or req.sampling_params.stop
                    )
                    with self._streams_lock:
                        self._streams[req.request_id] = stream
                    metrics.REQUESTS_RUNNING.inc()
                    metrics.PROMPT_TOKENS.inc(len(req.prompt_token_ids))
                    stream.loop.call_soon_threadsafe(
                        done.set_result, req.request_id
                    )
                except Exception as e:
                    stream.loop.call_soon_threadsafe(done.set_exception, e)

            if not eng.has_unfinished():
                self._wake.wait(timeout=0.01)
                self._wake.clear()
                continue

            try:
                with metrics.observe_latency(metrics.SCHEDULE_LATENCY):
                    outputs = eng.step()
            except Exception as e:  # push the failure to every client
                # instead of silently killing the thread — a dead loop
                # leaves every in-flight await hanging forever
                logger.exception("engine step failed; failing %d streams",
                                 len(self._streams))
                with self._streams_lock:
                    streams = list(self._streams.values())
                    self._streams.clear()
                for stream in streams:
                    try:
                        stream.push(e)
                    except Exception:  # pragma: no cover
                        pass
                self._stopped.set()
                break
            metrics.ENGINE_STEPS.inc()
            metrics.KV_BLOCKS_USED.set(eng.block_manager.num_used_blocks)
            if outputs:
                # hand off to the response thread; the step loop never
                # detokenizes or touches asyncio machinery
                self._resp_q.put(outputs)
        logger.info("engine loop stopped")

    def _response_loop(self) -> None:
        """Detok + stream push off the step loop."""
        from xllm_tpu_torch.framework.tokenizer import IncrementalDecoder

        tok = self.engine.tokenizer
        decoders: dict[tuple, object] = {}
        texts: dict[tuple, str] = {}
        while True:
            outputs = self._resp_q.get()
            if outputs is None:
                break
            for ro in outputs:
                with self._streams_lock:
                    stream = self._streams.get(ro.request_id)
                if stream is None:
                    # consumer went away (abort/disconnect): drop any
                    # detok state so aborted requests cannot leak it
                    for o in ro.outputs:
                        decoders.pop((ro.request_id, o.index), None)
                        texts.pop((ro.request_id, o.index), None)
                if stream is not None and tok is not None and not (
                    stream.inline_detok
                ):
                    pids = stream.prompt_ids or []
                    for o in ro.outputs:
                        key = (ro.request_id, o.index)
                        dec = decoders.get(key)
                        if dec is None:
                            dec = IncrementalDecoder(tok, len(pids))
                            decoders[key] = dec
                            texts[key] = ""
                        delta = dec.decode_new(pids + list(o.token_ids))
                        if delta:
                            texts[key] += delta
                        o.text = texts[key]
                if ro.finished:
                    for o in ro.outputs:
                        decoders.pop((ro.request_id, o.index), None)
                        texts.pop((ro.request_id, o.index), None)
                    metrics.REQUESTS_RUNNING.dec()
                    if ro.usage:
                        metrics.GENERATED_TOKENS.inc(
                            ro.usage["completion_tokens"]
                        )
                if stream is not None:
                    stream.push(ro)
        logger.info("response loop stopped")
