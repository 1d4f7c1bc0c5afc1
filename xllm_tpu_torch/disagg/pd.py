"""Disaggregated prefill/decode serving. A port of ``xllm_tpu/disagg/pd.py``.

Counterpart of the reference's PD disaggregation stack
(reference xllm/core/scheduler/disagg_pd_scheduler.h:37-100 dispatch /
first-generation handoff, disagg_pd_service_impl.cpp, and the Mooncake /
LlmDataDist KV movement, SURVEY.md §3.4). KV blocks stage through pinned
host memory and move between instances over HTTP (in-process for
colocated runs).

Flow (PUSH-style):
    prefill instance: run prompt -> first token; extract the sequence's KV
    blocks to host; serialize {tokens, sampling params, first token, KV}
    decode instance: allocate blocks, inject KV into its paged cache,
    install the request mid-flight (sample-then-compute invariant holds:
    the first token's KV is NOT yet computed) and continue decoding.

The wire is the JAX package's npz, byte for byte, so JAX and CUDA nodes
interoperate: bf16 and e4m3 blocks ship as uint16 / uint8 views beside
their dtype names, and ``sampling_params`` as ``dataclasses.asdict``. The
handoff carries no KV scales: both nodes of an int8 / fp8 cache must run
the same ``cache.kv_scale_k`` / ``kv_scale_v``.
"""

from __future__ import annotations

import dataclasses
import io
import json
import uuid
from dataclasses import dataclass

import numpy as np
import torch

from xllm_tpu_torch.engine import LLMEngine
from xllm_tpu_torch.framework.request import Request, RequestOutput, SequenceStatus
from xllm_tpu_torch.framework.sampling_params import SamplingParams

# dtypes that npz cannot carry, shipped as a same-width unsigned view:
# name -> (torch dtype, torch / numpy signed view, numpy unsigned view)
_VIEWED = {"bfloat16": (torch.bfloat16, torch.int16, np.int16, np.uint16),
           "float8_e4m3fn": (torch.float8_e4m3fn, torch.int8, np.int8, np.uint8)}


@dataclass
class PrefillHandoff:
    """The wire payload prefill -> decode (reference disagg_pd.proto)."""

    request_id: str
    prompt_token_ids: list[int]
    first_token: int
    sampling_params: SamplingParams
    k_blocks: torch.Tensor  # [n_blocks, L, Hkv, bs, D], on the host
    v_blocks: torch.Tensor
    # the sending engine's CacheConfig.kv_layout: page CONTENT is a
    # layout convention (interleaved_rm tail pages are token-major), so
    # the receiver must verify compatibility, not assume it
    kv_layout: str = "split"

    @staticmethod
    def _wire(t: torch.Tensor) -> tuple[np.ndarray, str]:
        """-> (numpy array npz can write, dtype name): bf16 / e4m3 as their
        uint16 / uint8 bits."""
        name = str(t.dtype).removeprefix("torch.")  # numpy's / ml_dtypes' name
        t = t.detach().cpu().contiguous()
        if name in _VIEWED:
            _, t_signed, _, np_unsigned = _VIEWED[name]
            return t.view(t_signed).numpy().view(np_unsigned), name
        return t.numpy(), name

    @staticmethod
    def _unwire(a: np.ndarray, name: str) -> torch.Tensor:
        """The receive-side re-view, through torch (no ml_dtypes)."""
        if a.dtype.name != name:
            dtype, _, np_signed, _ = _VIEWED[name]
            return torch.from_numpy(a.view(np_signed)).view(dtype)
        return torch.from_numpy(a)

    def to_bytes(self) -> bytes:
        """npz serialization — the wire format."""
        buf = io.BytesIO()
        k, k_dt = self._wire(self.k_blocks)
        v, v_dt = self._wire(self.v_blocks)
        meta = json.dumps(
            {
                "request_id": self.request_id,
                "prompt_token_ids": self.prompt_token_ids,
                "first_token": self.first_token,
                "sampling_params": dataclasses.asdict(self.sampling_params),
                "k_dtype": k_dt,
                "v_dtype": v_dt,
                "kv_layout": self.kv_layout,
            }
        )
        np.savez(buf, meta=np.frombuffer(meta.encode(), np.uint8), k=k, v=v)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "PrefillHandoff":
        z = np.load(io.BytesIO(raw))
        meta = json.loads(bytes(z["meta"]).decode())
        return cls(
            request_id=meta["request_id"],
            prompt_token_ids=meta["prompt_token_ids"],
            first_token=meta["first_token"],
            sampling_params=SamplingParams(**meta["sampling_params"]),
            k_blocks=cls._unwire(z["k"], meta.get("k_dtype", z["k"].dtype.name)),
            v_blocks=cls._unwire(z["v"], meta.get("v_dtype", z["v"].dtype.name)),
            kv_layout=meta.get("kv_layout", "split"),
        )


class PrefillInstance:
    """Prefill-role engine: prompt -> first token + KV extraction."""

    def __init__(self, engine: LLMEngine):
        self.engine = engine
        # overlap off: the handoff needs the first token synchronously
        self.engine.overlap_depth = 0

    def prefill(
        self,
        prompt_token_ids: list[int],
        sampling_params: SamplingParams,
        request_id: str | None = None,
    ) -> PrefillHandoff:
        eng = self.engine
        request_id = request_id or f"pd-{uuid.uuid4().hex[:16]}"
        sp = sampling_params
        req = eng.add_request(
            prompt_token_ids=list(prompt_token_ids),
            sampling_params=sp,
            request_id=request_id,
        )
        seq = req.sequences[0]
        # run steps until the first token is fixed on host
        guard = 0
        while seq.num_fixed_tokens <= seq.num_prompt_tokens:
            eng.step()
            guard += 1
            if guard > 10000:
                raise RuntimeError("prefill did not produce a first token")
        first_token = seq.token_ids[seq.num_prompt_tokens]
        k, v = eng.runner.extract_blocks(seq.block_ids)
        handoff = PrefillHandoff(
            request_id=request_id,
            prompt_token_ids=list(prompt_token_ids),
            first_token=int(first_token),
            sampling_params=sp,
            k_blocks=k,
            v_blocks=v,
            # JAX's blocking path leaves the default ("split") here, so a
            # split decode node would take an interleaved node's pages
            kv_layout=eng.config.cache.kv_layout,
        )
        eng.abort_request(request_id)  # frees prefill-side blocks
        # drain bookkeeping
        while eng.has_unfinished():
            eng.step()
        return handoff


class AsyncPrefillInstance:
    """Non-blocking prefill node: a queue of in-flight prompts sharing the
    continuous-batching engine, each handed off as soon as its first token
    lands (reference DisaggPDScheduler dispatch queues,
    disagg_pd_scheduler.h:37-100 — the engine loop never stalls on one
    request, and KV extraction overlaps serving via the async gather).
    """

    def __init__(self, engine: LLMEngine):
        self.engine = engine
        self.engine.overlap_depth = 0  # first token must land promptly
        # request_id -> (Request, on_ready callback)
        self._inflight: dict[str, tuple] = {}
        # request_id -> (parts, meta) awaiting host copies; parts is a list
        # of (copy_k, copy_v, n) covering the sequence's pages in order
        self._extracting: dict[str, tuple] = {}
        # chunk-overlapped extraction state: request_id -> list of
        # (copy_k, copy_v, n) for pages already pushed
        self._partial: dict[str, list] = {}
        # request_id -> block ids recorded at partial-extraction time
        # (preemption guard: RECOMPUTE reallocates blocks)
        self._partial_ids: dict[str, list[int]] = {}

    def submit(
        self,
        prompt_token_ids: list[int],
        sampling_params: SamplingParams,
        on_ready,
        request_id: str | None = None,
        offline: bool = False,
    ) -> str:
        request_id = request_id or f"pd-{uuid.uuid4().hex[:16]}"
        req = self.engine.add_request(
            prompt_token_ids=list(prompt_token_ids),
            sampling_params=sampling_params,
            request_id=request_id,
            offline=offline,
        )
        self._inflight[request_id] = (req, on_ready)
        return request_id

    @property
    def busy(self) -> bool:
        return bool(self._inflight) or bool(self._extracting)

    def pump(self) -> None:
        """One engine step + handoff any requests whose first token landed.

        Chunk-overlapped extraction: as prefill chunks complete, fully
        written pages start their copy to the host WHILE later chunks still
        compute (the reference's layer-wise KV push during the forward,
        llm_worker_impl.cpp:223-247). By first-token time only the tail
        page remains to transfer.
        """
        eng = self.engine
        bs = eng.config.cache.block_size
        if eng.has_unfinished():
            eng.step()
        for rid in list(self._inflight):
            req, cb = self._inflight[rid]
            seq = req.sequences[0]
            done_ids = self._partial_ids.get(rid, [])
            if seq.block_ids[: len(done_ids)] != done_ids:
                # preempted (RECOMPUTE) since the last pump: the extracted
                # pages belong to reallocated blocks — restart from scratch
                self._partial.pop(rid, None)
                self._partial_ids.pop(rid, None)
                done_ids = []
            if seq.num_fixed_tokens <= seq.num_prompt_tokens:
                # mid-prefill: pages fully below the computed frontier are
                # final (chunks start page-aligned; only the tail page sees
                # later RMW writes) — push them now, overlapped with compute
                done = min(seq.num_computed_tokens,
                           seq.num_prompt_tokens) // bs
                if done > len(done_ids):
                    new_ids = seq.block_ids[len(done_ids):done]
                    k, v, n = eng.runner.extract_blocks_async(new_ids)
                    self._partial.setdefault(rid, []).append((k, v, n))
                    self._partial_ids[rid] = seq.block_ids[:done]
                continue
            # first token fixed: extract the remaining (tail) pages only
            n_kv_blocks = -(-seq.num_prompt_tokens // bs)
            parts = self._partial.pop(rid, [])
            self._partial_ids.pop(rid, None)
            tail_ids = seq.block_ids[len(done_ids):n_kv_blocks]
            if tail_ids:
                parts.append(eng.runner.extract_blocks_async(tail_ids))
            first = seq.token_ids[seq.num_prompt_tokens]
            meta = (list(seq.prompt_token_ids), int(first),
                    seq.sampling_params, cb)
            self._extracting[rid] = (parts, meta)
            del self._inflight[rid]
            eng.abort_request(rid)  # prefill-side blocks free after gather
        for rid in list(self._extracting):
            parts, (prompt, first, sp, cb) = self._extracting[rid]
            # materialize (the async copies have been landing during serving)
            k_blocks = torch.cat([k.wait()[:n] for k, _, n in parts])
            v_blocks = torch.cat([v.wait()[:n] for _, v, n in parts])
            del self._extracting[rid]
            cb(PrefillHandoff(
                request_id=rid,
                prompt_token_ids=prompt,
                first_token=first,
                sampling_params=sp,
                k_blocks=k_blocks,
                v_blocks=v_blocks,
                kv_layout=eng.config.cache.kv_layout,
            ))


class DecodeInstance:
    """Decode-role engine: accepts handoffs and continues generation."""

    def __init__(self, engine: LLMEngine):
        self.engine = engine

    @staticmethod
    def _rechunk_blocks(blocks: torch.Tensor, decode_bs: int) -> torch.Tensor:
        """Prefill-node pages -> decode-node pages (cross-page-size PD).

        Prefill nodes may run bigger pages than decode; each wire block
        splits along its token axis into ratio decode blocks. Requires
        canonical page content (split/interleaved layouts; a row-major-tail
        prefill node would need convention conversion).
        Token axis: [n, L, Hkv, bs, D] -> 3; [n, L, 2, Hkv, bs, D] -> 4.
        """
        tok_ax = blocks.ndim - 2
        pbs = blocks.shape[tok_ax]
        if pbs == decode_bs:
            return blocks
        if pbs % decode_bs != 0:
            raise ValueError(
                f"prefill page {pbs} must be a multiple of decode page "
                f"{decode_bs}"
            )
        r = pbs // decode_bs
        n = blocks.shape[0]
        mid = tuple(blocks.shape[1:tok_ax])
        split = blocks.reshape((n,) + mid + (r, decode_bs, blocks.shape[-1]))
        # the r sub-pages become consecutive decode blocks
        order = (0, tok_ax) + tuple(range(1, tok_ax)) + (tok_ax + 1, tok_ax + 2)
        return split.permute(order).contiguous().reshape(
            (n * r,) + mid + (decode_bs, blocks.shape[-1]))

    def accept(self, handoff: PrefillHandoff) -> Request:
        """Install a prefilled request (reference decode_recv_first_generation
        + allocate path, disagg_pd_scheduler.h:65-80)."""
        eng = self.engine
        dbs = eng.config.cache.block_size
        my_layout = eng.config.cache.kv_layout
        if handoff.kv_layout != my_layout:
            # page CONTENT follows the layout convention — installing
            # blocks under a different convention corrupts silently
            raise ValueError(
                f"PD kv_layout mismatch: prefill node sent "
                f"{handoff.kv_layout!r}, decode node runs {my_layout!r}"
            )
        tok_ax = handoff.k_blocks.ndim - 2
        if (
            handoff.k_blocks.shape[tok_ax] != dbs
            and my_layout == "interleaved_rm"
        ):
            # a row-major tail page's token-major content cannot be
            # split along the canonical token axis
            raise ValueError(
                "cross-page-size PD requires canonical page content "
                "(kv_layout split/interleaved), not interleaved_rm"
            )
        handoff.k_blocks = self._rechunk_blocks(handoff.k_blocks, dbs)
        if handoff.v_blocks.ndim >= 5:  # MLA's dummy slot passes through
            handoff.v_blocks = self._rechunk_blocks(handoff.v_blocks, dbs)
        # capacity gate BEFORE any state mutates: the ring-slot pool and
        # decode batch are sized to max_seqs_per_batch — overfilling
        # would underflow _free_slots after the KV was already injected
        # (a corrupt half-installed request)
        if (
            not eng._free_slots
            or eng.scheduler.num_running_seqs
            >= eng.config.scheduler.max_seqs_per_batch
        ):
            raise RuntimeError("decode instance at capacity; retry later")
        req = Request(
            request_id=handoff.request_id,
            prompt_token_ids=handoff.prompt_token_ids,
            sampling_params=handoff.sampling_params,
            eos_token_ids=tuple(eng.config.model.eos_token_ids),
            max_model_len=eng.config.scheduler.max_model_len,
        )
        seq = req.sequences[0]
        n_prompt = len(handoff.prompt_token_ids)
        if not eng.block_manager.allocate(seq, n_prompt):
            raise RuntimeError("decode instance out of KV blocks")
        # a big-page prefill node may ship MORE page slots than the
        # decode side needs (its last page covers tokens past the
        # prompt); inject only the blocks that hold needed tokens
        n_needed = min(handoff.k_blocks.shape[0], len(seq.block_ids))
        eng.runner.inject_blocks(
            handoff.k_blocks[:n_needed],
            handoff.v_blocks[:n_needed]
            if handoff.v_blocks.ndim >= 5 else handoff.v_blocks,
            seq.block_ids[:n_needed],
        )
        # first token appended; its KV computes on the first decode step
        seq.num_computed_tokens = n_prompt
        seq.append_token(handoff.first_token)
        seq.status = SequenceStatus.RUNNING
        if seq.maybe_finish(
            handoff.first_token, eng.config.scheduler.max_model_len
        ):
            eng.block_manager.free(seq)
            return req
        # seed the device token ring so the first decode reads it
        eng._assign_slot(seq)
        eng.runner.seed_last_token(seq.slot_id, handoff.first_token)
        eng.scheduler.running.append(req)
        eng._active_requests[req.request_id] = req
        if eng.tokenizer is not None:
            from xllm_tpu_torch.framework.tokenizer import IncrementalDecoder

            eng._decoders[seq.seq_id] = IncrementalDecoder(
                eng.tokenizer, seq.num_prompt_tokens
            )
        return req


class PDOrchestrator:
    """Colocated router for tests / single-host PD: prefill -> decode.

    The production path puts PrefillInstance and DecodeInstance in
    different processes with `PrefillHandoff.to_bytes()` over HTTP
    (``disagg/service.py``); the orchestration logic is identical.
    """

    def __init__(self, prefill: PrefillInstance, decode: DecodeInstance):
        self.prefill = prefill
        self.decode = decode

    def generate(
        self,
        prompt_token_ids: list[int],
        sampling_params: SamplingParams,
    ) -> RequestOutput:
        handoff = self.prefill.prefill(prompt_token_ids, sampling_params)
        # wire round-trip (serialize/deserialize) to exercise the format
        handoff = PrefillHandoff.from_bytes(handoff.to_bytes())
        req = self.decode.accept(handoff)
        eng = self.decode.engine
        if req.is_finished:  # first token was already a stop
            return RequestOutput(
                request_id=req.request_id,
                prompt="",
                finished=True,
                outputs=[],
            )
        final = None
        while eng.has_unfinished():
            for ro in eng.step():
                if ro.request_id == req.request_id and ro.finished:
                    final = ro
        assert final is not None
        return final
