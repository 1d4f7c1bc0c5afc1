"""Device execution: forward steps + sampling, eagerly in PyTorch.

Counterpart of the subset of ``xllm_tpu/runtime/model_runner.py`` that
serves the dense, MoE, MLA and hybrid (qwen3-next) main paths on one device: ``load_model``, ``initialize_kv_cache``,
``run_prefill_batched`` and ``run_decode``, the single-chunk passes of
prompt scoring (``run_score_chunk``) and embeddings (``run_prefill_embed``),
speculative decoding's batched verify passes (``run_verify_batched``
for the suffix / ngram drafts, ``run_verify_mtp`` for the MTP / Eagle3
draft head, whose drafts never leave the device) and multi-position
sampling (``run_sample_slots``), all of which read their result back
synchronously, as the JAX runner does. The device-resident
``last_tokens`` ring (each slot holds its sequence's last sampled token, so
the next decode reads it without a host round trip) and the ``token_hist``
ring (the sampler's penalty history) are kept. There is no jit, no warmup
and no mesh: each step runs eagerly, and its numpy inputs reach the card in
one non-blocking copy from pinned memory (``_upload``). The KV caches are
updated in place.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from xllm_tpu_torch.config import EngineConfig
from xllm_tpu_torch.framework.request import Sequence
from xllm_tpu_torch.models.registry import (
    HYBRID_FAMILIES,
    MLA_FAMILIES,
    MOE_FAMILIES,
    create_model,
)
from xllm_tpu_torch.ops.norms import rms_norm
from xllm_tpu_torch.ops.quant import quant_eligible
from xllm_tpu_torch.runtime.forward_params import (
    BatchedPrefillInput,
    DecodeInput,
    PrefillInput,
    SamplingInput,
)
from xllm_tpu_torch.runtime.input_builder import (
    DecodeStepCache,
    build_batched_prefill_input,
    build_batched_verify_input,
    build_decode_input,
    build_prefill_input,
    build_sampling_input,
)
from xllm_tpu_torch.runtime.rejection_sampler import rejection_sample
from xllm_tpu_torch.runtime.sampler import gumbel_noise, sample
from xllm_tpu_torch.utils import cdiv, get_logger, next_bucket

logger = get_logger(__name__)

_PRUNE_K = 64  # sampler candidate set (runtime/sampler.py)
# SamplingInput fields that travel to the device with each step's inputs
_SAMPLING_FIELDS = ("temperature", "top_k", "top_p", "repetition_penalty",
                    "frequency_penalty", "presence_penalty", "hist_len")


def resolve_device(device) -> torch.device:
    """The entry points run on the card unless the caller asks for the
    CPU; they never fall back to it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "xllm_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def reject_unported(config: EngineConfig) -> None:
    """Knobs whose code paths are not ported yet raise instead of
    degrading quietly."""
    c = config
    if c.cache.kv_layout not in ("split", "interleaved", "interleaved_rm"):
        raise ValueError(
            f"kv_layout={c.cache.kv_layout!r}: one of split, interleaved, interleaved_rm"
        )
    if c.quant.method not in ("", "int8", "fp8_e4m3"):
        raise ValueError(f"quant.method={c.quant.method!r}: one of '', int8, fp8_e4m3")
    p = c.parallel
    if max(p.dp_size, p.tp_size, p.cp_size, p.ep_size, p.num_nodes) > 1:
        raise NotImplementedError("parallelism (dp/tp/cp/ep, multi-node) is not ported yet")
    if c.eplb.enable_eplb or c.eplb.redundant_experts > 0:
        raise NotImplementedError("EPLB and redundant experts are not ported yet")
    if c.cache.block_backend == "native":
        raise NotImplementedError("the native block manager is not ported yet")
    if c.model.vision:
        raise NotImplementedError("VLM families are not ported yet")
    moe = MOE_FAMILIES + MLA_FAMILIES + HYBRID_FAMILIES
    if c.model.num_experts > 0 and c.model.model_type not in moe:
        raise NotImplementedError(
            f"MoE family {c.model.model_type!r} is not ported yet; ported: {moe}")


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` viewed as integers of its width: the block gathers and scatters
    move bytes, whatever the cache's dtype (fp8 included)."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


class HostStream:
    """The device's stream as the host-memory copies see it: ``run`` queues
    copies (on the card they run in stream order, after every pass queued
    before them, while the host goes on), ``event`` marks the point
    reached, and ``event.synchronize()`` waits for it. On the CPU both are
    immediate (``event`` is None). ``tests/test_torch_kv_tiers.py`` puts a
    deferred model of the card's stream in its place."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def run(self, fn) -> None:
        fn()

    def event(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev


class BlockCopy:
    """A gather of KV blocks on its way into pinned host memory
    (``ModelRunner.extract_blocks_async``); ``wait()`` returns the host
    tensor once its copy has landed, by waiting on the copy's event."""

    def __init__(self, host: torch.Tensor, event=None):
        self.host = host
        self.event = event

    def wait(self) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        return self.host


class ModelRunner:
    def __init__(self, config: EngineConfig, device="cuda"):
        reject_unported(config)
        self.config = config
        self.device = resolve_device(device)
        self.model = create_model(config.model, device=self.device,
                                  quant=config.quant.method)
        self.weights_loaded = False
        self.k_cache = None
        self.v_cache = None
        self.num_blocks = 0
        self.block_size = config.cache.block_size
        self.max_blocks_per_seq = cdiv(
            config.scheduler.max_model_len, self.block_size
        )
        # last_tokens ring: one slot per live sequence plus the slack for
        # finished sequences whose fixups are still in flight; the extra
        # trash slot absorbs padded rows
        self.max_slots = (
            config.scheduler.max_seqs_per_batch
            + 2 * max(config.scheduler.overlap_depth, 1)
        )
        self.trash_slot = self.max_slots
        # decode block-table column buckets (tables track live context)
        self.nb_buckets = []
        nb = 4
        while nb < self.max_blocks_per_seq:
            self.nb_buckets.append(nb)
            nb *= 2
        self.nb_buckets.append(self.max_blocks_per_seq)
        # incremental decode-input assembly; off, as in JAX, under a sliding
        # window (it may repoint table entries at the null block without
        # changing their count) and with the host KV tier
        self._decode_cache = (
            None if config.model.sliding_window or config.cache.num_host_blocks > 0
            else DecodeStepCache()
        )
        # unseeded sampling rows draw their noise from this stream
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(config.seed)
        self.last_tokens = None
        self.token_hist = None
        # host KV tier (``init_host_kv``): pinned slots, and the stream its
        # copies are queued on
        self.host_k = self.host_v = None
        self.host_stream = HostStream(self.device)
        # model-based speculative decoding (MTP / Eagle3): a draft head
        # sharing the target's embedding and lm_head, its own one-layer
        # cache, and a ring of each slot's last pre-norm hidden state
        self.draft_head = None
        self.dk_cache = self.dv_cache = self.hidden_ring = None
        if config.speculative.method in ("mtp", "eagle3"):
            from xllm_tpu_torch.models.mtp_head import MTPHead

            self.draft_head = MTPHead(config.model, self.model)

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def load_model(self, params: dict | None = None, seed: int | None = None,
                   head_params: dict | None = None) -> None:
        """Load weights: a JAX-layout parameter tree (``weights.py``), the
        HF checkpoint at ``model.model_path`` (``_load_checkpoint``; not
        under ``load_format="dummy"``), or a random init from ``seed``
        (default ``config.seed``). With ``quant.method`` set, a
        full-precision tree is quantized first, as the JAX runner does; a
        tree that is already quantized (int8 / float8_e4m3fn stacks with
        their ``*_scale``) is carried as it is. An MTP / Eagle3 engine's
        draft head loads ``head_params`` (the JAX head's tree), else a
        random init from ``config.seed + 1`` over which a
        ``speculative.draft_model_path`` checkpoint loads, best effort
        (``loader.load_mtp_head``)."""
        if params is not None:
            from xllm_tpu_torch.weights import load_param_tree

            if self.config.quant.method:
                params = self._quantize_params(params)
            load_param_tree(self.model, params)
        elif self.config.model.model_path and self.config.load_format != "dummy":
            self._load_checkpoint()
        else:
            logger.info("no model_path: initializing random weights")
            self.model.init_random_(self.config.seed if seed is None else seed)
        self.weights_loaded = True
        self.last_tokens = torch.zeros(
            self.max_slots + 1, dtype=torch.int32, device=self.device
        )
        hist_cols = -(-self.config.scheduler.max_model_len // 128) * 128
        self.token_hist = torch.zeros(
            (self.max_slots + 1, hist_cols), dtype=torch.int32, device=self.device
        )
        if self.draft_head is not None:
            if head_params is not None:
                from xllm_tpu_torch.weights import load_mtp_head_params

                load_mtp_head_params(self.draft_head, head_params)
            else:
                self.draft_head.init_random_(self.config.seed + 1)
                if self.config.speculative.draft_model_path:
                    from xllm_tpu_torch.models.loader import load_mtp_head

                    load_mtp_head(self.draft_head, self.config.speculative.draft_model_path,
                                  self.config.model)
            self.hidden_ring = torch.zeros(
                (self.max_slots + 1, self.config.model.hidden_size),
                dtype=self.model.dtype, device=self.device,
            )

    @torch.no_grad()
    def _load_checkpoint(self) -> None:
        """Stream the HF checkpoint at ``model.model_path`` into the model's
        parameters (``models/loader.py``): the tensors outside the layers a
        64 MB chunk at a time, then each stack one layer's slice at a time,
        uploaded in the checkpoint's dtype, cast to the model dtype on the
        device and copied into its layer, then freed. With ``quant.method``
        set, each eligible slice is quantized on the device as it lands (the
        JAX ``_rolling_quantize_transform``, a layer or an expert in place
        of a stack: the scales are per layer and per expert, so the bytes
        are those of the two-phase ``_quantize_params``), and the
        full-precision model never sits on the device: the load's extra
        device memory is one layer's slice and its quantizer's temporaries.
        Every parameter of every layer must be written once."""
        from xllm_tpu_torch.models import loader
        from xllm_tpu_torch.weights import layer_groups, put_param

        cfg, model, method = self.config.model, self.model, self.config.quant.method
        if getattr(model, "is_hybrid", False):
            # the JAX family loader: the whole tree on the host, then the
            # runner's catch-all quantizer, as the JAX runner does
            from xllm_tpu_torch.weights import load_param_tree

            tree = loader.load_qwen3_next_params(cfg, model.dtype, "cpu")
            load_param_tree(model, self._quantize_params(tree) if method else tree)
            return
        groups = layer_groups(model)
        written: dict[str, set] = {g: set() for g in groups}
        t0 = time.perf_counter()
        with loader.SafetensorsReader(cfg.model_path) as reader:
            ts = loader.Tensors(reader, self.device)
            for name, hf, transpose in loader.top_level(cfg):
                loader.copy_rows(getattr(model, name), ts.host(hf), transpose)
            for group, name, i, w in loader.layer_slices(cfg, ts):
                if name != "expert_placement":  # the identity: EPLB is not ported
                    layer = groups[group][i]
                    w = loader.cast(w, model.dtype)
                    if method and self.quant_eligible(name, method):
                        self._quantize_into(layer, name, w)
                        written[group].add(name + "_scale")
                    else:
                        put_param(getattr(layer, name), w)
                    written[group].add(name)
                del w  # freed before the next slice lands
        for group, names in written.items():
            want = {n for n, _ in groups[group][0].named_parameters()}
            if names != want:
                raise ValueError(f"{cfg.model_path}: {group} loaded {sorted(names)}, the "
                                 f"model has {sorted(want)}")
        logger.info("loaded %s in %.2f s%s", cfg.model_path, time.perf_counter() - t0,
                    f" ({method} as it landed)" if method else "")

    def _quantize_into(self, layer, name: str, w: torch.Tensor) -> None:
        """``layer.<name>`` and ``<name>_scale`` <- ``w`` quantized one
        ``[K, N]`` matrix at a time (an expert stack's scales are per
        expert), so that the quantizer's temporaries stay a matrix's."""
        from xllm_tpu_torch.ops.quant import QUANTIZERS
        from xllm_tpu_torch.weights import put_param

        param, scale = getattr(layer, name), getattr(layer, name + "_scale")
        if w.shape != param.shape:
            raise ValueError(f"{name}: shape {tuple(w.shape)} does not fit {tuple(param.shape)}")
        mats = w.reshape(-1, *w.shape[-2:])
        param, scale = param.view(mats.shape), scale.view(-1, scale.shape[-1])
        for j in range(mats.shape[0]):
            codes, s = QUANTIZERS[self.config.quant.method](mats[j])
            put_param(param[j], codes)
            put_param(scale[j], s)

    quant_eligible = staticmethod(quant_eligible)

    def _quantize_params(self, params: dict) -> dict:
        """Quantize every eligible bf16 / f32 stack of a JAX-layout tree
        with ``ops.quant`` (the JAX ``_quantize_params``: same eligibility,
        same bytes). Embeddings, lm_head, norms, routers and the MLA
        ``kv_b_*`` stacks stay as they are; stacks already quantized are
        kept."""
        from xllm_tpu_torch.ops.quant import QUANTIZERS
        from xllm_tpu_torch.weights import as_tensor

        method = self.config.quant.method
        quantize = QUANTIZERS[method]
        out = dict(params)
        for group_name, group in params.items():
            if not isinstance(group, dict):
                continue
            new_group = dict(group)
            for name, w in group.items():
                if not self.quant_eligible(name, method):
                    continue
                w = as_tensor(w)
                if w.dtype not in (torch.bfloat16, torch.float32):
                    continue
                new_group[name], new_group[name + "_scale"] = quantize(w)
            out[group_name] = new_group
        return out

    def set_kv_scales(self, s_k, s_v) -> None:
        """Install calibrated int8-KV scales (``ops.quant.calibrate_kv_scales``)."""
        if self.k_cache is not None and self.k_cache.dtype != torch.int8:
            raise ValueError("set_kv_scales applies to int8-KV engines")
        self.model.set_kv_scales(s_k, s_v)

    def initialize_kv_cache(self, num_blocks: int | None = None) -> int:
        """Allocate the paged pool; returns num_blocks."""
        self.num_blocks = num_blocks or self._derive_num_blocks()
        kv_dtype = self._resolve_kv_dtype()
        if kv_dtype == torch.int8 and not self.model.supports_int8_kv:
            raise NotImplementedError(
                "int8 KV needs the GQA decoder's scale folding; this family "
                "lacks it (MLA uses its own fp8 latent cache)"
            )
        if kv_dtype == torch.int8 and self.model.kv_scales is None:
            cc = self.config.cache
            self.model.set_kv_scales(cc.kv_scale_k, cc.kv_scale_v)
        self.model.kv_layout = self.resolve_kv_layout(kv_dtype)
        # the hybrid family's linear-state rows: one a slot, and the trash row
        self.model.num_state_slots = self.max_slots
        self.k_cache, self.v_cache = self.model.new_kv_cache(
            self.num_blocks, self.block_size, kv_dtype
        )
        if self.draft_head is not None:
            self.dk_cache, self.dv_cache = self.draft_head.new_kv_cache(
                self.num_blocks, self.block_size
            )
        logger.info(
            "KV cache: %d blocks x %d tokens (%s, %s, %s layout)",
            self.num_blocks, self.block_size, kv_dtype, self.device, self.model.kv_layout,
        )
        return self.num_blocks

    def resolve_kv_layout(self, kv_dtype: torch.dtype) -> str:
        """The cache layout served for ``cache.kv_layout``, by the JAX
        runner's rules: a family without ``supports_interleaved_kv`` (MLA)
        keeps split, with a warning; ``interleaved_rm`` becomes plain
        ``interleaved`` for an int8 cache, or when ``2 * Hkv`` is not a
        multiple of 16 or does not divide ``block_size`` (its token-major
        row of ``[2 * Hkv, D]`` must tile the TPU page). The port's kernels
        have no such tile rule; the rules stay because the layout decides
        the cache's bytes, which another JAX or CUDA node may read. A
        speculative engine serves ``interleaved`` for ``interleaved_rm``:
        its verify chunks write rows past the sequence's true length, and a
        rejected draft would leave a page canonical too early."""
        layout = self.config.cache.kv_layout
        if not layout.startswith("interleaved"):
            return layout
        if not self.model.supports_interleaved_kv:
            logger.warning("kv_layout=%s unsupported for %s; using split", layout,
                           type(self.model).__name__)
            return "split"
        if layout == "interleaved_rm" and self.config.speculative.method:
            logger.info("kv_layout=interleaved_rm under speculative decoding; using "
                        "interleaved")
            return "interleaved"
        two_h = 2 * self.config.model.num_kv_heads
        if layout == "interleaved_rm" and (
            two_h % 16 or self.block_size % two_h or kv_dtype == torch.int8
        ):
            logger.info("kv_layout=interleaved_rm ineligible (int8 KV or head/page "
                        "tiling); using interleaved")
            return "interleaved"
        return layout

    def _resolve_kv_dtype(self) -> torch.dtype:
        """The cache's storage dtype. int8 holds codes whose per-head scales
        fold outside the kernels; fp8_e4m3 holds the values themselves."""
        name = self.config.cache.kv_cache_dtype
        if name in ("auto", ""):
            return self.model.dtype
        table = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}
        if name not in table:
            raise ValueError(
                f"unsupported kv_cache_dtype {name!r}; one of {sorted(table)}"
            )
        return table[name]

    def _derive_num_blocks(self) -> int:
        cfg = self.config
        if cfg.cache.num_blocks > 0:
            return cfg.cache.num_blocks
        per_block = self.model.kv_bytes_per_token(
            self._resolve_kv_dtype().itemsize
        ) * self.block_size
        if self.device.type != "cuda":
            logger.warning("no device memory to size from; defaulting to 512 KV blocks")
            return 512
        free, total = torch.cuda.mem_get_info(self.device)
        budget = total * cfg.cache.memory_utilization - (total - free)
        if getattr(self.model, "is_hybrid", False):  # the linear state comes first
            self.model.num_state_slots = self.max_slots
            budget -= self.model.state_bytes()
        return max(int(budget // per_block), 16)

    # ------------------------------------------------------------------
    # host -> device
    # ------------------------------------------------------------------
    def _upload(self, arrays: dict) -> dict:
        """numpy arrays -> device tensors of the same shapes and dtypes
        (int32 or float32), in ONE non-blocking copy from pinned memory.
        A 0-d array arrives as a 0-d tensor."""
        if self.device.type == "cpu":
            return {k: torch.from_numpy(np.ascontiguousarray(a).reshape(np.shape(a)))
                    for k, a in arrays.items()}
        flat, meta, off = [], [], 0
        for name, a in arrays.items():
            shape = np.shape(a)
            a = np.ascontiguousarray(a)
            is_float = a.dtype == np.float32
            f = a.view(np.int32) if is_float else a.astype(np.int32, copy=False)
            flat.append(f.ravel())
            meta.append((name, shape, is_float, off, a.size))
            off += a.size
        host = torch.empty(off, dtype=torch.int32, pin_memory=True)
        np.concatenate(flat, out=host.numpy())
        dev = host.to(self.device, non_blocking=True)
        out = {}
        for name, shape, is_float, o, n in meta:
            t = dev[o : o + n]
            out[name] = (t.view(torch.float32) if is_float else t).view(shape)
        return out

    @staticmethod
    def _sampling_arrays(fields: dict) -> dict:
        """The per-row sampling arrays among ``fields``."""
        return {k: fields[k] for k in _SAMPLING_FIELDS}

    def _noise(self, si: SamplingInput, n: int) -> torch.Tensor | None:
        """Gumbel noise for the sampled rows, or None when every row is
        greedy (the sampler then never reads it)."""
        if not np.any(si.temperature > 0):
            return None
        k = min(_PRUNE_K, self.config.model.vocab_size)
        return gumbel_noise(n, k, self._gen, self.device, si.seeds, si.steps)

    # ------------------------------------------------------------------
    # public step API (host numpy in, device tensors out)
    # ------------------------------------------------------------------
    @property
    def supports_batched_prefill(self) -> bool:
        return getattr(self.model, "supports_batched_prefill", False)

    @torch.inference_mode()
    def run_prefill_batched(self, items: list[tuple[Sequence, int]]):
        """Run P prompt chunks in one pass (asynchronous on the card).

        Returns (tokens [P_pad], logprobs [P_pad], samples_flags, rows,
        (top_ids, top_logprobs)) — device tensors for the lagged fixup; row
        i samples a real token iff samples_flags[i].
        """
        sc = self.config.scheduler
        inp_np, samples_flags, rows = build_batched_prefill_input(
            items,
            self.block_size,
            sc.prefill_token_buckets,
            sc.prefill_row_buckets,
            self.max_blocks_per_seq,
            self.trash_slot,
        )
        p_pad = inp_np.kv_lens.shape[0]
        seqs = [seq for seq, _ in items]
        si_np, use_penalties = build_sampling_input(seqs, p_pad, rows, self._gen)
        dev = self._upload({**vars(inp_np), **self._sampling_arrays(vars(si_np))})
        inp = BatchedPrefillInput(**{k: dev[k] for k in vars(inp_np)})
        si = SamplingInput(key=self._gen, **self._sampling_arrays(dev))
        noise = self._noise(si_np, p_pad)

        model = self.model
        head = self.draft_head
        if head is None:
            hidden, _, _ = model.prefill_batched(self.k_cache, self.v_cache, inp)
        else:
            # the draft head advances its cache over the chunk, and each
            # sampling row's last pre-norm state joins the hidden ring
            hidden, _, _, pre = model.prefill_batched(self.k_cache, self.v_cache, inp,
                                                      return_hidden=True)
            head.prefill_batched(self.dk_cache, self.dv_cache, pre, inp)
            last_pre = pre[torch.arange(p_pad, device=pre.device), inp.logits_idx.long()]
            self.hidden_ring[inp.sample_slots.long()] = last_pre
        logits = model.compute_logits(hidden[:, 0])  # [P, V]
        # history ring: each real token at its absolute index; pad columns
        # go to column 0 of the trash row, which no real row reads
        th = self.token_hist
        live = inp.hist_pos < th.shape[1]
        hrow = torch.where(live, inp.hist_slots[:, None], self.trash_slot).long()
        hcol = torch.where(live, inp.hist_pos, 0).long()
        th[hrow, hcol] = inp.token_ids
        hist = th[inp.hist_slots.long()] if use_penalties else None
        num_top = self._num_top(seqs)
        out = sample(logits, si, hist, num_top, self._need_lp(seqs), gumbel=noise)
        tokens, logprobs = out[0], out[1]
        tops = out[2:] if num_top else (None, None)
        self.last_tokens[inp.sample_slots.long()] = tokens
        return tokens, logprobs, samples_flags, rows, tops

    @torch.inference_mode()
    def run_decode(self, seqs: list[Sequence]):
        """One decode token for each running sequence (asynchronous on the
        card). Input tokens come from the last_tokens ring on the device.
        Returns (tokens, logprobs, rows, (top_ids, top_logprobs))."""
        sc = self.config.scheduler
        if self._decode_cache is not None:
            inp_np, rows, si_np, use_penalties = self._decode_cache.build(
                seqs, self.block_size, sc.decode_batch_buckets,
                self.max_blocks_per_seq, self.trash_slot, self.nb_buckets,
                self._gen,
            )
        else:
            inp_np, rows = build_decode_input(
                seqs, self.block_size, sc.decode_batch_buckets,
                self.max_blocks_per_seq, self.trash_slot, self.nb_buckets,
            )
            si_np, use_penalties = build_sampling_input(
                seqs, inp_np.slot_ids.shape[0], rows, self._gen
            )
        b_pad = inp_np.slot_ids.shape[0]
        dev = self._upload({**vars(inp_np), **self._sampling_arrays(vars(si_np))})
        inp = DecodeInput(**{k: dev[k] for k in vars(inp_np)})
        si = SamplingInput(key=self._gen, **self._sampling_arrays(dev))
        noise = self._noise(si_np, b_pad)

        slot_ids = inp.slot_ids.long()
        token_ids = self.last_tokens[slot_ids]
        # record each row's input token (the previous sample) so the
        # history ring holds every position < num_tokens
        self.token_hist[slot_ids, inp.hist_positions.long()] = token_ids
        if self.hidden_ring is None:
            hidden, _, _ = self.model.decode(self.k_cache, self.v_cache, inp, token_ids)
        else:
            hidden, _, _, pre = self.model.decode(self.k_cache, self.v_cache, inp,
                                                  token_ids, return_hidden=True)
            self.hidden_ring[slot_ids] = pre
        logits = self.model.compute_logits(hidden)
        hist = self.token_hist[slot_ids] if use_penalties else None
        num_top = self._num_top(seqs)
        out = sample(logits, si, hist, num_top, self._need_lp(seqs), gumbel=noise)
        tokens, logprobs = out[0], out[1]
        tops = out[2:] if num_top else (None, None)
        self.last_tokens[slot_ids] = tokens
        return tokens, logprobs, rows, tops

    # ------------------------------------------------------------------
    # speculative verify (synchronous: one read-back a dispatch)
    # ------------------------------------------------------------------
    def _verify_input(self, pairs, spec_k: int):
        """The verify chunks of ``pairs`` on the device -> (input, drafts
        [P, k], draft_lens [P], temperature [P], rows, sampled): one copy;
        ``sampled`` is False when every row is greedy."""
        inp_np, drafts, lens, rows = build_batched_verify_input(
            pairs, spec_k, self.block_size, self.config.scheduler.prefill_row_buckets,
            self.max_blocks_per_seq, self.trash_slot,
        )
        temperature = np.zeros(inp_np.kv_lens.shape[0], np.float32)
        for (seq, _), i in zip(pairs, rows):
            temperature[i] = seq.sampling_params.temperature
        fields = {k: v for k, v in vars(inp_np).items() if v is not None}
        dev = self._upload({**fields, "drafts": drafts, "draft_lens": lens,
                            "temperature": temperature})
        inp = BatchedPrefillInput(**{k: dev[k] for k in fields})
        return (inp, dev["drafts"], dev["draft_lens"], dev["temperature"], rows,
                bool(np.any(temperature > 0)))

    def _verify_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        p, n = hidden.shape[:2]
        return self.model.compute_logits(hidden.reshape(p * n, -1)).reshape(p, n, -1)

    @staticmethod
    def _read_back(tokens: torch.Tensor, num_acc: torch.Tensor):
        """-> (tokens [P, k+1], num_accepted [P]) as numpy, in one read."""
        host = torch.cat([tokens, num_acc[:, None]], dim=1).cpu().numpy()
        return host[:, :-1], host[:, -1]

    @torch.inference_mode()
    def run_verify_batched(self, pairs: list[tuple[Sequence, list[int]]], spec_k: int):
        """Verify the host's drafts (suffix / ngram) of every sequence in
        one pass: row i is [last token, drafts...], ``num_logits = k + 1``.
        Returns (tokens [P, k+1], num_accepted [P], rows) on the host."""
        inp, drafts, draft_lens, temperature, rows, sampled = self._verify_input(
            pairs, spec_k)
        hidden, _, _ = self.model.prefill_batched(self.k_cache, self.v_cache, inp,
                                                  num_logits=spec_k + 1)
        logits = self._verify_logits(hidden)
        # only the row's first token (the previous sample) is history yet;
        # accepted drafts are recorded by later steps' inputs
        self.token_hist[inp.hist_slots.long(), inp.positions[:, 0].long()] = inp.token_ids[:, 0]
        tokens, num_acc = rejection_sample(drafts, draft_lens, logits, temperature,
                                           self._gen if sampled else None)
        self._set_last(inp, tokens, num_acc)
        return (*self._read_back(tokens, num_acc), rows)

    @torch.inference_mode()
    def run_verify_mtp(self, seqs: list[Sequence], spec_k: int):
        """Draft (MTP head, k single-token decodes on the device), verify
        and accept in one pass; then the head's cache is rewritten over the
        verify chunk with the emitted tokens. Returns (tokens [P, k+1],
        num_accepted [P], rows) on the host."""
        pairs = [(seq, [0] * spec_k) for seq in seqs]  # the drafts come from the head
        inp, _, _, temperature, rows, sampled = self._verify_input(pairs, spec_k)
        head = self.draft_head
        slots = inp.hist_slots.long()
        last_tok = self.last_tokens[slots]
        seq_base = torch.where(inp.kv_lens > 0, inp.kv_lens - spec_k, 0)  # num_tokens
        drafts = head.draft_tokens(
            self.dk_cache, self.dv_cache, self.hidden_ring[slots], last_tok,
            inp.positions[:, 0], inp.slot_mapping[:, :spec_k], inp.block_tables, seq_base,
            spec_k,
        )
        inp.token_ids = torch.cat([last_tok[:, None], drafts], dim=1)
        hidden, _, _, pre = self.model.prefill_batched(
            self.k_cache, self.v_cache, inp, num_logits=spec_k + 1, return_hidden=True)
        logits = self._verify_logits(hidden)
        draft_lens = torch.where(inp.kv_lens > 0, spec_k, 0)
        tokens, num_acc = rejection_sample(drafts, draft_lens, logits, temperature,
                                           self._gen if sampled else None)
        # the head's rows over the chunk, from the true (hidden_t, token_t+1)
        head.prefill_batched(self.dk_cache, self.dv_cache, pre, inp, tokens_next=tokens)
        self._set_last(inp, tokens, num_acc)
        last = (num_acc - 1).long()
        self.hidden_ring[inp.sample_slots.long()] = pre[
            torch.arange(pre.shape[0], device=pre.device), last]
        self.token_hist[slots, inp.positions[:, 0].long()] = inp.token_ids[:, 0]
        return (*self._read_back(tokens, num_acc), rows)

    @torch.inference_mode()
    def run_sample_slots(
        self,
        seq: Sequence,
        source_rows: np.ndarray,  # [n] prompt rows whose logits to sample
        temperature: float,
        top_k: int,
        top_p: float,
        seed: int,
        num_top: int = 0,
    ):
        """Multi-position sampling over ONE prompt pass (``/v1/sample``):
        the batched prefill with every row's pre-norm state returned, the
        slot rows gathered, then the final norm, the lm_head and the
        sampler on f32 logits. A seed >= 0 draws slot j's noise from the
        sampler's seeded stream at (seed, j); otherwise from the runner's
        generator. Synchronous read-back. -> (tokens [n], logprobs [n],
        top_ids [n, num_top] | None, top_lps [n, num_top] | None)."""
        sc = self.config.scheduler
        inp_np, _, rows = build_batched_prefill_input(
            [(seq, seq.num_tokens)], self.block_size, sc.prefill_token_buckets,
            sc.prefill_row_buckets, self.max_blocks_per_seq, self.trash_slot,
        )
        n = len(source_rows)
        si_np = {"temperature": np.full(n, temperature, np.float32),
                 "top_k": np.full(n, top_k, np.int32),
                 "top_p": np.full(n, top_p, np.float32),
                 "srows": np.asarray(source_rows, np.int32)}
        dev = self._upload({**vars(inp_np), **si_np})
        inp = BatchedPrefillInput(**{k: dev[k] for k in vars(inp_np)})
        si = SamplingInput(key=self._gen,
                           **{k: dev[k] for k in ("temperature", "top_k", "top_p")})
        model = self.model
        _, _, _, pre = model.prefill_batched(self.k_cache, self.v_cache, inp,
                                             return_hidden=True)
        hidden = rms_norm(pre[rows[0]][dev["srows"].long()], model.norm,
                          self.config.model.rms_norm_eps)
        logits = model.compute_logits(hidden).float()
        noise = None
        if temperature > 0:
            k = min(_PRUNE_K, self.config.model.vocab_size)
            noise = gumbel_noise(n, k, self._gen, self.device,
                                 [seed] * n if seed >= 0 else None, range(n))
        out = sample(logits, si, None, num_top, True, gumbel=noise)
        host = [x.cpu().numpy() for x in out]
        if num_top:
            return tuple(host)
        return host[0], host[1], None, None

    def _set_last(self, inp, tokens: torch.Tensor, num_acc: torch.Tensor) -> None:
        """Each row's last emitted token into the last_tokens ring."""
        final = torch.gather(tokens, 1, (num_acc - 1).long()[:, None])[:, 0]
        self.last_tokens[inp.sample_slots.long()] = final

    def _chunk_input(self, seq: Sequence, num_new_tokens: int, **extra):
        """One sequence's next chunk as a device ``PrefillInput`` (and the
        ``extra`` arrays, uploaded with it) -> (input, extra tensors,
        samples_token)."""
        inp_np, samples_token = build_prefill_input(
            seq, num_new_tokens, self.block_size,
            self.config.scheduler.prefill_token_buckets, self.max_blocks_per_seq,
        )
        dev = self._upload({**vars(inp_np), **extra})
        inp = PrefillInput(**{k: dev[k] for k in vars(inp_np)})
        return inp, {k: dev[k] for k in extra}, samples_token

    @torch.inference_mode()
    def run_prefill_embed(self, seq: Sequence, num_new_tokens: int) -> np.ndarray:
        """The final prompt chunk of an embed request -> its pooled hidden
        state: the last token's final-norm hidden state in f32, divided by
        max(its L2 norm, 1e-12). Synchronous read-back."""
        inp, _, samples_token = self._chunk_input(seq, num_new_tokens)
        assert samples_token, "embed must run on the final chunk"
        hidden, _, _ = self.model.prefill(self.k_cache, self.v_cache, inp)
        vec = hidden[0].float()
        vec = vec / torch.clamp(torch.linalg.vector_norm(vec), min=1e-12)
        return vec.cpu().numpy()

    @torch.inference_mode()
    def run_score_chunk(self, seq: Sequence, num_new_tokens: int) -> np.ndarray:
        """Next-token logprobs of one prompt chunk (scoring, perplexity) ->
        lp [num_new_tokens] f32: lp[i] is the logprob of the prompt token
        after chunk row i (the final prompt position, which has no next
        token, scores token 0; ``score_prompt`` drops it). The chosen logit is taken in the model's
        dtype, then cast to f32, minus the logsumexp of the logits in f32,
        as the JAX runner computes it. Synchronous read-back."""
        start = seq.num_computed_tokens
        s_pad = next_bucket(self.config.scheduler.prefill_token_buckets, num_new_tokens)
        nxt = np.zeros(s_pad, np.int32)
        j = np.arange(start + 1, start + num_new_tokens + 1)
        j = j[j < seq.num_tokens]
        nxt[: len(j)] = np.asarray(seq.token_ids)[j]
        inp, extra, _ = self._chunk_input(seq, num_new_tokens, next_tokens=nxt)
        hidden, _, _ = self.model.prefill(self.k_cache, self.v_cache, inp,
                                          num_logits=s_pad)
        logits = self.model.compute_logits(hidden)  # [S_pad, V], model dtype
        logz = torch.logsumexp(logits.float(), dim=-1)
        chosen = logits.gather(1, extra["next_tokens"].long()[:, None])[:, 0].float()
        return (chosen - logz)[:num_new_tokens].cpu().numpy()

    def _need_lp(self, seqs) -> bool:
        """The exact logsumexp pass runs only when some request reports
        logprobs."""
        return any(seq.sampling_params.logprobs is not None for seq in seqs)

    def _num_top(self, seqs) -> int:
        """Top-logprobs width for the batch: 0 or 20 (the OpenAI cap)."""
        want = max(
            (seq.sampling_params.logprobs or 0) for seq in seqs
        ) if seqs else 0
        return 20 if want > 0 else 0

    # ------------------------------------------------------------------
    # host-DRAM KV tier (the JAX runner's init_host_kv, swap_out_block,
    # write_host_block and swap_in_block)
    # ------------------------------------------------------------------
    def init_host_kv(self, num_host_blocks: int) -> None:
        """Allocate the host tier's slots. Their shapes follow the live
        cache (``(L,) + shape[2:]`` a block), so MLA's 1-d dummy v slot and
        the interleaved layouts' 6-d pages ride the tier unchanged; their
        dtype is JAX's: float32 for an f32 model, else float16, for bf16,
        int8 and fp8 caches alike (the global store ships these arrays). On
        the card they are pinned. Each slot keeps the event of the last
        copy queued on it; the host waits on it before it reads or writes
        the slot (``_wait_host_slot``)."""
        self._refuse_hybrid("the host KV tier")
        host_dt = torch.float32 if self.model.dtype == torch.float32 else torch.float16
        pin = self.device.type == "cuda"
        k_shape = (self.k_cache.shape[0],) + tuple(self.k_cache.shape[2:])
        self.host_k = torch.zeros((num_host_blocks,) + k_shape, dtype=host_dt,
                                  pin_memory=pin)
        self._paged_v = self.v_cache.ndim == 5
        v_shape = ((self.v_cache.shape[0],) + tuple(self.v_cache.shape[2:])
                   if self._paged_v else (0,))
        self.host_v = torch.zeros((num_host_blocks,) + v_shape, dtype=host_dt,
                                  pin_memory=pin)
        self._host_events: list = [None] * num_host_blocks
        logger.info("host KV tier: %d blocks (%s, %.1f MB a block)", num_host_blocks,
                    host_dt, (self.host_k[0].nbytes + self.host_v[0].nbytes) / 1e6)

    def _refuse_hybrid(self, what: str) -> None:
        """The host tier and PD move KV pages only. For a hybrid model the
        JAX runner fails at the same points (its ``v_cache.ndim`` check
        meets the (pages, conv state, recurrent state) tuple), and neither
        package ships the GDN state, without which the pages serve nothing:
        refused."""
        if getattr(self.model, "is_hybrid", False):
            raise NotImplementedError(
                f"{what} is unsupported for hybrid linear-attention models: it moves KV "
                "pages but not the GatedDeltaNet state")

    def _wait_host_slot(self, host_idx: int) -> None:
        """Wait for the copies queued on a host slot before the host reads
        or writes it: a swap-out into it must have landed before it is read,
        and a swap-in from it must have read it before it is rewritten (a
        store fetch, or an LRU reuse's push upstream)."""
        ev = self._host_events[host_idx]
        if ev is not None:
            ev.synchronize()
            self._host_events[host_idx] = None

    def _queue_host_copy(self, host_idx: int, copy) -> None:
        self.host_stream.run(copy)
        self._host_events[host_idx] = self.host_stream.event()

    @torch.no_grad()
    def swap_out_block(self, dev_block: int, host_idx: int) -> None:
        """HBM block -> host slot: cast on the device, then a non-blocking
        copy into the pinned slot, queued after every pass already queued
        (so it reads the block as they leave it) and before any that later
        rewrites it."""
        def copy():
            self.host_k[host_idx].copy_(self.k_cache[:, dev_block].to(self.host_k.dtype),
                                        non_blocking=True)
            if self._paged_v:
                self.host_v[host_idx].copy_(
                    self.v_cache[:, dev_block].to(self.host_v.dtype), non_blocking=True)

        self._queue_host_copy(host_idx, copy)

    def read_host_block(self, host_idx: int) -> tuple[np.ndarray, np.ndarray]:
        """A host slot's (k, v) as numpy views, once its copies have landed
        (the global store's ``read_host``)."""
        self._wait_host_slot(host_idx)
        return self.host_k[host_idx].numpy(), self.host_v[host_idx].numpy()

    def write_host_block(self, host_idx: int, k_block, v_block) -> None:
        """Fill a host slot from wire arrays (a global store fetch), after
        the copies queued on it have run."""
        self._wait_host_slot(host_idx)
        self.host_k[host_idx].copy_(torch.as_tensor(np.asarray(k_block)))
        if self._paged_v:
            self.host_v[host_idx].copy_(torch.as_tensor(np.asarray(v_block)))

    @torch.no_grad()
    def swap_in_block(self, host_idx: int, dev_block: int) -> None:
        """Host slot -> HBM block: a non-blocking copy from the pinned slot,
        then the cast into the cache on the device, queued before the pass
        that reads the block."""
        def copy():
            self.k_cache[:, dev_block].copy_(
                self.host_k[host_idx].to(self.device, non_blocking=True))
            if self._paged_v:
                self.v_cache[:, dev_block].copy_(
                    self.host_v[host_idx].to(self.device, non_blocking=True))

        self._queue_host_copy(host_idx, copy)

    # ------------------------------------------------------------------
    # PD-disaggregation block moves (the JAX runner's extract_blocks_async,
    # extract_blocks, inject_blocks and seed_last_token). JAX pads block
    # counts to powers of two to bound its jit shapes; the port moves
    # exactly the blocks asked for.
    # ------------------------------------------------------------------
    def _gather_to_host(self, cache: torch.Tensor, ids: torch.Tensor | None) -> BlockCopy:
        """One ``index_select`` gather of blocks ``ids`` as [n, L, ...] (the
        whole tensor when ``ids`` is None: MLA's dummy v slot), of the
        cache's bits, and one non-blocking copy into a pinned buffer, with
        its event."""
        src = cache if ids is None else _bits(cache).transpose(0, 1).index_select(
            0, ids).view(cache.dtype)
        if self.device.type != "cuda":
            return BlockCopy(src.clone() if ids is None else src)
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        host.copy_(src, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return BlockCopy(host, ev)

    @torch.no_grad()
    def extract_blocks_async(self, block_ids: list[int]) -> tuple[BlockCopy, BlockCopy, int]:
        """Start the copy of KV blocks to the host: (k, v, n), where ``k``
        and ``v`` are ``BlockCopy`` handles of [n, L, ...] blocks (``v``
        the dummy slot itself in an MLA model, whose latent pages hold K
        and V). Queued on the current stream after the passes that wrote
        the blocks; serving goes on while the copy lands."""
        self._refuse_hybrid("PD block transfer")
        ids = torch.as_tensor(np.asarray(block_ids, np.int64)).to(self.device)
        k = self._gather_to_host(self.k_cache, ids)
        v = self._gather_to_host(self.v_cache, ids if self.v_cache.ndim == 5 else None)
        return k, v, len(block_ids)

    def extract_blocks(self, block_ids: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
        """Device KV blocks -> host tensors [n, L, Hkv, bs, D]."""
        k, v, n = self.extract_blocks_async(block_ids)
        return k.wait()[:n], v.wait()[:n]

    @torch.no_grad()
    def inject_blocks(self, k_blocks: torch.Tensor, v_blocks: torch.Tensor,
                      block_ids: list[int]) -> None:
        """Host blocks [n, L, ...] -> device blocks ``block_ids``: one
        non-blocking copy each through pinned memory and one ``index_copy_``
        scatter, cast to the cache's dtype on the device. MLA's dummy v
        slot is left as it is."""
        self._refuse_hybrid("PD block transfer")
        ids = torch.as_tensor(np.asarray(block_ids, np.int64)).to(self.device)
        pairs = [(self.k_cache, k_blocks)]
        if self.v_cache.ndim == 5:
            pairs.append((self.v_cache, v_blocks))
        for cache, blocks in pairs:
            if self.device.type == "cuda":
                blocks = blocks.pin_memory().to(self.device, non_blocking=True)
            _bits(cache).transpose(0, 1).index_copy_(0, ids, _bits(blocks.to(cache.dtype)))

    def seed_last_token(self, slot: int, token: int) -> None:
        """Write a token into the device ring (the PD accept path)."""
        self.last_tokens[slot] = token
