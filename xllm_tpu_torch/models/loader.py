"""HF safetensors checkpoint loader.

Counterpart of ``xllm_tpu/models/loader.py`` for the families the port
serves (dense GQA, GQA MoE, MLA without DSA) and the MTP draft head. It reads
``config.json``'s checkpoint, ``model.safetensors`` or the shards of
``model.safetensors.index.json``, and maps HF tensor names onto the JAX
parameter tree's names and layouts, which the port's modules keep
(``weights.py``).

- ``SafetensorsReader`` parses the format itself (an 8-byte little-endian
  header length, a JSON header of ``dtype`` / ``shape`` / ``data_offsets``,
  the raw buffer) and memory-maps each file: a tensor is a view of the
  mapped bytes, so a checkpoint is never copied whole into host memory.
- ``layer_slices`` yields every per-layer tensor in the tree's layout, stack
  by stack and layer by layer, each on the device it is asked for; the
  runner (``ModelRunner.load_model``) streams them into the model's
  parameters, and ``load_params`` stacks them into the JAX-layout tree
  (the JAX ``load_params``: the same names, shapes and bytes).
- Casts to the model dtype round to nearest even, as ``ml_dtypes`` does. A
  float8 or integer tensor where a float weight belongs (a pre-quantized
  checkpoint, e.g. DeepSeek-V3's e4m3 weights with ``weight_scale_inv``)
  raises ``NotImplementedError``: the JAX loader has no such ingestion
  either, and codes are never loaded as weights.
- qwen3-next / qwen3.5 (``load_qwen3_next_params``, the JAX family
  loader) build their group-stacked tree on the host, whole, as the JAX
  loader does; the runner copies it in and quantizes it with its
  catch-all. The vision towers are not ported (they raise); neither is the
  DSA lightning indexer (``self_attn.indexer.*``), whose families
  ``models/registry.py`` refuses.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from collections.abc import Callable, Iterator

import torch

from xllm_tpu_torch.config import ModelConfig
from xllm_tpu_torch.utils import get_logger

logger = get_logger(__name__)

# the safetensors format's dtype names
DTYPES = {
    "BOOL": torch.bool,
    "U8": torch.uint8,
    "I8": torch.int8,
    "I16": torch.int16,
    "I32": torch.int32,
    "I64": torch.int64,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F32": torch.float32,
    "F64": torch.float64,
    "F8_E4M3": torch.float8_e4m3fn,
}
# what a float weight may be stored in: anything else holds codes
_WEIGHT_DTYPES = (torch.bfloat16, torch.float16, torch.float32, torch.float64)


class _MappedFile:
    """One ``.safetensors`` file: its header and a copy-on-write map of it
    (writable for ``torch.frombuffer``, never written)."""

    def __init__(self, path: str) -> None:
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        header.pop("__metadata__", None)
        self.entries: dict = header
        self._base = 8 + n
        self.path = path

    def tensor(self, name: str) -> torch.Tensor:
        e = self.entries[name]
        if e["dtype"] not in DTYPES:
            raise ValueError(f"{name} in {self.path}: unsupported dtype {e['dtype']}")
        dtype, shape = DTYPES[e["dtype"]], list(e["shape"])
        start, end = e["data_offsets"]
        numel = 1
        for s in shape:
            numel *= s
        if end - start != numel * dtype.itemsize:
            raise ValueError(f"{name} in {self.path}: {end - start} bytes for {shape} {dtype}")
        if numel == 0:
            return torch.empty(shape, dtype=dtype)
        raw = torch.frombuffer(self._map, dtype=torch.uint8, count=end - start,
                               offset=self._base + start)
        if (self._base + start) % dtype.itemsize:
            raw = raw.clone()  # a misaligned view: copy this one tensor
        return raw.view(dtype).reshape(shape)


class SafetensorsReader:
    """Uniform access over a single-file or index-sharded checkpoint.
    ``get`` returns a CPU tensor that views the mapped file."""

    def __init__(self, model_path: str):
        self.model_path = model_path
        self._files: dict[str, _MappedFile] = {}
        index_path = os.path.join(model_path, "model.safetensors.index.json")
        if os.path.exists(index_path):
            with open(index_path) as f:
                self.name_to_file: dict[str, str] = dict(json.load(f)["weight_map"])
        else:
            if not os.path.exists(os.path.join(model_path, "model.safetensors")):
                raise FileNotFoundError(f"no safetensors checkpoint in {model_path}")
            names = self._file("model.safetensors").entries
            self.name_to_file = {name: "model.safetensors" for name in names}
        # multimodal checkpoints (qwen3-vl, qwen3.5) nest the LM under
        # model.language_model.: alias "model.X" to it
        self._lm_prefix = ""
        if ("model.language_model.embed_tokens.weight" in self.name_to_file
                and "model.embed_tokens.weight" not in self.name_to_file):
            self._lm_prefix = "model.language_model."

    def _file(self, fname: str) -> _MappedFile:
        if fname not in self._files:
            self._files[fname] = _MappedFile(os.path.join(self.model_path, fname))
        return self._files[fname]

    def _resolve(self, name: str) -> str:
        if (self._lm_prefix and name not in self.name_to_file
                and name.startswith("model.")
                and not name.startswith("model.language_model.")):
            alias = self._lm_prefix + name[len("model."):]
            if alias in self.name_to_file:
                return alias
        return name

    def __contains__(self, name: str) -> bool:
        return self._resolve(name) in self.name_to_file

    def get(self, name: str) -> torch.Tensor:
        name = self._resolve(name)
        return self._file(self.name_to_file[name]).tensor(name)

    def close(self) -> None:
        # tensors still viewing a map keep it alive; the reader lets go
        self._files.clear()

    def __enter__(self) -> "SafetensorsReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Tensors:
    """The reader's float weights on ``device`` (``w``, or transposed from
    HF's ``[out, in]`` to the tree's ``[in, out]`` as a view: ``t``)."""

    def __init__(self, reader: SafetensorsReader, device) -> None:
        self.reader = reader
        self.device = torch.device(device)

    def __contains__(self, name: str) -> bool:
        return name in self.reader

    def host(self, name: str) -> torch.Tensor:
        t = self.reader.get(name)
        if t.dtype not in _WEIGHT_DTYPES:
            raise NotImplementedError(
                f"{name} is stored as {t.dtype}: pre-quantized checkpoints (codes with "
                "their scales) are not supported; load a bf16 / f16 / f32 checkpoint and "
                "set quant.method to quantize it")
        return t

    def w(self, name: str) -> torch.Tensor:
        return self.host(name).to(self.device)

    def t(self, name: str) -> torch.Tensor:
        return self.w(name).T


def check_family(cfg: ModelConfig) -> None:
    """The JAX loader's families that are not ported raise."""
    if cfg.vision:
        raise NotImplementedError("loading a vision tower (VLM families) is not ported yet")
    if cfg.index_topk > 0:
        raise NotImplementedError("loading the DSA lightning indexer is not ported yet")


def top_level(cfg: ModelConfig) -> list[tuple[str, str, bool]]:
    """(tree name, HF name, transposed?) of the tensors outside the layers."""
    out = [("embed_tokens", "model.embed_tokens.weight", False),
           ("norm", "model.norm.weight", False)]
    if not cfg.tie_word_embeddings:
        out.append(("lm_head", "lm_head.weight", True))
    return out


# tree name of a per-layer stack -> (HF template, transposed?)
_LAYER_MAP = {
    "input_layernorm": ("model.layers.{i}.input_layernorm.weight", False),
    "post_attention_layernorm": ("model.layers.{i}.post_attention_layernorm.weight", False),
    "o_proj_w": ("model.layers.{i}.self_attn.o_proj.weight", True),
    "q_norm": ("model.layers.{i}.self_attn.q_norm.weight", False),
    "k_norm": ("model.layers.{i}.self_attn.k_norm.weight", False),
    "post_self_attn_layernorm": ("model.layers.{i}.post_self_attn_layernorm.weight", False),
    "post_mlp_layernorm": ("model.layers.{i}.post_mlp_layernorm.weight", False),
    "down_proj_w": ("model.layers.{i}.mlp.down_proj.weight", True),
}

# (group, name, layer index within the group, tensor)
Slice = tuple[str, str, int, torch.Tensor]


def fuse_qkv(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """HF ``[out, in]`` (or ``[out]`` bias) q / k / v -> the group-major
    fused ``[in, out]`` (``[out]``): Hkv groups x (G q-heads + 1 K + 1 V) x
    head_dim, the layout of ``DecoderLayer.qkv_proj_w``."""
    hkv, dh = cfg.num_kv_heads, cfg.head_dim
    g = cfg.num_attention_heads // hkv
    vec = q.ndim == 1
    qh, kh, vh = (t.reshape(n, dh, -1) for t, n in ((q, hkv * g), (k, hkv), (v, hkv)))
    groups = torch.cat([qh.reshape(hkv, g, dh, -1), kh[:, None], vh[:, None]], dim=1)
    fused = groups.reshape(hkv * (g + 2) * dh, -1)
    return fused[:, 0] if vec else fused.T


def _stacks(layers, group_of: Callable[[int], tuple[str, int]],
            items) -> Iterator[Slice]:
    """``items``: (name, fetch(i)) -> each stack over ``layers``, in turn."""
    for name, fetch in items:
        for i in layers:
            group, j = group_of(i)
            yield group, name, j, fetch(i)


def _expert_stack(n: int, fetch: Callable[[int], torch.Tensor]) -> torch.Tensor:
    """``[n, ...]`` from ``fetch(j)``, filled expert by expert."""
    first = fetch(0)
    out = first.new_empty((n, *first.shape))
    out[0] = first
    for j in range(1, n):
        out[j] = fetch(j)
    return out


def _moe(cfg: ModelConfig, ts: Tensors, first_layer: int) -> list:
    """The routed-expert stacks of the layers from ``first_layer`` (the JAX
    ``_load_moe_mlp``): router ``[D, E]``, the correction bias (deepseek
    keeps it under ``mlp.gate.``, minimax-m2 under ``mlp.``), experts
    ``[E, D, 2I]`` (gate | up) and ``[E, I, D]`` (per-expert tensors, or
    the batched ``experts.gate_up_proj`` of qwen3-vl-moe), the shared
    experts, and the identity ``expert_placement``."""
    E = cfg.num_experts

    def mlp(i, rest):
        return f"model.layers.{i}.mlp.{rest}"

    items = [("router_w", lambda i: ts.t(mlp(i, "gate.weight")))]
    for rest in ("gate.e_score_correction_bias", "e_score_correction_bias"):
        if mlp(first_layer, rest) in ts:
            items.append(("router_bias", lambda i, rest=rest: ts.w(mlp(i, rest)).float()))
            break

    def expert(i, j, proj):
        return ts.t(mlp(i, f"experts.{j}.{proj}_proj.weight"))

    if mlp(first_layer, "experts.gate_up_proj") in ts:
        items += [("experts_gate_up", lambda i: ts.w(mlp(i, "experts.gate_up_proj"))),
                  ("experts_down", lambda i: ts.w(mlp(i, "experts.down_proj")))]
    else:
        items += [
            ("experts_gate_up", lambda i: _expert_stack(E, lambda j: torch.cat(
                [expert(i, j, "gate"), expert(i, j, "up")], dim=1))),
            ("experts_down", lambda i: _expert_stack(E, lambda j: expert(i, j, "down"))),
        ]
    if cfg.n_shared_experts > 0:
        for proj in ("gate", "up", "down"):
            items.append((f"shared_{proj}_proj_w", lambda i, proj=proj: ts.t(
                mlp(i, f"shared_experts.{proj}_proj.weight"))))
    items.append(("expert_placement",
                  lambda i: torch.arange(E, dtype=torch.int32, device=ts.device)))
    return items


def _dense_mlp(ts: Tensors) -> list:
    return [(f"{proj}_proj_w", lambda i, proj=proj: ts.t(f"model.layers.{i}.mlp.{proj}_proj.weight"))
            for proj in ("gate", "up", "down")]


def _gqa_slices(cfg: ModelConfig, ts: Tensors) -> Iterator[Slice]:
    """The dense and GQA MoE families (the JAX ``load_dense_params``). A
    glm4-moe dense prefix of ``first_k_dense_replace`` layers forms the
    ``dense_layers`` group."""
    L = cfg.num_hidden_layers
    nd = cfg.first_k_dense_replace if cfg.num_experts > 0 else 0

    def group_of(i):
        return ("dense_layers", i) if i < nd else ("layers", i - nd)

    items = []
    for name, (tmpl, transpose) in _LAYER_MAP.items():
        if (name == "down_proj_w" and nd > 0) or tmpl.format(i=0) not in ts:
            continue  # a dense prefix's MLP loads below; MoE layers have none
        items.append((name, lambda i, tmpl=tmpl, tr=transpose:
                      (ts.t if tr else ts.w)(tmpl.format(i=i))))
    attn = "model.layers.{i}.self_attn.{p}_proj.{t}"

    def qkv(t):
        return lambda i: fuse_qkv(cfg, *(ts.w(attn.format(i=i, p=p, t=t)) for p in "qkv"))

    items.append(("qkv_proj_w", qkv("weight")))
    if attn.format(i=0, p="q", t="bias") in ts:
        items.append(("qkv_proj_b", qkv("bias")))
    yield from _stacks(range(L), group_of, items)
    if cfg.num_experts > 0:
        yield from _stacks(range(nd), group_of, _dense_mlp(ts))
        yield from _stacks(range(nd, L), group_of, _moe(cfg, ts, nd))
    elif "model.layers.0.mlp.gate_up_proj.weight" in ts:
        # glm4's fused gate_up: rows [gate | up]
        def half(i, h):
            gu = ts.w(f"model.layers.{i}.mlp.gate_up_proj.weight")
            n = gu.shape[0] // 2
            return gu[h * n:(h + 1) * n].T

        yield from _stacks(range(L), group_of, [("gate_proj_w", lambda i: half(i, 0)),
                                                ("up_proj_w", lambda i: half(i, 1))])
    else:
        yield from _stacks(range(L), group_of, _dense_mlp(ts)[:2])


def _mla_slices(cfg: ModelConfig, ts: Tensors) -> Iterator[Slice]:
    """deepseek-v2 / v3, kimi-k2, glm4-moe-lite (the JAX
    ``load_mla_params``): q_a / q_b or q_proj, kv_a, ``kv_b_proj`` split
    into ``kv_b_nope_w [H, kvr, nope]`` and ``kv_b_v_w [H, kvr, vh]``, o;
    the dense layers' MLP or the MoE layers' experts."""
    L, H = cfg.num_hidden_layers, cfg.num_attention_heads
    nope, vh, kvr = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    n_dense = cfg.first_k_dense_replace if cfg.num_experts > 0 else L

    def a(i, rest):
        return f"model.layers.{i}.self_attn.{rest}"

    def kv_b(i, lo, hi):
        w = ts.w(a(i, "kv_b_proj.weight")).reshape(H, nope + vh, kvr)
        return w[:, lo:hi].transpose(1, 2)

    attn = [
        ("input_layernorm", lambda i: ts.w(f"model.layers.{i}.input_layernorm.weight")),
        ("post_attention_layernorm",
         lambda i: ts.w(f"model.layers.{i}.post_attention_layernorm.weight")),
        ("kv_a_proj_w", lambda i: ts.t(a(i, "kv_a_proj_with_mqa.weight"))),
        ("kv_a_norm", lambda i: ts.w(a(i, "kv_a_layernorm.weight"))),
        ("o_proj_w", lambda i: ts.t(a(i, "o_proj.weight"))),
        ("kv_b_nope_w", lambda i: kv_b(i, 0, nope)),
        ("kv_b_v_w", lambda i: kv_b(i, nope, nope + vh)),
    ]
    if cfg.q_lora_rank > 0:
        attn += [("q_a_proj_w", lambda i: ts.t(a(i, "q_a_proj.weight"))),
                 ("q_a_norm", lambda i: ts.w(a(i, "q_a_layernorm.weight"))),
                 ("q_b_proj_w", lambda i: ts.t(a(i, "q_b_proj.weight")))]
    else:
        attn.append(("q_proj_w", lambda i: ts.t(a(i, "q_proj.weight"))))

    def group_of(i):
        return ("dense_layers", i) if i < n_dense else ("moe_layers", i - n_dense)

    if n_dense > 0:
        yield from _stacks(range(n_dense), group_of, attn + _dense_mlp(ts))
    if n_dense < L:
        yield from _stacks(range(n_dense, L), group_of, attn + _moe(cfg, ts, n_dense))


def layer_slices(cfg: ModelConfig, ts: Tensors) -> Iterator[Slice]:
    """Every per-layer tensor of the checkpoint as ``(group, name, index,
    tensor)``: the tree's group (``layers``, ``dense_layers`` or
    ``moe_layers``) and name, the layer's index within the group, and the
    tensor in the tree's layout (possibly a strided view) on ``ts.device``,
    in the checkpoint's dtype (the router bias in f32); stack by stack, each
    stack layer by layer."""
    check_family(cfg)
    if cfg.kv_lora_rank > 0:
        return _mla_slices(cfg, ts)
    return _gqa_slices(cfg, ts)


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float tensor to ``dtype`` (round to nearest even); integers as
    they are (the JAX ``put``)."""
    return t.to(dtype) if t.is_floating_point() else t


@torch.no_grad()
def copy_rows(param: torch.Tensor, host: torch.Tensor, transpose: bool,
              chunk_bytes: int = 64 << 20) -> None:
    """``param`` <- ``host`` (``host.T`` if ``transpose``), cast to the
    parameter's dtype, uploaded ``chunk_bytes`` of ``host``'s rows at a time
    so that a large tensor (an embedding, an lm_head) needs no copy of its
    own on the device."""
    want = tuple(reversed(host.shape)) if transpose else tuple(host.shape)
    if want != tuple(param.shape):
        raise ValueError(f"shape {want} does not fit {tuple(param.shape)}")
    if host.ndim == 1:
        param.copy_(host.to(param.device).to(param.dtype))
        return
    rows = max(1, chunk_bytes // max(1, host[0].numel() * host.element_size()))
    for r0 in range(0, host.shape[0], rows):
        part = host[r0:r0 + rows].to(param.device).to(param.dtype)
        if transpose:
            param[:, r0:r0 + rows].copy_(part.T)
        else:
            param[r0:r0 + rows].copy_(part)


def load_params(cfg: ModelConfig, dtype: torch.dtype | None = None, device="cpu") -> dict:
    """The checkpoint at ``cfg.model_path`` as the JAX parameter tree (the
    JAX ``load_params(cfg, None, dtype)``: the same names, shapes and, after
    the cast to ``dtype`` (default bf16), the same bytes), its tensors on
    ``device``. ``ModelRunner.load_model(params=...)`` serves it."""
    check_family(cfg)
    from xllm_tpu_torch.models.registry import HYBRID_FAMILIES

    if cfg.model_type in HYBRID_FAMILIES:
        return load_qwen3_next_params(cfg, dtype, device)
    dtype = dtype or torch.bfloat16
    tree: dict = {}
    with SafetensorsReader(cfg.model_path) as reader:
        ts = Tensors(reader, device)
        for name, hf, transpose in top_level(cfg):
            t = ts.t(hf) if transpose else ts.w(hf)
            tree[name] = cast(t, dtype).contiguous()
        stacks: dict[tuple[str, str], list] = {}
        for group, name, _, t in layer_slices(cfg, ts):
            stacks.setdefault((group, name), []).append(cast(t, dtype))
        for (group, name), ts_ in stacks.items():
            tree.setdefault(group, {})[name] = torch.stack(ts_)
    return tree


def load_qwen3_next_params(cfg: ModelConfig, dtype: torch.dtype | None = None,
                           device="cpu") -> dict:
    """An HF Qwen3Next (or qwen3.5) checkpoint -> the group-stacked hybrid
    tree of ``models/qwen3_next.py`` (the JAX ``load_qwen3_next_params``):

    - layers regroup as [G, interval] with the full-attention layer last in
      each group: ``lin_*`` stacks [G, I1, ...], ``full_*`` [G, ...], the
      MLPs [G, interval, ...];
    - the centered RMSNorms (applied as 1 + w) fold into plain weights by
      adding 1 (input / post layernorms, q / k norms, the final norm; not
      the gated GDN norm);
    - the fused ``in_proj_qkvz`` / ``in_proj_ba`` (per key head [q | k | v |
      z], [b | a]), or qwen3.5's split ``in_proj_qkv`` / ``z`` / ``b`` /
      ``a`` merged into that layout (a fixed permutation of output
      channels); the LM under ``model.language_model.`` (the reader's
      alias);
    - ``lin_A_log`` and ``lin_dt_bias`` stay f32; every other tensor is
      cast to ``dtype`` (default bf16) from f32, rounding to nearest even."""
    dtype = dtype or torch.bfloat16
    L, interval = cfg.num_hidden_layers, cfg.full_attention_interval
    G, I1 = L // interval, interval - 1
    hk, hv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
    dk, dv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
    r = hv // hk
    key_dim = hk * dk
    with SafetensorsReader(cfg.model_path) as reader:
        ts = Tensors(reader, "cpu")

        def g(name: str) -> torch.Tensor:
            return ts.host("model." + name).float()

        def centered(name: str) -> torch.Tensor:
            return g(name) + 1.0

        def fused_qkvz(i: int) -> torch.Tensor:  # [out, D]
            base = f"layers.{i}.linear_attn."
            if "model." + base + "in_proj_qkvz.weight" in ts:
                return g(base + "in_proj_qkvz.weight")
            qkv, z = g(base + "in_proj_qkv.weight"), g(base + "in_proj_z.weight")
            d = qkv.shape[1]
            q = qkv[:key_dim].reshape(hk, dk, d)
            k = qkv[key_dim:2 * key_dim].reshape(hk, dk, d)
            v = qkv[2 * key_dim:].reshape(hk, r * dv, d)
            return torch.cat([q, k, v, z.reshape(hk, r * dv, d)], dim=1).reshape(-1, d)

        def fused_ba(i: int) -> torch.Tensor:
            base = f"layers.{i}.linear_attn."
            if "model." + base + "in_proj_ba.weight" in ts:
                return g(base + "in_proj_ba.weight")
            b, a = g(base + "in_proj_b.weight"), g(base + "in_proj_a.weight")
            d = b.shape[1]
            return torch.cat([b.reshape(hk, r, d), a.reshape(hk, r, d)], dim=1).reshape(-1, d)

        lin_ids = [i for i in range(L) if (i + 1) % interval != 0]
        full_ids = [i for i in range(L) if (i + 1) % interval == 0]

        def stack(ids, fn) -> torch.Tensor:
            return torch.stack([fn(i) for i in ids])

        def lin(fn) -> torch.Tensor:  # [G * I1, ...] -> [G, I1, ...]
            t = stack(lin_ids, fn)
            return t.reshape(G, I1, *t.shape[1:])

        def mlp(fn) -> torch.Tensor:  # every layer, [G, interval, ...]
            t = stack(range(L), fn)
            return t.reshape(G, interval, *t.shape[1:])

        def attn(i: int, rest: str) -> str:
            return f"layers.{i}.{rest}"

        gp = {
            "lin_input_layernorm": lin(lambda i: centered(attn(i, "input_layernorm.weight"))),
            "lin_post_layernorm": lin(
                lambda i: centered(attn(i, "post_attention_layernorm.weight"))),
            "lin_qkvz_w": lin(lambda i: fused_qkvz(i).T),
            "lin_ba_w": lin(lambda i: fused_ba(i).T),
            "lin_conv_w": lin(lambda i: g(attn(i, "linear_attn.conv1d.weight"))[:, 0, :]),
            "lin_dt_bias": lin(lambda i: g(attn(i, "linear_attn.dt_bias"))),
            "lin_A_log": lin(lambda i: g(attn(i, "linear_attn.A_log"))),
            "lin_norm_w": lin(lambda i: g(attn(i, "linear_attn.norm.weight"))),
            "lin_out_w": lin(lambda i: g(attn(i, "linear_attn.out_proj.weight")).T),
            "full_input_layernorm": stack(
                full_ids, lambda i: centered(attn(i, "input_layernorm.weight"))),
            "full_post_layernorm": stack(
                full_ids, lambda i: centered(attn(i, "post_attention_layernorm.weight"))),
            "full_q_norm": stack(full_ids,
                                 lambda i: centered(attn(i, "self_attn.q_norm.weight"))),
            "full_k_norm": stack(full_ids,
                                 lambda i: centered(attn(i, "self_attn.k_norm.weight"))),
        }
        for p in "qkvo":
            gp[f"full_{p}_w"] = stack(
                full_ids, lambda i, p=p: g(attn(i, f"self_attn.{p}_proj.weight")).T)
        if cfg.num_experts > 0:
            def proj(i, rest):
                return g(attn(i, f"mlp.{rest}.weight")).T

            gp["router_w"] = mlp(lambda i: proj(i, "gate"))
            gp["experts_gate_up"] = mlp(lambda i: torch.stack([
                torch.cat([proj(i, f"experts.{j}.gate_proj"), proj(i, f"experts.{j}.up_proj")],
                          dim=1) for j in range(cfg.num_experts)]))
            gp["experts_down"] = mlp(lambda i: torch.stack([
                proj(i, f"experts.{j}.down_proj") for j in range(cfg.num_experts)]))
            for p in ("gate", "up", "down"):
                gp[f"shared_{p}_proj_w"] = mlp(
                    lambda i, p=p: proj(i, f"shared_expert.{p}_proj"))
            gp["shared_gate_w"] = mlp(lambda i: g(attn(i, "mlp.shared_expert_gate.weight"))[0])
        else:
            for p in ("gate", "up", "down"):
                gp[f"{p}_proj_w"] = mlp(lambda i, p=p: g(attn(i, f"mlp.{p}_proj.weight")).T)
        tree = {"embed_tokens": g("embed_tokens.weight"), "norm": centered("norm.weight"),
                "groups": gp}
        if not cfg.tie_word_embeddings:
            tree["lm_head"] = ts.host("lm_head.weight").float().T

    def put(name: str, t: torch.Tensor) -> torch.Tensor:
        keep = name in ("lin_A_log", "lin_dt_bias")  # the exp / softplus path stays f32
        return (t if keep else cast(t, dtype)).contiguous().to(device)

    out = {k: put(k, v) for k, v in tree.items() if k != "groups"}
    out["groups"] = {k: put(k, v) for k, v in gp.items()}
    logger.info("loaded qwen3-next: %d groups x %d layers", G, interval)
    return out


# where an MTP module's tensors may sit: a dedicated head checkpoint
# ("model.layers.0.") or the extra-module conventions
_MTP_PREFIXES = ("model.layers.0.", "mtp.", "model.mtp.")


@torch.no_grad()
def load_mtp_head(head, draft_model_path: str, cfg: ModelConfig) -> None:
    """Best-effort MTP / Eagle3 head weights (the JAX
    ``load_mtp_head_params``): MiMo / qwen-style MTP tensors (``enorm``,
    ``hnorm``, ``eh_proj``, one dense decoder layer and the final norm)
    under the first prefix of ``_MTP_PREFIXES`` that has ``enorm.weight``,
    copied into ``head`` (``models/mtp_head.MTPHead``) in place. A tensor
    the checkpoint lacks, or of another shape, keeps the head's own init
    with a warning; an unreadable path keeps the whole init with a
    warning."""
    try:
        reader = SafetensorsReader(draft_model_path)
    except (OSError, ValueError) as e:
        logger.warning("MTP head: cannot read %s (%s); random init", draft_model_path, e)
        return
    with reader:
        ts = Tensors(reader, "cpu")
        pfx = next((p for p in _MTP_PREFIXES if f"{p}enorm.weight" in ts), None)
        if pfx is None:
            logger.warning("MTP head: no enorm.weight under %s in %s; random init",
                           _MTP_PREFIXES, draft_model_path)
            return

        def put(owner, key: str, names: list[str], transform=None) -> None:
            name = next((n for n in names if n in ts), None)
            if name is None:
                logger.warning("MTP head: %s missing from %s; %s keeps its init",
                               names[0], draft_model_path, key)
                return
            value = ts.host(name) if transform is None else transform(ts.host(name))
            _put_checked(getattr(owner, key), value, name)

        def T(a):  # HF [out, in] -> [in, out]
            return a.T

        layer = head.layer
        put(head, "enorm", [f"{pfx}enorm.weight"])
        put(head, "hnorm", [f"{pfx}hnorm.weight"])
        put(head, "eh_proj", [f"{pfx}eh_proj.weight"], T)
        put(head, "norm", [f"{pfx}shared_head.norm.weight", f"{pfx}final_layernorm.weight",
                           "model.norm.weight"])
        put(layer, "input_layernorm", [f"{pfx}input_layernorm.weight"])
        put(layer, "post_attention_layernorm", [f"{pfx}post_attention_layernorm.weight"])
        qkv = [f"{pfx}self_attn.{p}_proj.weight" for p in "qkv"]
        if all(n in ts for n in qkv):
            _put_checked(layer.qkv_proj_w, fuse_qkv(cfg, *(ts.host(n) for n in qkv)),
                         "fused qkv")
        else:
            logger.warning("MTP head: %s missing from %s; qkv_proj_w keeps its init",
                           qkv, draft_model_path)
        put(layer, "o_proj_w", [f"{pfx}self_attn.o_proj.weight"], T)
        for proj in ("gate", "up", "down"):
            put(layer, f"{proj}_proj_w", [f"{pfx}mlp.{proj}_proj.weight"], T)
        if hasattr(layer, "q_norm"):
            put(layer, "q_norm", [f"{pfx}self_attn.q_norm.weight"])
            put(layer, "k_norm", [f"{pfx}self_attn.k_norm.weight"])


def _put_checked(param: torch.Tensor, value: torch.Tensor, name: str) -> None:
    """``param`` <- ``value`` (cast to its dtype) where the shapes agree;
    otherwise a warning and the parameter keeps its init."""
    if tuple(value.shape) != tuple(param.shape):
        logger.warning("MTP head: %s shape %s != %s; skipped", name, tuple(value.shape),
                       tuple(param.shape))
        return
    param.copy_(value.to(param.device).to(param.dtype))
