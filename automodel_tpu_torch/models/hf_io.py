"""HF safetensors <-> the port's modules (counterpart:
``automodel_tpu/models/hf_io.py``).

The key maps are the JAX package's for the three ported families (llama,
mixtral, qwen3_moe), keyed by the same JAX tree paths that
``models/weights.py::jax_leaves`` walks.  HF stores an ``nn.Linear`` as
``(out, in)``, the port's layout, so projections and routers copy as they
are; the expert stacks keep the JAX layout ``[E, in, out]`` per layer and
are split into (joined from) one transposed HF tensor per expert
(``...experts.{e}.<name>.weight``).

:func:`save_hf_weights` writes a consolidated HF repo as the JAX writer
does: ``model.safetensors`` (``model-0000i-of-0000n.safetensors`` past
``max_shard_bytes``), always with ``model.safetensors.index.json`` and
``config.json``.  The safetensors format is read and written by this
module's own code (the package is not needed): an 8-byte little-endian
header length, a JSON header (``dtype``, ``shape``, ``data_offsets`` per
tensor and ``__metadata__``) padded with spaces to 8 bytes, then the raw
little-endian bytes of every tensor back to back.

A model whose projections are an int8 base (``quantization/
weight_only.py``) reads through :func:`quantized_key_map`: each
projection's bf16 tensor is read on the host and quantized there, its
codes and scales copied to the card, so the dense tree never exists on the
card (:func:`load_quantized_hf_base`, the QLoRA streaming read); such a
base exports through ``dequantize_base_params`` and the dense map.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from automodel_tpu_torch.models.weights import jax_leaves

SAFETENSORS_INDEX = "model.safetensors.index.json"
SAFETENSORS_FILE = "model.safetensors"

_DTYPES = {
    torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32",
    torch.float64: "F64", torch.int64: "I64", torch.int32: "I32",
    torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8",
    torch.bool: "BOOL", torch.float8_e4m3fn: "F8_E4M3",
    torch.float8_e5m2: "F8_E5M2",
}
_FROM_NAME = {v: k for k, v in _DTYPES.items()}

_ARCHITECTURES = {"llama": "LlamaForCausalLM",
                  "mixtral": "MixtralForCausalLM",
                  "qwen3_moe": "Qwen3MoeForCausalLM"}


# ---------------------------------------------------------------------------
# safetensors, read and written here
# ---------------------------------------------------------------------------
def _raw_bytes(t: torch.Tensor) -> memoryview:
    t = t.detach().contiguous().cpu()
    if t.dim() == 0:
        t = t.reshape(1)
    return memoryview(t.view(torch.uint8).numpy()).cast("B")


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (name -> tensor, any device) as one safetensors
    file, names in sorted order; returns the bytes of tensor data."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    names = sorted(tensors)
    for name in names:
        t = tensors[name]
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            if tensors[name].numel():
                f.write(_raw_bytes(tensors[name]))
    return offset


def read_safetensors_header(path: str) -> Tuple[Dict[str, dict], int]:
    """``(header without __metadata__, byte offset of the data)``."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def read_safetensors(path: str, names: Optional[List[str]] = None
                     ) -> Dict[str, torch.Tensor]:
    """Tensors of one safetensors file (all, or ``names``) on the CPU."""
    header, start = read_safetensors_header(path)
    out = {}
    with open(path, "rb") as f:
        for name in (names if names is not None else sorted(header)):
            info = header[name]
            lo, hi = info["data_offsets"]
            f.seek(start + lo)
            buf = bytearray(f.read(hi - lo))
            dtype = _FROM_NAME[info["dtype"]]
            t = (torch.frombuffer(buf, dtype=torch.uint8) if buf
                 else torch.empty(0, dtype=torch.uint8))
            out[name] = t.view(dtype).reshape(info["shape"])
    return out


# ---------------------------------------------------------------------------
# key maps: JAX tree path -> (HF template, expert-stacked)
# ---------------------------------------------------------------------------
def llama_key_map(config) -> Dict[Tuple[str, ...], Tuple[str, bool]]:
    m = {
        ("embed_tokens", "embedding"): ("model.embed_tokens.weight", False),
        ("norm", "weight"): ("model.norm.weight", False),
    }
    for norm in ("input_layernorm", "post_attention_layernorm"):
        m[("layers", norm, "weight")] = (
            f"model.layers.{{i}}.{norm}.weight", False)
    for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
        m[("layers", "self_attn", proj, "kernel")] = (
            f"model.layers.{{i}}.self_attn.{proj}.weight", False)
    if config.qk_norm:
        for norm in ("q_norm", "k_norm"):
            m[("layers", "self_attn", norm, "weight")] = (
                f"model.layers.{{i}}.self_attn.{norm}.weight", False)
    for proj in ("gate_proj", "up_proj", "down_proj"):
        m[("layers", "mlp", proj, "kernel")] = (
            f"model.layers.{{i}}.mlp.{proj}.weight", False)
    if not config.tie_word_embeddings:
        m[("lm_head", "kernel")] = ("lm_head.weight", False)
    return m


def _moe_key_map(config, block: str, experts: Tuple[str, ...]):
    m = llama_key_map(config)
    for proj in ("gate_proj", "up_proj", "down_proj"):
        del m[("layers", "mlp", proj, "kernel")]
    m[("layers", block, "gate", "kernel")] = (
        f"model.layers.{{i}}.{block}.gate.weight", False)
    for name in experts:
        m[("layers", block, "experts", name, "kernel")] = (
            f"model.layers.{{i}}.{block}.experts.{{e}}.{name}.weight", True)
    return m


def mixtral_key_map(config):
    return _moe_key_map(config, "block_sparse_moe", ("w1", "w2", "w3"))


def qwen3_moe_key_map(config):
    return _moe_key_map(config, "mlp", ("gate_proj", "up_proj", "down_proj"))


_KEY_MAPS = {"llama": llama_key_map, "mixtral": mixtral_key_map,
             "qwen3_moe": qwen3_moe_key_map}

# the read transforms of an int8 base's two leaves (one HF tensor each)
INT8_CODES, INT8_SCALE = "int8_codes", "int8_scale"


def quantized_key_map(base_map):
    """``base_map`` with each int8 projection's ``kernel`` and ``scale``
    read from the projection's one HF tensor, quantized on the host
    (``quantize_kernel_np``): entries ``(template, expert_stacked,
    transform)``."""
    from automodel_tpu_torch.quantization.weight_only import (
        QUANTIZED_MODULES,
    )

    m = dict(base_map)
    for mod, proj in QUANTIZED_MODULES:
        path = ("layers", mod, proj, "kernel")
        if path in m:
            template, stacked = m[path]
            m[path] = (template, stacked, INT8_CODES)
            m[("layers", mod, proj, "scale")] = (template, stacked,
                                                 INT8_SCALE)
    return m


def key_map_for(model):
    """The JAX-path -> HF key map of ``model``'s family (the quantized one
    for an int8 base)."""
    from automodel_tpu_torch.quantization.weight_only import is_quantized

    mt = model.config.model_type
    if mt not in _KEY_MAPS:
        raise NotImplementedError(f"no HF key map for model_type {mt!r}")
    key_map = _KEY_MAPS[mt](model.config)
    return quantized_key_map(key_map) if is_quantized(model) else key_map


def hf_tensors(model, reading: bool = False
               ) -> Iterator[Tuple[str, torch.Tensor, Tuple]]:
    """``(HF name, HF-layout view of the parameter, (param, expert,
    transform))`` for every HF tensor of ``model``, in the key map's order;
    an expert's view is the transpose of ``param[expert]``.  An int8 base
    only reads (``reading``): its export raises."""
    key_map = key_map_for(model)
    for path, target, _transposed in jax_leaves(model):
        if path not in key_map:
            raise KeyError(f"no HF mapping for param {'/'.join(path)}")
        template, expert_stacked, *transform = key_map[path]
        transform = transform[0] if transform else None
        if transform and not reading:
            raise NotImplementedError(
                "int8 QLoRA bases export via dequantize_base_params and the "
                "dense key map, not the streaming quantized map")
        layers = target if isinstance(target, list) else [target]
        for i, p in enumerate(layers):
            name = template.format(i=i, e="{e}")
            if expert_stacked:
                for e in range(p.shape[0]):
                    yield name.format(e=e), p[e].t(), (p, e, None)
            else:
                yield name, p, (p, None, transform)


# ---------------------------------------------------------------------------
# reading and writing a consolidated HF repo
# ---------------------------------------------------------------------------
def save_hf_weights(model, out_dir: str,
                    max_shard_bytes: int = 5 * 1024 ** 3,
                    state: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Write ``model``'s weights as a consolidated HF repo (safetensors
    shards of at most ``max_shard_bytes``, the index, ``config.json``).
    ``state`` (HF name -> tensor, from :func:`hf_state`) writes a snapshot
    taken earlier instead of the live parameters."""
    if state is None:
        state = {name: t for name, t, _ in hf_tensors(model)}
    os.makedirs(out_dir, exist_ok=True)
    plan: List[List[str]] = [[]]
    cur = 0
    for name, t in state.items():
        nbytes = t.numel() * t.element_size()
        if plan[-1] and cur + nbytes > max_shard_bytes:
            plan.append([])
            cur = 0
        plan[-1].append(name)
        cur += nbytes
    weight_map, total = {}, 0
    for i, names in enumerate(plan):
        fname = (SAFETENSORS_FILE if len(plan) == 1
                 else f"model-{i + 1:05d}-of-{len(plan):05d}.safetensors")
        total += write_safetensors(os.path.join(out_dir, fname),
                                   {n: state[n] for n in names},
                                   metadata={"format": "pt"})
        weight_map.update(dict.fromkeys(names, fname))
    with open(os.path.join(out_dir, SAFETENSORS_INDEX), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)
    save_hf_config(model, out_dir)


def hf_state(model, device="cpu") -> Dict[str, torch.Tensor]:
    """A copy of every HF tensor of ``model`` on ``device`` (the snapshot
    an asynchronous save writes while training goes on)."""
    return {name: t.detach().to(device, copy=True,
                                memory_format=torch.contiguous_format)
            for name, t, _ in hf_tensors(model)}


@torch.no_grad()
def load_hf_weights(model, ckpt_dir: str) -> None:
    """Fill ``model`` in place from an HF repo (``model.safetensors`` or a
    sharded one with its index), casting to each parameter's dtype; a
    missing tensor or a shape mismatch raises."""
    index = os.path.join(ckpt_dir, SAFETENSORS_INDEX)
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
    elif os.path.exists(os.path.join(ckpt_dir, SAFETENSORS_FILE)):
        header, _ = read_safetensors_header(
            os.path.join(ckpt_dir, SAFETENSORS_FILE))
        weight_map = dict.fromkeys(header, SAFETENSORS_FILE)
    else:
        raise FileNotFoundError(
            f"{ckpt_dir} has no {SAFETENSORS_FILE} or {SAFETENSORS_INDEX}")
    wanted: Dict[str, List[Tuple[str, Tuple]]] = {}
    for name, view, where in hf_tensors(model, reading=True):
        if name not in weight_map:
            raise KeyError(f"{ckpt_dir} lacks {name}")
        wanted.setdefault(weight_map[name], []).append((name, where))
    for fname, entries in wanted.items():
        got = read_safetensors(os.path.join(ckpt_dir, fname),
                               sorted({n for n, _ in entries}))
        for name, (p, expert, transform) in entries:
            t = got[name]
            if transform is not None:     # an int8 base, quantized here
                from automodel_tpu_torch.quantization.weight_only import (
                    quantize_kernel_np,
                )

                t = torch.from_numpy(quantize_kernel_np(t.float().numpy())[
                    0 if transform == INT8_CODES else 1])
            dst = p if expert is None else p[expert].t()
            if tuple(t.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)}"
                                 f" does not fit {tuple(dst.shape)}")
            dst.copy_(t.to(p.dtype))


def load_quantized_hf_base(model, ckpt_dir: str) -> None:
    """Stream an HF repo's bf16 weights into ``model``'s int8 base (the
    projections quantized on the host, one tensor at a time; the JAX
    ``load_quantized_hf_base``)."""
    load_hf_weights(model, ckpt_dir)


def save_hf_config(model, out_dir: str) -> None:
    """``config.json``: the model config's fields plus ``architectures``."""
    d = dataclasses.asdict(model.config)
    d["architectures"] = [_ARCHITECTURES[model.config.model_type]]
    if isinstance(d.get("torch_dtype"), torch.dtype):
        d["torch_dtype"] = str(d["torch_dtype"]).replace("torch.", "")
    d.setdefault("torch_dtype", str(model.param_dtype).replace("torch.", ""))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(d, f, indent=2, default=str)
