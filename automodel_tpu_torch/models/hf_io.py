"""HF safetensors <-> the port's modules (counterpart:
``automodel_tpu/models/hf_io.py``).

The key maps are the JAX package's for the ported families (llama and, on
its map, mistral, qwen2 (q / k / v biases), qwen3 and granite; olmo2,
starcoder2, phi3 (fused ``qkv_proj`` / ``gate_up_proj``) and gpt2;
mixtral, qwen3_moe, deepseek_v2, deepseek_v3; gemma3_text and gemma2, and
the VLMs gemma3 and llava with their SigLIP tower), keyed by the same JAX
tree paths that ``models/weights.py::jax_leaves`` walks; an entry is an
:class:`HfEntry`. A sequence classifier's map is its backbone's re-rooted
under ``backbone`` without ``lm_head``, plus ``score.weight``, which a
causal-LM directory lacks: the head then keeps its fresh draw, as HF's
``from_pretrained`` and the JAX reader give a new head. GPT-2 is written
with the JAX package's names (``h.{i}.attn.c_attn.weight``, ``wte.weight``
...) in HF's Conv1D layout ``[in, out]`` (the parameter's transpose); a
checkpoint whose names carry HF's ``transformer.`` prefix reads too.
DeepSeek's split stack maps its sub-stacks onto HF's one layer index with
``layer_offset`` (``layers[j]`` is HF layer ``j +
first_k_dense_replace``), and a checkpoint without V3's
``e_score_correction_bias`` loads it as zeros, as the JAX reader does. HF
stores an ``nn.Linear`` as ``(out, in)``, the port's layout, so
projections and routers copy as they are; the expert stacks keep the JAX
layout ``[E, in, out]`` per layer and are split into (joined from) one
transposed HF tensor per expert (``...experts.{e}.<name>.weight``). The
vision tower's patch embedding is HF's Conv2d weight ``[H, C, p, p]`` and
the port's ``[H, p * p * C]`` matmul over ``(row, col, channel)`` patches:
the entry's ``view`` reads and writes the one through a permuted view of
the other.

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
card (``quantization/weight_only.py::load_quantized_hf_base``, the QLoRA
streaming read, re-exported here); such a
base exports through ``dequantize_base_params`` and the dense map.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

from automodel_tpu_torch.models.weights import jax_leaves
from automodel_tpu_torch.quantization.weight_only import (  # noqa: F401
    load_quantized_hf_base,
)

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
                  "mistral": "MistralForCausalLM",
                  "qwen2": "Qwen2ForCausalLM",
                  "qwen3": "Qwen3ForCausalLM",
                  "granite": "GraniteForCausalLM",
                  "olmo2": "Olmo2ForCausalLM",
                  "starcoder2": "Starcoder2ForCausalLM",
                  "phi3": "Phi3ForCausalLM",
                  "gpt2": "GPT2LMHeadModel",
                  "mixtral": "MixtralForCausalLM",
                  "qwen3_moe": "Qwen3MoeForCausalLM",
                  "deepseek_v2": "DeepseekV2ForCausalLM",
                  "deepseek_v3": "DeepseekV3ForCausalLM",
                  "gemma3_text": "Gemma3ForCausalLM",
                  "gemma2": "Gemma2ForCausalLM",
                  "gemma3": "Gemma3ForConditionalGeneration",
                  "llava": "LlavaForConditionalGeneration"}


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
# key maps: JAX tree path -> HfEntry
# ---------------------------------------------------------------------------
class HfEntry(NamedTuple):
    """How one JAX leaf maps onto HF tensors: the name ``template``
    (``{i}`` the HF layer, ``{e}`` the expert), whether the leaf stacks
    experts, the read ``transform`` of an int8 base, the HF layer of the
    leaf's first stacked slice, whether a checkpoint without the
    tensor reads it as zeros, ``view``: the parameter -> its HF-layout
    view, where the layouts differ by more than a transpose, and whether a
    checkpoint without the tensor leaves the parameter as drawn (a
    classifier's fresh ``score``)."""
    template: str
    expert_stacked: bool = False
    transform: Optional[str] = None
    layer_offset: int = 0
    zeros_if_missing: bool = False
    view: Optional[Callable] = None
    fresh_if_missing: bool = False


# Prefixes a checkpoint's names may carry that the key maps leave out
# (HF's ``GPT2LMHeadModel`` writes ``transformer.h.0...``).
_READ_PREFIXES = ("transformer.",)


def llama_key_map(config) -> Dict[Tuple[str, ...], HfEntry]:
    m = {
        ("embed_tokens", "embedding"): HfEntry("model.embed_tokens.weight"),
        ("norm", "weight"): HfEntry("model.norm.weight"),
    }
    for norm in ("input_layernorm", "post_attention_layernorm"):
        m[("layers", norm, "weight")] = HfEntry(
            f"model.layers.{{i}}.{norm}.weight")
    for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
        m[("layers", "self_attn", proj, "kernel")] = HfEntry(
            f"model.layers.{{i}}.self_attn.{proj}.weight")
    if config.attention_bias:
        for proj in ("q_proj", "k_proj", "v_proj"):
            m[("layers", "self_attn", proj, "bias")] = HfEntry(
                f"model.layers.{{i}}.self_attn.{proj}.bias")
    if config.qk_norm:
        for norm in ("q_norm", "k_norm"):
            m[("layers", "self_attn", norm, "weight")] = HfEntry(
                f"model.layers.{{i}}.self_attn.{norm}.weight")
    for proj in ("gate_proj", "up_proj", "down_proj"):
        m[("layers", "mlp", proj, "kernel")] = HfEntry(
            f"model.layers.{{i}}.mlp.{proj}.weight")
    if not config.tie_word_embeddings:
        m[("lm_head", "kernel")] = HfEntry("lm_head.weight")
    return m


def olmo2_key_map(config) -> Dict[Tuple[str, ...], HfEntry]:
    """OLMo-2 (HF ``Olmo2ForCausalLM``): Llama's projections, the
    post-attention and post-feedforward norms (no input norm), full-width
    q / k norms."""
    m = llama_key_map(config)
    del m[("layers", "input_layernorm", "weight")]
    m[("layers", "post_feedforward_layernorm", "weight")] = HfEntry(
        "model.layers.{i}.post_feedforward_layernorm.weight")
    for norm in ("q_norm", "k_norm"):
        m[("layers", "self_attn", norm, "weight")] = HfEntry(
            f"model.layers.{{i}}.self_attn.{norm}.weight")
    return m


def starcoder2_key_map(config) -> Dict[Tuple[str, ...], HfEntry]:
    """StarCoder-2 (HF ``Starcoder2ForCausalLM``): Llama's attention with
    biases everywhere, LayerNorms with biases, the ``c_fc`` / ``c_proj``
    MLP."""
    m = llama_key_map(config)
    for proj in ("gate_proj", "up_proj", "down_proj"):
        del m[("layers", "mlp", proj, "kernel")]
    for proj in ("c_fc", "c_proj"):
        m[("layers", "mlp", proj, "kernel")] = HfEntry(
            f"model.layers.{{i}}.mlp.{proj}.weight")
        if config.use_bias:
            m[("layers", "mlp", proj, "bias")] = HfEntry(
                f"model.layers.{{i}}.mlp.{proj}.bias")
    if config.use_bias:
        m[("layers", "self_attn", "o_proj", "bias")] = HfEntry(
            "model.layers.{i}.self_attn.o_proj.bias")
    for norm in ("input_layernorm", "post_attention_layernorm"):
        m[("layers", norm, "bias")] = HfEntry(
            f"model.layers.{{i}}.{norm}.bias")
    m[("norm", "bias")] = HfEntry("model.norm.bias")
    return m


def phi3_key_map(config) -> Dict[Tuple[str, ...], HfEntry]:
    """Phi-3 / Phi-4 text (HF ``Phi3ForCausalLM``): the fused ``qkv_proj``
    and ``gate_up_proj``."""
    m = {
        ("embed_tokens", "embedding"): HfEntry("model.embed_tokens.weight"),
        ("norm", "weight"): HfEntry("model.norm.weight"),
    }
    for norm in ("input_layernorm", "post_attention_layernorm"):
        m[("layers", norm, "weight")] = HfEntry(
            f"model.layers.{{i}}.{norm}.weight")
    for block, proj in (("self_attn", "qkv_proj"), ("self_attn", "o_proj"),
                        ("mlp", "gate_up_proj"), ("mlp", "down_proj")):
        m[("layers", block, proj, "kernel")] = HfEntry(
            f"model.layers.{{i}}.{block}.{proj}.weight")
    if not config.tie_word_embeddings:
        m[("lm_head", "kernel")] = HfEntry("lm_head.weight")
    return m


def _conv1d(w):             # nn.Linear [out, in] -> HF Conv1D [in, out]
    return w.t()


def gpt2_key_map(config) -> Dict[Tuple[str, ...], HfEntry]:
    """GPT-2 under the JAX package's names: ``wte`` / ``wpe`` / ``ln_f``
    and ``h.{i}.*``, the four linears in Conv1D's ``[in, out]``."""
    m = {
        ("wte", "embedding"): HfEntry("wte.weight"),
        ("wpe", "embedding"): HfEntry("wpe.weight"),
        ("ln_f", "weight"): HfEntry("ln_f.weight"),
        ("ln_f", "bias"): HfEntry("ln_f.bias"),
    }
    if not config.tie_word_embeddings:
        m[("lm_head", "kernel")] = HfEntry("lm_head.weight")
    for ln in ("ln_1", "ln_2"):
        for wb in ("weight", "bias"):
            m[("h", ln, wb)] = HfEntry(f"h.{{i}}.{ln}.{wb}")
    for mod, sub in (("attn", "c_attn"), ("attn", "c_proj"),
                     ("mlp", "c_fc"), ("mlp", "c_proj")):
        m[("h", mod, sub, "kernel")] = HfEntry(f"h.{{i}}.{mod}.{sub}.weight",
                                               view=_conv1d)
        m[("h", mod, sub, "bias")] = HfEntry(f"h.{{i}}.{mod}.{sub}.bias")
    return m


def _moe_key_map(config, block: str, experts: Tuple[str, ...]):
    m = llama_key_map(config)
    for proj in ("gate_proj", "up_proj", "down_proj"):
        del m[("layers", "mlp", proj, "kernel")]
    m[("layers", block, "gate", "kernel")] = HfEntry(
        f"model.layers.{{i}}.{block}.gate.weight")
    for name in experts:
        m[("layers", block, "experts", name, "kernel")] = HfEntry(
            f"model.layers.{{i}}.{block}.experts.{{e}}.{name}.weight", True)
    return m


def mixtral_key_map(config):
    return _moe_key_map(config, "block_sparse_moe", ("w1", "w2", "w3"))


def qwen3_moe_key_map(config):
    return _moe_key_map(config, "mlp", ("gate_proj", "up_proj", "down_proj"))


def deepseek_v3_key_map(config) -> Dict[Tuple[str, ...], HfEntry]:
    """DeepSeek-V2 / V3 (HF ``DeepseekV3ForCausalLM`` naming, the JAX
    map): the MLA projections and norms of both sub-stacks, the dense MLP
    of ``dense_layers``, and the router, its correction bias, the experts
    and the shared experts of ``layers``, whose HF layers start at
    ``first_k_dense_replace``."""
    kd = config.first_k_dense_replace
    m: Dict[Tuple[str, ...], HfEntry] = {
        ("embed_tokens", "embedding"): HfEntry("model.embed_tokens.weight"),
        ("norm", "weight"): HfEntry("model.norm.weight"),
    }
    if not config.tie_word_embeddings:
        m[("lm_head", "kernel")] = HfEntry("lm_head.weight")

    def attn_and_norms(stack: str, off: int):
        for norm in ("input_layernorm", "post_attention_layernorm"):
            m[(stack, norm, "weight")] = HfEntry(
                f"model.layers.{{i}}.{norm}.weight", layer_offset=off)
        projs = (("q_proj",) if config.q_lora_rank is None
                 else ("q_a_proj", "q_b_proj"))
        for proj in projs + ("kv_a_proj_with_mqa", "kv_b_proj", "o_proj"):
            m[(stack, "self_attn", proj, "kernel")] = HfEntry(
                f"model.layers.{{i}}.self_attn.{proj}.weight",
                layer_offset=off)
        norms = (("kv_a_layernorm",) if config.q_lora_rank is None
                 else ("q_a_layernorm", "kv_a_layernorm"))
        for norm in norms:
            m[(stack, "self_attn", norm, "weight")] = HfEntry(
                f"model.layers.{{i}}.self_attn.{norm}.weight",
                layer_offset=off)

    if kd:
        attn_and_norms("dense_layers", 0)
        for proj in ("gate_proj", "up_proj", "down_proj"):
            m[("dense_layers", "mlp", proj, "kernel")] = HfEntry(
                f"model.layers.{{i}}.mlp.{proj}.weight")
    if config.num_hidden_layers - kd:
        attn_and_norms("layers", kd)
        m[("layers", "mlp", "gate", "kernel")] = HfEntry(
            "model.layers.{i}.mlp.gate.weight", layer_offset=kd)
        m[("layers", "mlp", "gate", "e_score_correction_bias")] = HfEntry(
            "model.layers.{i}.mlp.gate.e_score_correction_bias",
            layer_offset=kd, zeros_if_missing=True)
        for proj in ("gate_proj", "up_proj", "down_proj"):
            m[("layers", "mlp", "experts", proj, "kernel")] = HfEntry(
                f"model.layers.{{i}}.mlp.experts.{{e}}.{proj}.weight", True,
                layer_offset=kd)
            m[("layers", "mlp", "shared_experts", proj, "kernel")] = HfEntry(
                f"model.layers.{{i}}.mlp.shared_experts.{proj}.weight",
                layer_offset=kd)
    return m


def deepseek_v2_key_map(config) -> Dict[Tuple[str, ...], HfEntry]:
    """DeepSeek-V2: the V3 map without the correction bias (V2's softmax
    gate has none)."""
    m = deepseek_v3_key_map(config)
    m.pop(("layers", "mlp", "gate", "e_score_correction_bias"), None)
    return m


def gemma3_key_map(config) -> Dict[Tuple[str, ...], HfEntry]:
    """Gemma-3 text and Gemma-2 (HF ``Gemma3ForCausalLM`` /
    ``Gemma2ForCausalLM`` naming): four norms a layer, q / k norms when
    the config has them."""
    m = {
        ("embed_tokens", "embedding"): HfEntry("model.embed_tokens.weight"),
        ("norm", "weight"): HfEntry("model.norm.weight"),
    }
    for norm in ("input_layernorm", "post_attention_layernorm",
                 "pre_feedforward_layernorm", "post_feedforward_layernorm"):
        m[("layers", norm, "weight")] = HfEntry(
            f"model.layers.{{i}}.{norm}.weight")
    for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
        m[("layers", "self_attn", proj, "kernel")] = HfEntry(
            f"model.layers.{{i}}.self_attn.{proj}.weight")
    if config.qk_norm:
        for norm in ("q_norm", "k_norm"):
            m[("layers", "self_attn", norm, "weight")] = HfEntry(
                f"model.layers.{{i}}.self_attn.{norm}.weight")
    for proj in ("gate_proj", "up_proj", "down_proj"):
        m[("layers", "mlp", proj, "kernel")] = HfEntry(
            f"model.layers.{{i}}.mlp.{proj}.weight")
    if not config.tie_word_embeddings:
        m[("lm_head", "kernel")] = HfEntry("lm_head.weight")
    return m


def vision_key_map(config, prefix: str = "vision_tower.vision_model."
                   ) -> Dict[Tuple[str, ...], HfEntry]:
    """The SigLIP tower (HF ``SiglipVisionModel`` naming under
    ``prefix``); the patch embedding through a view of HF's Conv2d layout
    ``[H, C, p, p]``."""
    p, C = config.patch_size, config.num_channels

    def conv_view(w):            # [H, p * p * C] -> [H, C, p, p]
        return w.view(w.shape[0], p, p, C).permute(0, 3, 1, 2)

    m = {
        ("patch_embed", "kernel"): HfEntry(
            prefix + "embeddings.patch_embedding.weight", view=conv_view),
        ("patch_embed", "bias"): HfEntry(
            prefix + "embeddings.patch_embedding.bias"),
        ("pos_embed", "embedding"): HfEntry(
            prefix + "embeddings.position_embedding.weight"),
        ("post_ln", "weight"): HfEntry(prefix + "post_layernorm.weight"),
        ("post_ln", "bias"): HfEntry(prefix + "post_layernorm.bias"),
    }
    layer = prefix + "encoder.layers.{i}."
    for ours, hf in (("ln_1", "layer_norm1"), ("ln_2", "layer_norm2")):
        for wb in ("weight", "bias"):
            m[("layers", ours, wb)] = HfEntry(layer + f"{hf}.{wb}")
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        for wb, leaf in (("weight", "kernel"), ("bias", "bias")):
            m[("layers", "attn", proj, leaf)] = HfEntry(
                layer + f"self_attn.{proj}.{wb}")
    for fc in ("fc1", "fc2"):
        for wb, leaf in (("weight", "kernel"), ("bias", "bias")):
            m[("layers", "mlp", fc, leaf)] = HfEntry(
                layer + f"mlp.{fc}.{wb}")
    return m


def vlm_key_map(config) -> Dict[Tuple[str, ...], HfEntry]:
    """llava (HF naming: ``language_model.*``,
    ``vision_tower.vision_model.*``,
    ``multi_modal_projector.linear_{1,2}``)."""
    m = {("language_model",) + path: e._replace(
        template="language_model." + e.template)
        for path, e in llama_key_map(config.text_config).items()}
    for path, e in vision_key_map(config.vision_config).items():
        m[("vision_tower",) + path] = e
    for ours, hf in (("fc1", "linear_1"), ("fc2", "linear_2")):
        m[("multi_modal_projector", ours, "kernel")] = HfEntry(
            f"multi_modal_projector.{hf}.weight")
        m[("multi_modal_projector", ours, "bias")] = HfEntry(
            f"multi_modal_projector.{hf}.bias")
    return m


def gemma3_vlm_key_map(config) -> Dict[Tuple[str, ...], HfEntry]:
    """Gemma-3 multimodal (HF ``Gemma3ForConditionalGeneration`` naming:
    ``model.language_model.*``, ``model.vision_tower.vision_model.*``,
    ``model.multi_modal_projector.mm_*``)."""
    m = {("language_model",) + path: e._replace(
        template=e.template.replace("model.", "model.language_model.", 1))
        for path, e in gemma3_key_map(config.text_config).items()}
    for path, e in vision_key_map(
            config.vision_config,
            prefix="model.vision_tower.vision_model.").items():
        m[("vision_tower",) + path] = e
    m[("multi_modal_projector", "mm_input_projection_weight")] = HfEntry(
        "model.multi_modal_projector.mm_input_projection_weight")
    m[("multi_modal_projector", "mm_soft_emb_norm", "weight")] = HfEntry(
        "model.multi_modal_projector.mm_soft_emb_norm.weight")
    return m


_KEY_MAPS = {"llama": llama_key_map, "mistral": llama_key_map,
             "qwen2": llama_key_map, "qwen3": llama_key_map,
             "granite": llama_key_map, "olmo2": olmo2_key_map,
             "starcoder2": starcoder2_key_map, "phi3": phi3_key_map,
             "gpt2": gpt2_key_map,
             "mixtral": mixtral_key_map,
             "qwen3_moe": qwen3_moe_key_map,
             "deepseek_v2": deepseek_v2_key_map,
             "deepseek_v3": deepseek_v3_key_map,
             "gemma3_text": gemma3_key_map, "gemma2": gemma3_key_map,
             "gemma3": gemma3_vlm_key_map, "llava": vlm_key_map}

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
            entry = HfEntry(*m[path])
            m[path] = entry._replace(transform=INT8_CODES)
            m[("layers", mod, proj, "scale")] = entry._replace(
                transform=INT8_SCALE)
    return m


def classifier_key_map(backbone_map) -> Dict[Tuple[str, ...], HfEntry]:
    """A sequence classifier's map: the backbone's under ``backbone``
    without ``lm_head``, and ``score.weight`` (fresh when missing)."""
    m = {("backbone",) + path: e for path, e in backbone_map.items()
         if path[0] != "lm_head"}
    m[("score", "kernel")] = HfEntry("score.weight", fresh_if_missing=True)
    return m


def key_map_for(model):
    """The JAX-path -> HF key map of ``model``'s family (the quantized one
    for an int8 base; a classifier's re-rooted one)."""
    from automodel_tpu_torch.quantization.weight_only import is_quantized

    if hasattr(model, "backbone") and hasattr(model, "score"):
        return classifier_key_map(key_map_for(model.backbone))
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
        entry = HfEntry(*key_map[path])
        template, expert_stacked, transform = entry[:3]
        if transform and not reading:
            raise NotImplementedError(
                "int8 QLoRA bases export via dequantize_base_params and the "
                "dense key map, not the streaming quantized map")
        layers = target if isinstance(target, list) else [target]
        for i, p in enumerate(layers):
            name = template.format(i=i + entry.layer_offset, e="{e}")
            if expert_stacked:
                for e in range(p.shape[0]):
                    yield name.format(e=e), p[e].t(), (p, e, None, False,
                                                       False)
            else:
                if entry.view is not None:
                    p = entry.view(p)
                yield name, p, (p, None, transform, entry.zeros_if_missing,
                                entry.fresh_if_missing)


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
        stored = next((pre + name for pre in ("",) + _READ_PREFIXES
                       if pre + name in weight_map), None)
        if stored is None:
            if where[3]:                # e.g. V3's correction bias
                view.zero_()
                continue
            if where[4]:                # a classifier's new score head
                continue
            raise KeyError(f"{ckpt_dir} lacks {name}")
        wanted.setdefault(weight_map[stored], []).append((stored, where))
    for fname, entries in wanted.items():
        got = read_safetensors(os.path.join(ckpt_dir, fname),
                               sorted({n for n, _ in entries}))
        for name, (p, expert, transform, _, _) in entries:
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


def save_hf_config(model, out_dir: str) -> None:
    """``config.json``: the model config's fields plus ``architectures``
    (and a classifier's ``num_labels``, ``pad_token_id`` and label maps,
    as the JAX writer)."""
    d = dataclasses.asdict(model.config)
    arch = _ARCHITECTURES[model.config.model_type]
    if hasattr(model, "num_labels"):
        n = model.num_labels
        arch = arch.replace("ForCausalLM", "") + "ForSequenceClassification"
        d.update(num_labels=n, pad_token_id=model.pad_token_id,
                 id2label={str(i): f"LABEL_{i}" for i in range(n)},
                 label2id={f"LABEL_{i}": i for i in range(n)})
    if d.get("original_max_position_embeddings", 0) is None:
        # HF reads an absent key as max_position_embeddings (Phi-3)
        d.pop("original_max_position_embeddings")
    d["architectures"] = [arch]
    if isinstance(d.get("torch_dtype"), torch.dtype):
        d["torch_dtype"] = str(d["torch_dtype"]).replace("torch.", "")
    d.setdefault("torch_dtype", str(model.param_dtype).replace("torch.", ""))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(d, f, indent=2, default=str)
