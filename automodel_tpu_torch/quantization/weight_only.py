"""Weight-only int8 quantization of a frozen PEFT base, the QLoRA role
(counterpart: ``automodel_tpu/quantization/weight_only.py``).

Each of the seven decoder projections (``QUANTIZED_MODULES``; embeddings
and the head stay in full precision) becomes an :class:`Int8Linear`: an
int8 code ``weight [out, in]`` and an fp32 per-output-channel ``scale
[out, 1]``, both *buffers*, so autograd never sees them and no gradient,
accumulator or optimizer state exists for the base.  The JAX package keeps
the same numbers in its ``[in, out]`` layout (``kernel [L, in, out]``,
``scale [L, 1, out]``): the port's tensors are their per-layer transposes,
code for code.  The model's ``_proj`` dequantizes in the compute dtype
(``weight.to(cd) * scale.to(cd)``) before the product, as the JAX layer
does before XLA fuses it.

The code is per-output-channel symmetric: ``amax`` over the ``in`` axis,
``scale = max(amax, 1e-12) / 127``, ``clip(round(w / scale), -127,
127)`` in fp32, round half to even.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

INT8_MAX = 127.0

# (block, projection) of the JAX tree; the port's layers hold each
# projection as an attribute of the decoder layer
QUANTIZED_MODULES = (
    ("self_attn", "q_proj"), ("self_attn", "k_proj"),
    ("self_attn", "v_proj"), ("self_attn", "o_proj"),
    ("mlp", "gate_proj"), ("mlp", "up_proj"), ("mlp", "down_proj"),
)


def quantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., out, in]`` (the ``nn.Linear`` layout) -> ``(int8 [..., out,
    in], fp32 scale [..., out, 1])``: each output channel's amax maps to
    127."""
    w32 = w.detach().to(torch.float32)
    amax = w32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / INT8_MAX
    q = torch.clamp(torch.round(w32 / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def quantize_kernel_np(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side :func:`quantize_kernel` of a ``[..., out, in]`` array (the
    HF layout), for the streaming read of ``models/hf_io.py``."""
    w32 = np.asarray(w, np.float32)
    amax = np.max(np.abs(w32), axis=-1, keepdims=True)
    scale = np.maximum(amax, np.float32(1e-12)) / np.float32(INT8_MAX)
    q = np.clip(np.round(w32 / scale), -INT8_MAX, INT8_MAX).astype(np.int8)
    return q, scale.astype(np.float32)


class Int8Linear(nn.Module):
    """A frozen projection held as int8 codes and fp32 scales (buffers);
    ``dequantize(dtype)`` gives the ``[out, in]`` weight back.  A biased
    projection (Qwen2's q / k / v) keeps its bias as it was, a frozen
    buffer, as the JAX node keeps ``bias`` beside ``kernel`` and
    ``scale``."""

    def __init__(self, in_features: int, out_features: int, device=None,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight", torch.zeros(
            out_features, in_features, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            out_features, 1, dtype=torch.float32, device=device))
        self.register_buffer(
            "bias", None if bias is None else bias.detach().clone())

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear) -> "Int8Linear":
        out = cls(lin.in_features, lin.out_features, lin.weight.device,
                  bias=lin.bias)
        q, s = quantize_kernel(lin.weight)
        out.weight.copy_(q)
        out.scale.copy_(s)
        return out

    def dequantize(self, dtype) -> torch.Tensor:
        """``weight * scale`` with both cast to ``dtype`` first (the JAX
        layer's order)."""
        return self.weight.to(dtype) * self.scale.to(dtype)


def _projections(model):
    """``(layer, attribute name)`` of every quantizable projection the
    model has (the MoE families' experts are no ``nn.Linear``).  A model
    without a decoder stack of its own (a VLM) raises: its int8 base is
    not ported, and the JAX transform fails on its tree as well."""
    if not hasattr(model, "layers"):
        raise NotImplementedError(
            f"int8 base weights need a decoder stack at `layers`; "
            f"{type(model).__name__} has none (a VLM's quantized base is "
            f"not ported)")
    for layer in model.layers:
        for _mod, proj in QUANTIZED_MODULES:
            if isinstance(getattr(layer, proj, None), (nn.Linear, Int8Linear)):
                yield layer, proj


def quantize_base_params(model) -> None:
    """Replace the decoder projections of ``model`` (a Llama-family model)
    by :class:`Int8Linear` codes of their weights, in place; the dense
    weights are dropped."""
    for layer, proj in _projections(model):
        lin = getattr(layer, proj)
        if isinstance(lin, nn.Linear):
            setattr(layer, proj, Int8Linear.from_linear(lin))


@torch.no_grad()
def dequantize_base_params(model, dtype=torch.bfloat16) -> None:
    """Inverse of :func:`quantize_base_params` (an export back to dense
    weights): ``weight * scale`` in fp32, cast to ``dtype``."""
    for layer, proj in _projections(model):
        q = getattr(layer, proj)
        if isinstance(q, Int8Linear):
            lin = nn.Linear(q.in_features, q.out_features,
                            bias=q.bias is not None, dtype=dtype,
                            device=q.weight.device)
            lin.weight.copy_((q.weight.float() * q.scale.float()).to(dtype))
            if q.bias is not None:
                lin.bias.copy_(q.bias)
                lin.bias.requires_grad_(False)
            setattr(layer, proj, lin)


def load_quantized_hf_base(model, ckpt_dir: str) -> None:
    """Stream an HF repo's bf16 weights straight into ``model``'s int8 base
    (the JAX ``load_quantized_hf_base``, the QLoRA read): each projection's
    tensor is read on the host and quantized there, one at a time, and
    only its codes and scales reach the model's device
    (``models/hf_io.py::quantized_key_map``), so the dense base never
    exists there.  ``model`` is a Llama-family model after
    :func:`quantize_base_params` (under PEFT, the wrapper's
    ``base_model``)."""
    from automodel_tpu_torch.models.hf_io import load_hf_weights

    if not is_quantized(model):
        raise ValueError("load_quantized_hf_base needs an int8 base "
                         "(quantize_base_params first)")
    load_hf_weights(model, ckpt_dir)


def is_quantized(model) -> bool:
    """Whether any decoder projection of ``model`` is an int8 base (never,
    for a model without a decoder stack at ``layers``)."""
    return hasattr(model, "layers") and any(isinstance(getattr(layer, proj), Int8Linear)
               for layer, proj in _projections(model))
