"""Phi-3 / Phi-4 text (HF ``model_type: phi3``; counterpart:
``automodel_tpu/models/phi3.py``, the text decoder of
``automodel_tpu/models/phi4_mm.py``: ``Phi4MMTextConfig`` /
``Phi4MMTextModel``).

The Llama decoder of ``models/llama.py`` with the Phi layout:

* fused, bias-free ``qkv_proj`` (``[(Hq + 2 Hk) D, H]``, split q | k | v)
  and ``gate_up_proj`` (``[2 I, H]``, gate first; ``up * silu(gate)``),
  kept fused so HF checkpoints round-trip tensor for tensor;
* partial rotary: rope turns the first ``head_dim *
  partial_rotary_factor`` channels of each head, the rest pass through;
* longrope (the 128k variants): both tables are held and the forward
  picks one from its positions (``ops/rotary.py``).

Phi-3-mini's and Phi-3.5-mini's head_dim 96 runs kernel 9 through its
zero-padded route (``ops/splash_attention.py``); the decode kernel takes
64 and 128 only and raises at 96.  The audio tower and
``Phi4MMForCausalLM`` are not ported (ROADMAP Queue 1 item 10.8).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

from automodel_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    _linear,
)


@dataclasses.dataclass
class Phi3Config(LlamaConfig):
    """HF ``Phi3Config`` field names (the JAX ``Phi4MMTextConfig``)."""

    partial_rotary_factor: float = 1.0

    def __post_init__(self):
        super().__post_init__()
        self.model_type = "phi3"

    @classmethod
    def from_hf_config(cls, hf: Dict[str, Any]) -> "Phi3Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in hf.items() if k in known})


class Phi3DecoderLayer(LlamaDecoderLayer):
    def init_attention(self, cfg: Phi3Config, dtype, device) -> None:
        H, D = cfg.hidden_size, cfg.head_dim
        Hq, Hk = cfg.num_attention_heads, cfg.num_key_value_heads
        self.qkv_proj = _linear(H, (Hq + 2 * Hk) * D, dtype, device)
        self.o_proj = _linear(Hq * D, H, dtype, device)

    def init_mlp(self, cfg: Phi3Config, dtype, device) -> None:
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.gate_up_proj = _linear(H, 2 * I, dtype, device)
        self.down_proj = _linear(I, H, dtype, device)


class Phi3ForCausalLM(LlamaForCausalLM):
    """``model_type: phi3``: the fused-projection Phi decoder."""

    layer_cls = Phi3DecoderLayer

    def _layer(self, layer, hidden, position_ids, segment_ids, kv_cache,
               attn_impl, adapters=None):
        if adapters is not None:
            # as JAX: no adapter wiring for the fused projections
            raise NotImplementedError(
                "LoRA is not wired for the fused Phi projections "
                "(qkv_proj, gate_up_proj)")
        return super()._layer(layer, hidden, position_ids, segment_ids,
                              kv_cache, attn_impl)

    def _attention_block(self, layer, hidden, position_ids, segment_ids,
                         kv_cache, attn_impl):
        cfg = self.config
        B, S, _ = hidden.shape
        D, Hq, Hk = cfg.head_dim, cfg.num_attention_heads, \
            cfg.num_key_value_heads
        x = layer.input_layernorm(hidden)
        qkv = self._proj(layer.qkv_proj, x, "self_attn.qkv_proj")
        q, k, v = qkv.split([Hq * D, Hk * D, Hk * D], dim=-1)
        q, k = self._apply_rope(q.reshape(B, S, Hq, D),
                                k.reshape(B, S, Hk, D), position_ids)
        attn = self._attend(q, k, v.reshape(B, S, Hk, D), segment_ids,
                            kv_cache, attn_impl)
        return hidden + self._proj(layer.o_proj, attn.reshape(B, S, Hq * D),
                                   "self_attn.o_proj")

    def _mlp_block(self, x: torch.Tensor, layer: Phi3DecoderLayer):
        gate, up = self._proj(layer.gate_up_proj, x,
                              "mlp.gate_up_proj").chunk(2, dim=-1)
        act = self._tag(up * F.silu(gate), "mlp_silu")
        return self._proj(layer.down_proj, act, "mlp.down_proj"), None

    def jax_tree_leaves(self) -> Iterator[Tuple[Tuple[str, ...], Any, bool]]:
        """``(JAX path, target, transposed)`` of every leaf of the JAX Phi
        tree (``models/weights.py::jax_leaves``)."""
        layers = self.layers
        yield ("embed_tokens", "embedding"), self.embed_tokens.weight, False
        for norm in ("input_layernorm", "post_attention_layernorm"):
            yield (("layers", norm, "weight"),
                   [getattr(l, norm).weight for l in layers], False)
        for block, proj in (("self_attn", "qkv_proj"), ("self_attn", "o_proj"),
                            ("mlp", "gate_up_proj"), ("mlp", "down_proj")):
            yield (("layers", block, proj, "kernel"),
                   [getattr(l, proj).weight for l in layers], True)
        yield ("norm", "weight"), self.norm.weight, False
        if self.lm_head is not None:
            yield ("lm_head", "kernel"), self.lm_head.weight, True
