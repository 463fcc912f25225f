"""OLMo-2 (HF ``model_type: olmo2``; counterpart:
``automodel_tpu/models/olmo2.py``).

The Llama decoder of ``models/llama.py`` with two deltas, both where the
norms sit:

* post-norm residual order: no input norm; the block norms apply to the
  attention and MLP outputs before the residual add (``h = resid +
  norm(attn(h))``, then ``h + norm(mlp(h))``), the second one named
  ``post_feedforward_layernorm``;
* ``q_norm`` / ``k_norm`` are RMSNorms over the whole projection width
  (``[Hq D]`` / ``[Hk D]``), applied before the head reshape and rope (not
  per head, as Qwen3's).

Projections (LoRA and quantized-compute seam), rope, attention (kernel 9
on the card), the SwiGLU MLP and the decode caches are the Llama class's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Tuple

from torch import nn

from automodel_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    RMSNorm,
)
from automodel_tpu_torch.models.weights import projection_leaves


@dataclasses.dataclass
class Olmo2Config(LlamaConfig):
    def __post_init__(self):
        super().__post_init__()
        self.model_type = "olmo2"
        self.qk_norm = False        # no per-head norm: OLMo-2's is full-width


class Olmo2DecoderLayer(LlamaDecoderLayer):
    """q / k / v / o, the full-width q / k norms, the post-attention and
    post-feedforward norms and the SwiGLU MLP (no input norm)."""

    def __init__(self, cfg: Olmo2Config, dtype, device):
        nn.Module.__init__(self)
        H, D, eps = cfg.hidden_size, cfg.head_dim, cfg.rms_norm_eps
        self.init_attention(cfg, dtype, device)
        self.q_norm = RMSNorm(cfg.num_attention_heads * D, eps, dtype, device)
        self.k_norm = RMSNorm(cfg.num_key_value_heads * D, eps, dtype, device)
        self.post_attention_layernorm = RMSNorm(H, eps, dtype, device)
        self.post_feedforward_layernorm = RMSNorm(H, eps, dtype, device)
        self.init_mlp(cfg, dtype, device)


class Olmo2ForCausalLM(LlamaForCausalLM):
    """``model_type: olmo2``: the post-norm Llama variant."""

    layer_cls = Olmo2DecoderLayer

    def _attention_block(self, layer, hidden, position_ids, segment_ids,
                         kv_cache, attn_impl):
        cfg = self.config
        B, S, _ = hidden.shape
        D, Hq, Hk = cfg.head_dim, cfg.num_attention_heads, \
            cfg.num_key_value_heads
        q = layer.q_norm(self._proj(layer.q_proj, hidden, "self_attn.q_proj"))
        k = layer.k_norm(self._proj(layer.k_proj, hidden, "self_attn.k_proj"))
        v = self._proj(layer.v_proj, hidden, "self_attn.v_proj")
        q, k = self._apply_rope(q.view(B, S, Hq, D), k.view(B, S, Hk, D),
                                position_ids)
        attn = self._attend(q, k, v.view(B, S, Hk, D), segment_ids, kv_cache,
                            attn_impl)
        out = self._proj(layer.o_proj, attn.reshape(B, S, Hq * D),
                         "self_attn.o_proj")
        return hidden + layer.post_attention_layernorm(out)

    def _layer(self, layer, hidden, position_ids, segment_ids, kv_cache,
               attn_impl, adapters=None):
        self._adapters = adapters
        try:
            hidden = self._attention_block(layer, hidden, position_ids,
                                           segment_ids, kv_cache, attn_impl)
            out, aux = self._mlp_block(hidden, layer)
        finally:
            self._adapters = None
        return hidden + layer.post_feedforward_layernorm(out), aux

    def jax_tree_leaves(self) -> Iterator[Tuple[Tuple[str, ...], Any, bool]]:
        """``(JAX path, target, transposed)`` of every leaf of the JAX
        OLMo-2 tree (``models/weights.py::jax_leaves``)."""
        layers = self.layers
        yield ("embed_tokens", "embedding"), self.embed_tokens.weight, False
        for norm in ("post_attention_layernorm", "post_feedforward_layernorm"):
            yield (("layers", norm, "weight"),
                   [getattr(l, norm).weight for l in layers], False)
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            yield from projection_leaves(layers, "self_attn", proj)
        for norm in ("q_norm", "k_norm"):
            yield (("layers", "self_attn", norm, "weight"),
                   [getattr(l, norm).weight for l in layers], False)
        for proj in ("gate_proj", "up_proj", "down_proj"):
            yield from projection_leaves(layers, "mlp", proj)
        yield ("norm", "weight"), self.norm.weight, False
        if self.lm_head is not None:
            yield ("lm_head", "kernel"), self.lm_head.weight, True
