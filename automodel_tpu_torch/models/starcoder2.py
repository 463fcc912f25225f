"""StarCoder-2 (HF ``model_type: starcoder2``; counterpart:
``automodel_tpu/models/starcoder2.py``).

A pre-norm Llama-shaped decoder (``models/llama.py``) with GPT-2's genes:

* LayerNorm with weight and bias (``norm_epsilon``) for the block norms
  and the final norm (the decoder's ``norm_cls`` hook);
* biased q / k / v / o and MLP projections (``use_bias``);
* a plain MLP, ``c_fc -> gelu(tanh) -> c_proj``, no gate;
* the uniform ``sliding_window`` (4,096 in the released checkpoints),
  which reaches kernel 9 as its ``local_window_size``.

Rope, attention, the LoRA / quantized-compute seam and the decode caches
are the Llama class's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Tuple

import torch
import torch.nn.functional as F

from automodel_tpu_torch.models.llama import (
    LayerNorm,
    LlamaConfig,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    _linear,
)
from automodel_tpu_torch.models.weights import projection_leaves


@dataclasses.dataclass
class Starcoder2Config(LlamaConfig):
    use_bias: bool = True
    norm_epsilon: float = 1e-5

    def __post_init__(self):
        super().__post_init__()
        self.model_type = "starcoder2"
        self.rms_norm_eps = self.norm_epsilon      # the norms' epsilon
        self.attention_bias = bool(self.use_bias)


class Starcoder2DecoderLayer(LlamaDecoderLayer):
    norm_cls = LayerNorm

    def init_attention(self, cfg: Starcoder2Config, dtype, device) -> None:
        super().init_attention(cfg, dtype, device)
        if cfg.use_bias:
            H, D = cfg.hidden_size, cfg.head_dim
            self.o_proj = _linear(cfg.num_attention_heads * D, H, dtype,
                                  device, True)

    def init_mlp(self, cfg: Starcoder2Config, dtype, device) -> None:
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.c_fc = _linear(H, I, dtype, device, cfg.use_bias)
        self.c_proj = _linear(I, H, dtype, device, cfg.use_bias)


class Starcoder2ForCausalLM(LlamaForCausalLM):
    """``model_type: starcoder2``: LayerNorm and a biased GELU MLP."""

    layer_cls = Starcoder2DecoderLayer

    def _mlp_block(self, x: torch.Tensor, layer: Starcoder2DecoderLayer):
        h = self._tag(F.gelu(self._proj(layer.c_fc, x, "mlp.c_fc"),
                             approximate="tanh"), "mlp_silu")
        return self._proj(layer.c_proj, h, "mlp.c_proj"), None

    def flops_per_token(self) -> float:
        """6N over the matmul parameters, as the Llama class counts, with
        the MLP's two matrices (the JAX family inherits Llama's three)."""
        cfg = self.config
        return (super().flops_per_token()
                - 3.0 * cfg.num_hidden_layers * 2 * cfg.hidden_size
                * cfg.intermediate_size)

    def jax_tree_leaves(self) -> Iterator[Tuple[Tuple[str, ...], Any, bool]]:
        """``(JAX path, target, transposed)`` of every leaf of the JAX
        StarCoder-2 tree (``models/weights.py::jax_leaves``)."""
        layers = self.layers
        yield ("embed_tokens", "embedding"), self.embed_tokens.weight, False
        for norm in ("input_layernorm", "post_attention_layernorm"):
            for wb in ("weight", "bias"):
                yield (("layers", norm, wb),
                       [getattr(getattr(l, norm), wb) for l in layers], False)
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            yield from projection_leaves(layers, "self_attn", proj)
        for proj in ("c_fc", "c_proj"):
            yield from projection_leaves(layers, "mlp", proj)
        yield ("norm", "weight"), self.norm.weight, False
        yield ("norm", "bias"), self.norm.bias, False
        if self.lm_head is not None:
            yield ("lm_head", "kernel"), self.lm_head.weight, True
