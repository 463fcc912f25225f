"""Mixtral-family sparse-MoE decoder (counterpart:
``automodel_tpu/models/mixtral.py``).

The Llama decoder of ``models/llama.py`` with its dense SwiGLU replaced by
the routed expert block of ``ops/moe.py``.  Each layer holds a
:class:`SparseMoeBlock`: the router ``gate`` (an ``nn.Linear`` ``[E, H]``;
the JAX kernel is ``[H, E]``) and the experts' weights stacked as
parameters ``[E, H, I]`` (gate and up projections) and ``[E, I, H]``
(down), the JAX layout, which the grouped matmuls take as they are.  The
expert names are the JAX tree's (``w1`` / ``w3`` / ``w2`` here,
``gate_proj`` / ``up_proj`` / ``down_proj`` in Qwen3-MoE), so
``models/weights.py`` maps the two trees one to one.

Each layer returns its routing statistics; ``_combine_aux`` averages them
over the layers before the load-balancing product (HF concatenates every
layer's tokens) and scales by ``router_aux_loss_coef`` when
``output_router_logits`` is on.  ``gmm_impl`` reaches the grouped matmuls
(None: the kernels on CUDA tensors; ``"plain"`` forces the plain
versions).  With quantized compute on, the experts' grouped matmuls are
quantized unless ``filter_fqns`` names ``block_sparse_moe.experts``
(``mlp.experts`` in Qwen3-MoE), the JAX names.

With a KV cache (``DecodeEngine``'s ``PagedKVView`` or the dense cache of
``generate()``) the routed block runs on every row of the step, inactive
slots and prompt padding included, as the JAX model's inherited forward
does: under capacity routing a token's drops depend on the step's batch
(that is the JAX semantics; dropless routing, ``moe_capacity_factor:
null``, makes a token's experts its own).  The routing statistics are
computed and go unused while serving, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from automodel_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaDecoderLayer,
    LlamaForCausalLM,
)
from automodel_tpu_torch.ops import moe
from automodel_tpu_torch.ops.quant import quant_for


@dataclasses.dataclass
class MixtralConfig(LlamaConfig):
    """HF ``MixtralConfig`` field names on top of the Llama config."""

    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    router_aux_loss_coef: float = 0.02
    output_router_logits: bool = False
    # not HF fields: GShard capacity (None = dropless), tokens per routing
    # group, and the expert dispatch path (None = sorted)
    moe_capacity_factor: Optional[float] = 2.0
    moe_group_size: int = 512
    moe_dispatch: Optional[str] = None

    def __post_init__(self):
        super().__post_init__()
        self.model_type = "mixtral"
        self.moe_dispatch = moe.validate_moe_dispatch(
            moe.normalize_moe_dispatch(self.moe_dispatch))


class SparseMoeBlock(nn.Module):
    """Router ``gate`` and the stacked experts ``experts.<name>`` for the
    three names of the family (gate, up, down projections)."""

    def __init__(self, hidden: int, inter: int, experts: int,
                 names: Sequence[str], dtype, device):
        super().__init__()
        self.gate = nn.Linear(hidden, experts, bias=False, dtype=dtype,
                              device=device)
        self.experts = nn.Module()
        shapes = ((experts, hidden, inter), (experts, hidden, inter),
                  (experts, inter, hidden))
        for name, shape in zip(names, shapes):
            self.experts.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device)))


class MixtralDecoderLayer(LlamaDecoderLayer):
    moe_block = "block_sparse_moe"              # the layer's attribute
    expert_names = ("w1", "w3", "w2")           # gate, up, down

    @staticmethod
    def expert_inter(cfg) -> int:
        return cfg.intermediate_size

    def init_mlp(self, cfg, dtype, device) -> None:
        setattr(self, self.moe_block, SparseMoeBlock(
            cfg.hidden_size, self.expert_inter(cfg), cfg.num_local_experts,
            self.expert_names, dtype, device))


class MixtralForCausalLM(LlamaForCausalLM):
    """Llama decoder with the MLP replaced by routed experts."""

    layer_cls = MixtralDecoderLayer

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.gmm_impl: Optional[str] = None

    def _norm_topk(self) -> bool:
        return True

    def _mlp_block(self, x, layer):
        cfg = self.config
        block = getattr(layer, layer.moe_block)
        wg, wu, wd = (getattr(block.experts, n) for n in layer.expert_names)
        return moe.moe_mlp_block(
            x, block.gate.weight.t(), wg, wu, wd,
            num_experts_per_tok=cfg.num_experts_per_tok,
            capacity_factor=cfg.moe_capacity_factor,
            group_size=cfg.moe_group_size,
            compute_dtype=self.compute_dtype,
            norm_topk=self._norm_topk(),
            dispatch=cfg.moe_dispatch,
            quant=quant_for(self.quant, f"{layer.moe_block}.experts"),
            impl=self.gmm_impl)

    def _combine_aux(self, aux_losses):
        """HF ``load_balancing_loss_func`` over all layers: the layers'
        routing statistics averaged first, then ``E * sum f * P``, times
        ``router_aux_loss_coef``; 0 when ``output_router_logits`` is off."""
        cfg = self.config
        coef = float(cfg.router_aux_loss_coef)
        dev = aux_losses[0][0].device
        if not cfg.output_router_logits or coef == 0.0:
            return torch.zeros((), dtype=torch.float32, device=dev)
        tokens_per_expert = torch.stack([a for a, _ in aux_losses]).mean(0)
        router_prob = torch.stack([p for _, p in aux_losses]).mean(0)
        return coef * moe.load_balancing_loss(tokens_per_expert, router_prob)

    def flops_per_token(self) -> float:
        """Training FLOPs per token (fwd + bwd = 3 x fwd): attention
        projections as Llama, the FFN at ``k`` active experts, the router
        and the head (the JAX model's convention)."""
        cfg = self.config
        attn = (
            2 * cfg.hidden_size
            * (cfg.num_attention_heads + 2 * cfg.num_key_value_heads)
            * cfg.head_dim
            + 2 * cfg.num_attention_heads * cfg.head_dim * cfg.hidden_size)
        ffn = cfg.num_experts_per_tok * 6 * cfg.hidden_size \
            * self.layer_cls.expert_inter(cfg)
        router = 2 * cfg.hidden_size * cfg.num_local_experts
        embed = 2 * cfg.vocab_size * cfg.hidden_size
        return 3.0 * (cfg.num_hidden_layers * (attn + ffn + router) + embed)
