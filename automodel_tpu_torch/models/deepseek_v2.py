"""DeepSeek-V2 family, e.g. DeepSeek-V2-Lite (counterpart:
``automodel_tpu/models/deepseek_v2.py``; HF ``modeling_deepseek_v2.py``).

The V3 family's MLA and split dense / MoE stack (V2's complex-number rope
is the interleaved rotation V3 implements) with V2's gate instead of the
aux-loss-free router: softmax scores, ``greedy`` (V2-Lite) or
``group_limited_greedy`` top-k, the selected scores times
``routed_scaling_factor`` with no renormalisation, and no
``e_score_correction_bias`` parameter
(:func:`~automodel_tpu_torch.ops.moe.softmax_group_topk_routing`).  The
gate is the only seam.
"""

from __future__ import annotations

import dataclasses

import torch

from automodel_tpu_torch.models.deepseek_v3 import (
    DeepseekV3Config,
    DeepseekV3ForCausalLM,
)
from automodel_tpu_torch.ops import moe


@dataclasses.dataclass
class DeepseekV2Config(DeepseekV3Config):
    """HF ``DeepseekV2Config`` field names on the V3 config."""

    topk_method: str = "greedy"
    # accepted for HF-config compatibility; HF's modeling computes no aux
    aux_loss_alpha: float = 0.001
    seq_aux: bool = True

    def __post_init__(self):
        super().__post_init__()
        self.model_type = "deepseek_v2"


class DeepseekV2ForCausalLM(DeepseekV3ForCausalLM):
    """``model_type: deepseek_v2``: MLA x the softmax-gated MoE."""

    correction_bias = False

    def _route(self, xg, gate, k):
        cfg = self.config
        scores = torch.softmax(moe.router_logits(xg, gate.weight.t()),
                               dim=-1)
        return moe.softmax_group_topk_routing(
            scores, k, topk_method=cfg.topk_method, n_group=cfg.n_group,
            topk_group=cfg.topk_group,
            routed_scaling_factor=float(cfg.routed_scaling_factor))
