"""Qwen3-MoE family, e.g. Qwen3-30B-A3B (counterpart:
``automodel_tpu/models/qwen3_moe.py``).

Qwen3 attention (per-head q/k RMSNorm, explicit ``head_dim``:
``LlamaConfig.qk_norm``) with the Mixtral expert block under Qwen3's names:
the router ``mlp.gate`` and the experts ``mlp.experts.{gate,up,down}_proj``
of width ``moe_intermediate_size``; ``norm_topk_prob`` says whether the
top-k weights are renormalised.  Every layer is sparse
(``decoder_sparse_step == 1``, no ``mlp_only_layers``), as in the released
checkpoints; anything else raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from automodel_tpu_torch.models.mixtral import (
    MixtralConfig,
    MixtralDecoderLayer,
    MixtralForCausalLM,
)


@dataclasses.dataclass
class Qwen3MoeConfig(MixtralConfig):
    """HF ``Qwen3MoeConfig`` field names on the Mixtral config."""

    num_experts: int = 128
    moe_intermediate_size: int = 768
    norm_topk_prob: bool = False
    decoder_sparse_step: int = 1
    mlp_only_layers: Tuple[int, ...] = ()
    router_aux_loss_coef: float = 0.001

    def __post_init__(self):
        super().__post_init__()
        self.model_type = "qwen3_moe"
        self.qk_norm = True                        # always on in Qwen3
        self.num_local_experts = self.num_experts  # HF name difference
        if int(self.decoder_sparse_step) != 1 or tuple(self.mlp_only_layers):
            raise NotImplementedError(
                "qwen3_moe: only the all-sparse layout is implemented "
                f"(decoder_sparse_step={self.decoder_sparse_step}, "
                f"mlp_only_layers={self.mlp_only_layers}); the released "
                "Qwen3-MoE checkpoints use decoder_sparse_step=1 with no "
                "dense layers")

    @classmethod
    def from_hf_config(cls, hf: Dict[str, Any]) -> "Qwen3MoeConfig":
        # HF's Qwen configs default use_sliding_window to False
        return super().from_hf_config({"use_sliding_window": False, **hf})


class Qwen3MoeDecoderLayer(MixtralDecoderLayer):
    moe_block = "mlp"
    expert_names = ("gate_proj", "up_proj", "down_proj")

    @staticmethod
    def expert_inter(cfg) -> int:
        return cfg.moe_intermediate_size


class Qwen3MoeForCausalLM(MixtralForCausalLM):
    """Qwen3 attention x Mixtral expert dispatch; the load-balancing loss
    is Mixtral's ``_combine_aux`` (folded in iff
    ``output_router_logits``, as ``modeling_qwen3_moe.py`` does)."""

    layer_cls = Qwen3MoeDecoderLayer

    def _norm_topk(self) -> bool:
        return bool(self.config.norm_topk_prob)
