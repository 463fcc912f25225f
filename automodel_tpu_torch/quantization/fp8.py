"""FP8/int8 training configuration (counterpart:
``automodel_tpu/quantization/fp8.py``).

``FP8Config``, ``build_fp8_config``, ``apply_fp8_to_model`` and
``verify_fp8_conversion`` with the JAX package's schema.  Applying fp8
sets a :class:`~automodel_tpu_torch.ops.quant.QuantConfig` on the model
(no module is swapped): the dense projections then go through
``ops.quant.maybe_qdot`` under their JAX names (``self_attn.q_proj`` ...
``mlp.down_proj``) and the MoE experts through ``ops.moe``'s quantized
grouped matmuls.  The torchao-only knobs (fp8 all-gather, scale
precompute) are accepted and do nothing.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from typing import List, Optional

from automodel_tpu_torch.ops.quant import (
    QuantConfig,
    normalize_quant_dtype,
    normalize_quant_recipe,
    validate_quant_dtype,
    validate_quant_recipe,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class FP8Config:
    enabled: bool = False
    recipe_name: Optional[str] = "tensorwise"
    dtype: str = "float8"                      # "float8" | "int8"
    filter_fqns: List[str] = dataclasses.field(default_factory=list)
    emulate: bool = False
    # torchao-only knobs, accepted for the reference's schema:
    enable_fsdp_float8_all_gather: bool = False
    precompute_float8_dynamic_scale_for_fsdp: bool = False
    force_recompute_fp8_weight_in_bwd: bool = False

    def __post_init__(self):
        # the config loader's normalisation and membership rule, so a
        # programmatic FP8Config cannot hold what a YAML would refuse
        self.recipe_name = validate_quant_recipe(
            normalize_quant_recipe(self.recipe_name))
        self.dtype = validate_quant_dtype(
            normalize_quant_dtype(self.dtype)) or "float8"

    def to_quant_config(self) -> QuantConfig:
        return QuantConfig(
            enabled=self.enabled,
            recipe_name=self.recipe_name or "tensorwise",
            dtype=self.dtype,
            filter_fqns=list(self.filter_fqns),
            emulate=self.emulate,
        )


def build_fp8_config(cfg=None, **kwargs) -> FP8Config:
    """An ``FP8Config`` from a config node or mapping (unknown keys are
    dropped) and keyword overrides."""
    fields = {f.name for f in dataclasses.fields(FP8Config)}
    if cfg is not None:
        data = cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)
        kwargs = {**{k: v for k, v in data.items() if k in fields}, **kwargs}
    return FP8Config(**{k: v for k, v in kwargs.items() if k in fields})


def _quant_targets(model) -> list:
    """The module(s) whose products read a ``quant`` config: the model, or
    a VLM wrapper's language tower.  Only objects that declare a ``quant``
    attribute count: setting it on a model whose forward never reads it
    would do nothing."""
    target = getattr(model, "base_model", model)   # through LoRA wrappers
    if hasattr(target, "quant"):
        return [target]
    lm = getattr(target, "language_model", None)
    if lm is not None and hasattr(lm, "quant"):
        return [lm]
    return []


def apply_fp8_to_model(model, config: Optional[FP8Config] = None, **kwargs):
    """Turn quantized compute on (sets ``quant`` on every quant-capable
    target).  A model family without a ``quant`` seam warns, and raises
    under ``AUTOMODEL_STRICT_CONFIG=1``, instead of letting ``fp8.enabled:
    true`` train in bf16 unnoticed."""
    config = config or build_fp8_config(**kwargs)
    if not config.enabled:
        return model
    targets = _quant_targets(model)
    if not targets:
        msg = (f"fp8.enabled is set but model family "
               f"{type(getattr(model, 'base_model', model)).__name__} has no "
               "quantized-compute seam (no 'quant' attribute on the model or "
               "its language tower) — the knob would silently no-op")
        if os.environ.get("AUTOMODEL_STRICT_CONFIG") == "1":
            raise ValueError(msg)
        logger.warning("%s; TRAINING CONTINUES IN bf16", msg)
        return model
    for t in targets:
        t.quant = config.to_quant_config()
    logger.info("Quantized compute enabled: %s/%s on %s",
                config.dtype, config.recipe_name,
                ", ".join(type(t).__name__ for t in targets))
    return model


def _matmul_weights(target) -> dict:
    """``{name: shape}`` of every matmul weight (dim >= 2, embeddings
    excluded), one entry per projection across the layers, named as the
    JAX tree's stacked leaves (``layers.self_attn.q_proj``)."""
    from torch import nn

    embeds = {id(p) for m in target.modules() if isinstance(m, nn.Embedding)
              for p in m.parameters()}
    flat = {}
    for name, p in target.named_parameters():
        if p.dim() < 2 or id(p) in embeds:
            continue
        key = re.sub(r"\.\d+\.", ".", name).removesuffix(".weight")
        flat[key] = tuple(p.shape)
    return flat


def verify_fp8_conversion(model) -> dict:
    """Count the quantizable matmuls (both of the last two dimensions
    multiples of 16, not filtered), the reference's ``fp8.py:265`` report
    with the JAX package's counting."""
    targets = _quant_targets(model)
    target = targets[0] if targets else getattr(model, "base_model", model)
    quant = getattr(target, "quant", None)
    flat = list(_matmul_weights(target).items())
    eligible = [
        (n, s) for n, s in flat
        if s[-1] % 16 == 0 and s[-2] % 16 == 0
        and not (quant and any(f in n for f in quant.filter_fqns))
    ]
    on = bool(quant and quant.enabled)
    return {
        "enabled": on,
        "total_linears": len(flat),
        "converted": len(eligible) if on else 0,
        "skipped": len(flat) - (len(eligible) if on else 0),
    }
