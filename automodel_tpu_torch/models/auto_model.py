"""YAML-friendly model builder (counterpart:
``automodel_tpu/models/auto_model.py::build_model``).

The ``llama``, ``mixtral`` and ``qwen3_moe`` families are ported (the
JAX registry's names, ``automodel_tpu/models/registry.py``); other
``model_type`` values raise.  Loading HF checkpoint weights waits until a
checkpoint is available to test against; ``build_model`` returns a model
with random weights drawn from ``seed``.
"""

from __future__ import annotations

from typing import Any

from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from automodel_tpu_torch.models.mixtral import (
    MixtralConfig,
    MixtralForCausalLM,
)
from automodel_tpu_torch.models.qwen3_moe import (
    Qwen3MoeConfig,
    Qwen3MoeForCausalLM,
)

FAMILIES = {
    "llama": (LlamaConfig, LlamaForCausalLM),
    "mixtral": (MixtralConfig, MixtralForCausalLM),
    "qwen3_moe": (Qwen3MoeConfig, Qwen3MoeForCausalLM),
}


def build_model(config: Any, *, seed: int = 0, device=None,
                **model_kwargs) -> LlamaForCausalLM:
    """Build from an inline HF-style config dict (or a config dataclass).
    ``param_dtype`` defaults to the config's ``torch_dtype``, as in the JAX
    package.  ``device`` None is ``cuda`` and raises without a card (the
    YAML ``model._target_`` is an entry point); pass ``device="cpu"`` to
    build on the CPU."""
    if hasattr(config, "to_dict"):
        config = config.to_dict()
    if isinstance(config, dict):
        model_type = config.get("model_type", "llama")
        if model_type not in FAMILIES:
            raise NotImplementedError(
                f"model_type {model_type!r} is not ported (ported: "
                f"{sorted(FAMILIES)})")
        config = FAMILIES[model_type][0].from_hf_config(config)
    if config.torch_dtype:
        model_kwargs.setdefault("param_dtype", str(config.torch_dtype))
    model = FAMILIES[config.model_type][1](config, device=device,
                                           **model_kwargs)
    return model.init_weights(seed)
