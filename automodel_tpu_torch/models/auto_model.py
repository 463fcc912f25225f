"""YAML-friendly model builder (counterpart:
``automodel_tpu/models/auto_model.py::build_model``).

Only the ``llama`` family is ported; other ``model_type`` values raise.
Loading HF checkpoint weights waits until a checkpoint is available to
test against; ``build_model`` returns a model with random weights drawn
from ``seed``.
"""

from __future__ import annotations

from typing import Any

from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM


def build_model(config: Any, *, seed: int = 0, device=None,
                **model_kwargs) -> LlamaForCausalLM:
    """Build from an inline HF-style config dict (or ``LlamaConfig``).
    ``param_dtype`` defaults to the config's ``torch_dtype``, as in the JAX
    package.  ``device`` None is ``cuda`` and raises without a card (the
    YAML ``model._target_`` is an entry point); pass ``device="cpu"`` to
    build on the CPU."""
    if hasattr(config, "to_dict"):
        config = config.to_dict()
    if isinstance(config, dict):
        model_type = config.get("model_type", "llama")
        if model_type != "llama":
            raise NotImplementedError(
                f"model_type {model_type!r} is not ported (llama is)")
        config = LlamaConfig.from_hf_config(config)
    if config.torch_dtype:
        model_kwargs.setdefault("param_dtype", str(config.torch_dtype))
    model = LlamaForCausalLM(config, device=device, **model_kwargs)
    return model.init_weights(seed)
