"""Parameter counting and freezing (counterpart:
``automodel_tpu/utils/model_utils.py``).

The JAX package freezes with a boolean mask over its params tree (True =
trainable) that the train step turns into its trainable subtree; the port
sets ``requires_grad=False`` on the frozen parameters, which the train
step and the optimizer then leave out.  The masks here are keyed by the
JAX leaf path (``layers.self_attn.q_proj.kernel``, ``base.`` / ``lora.``
under PEFT; ``models/weights.py::jax_leaves``), so they compare leaf by
leaf with the JAX ones and the same regexes match the same leaves.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from automodel_tpu_torch.models.weights import jax_leaves

logger = logging.getLogger(__name__)


def _leaves(model) -> Iterator[Tuple[str, List[torch.Tensor]]]:
    for path, target, _ in jax_leaves(model):
        yield ".".join(path), (target if isinstance(target, list)
                               else [target])


def jax_named_parameters(model) -> Iterator[Tuple[str, torch.nn.Parameter]]:
    """``model.named_parameters()`` in its order, each named by its JAX
    leaf path (every layer's slice of a stacked leaf by the same path)."""
    names = {id(t): name for name, ts in _leaves(model) for t in ts}
    for name, p in model.named_parameters():
        yield names.get(id(p), name), p


def count_parameters(model) -> int:
    """Elements of every JAX leaf (an int8 base's codes and scales too)."""
    return sum(t.numel() for _, ts in _leaves(model) for t in ts)


def print_trainable_parameters(model, log=logger.info) -> Dict[str, int]:
    total = count_parameters(model)
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    log("trainable params: %s || all params: %s || trainable%%: %.4f",
        f"{trainable:,}", f"{total:,}", 100.0 * trainable / max(total, 1))
    return {"trainable": trainable, "total": total}


def make_freeze_mask(
    model,
    freeze_patterns: Optional[List[str]] = None,
    freeze_embeddings: bool = False,
    freeze_vision_tower: bool = False,
    freeze_language_model: bool = False,
) -> Dict[str, bool]:
    """``{JAX leaf path: trainable}`` from the freezing knobs: the embedding
    modules (whole path segments), vision tower, language model and free
    regexes, each matched at the start or over the whole path, as JAX."""
    patterns = list(freeze_patterns or [])
    if freeze_embeddings:
        patterns.append(r"(?:.*\.)?(?:embed_tokens|wte|wpe)(?:\..*)?")
    if freeze_vision_tower:
        patterns.append(r".*(vision_tower|vision_model).*")
    if freeze_language_model:
        patterns.append(r".*(language_model|layers).*")
    compiled = [re.compile(p) for p in patterns]
    return {name: not any(rx.fullmatch(name) or rx.match(name)
                          for rx in compiled)
            for name, _ in _leaves(model)}


def apply_parameter_freezing(model, freeze_config) -> Dict[str, bool]:
    """The YAML ``freeze_config`` -> its mask, applied to ``model``:
    ``requires_grad=False`` on every parameter whose leaf the mask marks
    False (buffers, such as an int8 base, are never trained)."""
    cfg = (freeze_config.to_dict() if hasattr(freeze_config, "to_dict")
           else dict(freeze_config or {}))
    mask = make_freeze_mask(
        model,
        freeze_patterns=cfg.get("freeze_patterns"),
        freeze_embeddings=cfg.get("freeze_embeddings", False),
        freeze_vision_tower=cfg.get("freeze_vision_tower", False),
        freeze_language_model=cfg.get("freeze_language_model", False),
    )
    for name, ts in _leaves(model):
        if not mask[name]:
            for t in ts:
                if isinstance(t, torch.nn.Parameter):
                    t.requires_grad_(False)
    return mask
