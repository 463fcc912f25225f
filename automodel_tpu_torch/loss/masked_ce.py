"""Masked cross-entropy, the framework's default SFT loss (counterpart:
``automodel_tpu/loss/masked_ce.py``).

fp32-upcast CE over the logits, labels equal to ``IGNORE_INDEX`` (-100)
contribute exactly 0, an optional mask folds into that convention, and the
reduction is a **sum**: the train step divides by the global label-token
count of the whole optimizer step itself.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

IGNORE_INDEX = -100


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of token CE in fp32 (``logsumexp - picked``); ignored positions
    contribute exactly 0."""
    if mask is not None:
        labels = torch.where(mask.bool(), labels,
                             torch.full_like(labels, IGNORE_INDEX))
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long(),
                           ignore_index=IGNORE_INDEX, reduction="sum")


class MaskedCrossEntropy:
    """``loss_fn._target_: automodel_tpu.loss.masked_ce.MaskedCrossEntropy``
    (the JAX target name maps to this class)."""

    needs_hidden = False

    def __init__(self, ignore_index: int = IGNORE_INDEX,
                 reduction: str = "sum"):
        if ignore_index != IGNORE_INDEX or reduction != "sum":
            raise NotImplementedError(
                f"only ignore_index={IGNORE_INDEX} with reduction='sum' is "
                "ported (the train step divides by the label-token count)")
        self.reduction = reduction

    def __call__(self, logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return cross_entropy_sum(logits, labels, mask)
