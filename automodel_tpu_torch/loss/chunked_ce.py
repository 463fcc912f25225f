"""Chunked cross-entropy: caps the fp32 logit-upcast working set
(counterpart: ``automodel_tpu/loss/chunked_ce.py``).

The sequence axis is processed ``chunk_len`` positions at a time, so only
one chunk of logits is upcast to fp32 at once; each chunk runs under
``torch.utils.checkpoint``, so the backward upcasts it again instead of
keeping every chunk's fp32 log-softmax alive.  The reduction is a **sum**
(the train step divides by the label-token count).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from automodel_tpu_torch.loss.masked_ce import IGNORE_INDEX, cross_entropy_sum


class ChunkedCrossEntropy:
    """``loss_fn._target_: automodel_tpu.loss.chunked_ce.
    ChunkedCrossEntropy`` (the JAX target name maps to this class)."""

    needs_hidden = False
    reduction = "sum"

    def __init__(self, chunk_len: int = 32, ignore_index: int = IGNORE_INDEX):
        if ignore_index != IGNORE_INDEX:
            raise NotImplementedError(
                f"only ignore_index={IGNORE_INDEX} is ported")
        self.chunk_len = int(chunk_len)

    def __call__(self, logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 num_label_tokens: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        if mask is not None:
            labels = torch.where(mask.bool(), labels,
                                 torch.full_like(labels, IGNORE_INDEX))
        total = torch.zeros((), dtype=torch.float32, device=logits.device)
        for s0 in range(0, logits.shape[1], self.chunk_len):
            total = total + checkpoint(
                cross_entropy_sum, logits[:, s0:s0 + self.chunk_len],
                labels[:, s0:s0 + self.chunk_len], use_reentrant=False)
        if num_label_tokens is not None:
            total = total / num_label_tokens
        return total
