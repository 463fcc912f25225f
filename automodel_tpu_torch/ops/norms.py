"""Normalization ops (counterpart: ``automodel_tpu/ops/norms.py``)."""

from __future__ import annotations

import torch

# lanes of the first partial sums of a row's squares on CUDA (see rms_norm)
_PARTIALS = 16


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the variance in fp32, cast back to ``x``'s dtype.

    On a CUDA tensor the sum of squares is taken in two fixed steps,
    ``_PARTIALS`` partial sums of a row and then their sum, so a row's
    variance has the same bits however many rows the call holds: one CUDA
    reduction over the row picks its thread layout from the number of rows,
    and a decode step (8 rows) must norm a token exactly as a speculative
    verify step (40 rows) does.  On the CPU it is one mean."""
    x32 = x.float()
    H = x.shape[-1]
    sq = x32.square()
    if x.is_cuda and H % _PARTIALS == 0:
        var = sq.view(*sq.shape[:-1], _PARTIALS, H // _PARTIALS).sum(
            -1).sum(-1, keepdim=True) / H
    else:
        var = sq.mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)
