"""Normalization ops (counterpart: ``automodel_tpu/ops/norms.py``)."""

from __future__ import annotations

import torch

# lanes of the first partial sums of a row's squares on CUDA (see rms_norm)
_PARTIALS = 16


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6, offset: float = 0.0) -> torch.Tensor:
    """RMSNorm with the variance in fp32, cast back to ``x``'s dtype;
    ``offset=1.0`` scales by ``(1 + w)`` in fp32 (Gemma's zero-centred
    weights).

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
    w = weight.float() + offset if offset else weight.float()
    return (x32 * torch.rsqrt(var + eps) * w).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with the mean and the (biased) variance in fp32, scale and
    bias in fp32, cast back to ``x``'s dtype (the vision tower's)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)
