"""Training attention: masks and the dispatch (counterpart:
``automodel_tpu/ops/attention.py``).

Sequence packing uses *segment ids* ``[B, S]`` int (1-based per packed
sample, 0 = padding), as in the JAX package: a query attends only keys of
its own segment; on the splash rung segment 0 never attends nor is
attended, on the flash rung it attends itself.  A padding
mask folds into the segment ids (:func:`fold_padding_into_segments`).

:func:`attention` is the entry point the model calls; ``impl`` names the
rung, as the JAX registry chain is resolved from its head
(``automodel_tpu/ops/kernel_lib/registry.py``).  By default it runs
``ops/splash_attention.py`` (the splash rung): the hand-written CUDA
kernels on CUDA tensors, the plain PyTorch versions on CPU tensors, and the
plain versions on any device when the caller asks for ``impl="plain"``.
``impl="flash"`` runs ``ops/flash_attention.py`` (the Pallas MHA flash
rung's counterpart: kv heads repeated to the query heads, segment 0
attending segment 0), its kernels on CUDA tensors and its plain versions
on CPU tensors; like the JAX rung it refuses a soft cap or a window.  The
JAX package's XLA SDPA and ring-attention rungs are not ported (ring
attention waits for multi-GPU).
"""

from __future__ import annotations

from typing import Optional

import torch


def make_attention_mask(
    q_len: int,
    kv_len: int,
    *,
    causal: bool = True,
    segment_ids_q: Optional[torch.Tensor] = None,   # [B, Sq] int, 0 = pad
    segment_ids_kv: Optional[torch.Tensor] = None,  # [B, Skv]
    local_window_size: Optional[int] = None,
    device=None,
) -> Optional[torch.Tensor]:
    """Boolean mask ``[B or 1, 1, Sq, Skv]``; True = attend.  A query
    attends keys at most ``local_window_size - 1`` positions back.  (A
    padding mask reaches it folded into the segment ids.)"""
    masks = []
    if causal:
        q_pos = torch.arange(q_len, device=device)
        kv_pos = torch.arange(kv_len, device=device)
        diff = q_pos[:, None] - kv_pos[None, :]
        masks.append((diff >= 0)[None, None])
        if local_window_size is not None:
            masks.append((diff < local_window_size)[None, None])
    if segment_ids_q is not None and segment_ids_kv is not None:
        seg = segment_ids_q[:, None, :, None] == segment_ids_kv[:, None, None, :]
        # segment id 0 marks padding: never attend to/from it
        seg &= (segment_ids_kv != 0)[:, None, None, :]
        masks.append(seg)
    if not masks:
        return None
    out = masks[0]
    for m in masks[1:]:
        out = out & m
    return out


def fold_padding_into_segments(
    batch_shape: tuple,
    segment_ids: Optional[torch.Tensor],
    attention_mask: Optional[torch.Tensor],
) -> Optional[torch.Tensor]:
    """The one place that encodes the padding convention: pad positions get
    segment 0, which real tokens (segments >= 1) never attend to.  Returns
    int32 segment ids, or None when there is neither input."""
    if attention_mask is None:
        return None if segment_ids is None else segment_ids.to(torch.int32)
    base = (segment_ids if segment_ids is not None
            else torch.ones(batch_shape, dtype=torch.int32,
                            device=attention_mask.device))
    return torch.where(attention_mask.bool(), base,
                       torch.zeros_like(base)).to(torch.int32)


def attention(
    q: torch.Tensor,              # [B, S, Hq, D]
    k: torch.Tensor,              # [B, S, Hk, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    logits_soft_cap: Optional[float] = None,
    local_window_size: Optional[int] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Grouped-query attention over ``[B, S, H, D]`` with causal, segment,
    padding, window and soft-cap masks; differentiable.

    ``impl``: None runs the splash rung's CUDA kernels on CUDA tensors and
    its plain PyTorch versions on CPU tensors; ``"plain"`` runs the plain
    versions on any device (the reference a card run is held against);
    ``"kernel"`` runs the kernels and raises on CPU tensors; ``"flash"``
    runs the flash rung (its kernels on CUDA tensors, its plain versions
    on CPU tensors), which raises on a soft cap or a window."""
    from automodel_tpu_torch.ops.splash_attention import splash_attention_bshd

    if impl == "flash":
        from automodel_tpu_torch.ops.flash_attention import (
            flash_attention_bshd,
        )

        if logits_soft_cap is not None or local_window_size is not None:
            raise NotImplementedError(
                "the flash rung takes no soft cap and no sliding window "
                "(the Pallas MHA flash kernel has neither); use the splash "
                "rung (impl=None)")
        return flash_attention_bshd(
            q, k, v, causal=causal, segment_ids=segment_ids,
            attention_mask=attention_mask, scale=scale)
    if local_window_size is not None and not causal:
        raise NotImplementedError(
            "local_window_size is defined for causal attention only (the "
            "window trails the query position)")
    return splash_attention_bshd(
        q, k, v, causal=causal, segment_ids=segment_ids,
        attention_mask=attention_mask, scale=scale,
        logits_soft_cap=logits_soft_cap,
        local_window_size=local_window_size, impl=impl)
