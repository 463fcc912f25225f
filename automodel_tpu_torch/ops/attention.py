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
on CPU tensors; like the JAX rung it refuses a soft cap or a window.  An
active sharding context with cp > 1 (``distributed/shardings.py``) routes
every call to the ring (``ops/ring_attention.py``) ahead of every other
rung, as the JAX registry's ``attention.ring`` head: under the zig-zag
layout a rung that assumes arange token order would mask the wrong
tokens.  The JAX package's XLA SDPA rung is not ported.  :func:`cached_attention` is the dense
decode cache's attention (``generation/generate.py``), and
:func:`dot_product_attention` the grouped SDPA the vision tower calls
(non-causal, no kernel): plain PyTorch both, as the JAX functions are XLA.
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

    ring = _cp_mesh()
    if ring is not None:
        from automodel_tpu_torch.distributed.shardings import (
            current_cp_layout,
        )
        from automodel_tpu_torch.ops.ring_attention import (
            sharded_ring_attention,
        )

        if local_window_size is not None and not causal:
            raise NotImplementedError(
                "local_window_size is defined for causal attention only")
        seg = fold_padding_into_segments(q.shape[:2], segment_ids,
                                         attention_mask)
        return sharded_ring_attention(
            q, k, v, ring, causal=causal, segment_ids=seg, scale=scale,
            local_window_size=dispatched_window(local_window_size,
                                                q.shape[1] * ring.cp_size),
            logits_soft_cap=logits_soft_cap, layout=current_cp_layout(),
            impl="plain" if impl == "plain" else None)
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
        local_window_size=dispatched_window(local_window_size, q.shape[1]),
        impl=impl)


def _cp_mesh():
    """The mesh manager of an active sharding context with cp > 1, else
    None."""
    from automodel_tpu_torch.distributed.shardings import current_sharding

    ctx = current_sharding()
    if ctx is None or ctx[0].cp_size <= 1:
        return None
    return ctx[0]


def dispatched_window(local_window_size: Optional[int],
                      rows: int) -> Optional[int]:
    """The window :func:`attention` runs over ``rows`` rows: None (the
    causal plan, without the window's partial tiles, so the same output
    bit for bit) where the window is at least as long as the rows and so
    masks nothing that causal does not (Phi-4's 262,144)."""
    if local_window_size is not None and local_window_size >= rows:
        return None
    return local_window_size


_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def dot_product_attention(
    q: torch.Tensor,              # [B, S, Hq, D]
    k: torch.Tensor,              # [B, S, Hk, D]
    v: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Non-causal, unmasked grouped-query SDPA in plain PyTorch (the JAX
    ``dot_product_attention`` as the vision tower calls it,
    ``causal=False``): the scores in the operands' dtype, then fp32 times
    the scale (default ``D ** -0.5``), an fp32 softmax cast to ``v``'s
    dtype and the product with ``v``.  Masked attention is
    ``ops/splash_attention.py::splash_attention_plain``."""
    B, Sq, Hq, D = q.shape
    Hk = k.shape[2]
    G = Hq // Hk
    scale = D ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, Sq, Hk, G, D),
                          k).float() * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, Hq, D)


def cached_attention(
    q: torch.Tensor,              # [B, T, Hq, D] this step's queries
    k_cache: torch.Tensor,        # [B, S_max, Hk, D] dense decode cache
    v_cache: torch.Tensor,
    *,
    cache_index: int,             # the queries sit at cache_index + t
    attention_mask: Optional[torch.Tensor] = None,   # [B, S_max] keys
    scale: Optional[float] = None,
    logits_soft_cap: Optional[float] = None,
    local_window_size: Optional[int] = None,
) -> torch.Tensor:
    """Attention over a dense decode cache, in plain PyTorch (the JAX
    ``cached_attention``: its XLA SDPA with ``q_offset``, fp32 softmax).
    Query ``t`` sees cache positions ``<= cache_index + t`` that the
    padding mask keeps; the unwritten tail lies in every query's future."""
    B, T, Hq, D = q.shape
    Skv, Hk = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hk
    scale = D ** -0.5 if scale is None else scale
    qg = q.reshape(B, T, Hk, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                          k_cache.to(q.dtype)).float() * scale
    if logits_soft_cap is not None:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    q_pos = cache_index + torch.arange(T, device=q.device)
    diff = q_pos[:, None] - torch.arange(Skv, device=q.device)[None, :]
    mask = (diff >= 0)[None]                              # [1, T, Skv]
    if local_window_size is not None:
        mask = mask & (diff < local_window_size)[None]
    if attention_mask is not None:
        mask = mask & attention_mask.bool()[:, None, :]
    logits = torch.where(mask[:, None, None], logits,
                         torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v_cache)
    return out.reshape(B, T, Hq, D).to(q.dtype)
