"""Zig-zag context-parallel sequence layout: the causal load balance of
the ring (``ops/ring_attention.py``; counterpart:
``automodel_tpu/ops/zigzag.py``, whose numbers these are bit for bit).

Under the contiguous layout each cp shard holds one run of ``S / cp``
tokens, so under a causal mask shard 0 has one block of work and shard
``cp - 1`` has ``cp``.  The zig-zag layout cuts the sequence into ``2 cp``
chunks and gives shard ``i`` chunks ``i`` and ``2 cp - 1 - i``:

    cp=2, chunks 0..3:   shard 0 = [0, 3]     shard 1 = [1, 2]
    cp=4, chunks 0..7:   shard 0 = [0, 7]     shard 1 = [1, 6]
                         shard 2 = [2, 5]     shard 3 = [3, 4]

so every (q shard, kv shard) pair carries the same causal work.  The
permutation is applied once, on the host, to every sequence-dim batch key
before the batch is cut over cp (``training/train_step.py::shard_batch``);
the true token positions ride ``position_ids`` (injected when absent) so
rotary embeddings stay exact, and the ring derives its masks from the
layout itself.  Training never needs the inverse: the loss is a sum over
tokens.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

CP_LAYOUTS = ("contiguous", "zigzag")

# Batch keys whose trailing dim is the sequence and rides the permutation
# (``position_ids`` is handled on its own: M-RoPE ids are [..., S, 3]).
_SEQ_KEYS = ("input_ids", "labels", "segment_ids", "attention_mask",
             "loss_mask")
# Keys without a text-sequence dim.  Any other key whose trailing dim
# equals S raises: left unpermuted it would train on misaligned data.
_PASSTHROUGH_KEYS = frozenset({
    "position_ids",
    "pixel_values", "pixel_values_videos",
    "image_grid_thw", "video_grid_thw",
    "input_audio_embeds", "audio_embed_sizes", "audio_attention_mask",
    "dropout_rng",
})


def normalize_cp_layout(layout: Optional[str]) -> Optional[str]:
    """The YAML null spellings ("none", "null", "") -> None."""
    if isinstance(layout, str) and layout.lower() in ("none", "null", ""):
        return None
    return layout


def validate_cp_layout(layout: Optional[str]) -> Optional[str]:
    """None (the cp-size default) or a member of :data:`CP_LAYOUTS`."""
    if layout is None:
        return None
    if layout not in CP_LAYOUTS:
        raise ValueError(
            f"distributed.cp_layout must be one of {list(CP_LAYOUTS)}, "
            f"got {layout!r}")
    return layout


def resolve_cp_layout(layout: Optional[str], cp_size: int) -> str:
    """The default: zig-zag whenever the ring is real (cp > 1)."""
    validate_cp_layout(layout)
    if layout is not None:
        return layout
    return "zigzag" if cp_size > 1 else "contiguous"


def zigzag_indices(seq_len: int, cp: int) -> np.ndarray:
    """Gather indices (layout order -> original position), shard-major:
    the first ``S / cp`` entries are shard 0's tokens (chunk 0, then chunk
    ``2 cp - 1``), so cutting the permuted sequence into cp equal runs
    hands each shard its pair."""
    if seq_len % (2 * cp):
        raise ValueError(
            f"zigzag cp layout needs seq_len divisible by 2*cp="
            f"{2 * cp}, got {seq_len} (pad the batch — "
            "dataloader.pad_seq_len_divisible — or use cp_layout: contiguous)")
    chunks = np.arange(seq_len, dtype=np.int64).reshape(2 * cp, -1)
    order = np.stack([np.arange(cp), 2 * cp - 1 - np.arange(cp)], 1).ravel()
    return chunks[order].ravel()


def zigzag_inverse_indices(seq_len: int, cp: int) -> np.ndarray:
    """Scatter inverse: ``permuted[inverse]`` is the original order."""
    return np.argsort(zigzag_indices(seq_len, cp))


def zigzag_permute(x, cp: int, axis: int = -1):
    """Reorder ``axis`` (length S) into the zig-zag layout (numpy arrays
    or torch tensors)."""
    idx = zigzag_indices(x.shape[axis], cp)
    if isinstance(x, np.ndarray):
        return np.take(x, idx, axis=axis)
    import torch

    return x.index_select(axis, torch.from_numpy(idx).to(x.device))


def zigzag_unpermute(x, cp: int, axis: int = -1):
    """Inverse of :func:`zigzag_permute` (inspection only)."""
    idx = zigzag_inverse_indices(x.shape[axis], cp)
    if isinstance(x, np.ndarray):
        return np.take(x, idx, axis=axis)
    import torch

    return x.index_select(axis, torch.from_numpy(idx).to(x.device))


def permute_batch_for_cp(stacked: Dict[str, np.ndarray], cp: int,
                         inject_position_ids: bool = True,
                         ) -> Dict[str, np.ndarray]:
    """The host-side zig-zag reorder of one stacked microbatch dict:
    the keys of ``_SEQ_KEYS`` whose trailing dim is S are permuted along
    it, ``position_ids`` along its S axis (trailing for ``[A, B, S]``, -2
    for M-RoPE ``[A, B, S, 3]``) or injected as the permutation itself
    when absent, and keys without a text-sequence dim pass through."""
    ids = stacked.get("input_ids")
    if ids is None:
        return stacked
    seq_len = ids.shape[-1]
    idx = zigzag_indices(seq_len, cp)
    out = dict(stacked)
    for key, v in stacked.items():
        if key in _PASSTHROUGH_KEYS or getattr(v, "ndim", 0) < ids.ndim:
            # lower-rank keys (a classifier's labels [A, B]) carry no
            # per-token dim even when a size equals S
            continue
        if v.shape[-1] != seq_len:
            continue
        if key not in _SEQ_KEYS:
            raise ValueError(
                f"batch key {key!r} (shape {tuple(v.shape)}) has a trailing "
                f"dim of the sequence length {seq_len} but is not registered "
                "for the zig-zag cp permutation — leaving it unpermuted "
                "would silently misalign per-token data.  Add it to "
                "ops/zigzag.py _SEQ_KEYS (permute) or _PASSTHROUGH_KEYS "
                "(no text-sequence dim), or use cp_layout: contiguous.")
        out[key] = np.take(np.asarray(v), idx, axis=-1)
    pos = out.get("position_ids")
    if pos is not None:
        axis = -2 if np.asarray(pos).ndim >= 2 and pos.shape[-1] != seq_len \
            else -1
        if pos.shape[axis] != seq_len:
            raise ValueError(
                f"position_ids shape {pos.shape} has no axis of the "
                f"sequence length {seq_len}; cannot apply the zig-zag "
                "cp layout")
        out["position_ids"] = np.take(np.asarray(pos), idx, axis=axis)
    elif inject_position_ids:
        out["position_ids"] = np.broadcast_to(
            idx.astype(np.int32), ids.shape).copy()
    return out
