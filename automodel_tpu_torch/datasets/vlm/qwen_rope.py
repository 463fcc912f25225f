"""Qwen2.5-VL's M-RoPE position ids, computed on the host by the collator
(counterpart: ``automodel_tpu/datasets/vlm/qwen_rope.py``; HF
``Qwen2_5_VLModel.get_rope_index``).

The ``(temporal, height, width)`` ids are a data-dependent walk over the
token stream (the vision-start markers, each image's span), so they are
numpy here and reach the model as ``position_ids [B, S, 3]``.  Text
tokens advance all three axes together; an image's span takes its grid
coordinates offset past the text before it; text after an image resumes at
``max(vision positions) + 1``; padding positions get 1 (HF's convention).
A video's temporal axis is scaled by ``tokens_per_second *
second_per_grid_t``, the interval truncated to an integer first, as HF
casts it to its ``arange``'s integer dtype.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def qwen_mrope_position_ids(
    input_ids: np.ndarray,
    image_grid_thw: Optional[np.ndarray],
    attention_mask: Optional[np.ndarray] = None,
    *,
    spatial_merge_size: int = 2,
    image_token_id: int = 151655,
    video_token_id: int = 151656,
    vision_start_token_id: int = 151652,
    video_grid_thw: Optional[np.ndarray] = None,
    second_per_grid_ts: Optional[np.ndarray] = None,
    tokens_per_second: int = 2,
) -> np.ndarray:
    """``input_ids [B, S]``, per-image grids ``[N, 3]`` (and per-video
    ones), ``attention_mask [B, S]`` (1 = a real token) -> ``[B, S, 3]``
    int32 ``(t, h, w)`` position ids."""
    input_ids = np.asarray(input_ids)
    B, S = input_ids.shape
    if image_grid_thw is None and video_grid_thw is None:
        if attention_mask is not None:
            mask = np.asarray(attention_mask)
            pos = np.where(mask == 0, 1, np.cumsum(mask, axis=-1) - 1)
        else:
            pos = np.broadcast_to(np.arange(S), (B, S))
        return np.repeat(pos[..., None], 3, axis=-1).astype(np.int32)

    out = np.ones((B, S, 3), np.int64)
    img_i = vid_i = 0
    for b in range(B):
        keep = (np.asarray(attention_mask[b]) == 1
                if attention_mask is not None else np.ones(S, bool))
        toks = input_ids[b][keep]
        starts = np.nonzero(toks == vision_start_token_id)[0]
        kinds = toks[starts + 1] if len(starts) else np.array([], int)
        pieces = []
        st = 0
        for kind in kinds:
            if kind == image_token_id:
                ed = int(np.nonzero(toks[st:] == image_token_id)[0][0]) + st
                t, h, w = (int(x) for x in image_grid_thw[img_i])
                per_t = 0.0
                img_i += 1
            else:
                ed = int(np.nonzero(toks[st:] == video_token_id)[0][0]) + st
                t, h, w = (int(x) for x in video_grid_thw[vid_i])
                per_t = (float(second_per_grid_ts[vid_i])
                         if second_per_grid_ts is not None else 1.0)
                vid_i += 1
            gh, gw = h // spatial_merge_size, w // spatial_merge_size
            text_len = ed - st
            base = pieces[-1].max() + 1 if pieces else 0
            pieces.append(np.broadcast_to(np.arange(text_len) + base,
                                          (3, text_len)).copy())
            t_idx = (np.arange(t)[:, None] * np.int64(per_t)
                     * tokens_per_second).astype(np.int64)
            t_idx = np.broadcast_to(t_idx, (t, gh * gw)).reshape(-1)
            h_idx = np.broadcast_to(np.arange(gh)[None, :, None],
                                    (t, gh, gw)).reshape(-1)
            w_idx = np.broadcast_to(np.arange(gw)[None, None, :],
                                    (t, gh, gw)).reshape(-1)
            pieces.append(np.stack([t_idx, h_idx, w_idx]) + text_len + base)
            st = ed + t * gh * gw
        if st < len(toks):
            base = pieces[-1].max() + 1 if pieces else 0
            text_len = len(toks) - st
            pieces.append(np.broadcast_to(np.arange(text_len) + base,
                                          (3, text_len)).copy())
        if pieces:
            out[b, keep, :] = np.concatenate(pieces, axis=1).T
    return out.astype(np.int32)
