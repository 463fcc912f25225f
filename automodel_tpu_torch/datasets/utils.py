"""Collation (counterpart: ``automodel_tpu/datasets/utils.py``).

``default_collater`` pads within the microbatch with the per-key pad table
and returns int32 numpy arrays; the train step moves them to the recipe's
device.  This is the JAX package's pure-Python pad loop; its native C++
pad path is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

CROSS_ENTROPY_IGNORE_IDX = -100

PAD_TOKEN_IDS = {
    "labels": CROSS_ENTROPY_IGNORE_IDX,
    "attention_mask": 0,
    "loss_mask": 0,
    "segment_ids": 0,      # segment 0 == padding for the attention kernels
    "position_ids": 0,
}



def resolve_pad_geometry(batch: List[List[int]], pad_token_id: Optional[int],
                         pad_seq_len_divisible: Optional[int] = None):
    """(max_len, pad_id): the longest row, rounded UP to the next multiple
    of ``pad_seq_len_divisible`` (a row already on a multiple gains a whole
    one more, as in the JAX package); a missing pad id is the first row's
    last token."""
    max_len = max(map(len, batch))
    if pad_seq_len_divisible:
        max_len = (pad_seq_len_divisible
                   - max_len % pad_seq_len_divisible) + max_len
    if pad_token_id is None:
        pad_token_id = batch[0][-1]
    return max_len, pad_token_id


def default_collater(batch: List[dict],
                     pad_seq_len_divisible: Optional[int] = None
                     ) -> Dict[str, np.ndarray]:
    """Pad-and-stack collater -> ``{key: int32 [B, S]}``.  (The JAX
    collater's per-dataset pad override, ``___PAD_TOKEN_IDS___``, is not
    ported: no ported dataset emits it.)"""
    out = {}
    for key in batch[0].keys():
        rows = [x[key] for x in batch]
        max_len, pad_id = resolve_pad_geometry(
            rows, PAD_TOKEN_IDS.get(key), pad_seq_len_divisible)
        padded = [list(r) + [pad_id] * (max_len - len(r)) for r in rows]
        arr = np.asarray(padded, dtype=np.int32)
        out[key] = arr[None, :] if arr.ndim == 1 else arr
    return out
