"""Token accounting for tokens/s (counterpart:
``automodel_tpu/training/utils.py``).

``count_tail_padding`` counts each row's trailing ignore labels (the
flip + cumprod trick); ``count_tokens`` gives ``(tokens without tail
padding, label tokens)`` for a batch or a list of microbatches.
"""

from __future__ import annotations

import numpy as np

IGNORE_INDEX = -100


def count_tail_padding(labels, ignore_label: int = IGNORE_INDEX) -> int:
    """Trailing ignore-labelled tokens per row, summed (interior ignored
    tokens, a masked prompt, do not count)."""
    flipped = np.asarray(labels)[..., ::-1] == ignore_label
    return int(np.cumprod(flipped, axis=-1).sum())


def count_tokens(batch, ignore_label: int = IGNORE_INDEX):
    """``(num_tokens_excluding_tail_padding, num_label_tokens)`` for a
    batch or a list of microbatches."""
    if isinstance(batch, (list, tuple)):
        totals = [count_tokens(b, ignore_label) for b in batch]
        return sum(t[0] for t in totals), sum(t[1] for t in totals)
    labels = np.asarray(batch["labels"])
    if labels.ndim == 1 and "input_ids" in batch:
        # one label per example (sequence classification): the tokens
        # processed come from the input stream
        mask = batch.get("attention_mask")
        num_tokens = (int(np.asarray(mask).sum()) if mask is not None
                      else int(np.asarray(batch["input_ids"]).size))
        return num_tokens, int((labels != ignore_label).sum())
    num_tokens = labels.size - count_tail_padding(labels, ignore_label)
    return num_tokens, int((labels != ignore_label).sum())
