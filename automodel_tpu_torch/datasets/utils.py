"""Collation and the single-turn SFT preprocessor (counterpart:
``automodel_tpu/datasets/utils.py``).

``default_collater`` pads within the microbatch with the per-key pad table
(overridden by a row's ``___PAD_TOKEN_IDS___`` entry, as SQuAD's rows
carry) and returns int32 numpy arrays; the train step moves them to the
recipe's device.  This is the JAX package's pure-Python pad loop; its
native C++ pad path is not ported.

``SFTSingleTurnPreprocessor`` turns rows of a context / target dataset
(HellaSwag) into training rows as the JAX one does through HF
``datasets``' ``.map``: here a plain loop over the rows, in batches of
1000 (``.map``'s default), since the port has no ``datasets`` package.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

CROSS_ENTROPY_IGNORE_IDX = -100

PAD_TOKEN_IDS = {
    "labels": CROSS_ENTROPY_IGNORE_IDX,
    "attention_mask": 0,
    "loss_mask": 0,
    "segment_ids": 0,      # segment 0 == padding for the attention kernels
    "position_ids": 0,
}



def _str_is_hf_repo_id(val: str) -> bool:
    """``org/name`` that is no local path and no json file."""
    return (not os.path.exists(val) and val.count("/") == 1
            and not val.endswith((".json", ".jsonl")))


def load_local_rows(source: Union[str, Sequence]) -> List[dict]:
    """A dataset's rows: a list of row dicts as it is, or the rows of local
    json / jsonl files (one path or a list of paths; a json file holds a
    list of rows or one row).  A Hugging Face repo id raises
    ``NotImplementedError``: the port has no ``datasets`` package and
    reads no network."""
    paths = [source] if isinstance(source, str) else list(source)
    if paths and all(isinstance(p, dict) for p in paths):
        return paths
    if not all(isinstance(p, str) for p in paths):
        raise ValueError(f"expected rows (dicts) or json / jsonl paths, got "
                         f"{type(source)}")
    if paths and all(_str_is_hf_repo_id(p) for p in paths):
        raise NotImplementedError(
            f"{paths}: loading a Hugging Face dataset by repo id needs "
            "the datasets package and the network, which the port does "
            "not use; pass local json / jsonl files")
    rows: List[dict] = []
    for p in paths:
        with open(p) as f:
            if p.endswith(".jsonl"):
                rows.extend(json.loads(line) for line in f if line.strip())
            else:
                data = json.load(f)
                rows.extend(data if isinstance(data, list) else [data])
    return rows


# a row's own pad ids per key (``{key: pad id}``), read from the
# microbatch's first row and dropped from the output
PAD_SENTINEL_KEY = "___PAD_TOKEN_IDS___"


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
    """Pad-and-stack collater -> ``{key: int32 [B, S]}``.  The first row's
    ``___PAD_TOKEN_IDS___`` (if any) overrides the pad table per key; the
    rows themselves are left as they are."""
    pad_ids = batch[0].get(PAD_SENTINEL_KEY) or {}
    out = {}
    for key in batch[0].keys():
        if key == PAD_SENTINEL_KEY:
            continue
        rows = [x[key] for x in batch]
        max_len, pad_id = resolve_pad_geometry(
            rows, pad_ids.get(key, PAD_TOKEN_IDS.get(key)),
            pad_seq_len_divisible)
        padded = [list(r) + [pad_id] * (max_len - len(r)) for r in rows]
        arr = np.asarray(padded, dtype=np.int32)
        out[key] = arr[None, :] if arr.ndim == 1 else arr
    return out


def classification_collater(batch: List[dict],
                            pad_seq_len_divisible: Optional[int] = None
                            ) -> Dict[str, np.ndarray]:
    """Sequence classification (the JAX ``classification_collater``): the
    token keys pad and stack as :func:`default_collater` does; ``labels``
    is one int32 per example, ``[B]``.  The rows are left as they are."""
    labels = np.asarray([ex["labels"] for ex in batch], np.int32)
    out = default_collater([{k: v for k, v in ex.items() if k != "labels"}
                            for ex in batch], pad_seq_len_divisible)
    out["labels"] = labels
    return out


class SFTSingleTurnPreprocessor:
    """Context + target rows -> training rows (the JAX preprocessor):
    ``input_ids`` = the context's tokens then the target's (a trailing
    special token of the context and a leading one of the target trimmed,
    judged on each batch's first row as the JAX one does), ``labels``
    shifted in advance (-100 over the context but its last token, then the
    target's ids, then -100), ``loss_mask``, ``attention_mask``, and every
    row padded to the dataset's longest rounded up to a multiple of 8
    (``block_size`` caps it).  The tokenizer is duck-typed: called on a
    list of strings, it returns ``{"input_ids": [[...]], "attention_mask":
    [[...]]}``."""

    batch_size = 1000            # HF datasets' .map(batched=True) default

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.block_size = None

    def _tokenize(self, rows: List[dict], dataset) -> Dict[str, list]:
        ctx_tok = self.tokenizer(dataset.get_context(rows))
        tgt_tok = self.tokenizer(dataset.get_target(rows))
        ctx_ids, ctx_m = ctx_tok["input_ids"], ctx_tok["attention_mask"]
        tgt_ids, tgt_m = tgt_tok["input_ids"], tgt_tok["attention_mask"]
        special = set(getattr(self.tokenizer, "all_special_ids", []) or [])
        if len(ctx_ids[0]) > 0 and ctx_ids[0][-1] in special:
            ctx_ids = [ids[:-1] for ids in ctx_ids]
            ctx_m = [m[:-1] for m in ctx_m]
        if len(tgt_ids[0]) > 0 and tgt_ids[0][0] in special:
            tgt_ids = [ids[1:] for ids in tgt_ids]
            tgt_m = [m[1:] for m in tgt_m]
        labels = [[CROSS_ENTROPY_IGNORE_IDX] * (len(c) - 1) + list(t)
                  + [CROSS_ENTROPY_IGNORE_IDX]
                  for c, t in zip(ctx_ids, tgt_ids)]
        return {
            "input_ids": [list(c) + list(t) for c, t in zip(ctx_ids,
                                                          tgt_ids)],
            "attention_mask": [list(c) + list(t) for c, t in zip(ctx_m,
                                                               tgt_m)],
            "labels": labels,
            "loss_mask": [[int(t != CROSS_ENTROPY_IGNORE_IDX) for t in lbl]
                          for lbl in labels],
        }

    def process(self, rows: List[dict], dataset) -> List[dict]:
        """Tokenize ``rows`` (a list of dicts) through ``dataset``'s
        ``get_context`` / ``get_target``, then pad -> a list of dicts."""
        tk = self.tokenizer
        if (getattr(tk, "pad_token", None) is None
                and getattr(tk, "bos_token", None) is not None):
            tk.pad_token = tk.bos_token
        cols: Dict[str, list] = {}
        for i in range(0, len(rows), self.batch_size):
            for k, v in self._tokenize(rows[i:i + self.batch_size],
                                       dataset).items():
                cols.setdefault(k, []).extend(v)
        max_len = math.ceil(max(map(len, cols["input_ids"])) / 8) * 8
        if self.block_size is not None:
            max_len = min(max_len, self.block_size)
        pad_id = getattr(tk, "pad_token_id", None) or 0

        def pad(seq, value):
            return list(seq[:max_len]) + [value] * max(0, max_len - len(seq))

        return [{
            "input_ids": pad(ids, pad_id),
            "attention_mask": ([1] * min(len(m), max_len)
                               + [0] * max(0, max_len - len(m))),
            "labels": pad(lbl, CROSS_ENTROPY_IGNORE_IDX),
            "loss_mask": pad(lm, 0),
        } for ids, m, lbl, lm in zip(cols["input_ids"],
                                     cols["attention_mask"], cols["labels"],
                                     cols["loss_mask"])]
