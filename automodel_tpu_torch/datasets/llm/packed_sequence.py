"""Sequence packing with segment ids (counterpart:
``automodel_tpu/datasets/llm/packed_sequence.py``).

Greedy packing up to ``packed_sequence_size``; each pack carries
``input_ids``, ``labels``, ``position_ids`` (restarting per sample),
``segment_ids`` (1-based per sample, 0 = padding) and ``seq_lens``.  This
is the JAX package's pure-Python packer and gives identical packs; its
native C++ fast path, ``max_packs`` and the ``loss_mask`` pass-through (the
ported datasets carry the mask in their -100 labels) are not ported.
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np

from automodel_tpu_torch.datasets.utils import CROSS_ENTROPY_IGNORE_IDX

logger = logging.getLogger(__name__)

PACK_TYPE = Dict[str, List[int]]


class PackedSequence:
    """Greedy packer: concatenates samples up to ``packed_sequence_size``."""

    PADDING_IDX = 0

    def __init__(self, dataset, packed_sequence_size: int = 2048,
                 split_across_pack: bool = False):
        self.dataset = dataset
        self.packed_sequence_size = packed_sequence_size
        self.split_across_pack = split_across_pack
        self.packs: List[PACK_TYPE] = []
        self.packed_dataset = None

    def pack(self):
        size = self.packed_sequence_size
        cur = _empty_pack()
        next_seg = 1

        for sample in self.dataset:
            ids, labels = list(sample["input_ids"]), list(sample["labels"])
            seq_len = len(ids)
            if seq_len > size and not self.split_across_pack:
                raise ValueError(
                    f"Dataset sample is too long ({seq_len} > {size}). Set "
                    "split_across_pack=True or increase packed_sequence_size.")
            cur["input_ids"] += ids
            cur["labels"] += labels
            cur["position_ids"] += [p % size for p in range(seq_len)]
            cur["segment_ids"] += [next_seg] * seq_len
            cur["seq_lens"].append(seq_len)
            next_seg += 1
            while len(cur["input_ids"]) > size:
                cur, next_seg = self._split_and_add(cur, next_seg)

        if len(cur["input_ids"]) > 0:
            self._add(cur)

        self.packed_dataset = [
            {k: np.asarray(v, dtype=np.int32) for k, v in pack.items()}
            for pack in self.packs
        ]
        logger.info("Total number of packs created: %d", len(self.packs))
        return self

    def _split_and_add(self, cur: PACK_TYPE, next_seg: int):
        size = self.packed_sequence_size
        if self.split_across_pack:
            boundary = size
            leftover = size - sum(cur["seq_lens"][:-1])
            seq_lens = cur["seq_lens"][:-1] + ([leftover] if leftover > 0
                                               else [])
        else:
            # last (partial) sample moves wholly to the next pack
            boundary = len(cur["input_ids"]) - cur["seq_lens"][-1]
            seq_lens = cur["seq_lens"][:-1]
        pack = {k: cur[k][:boundary] for k in cur if k != "seq_lens"}
        pack["seq_lens"] = seq_lens
        self._add(pack)

        rest = {k: cur[k][boundary:] for k in cur if k != "seq_lens"}
        rest["seq_lens"] = [len(rest["input_ids"])] if rest["input_ids"] else []
        if self.split_across_pack and rest["input_ids"]:
            # the continuation gets a fresh segment id and restarted
            # positions
            rest["position_ids"] = [p % size
                                    for p in range(len(rest["input_ids"]))]
            rest["segment_ids"] = [next_seg] * len(rest["input_ids"])
            next_seg += 1
        return rest, next_seg

    def _add(self, pack: PACK_TYPE) -> None:
        """Pad to packed_sequence_size and renumber segments densely from
        1."""
        size = self.packed_sequence_size
        n = len(pack["input_ids"])
        pad = size - n
        out = dict(pack)
        if pad > 0:
            out["input_ids"] = pack["input_ids"] + [self.PADDING_IDX] * pad
            out["labels"] = pack["labels"] + [CROSS_ENTROPY_IGNORE_IDX] * pad
            out["position_ids"] = pack["position_ids"] + [
                p % size for p in range(n, size)]
            out["segment_ids"] = pack["segment_ids"] + [0] * pad
        remap: Dict[int, int] = {}
        seg = []
        for s in out["segment_ids"]:
            if s == 0:
                seg.append(0)
            else:
                remap.setdefault(s, len(remap) + 1)
                seg.append(remap[s])
        out["segment_ids"] = seg
        self.packs.append(out)

    def __len__(self) -> int:
        if self.packed_dataset is None:
            raise RuntimeError("call .pack() first")
        return len(self.packed_dataset)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if self.packed_dataset is None:
            raise RuntimeError("call .pack() first")
        item = dict(self.packed_dataset[idx])
        item.pop("seq_lens", None)
        return item


def _empty_pack() -> PACK_TYPE:
    return {"input_ids": [], "labels": [], "position_ids": [],
            "segment_ids": [], "seq_lens": []}
