"""Deterministic shuffling dataloader (counterpart:
``automodel_tpu/datasets/dataloader.py::StatefulDataLoader``).

A map-style or iterable dataset -> collated global microbatches as numpy
arrays, in the same order as the JAX package's loader for the same seed:
the epoch permutation is ``np.random.default_rng(seed +
epoch).permutation(n)``.  As there, the position advances before each
batch is yielded, so a loop that stops mid-epoch (``max_steps``) and
iterates again resumes at the next batch; ``state_dict()`` /
``load_state_dict()`` carry that position (``datasets/prefetch.py``
snapshots it with every batch it produces).  An iterable dataset (no
``__getitem__``, or ``streaming``) is read in its own order and resumes by
skipping the samples consumed.

``length_bucket_pool`` (map-style only): each pool of that many samples of
the epoch order is sorted by length (measured once and cached), cut into
batches, the remainders parked at the end, and the whole batches shuffled
again batch-wise, as in JAX: rows of a batch then have like lengths, so an
unpacked batch pads less.  Per-host input sharding (``host_rows``) waits
for the multi-GPU slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np

from automodel_tpu_torch.datasets.utils import default_collater


class StatefulDataLoader:
    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        collate_fn: Optional[Callable] = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        pad_seq_len_divisible: Optional[int] = None,
        length_bucket_pool: Optional[int] = None,
    ) -> None:
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.collate_fn = collate_fn or default_collater
        self.pad_seq_len_divisible = pad_seq_len_divisible
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.length_bucket_pool = length_bucket_pool
        self.epoch = 0
        self._index = 0          # samples consumed in the current epoch
        self.is_map_style = (
            hasattr(dataset, "__getitem__") and hasattr(dataset, "__len__")
            and not getattr(dataset, "streaming", False))
        if self.length_bucket_pool and not self.is_map_style:
            raise ValueError(
                "length_bucket_pool needs a map-style dataset (lengths are "
                "read ahead of batching); iterable/streaming datasets "
                "cannot be length-bucketed")
        self._lens: Optional[np.ndarray] = None   # per-sample lengths

    def set_epoch(self, epoch: int) -> None:
        # forward-only: the loader rolls itself to the next epoch when it
        # finishes one
        if epoch > self.epoch:
            self.epoch = epoch
            self._index = 0

    def _collate(self, samples) -> Dict[str, np.ndarray]:
        if self.pad_seq_len_divisible is not None:
            return self.collate_fn(
                samples, pad_seq_len_divisible=self.pad_seq_len_divisible)
        return self.collate_fn(samples)

    def _sample_lengths(self) -> np.ndarray:
        """Per-sample ``input_ids`` lengths, measured once (they do not
        change across epochs)."""
        if self._lens is None:
            lens = []
            for i in range(len(self.dataset)):
                s = self.dataset[int(i)]
                ids = s.get("input_ids") if isinstance(s, dict) else None
                lens.append(len(ids) if ids is not None else 0)
            self._lens = np.asarray(lens, np.int64)
            if not self._lens.any():
                raise ValueError(
                    "length_bucket_pool: no sample exposes 'input_ids' to "
                    "measure — bucketing would silently do nothing. Use a "
                    "dataset whose rows carry tokenized 'input_ids', or "
                    "drop the knob")
        return self._lens

    def _epoch_order(self) -> np.ndarray:
        n = len(self.dataset)
        rng = np.random.default_rng(self.seed + self.epoch)
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        if not self.length_bucket_pool:
            return order
        lens = self._sample_lengths()
        pool = max(int(self.length_bucket_pool), self.batch_size)
        full, remainder = [], []
        for st in range(0, n, pool):
            chunk = order[st:st + pool]
            chunk = chunk[np.argsort(lens[chunk], kind="stable")]
            for c in np.split(chunk, range(self.batch_size, len(chunk),
                                           self.batch_size)):
                # a short batch mid-order would shift every later batch
                # window across the sorted pools: remainders go last
                (full if len(c) == self.batch_size else remainder).append(c)
        # batch-wise re-shuffle: consecutive steps do not sweep through
        # the lengths in order
        if self.shuffle:
            rng.shuffle(full)
        parts = full + remainder
        return np.concatenate(parts) if parts else order

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """The rest of the current epoch; the loader rolls to the next
        epoch's order as soon as it yields an epoch's last batch."""
        if not self.is_map_style:
            yield from self._iter_stream()
            return
        order = self._epoch_order()
        n = len(order)
        i = self._index
        while i + self.batch_size <= n or (not self.drop_last and i < n):
            idxs = order[i:i + self.batch_size]
            i += len(idxs)
            more = i + self.batch_size <= n or (not self.drop_last and i < n)
            if more:
                self._index = i
            else:
                self._index = 0
                self.epoch += 1
            yield self._collate([dict(self.dataset[int(j)]) for j in idxs])
            if not more:
                return

    def _iter_stream(self) -> Iterator[Dict[str, np.ndarray]]:
        """An iterable dataset in its own order, after skipping the samples
        this epoch already consumed."""
        it = iter(self.dataset)
        for _ in range(self._index):
            next(it, None)
        batch = []
        for sample in it:
            batch.append(dict(sample))
            if len(batch) == self.batch_size:
                self._index += self.batch_size
                yield self._collate(batch)
                batch = []
        if batch and not self.drop_last:
            self._index += len(batch)
            yield self._collate(batch)
        self._index = 0
        self.epoch += 1

    def __len__(self) -> int:
        if not self.is_map_style:
            raise TypeError("iterable dataset loader has no len()")
        n = len(self.dataset)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    # -- resume state (the async input pipeline snapshots it per batch) ---
    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "index": self._index,
                "seed": self.seed, "shuffle": self.shuffle}

    def load_state_dict(self, sd: dict) -> None:
        self.epoch = sd["epoch"]
        self._index = sd["index"]
        self.seed = sd.get("seed", self.seed)
        self.shuffle = sd.get("shuffle", self.shuffle)
