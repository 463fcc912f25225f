"""Deterministic shuffling dataloader (counterpart:
``automodel_tpu/datasets/dataloader.py::StatefulDataLoader``).

A map-style dataset -> collated global microbatches as numpy arrays, in the
same order as the JAX package's loader for the same seed: the epoch
permutation is ``np.random.default_rng(seed + epoch).permutation(n)``.  As
there, the position advances before each batch is yielded, so a loop that
stops mid-epoch (``max_steps``) and iterates again resumes at the next
batch; ``state_dict()`` / ``load_state_dict()`` carry that position
(``datasets/prefetch.py`` snapshots it with every batch it produces).
Per-host input sharding (``host_rows``), length bucketing and iterable
datasets wait for the port's checkpointing and multi-GPU slices.
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
    ) -> None:
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.collate_fn = collate_fn or default_collater
        self.pad_seq_len_divisible = pad_seq_len_divisible
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self._index = 0          # samples consumed in the current epoch

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

    def _epoch_order(self) -> np.ndarray:
        n = len(self.dataset)
        rng = np.random.default_rng(self.seed + self.epoch)
        return rng.permutation(n) if self.shuffle else np.arange(n)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """The rest of the current epoch; the loader rolls to the next
        epoch's order as soon as it yields an epoch's last batch."""
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

    def __len__(self) -> int:
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
