"""Seeded random streams (counterpart: ``automodel_tpu/training/rng.py``).

One seed drives Python's ``random``, numpy's global state and ``torch``'s
default generator.  Where the JAX package folds a key per stream
(``key_for(step, ...)``), the port derives a seed per stream from (seed,
stream coordinates) with ``np.random.SeedSequence``; the consumer seeds its
own ``torch.Generator`` with it (``LlamaForCausalLM.init_weights`` does),
so a stream never depends on how much another one has drawn.  ``ranked``
offsets the seed by the host index, as JAX's ``jax.process_index()``
(one process drives a host's devices there): torchrun's node rank, 0 on
one host (``distributed/init.py::host_index``).  The ranks of one host
thus draw the same parameters, as JAX's devices share one init, before
the parallel plan shards them.
``state_dict`` / ``load_state_dict`` carry the seed and the three global
generators' states through a checkpoint.
"""

from __future__ import annotations

import random

import numpy as np
import torch


class StatefulRNG:
    def __init__(self, seed: int = 42, ranked: bool = False):
        self.seed = int(seed)
        self.ranked = bool(ranked)
        offset = 0
        if ranked:
            from automodel_tpu_torch.distributed.init import host_index

            offset = host_index()
        self._effective_seed = self.seed + offset
        random.seed(self._effective_seed)
        np.random.seed(self._effective_seed % (2 ** 32))
        torch.manual_seed(self._effective_seed)

    def seed_for(self, *stream: int) -> int:
        """A 63-bit seed for the stream at these coordinates."""
        seq = np.random.SeedSequence([self._effective_seed,
                                      *[int(s) for s in stream]])
        return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))

    def state_dict(self) -> dict:
        return {"seed": self.seed, "ranked": self.ranked,
                "effective_seed": self._effective_seed,
                "py_random": random.getstate(),
                "np_random": np.random.get_state(),
                "torch_random": torch.get_rng_state()}

    def load_state_dict(self, sd: dict) -> None:
        self.seed = sd["seed"]
        self.ranked = sd["ranked"]
        self._effective_seed = sd["effective_seed"]
        random.setstate(sd["py_random"])
        np.random.set_state(sd["np_random"])
        torch.set_rng_state(sd["torch_random"])
