"""Pretraining dataset over nanoGPT-style ``.bin`` token shards
(counterpart: ``automodel_tpu/datasets/llm/nanogpt_dataset.py``).

A shard is an ``int32[256]`` header -- magic 278895051 (``header[3]`` is
the token itemsize, 2 or 4) or the legacy 20240520 (uint16 tokens),
version 1, the token count at ``header[2]`` -- then the tokens.
:func:`write_shard` and :func:`load_shard` write and read the format as the
JAX package does, so a shard written by either package reads the same in
the other.  :class:`NanogptDataset` is iterable: windows of ``seq_len + 1``
tokens shifted into ``input_ids`` / ``labels``, optionally aligned to BOS
tokens through a cached ``.bos.idx`` sidecar, split round-robin across
ranks (``rank`` / ``world_size``; by default this process's
``torch.distributed`` rank, else 0 of 1).
"""

from __future__ import annotations

import glob as globlib
import os
from typing import Iterator, List, Optional

import numpy as np

MAGIC = 278895051
LEGACY_MAGIC = 20240520
VERSION = 1
HEADER_SIZE = 256  # int32s


def _header(path: str) -> np.ndarray:
    header = np.memmap(path, dtype=np.int32, mode="r", shape=(HEADER_SIZE,))
    if header[0] not in (MAGIC, LEGACY_MAGIC):
        raise ValueError(f"{path} magic mismatch ({header[0]})")
    return header


def _token_dtype(n_bytes: int):
    if n_bytes == 2:
        return np.uint16
    if n_bytes == 4:
        return np.uint32
    raise ValueError(f"Expected itemsize 2 or 4, got {n_bytes}")


def load_shard(path: str) -> np.ndarray:
    """Memory-map a ``.bin`` shard's tokens (header checked)."""
    header = _header(path)
    if header[1] != VERSION:
        raise ValueError(f"{path} version mismatch ({header[1]})")
    dtype = (np.uint16 if header[0] == LEGACY_MAGIC
             else _token_dtype(int(header[3])))
    return np.memmap(path, dtype=dtype, mode="r", offset=HEADER_SIZE * 4,
                     shape=(int(header[2]),))


def write_shard(path: str, tokens: np.ndarray) -> None:
    """Write tokens in the new ``.bin`` format (uint16 below 2^16, else
    uint32)."""
    tokens = np.asarray(tokens)
    dtype = np.uint32 if tokens.max(initial=0) >= 2 ** 16 else np.uint16
    tokens = tokens.astype(dtype)
    header = np.zeros(HEADER_SIZE, dtype=np.int32)
    header[0] = MAGIC
    header[1] = VERSION
    header[2] = len(tokens)
    header[3] = tokens.dtype.itemsize
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(tokens.tobytes())


def _default_rank():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class NanogptDataset:
    """Iterable dataset of ``{"input_ids", "labels"}`` windows (int32)."""

    def __init__(
        self,
        file_pattern: str,
        seq_len: int = 1024,
        shuffle_files: bool = False,
        align_to_bos: bool = False,
        bos_token: Optional[int] = None,
        *,
        rank: Optional[int] = None,
        world_size: Optional[int] = None,
    ):
        self.files: List[str] = sorted(globlib.glob(file_pattern))
        if not self.files:
            raise FileNotFoundError(f"No files match {file_pattern!r}")
        self.seq_len = seq_len
        self.shuffle_files = shuffle_files
        self.align_to_bos = align_to_bos
        self.bos_token = bos_token
        if align_to_bos and bos_token is None:
            raise ValueError("align_to_bos requires bos_token")
        if rank is None:
            rank, world_size = _default_rank()
        self.rank = rank
        self.world_size = world_size or 1

    def _bos_starts(self, path: str, tokens: np.ndarray) -> np.ndarray:
        sidecar = path + ".bos.idx"
        if os.path.exists(sidecar):
            return np.fromfile(sidecar, dtype=np.int64)
        starts = np.flatnonzero(
            np.asarray(tokens) == self.bos_token).astype(np.int64)
        try:
            starts.tofile(sidecar)
        except OSError:
            pass  # read-only data directory: recomputed next time
        return starts

    def _window_starts(self, path: str, tokens: np.ndarray):
        need = self.seq_len + 1
        if self.align_to_bos:
            for s in self._bos_starts(path, tokens):
                if s + need > len(tokens):
                    return
                yield int(s)
        else:
            for w in range((len(tokens) - 1) // self.seq_len):
                yield w * self.seq_len

    def __iter__(self) -> Iterator[dict]:
        files = list(self.files)
        if self.shuffle_files:
            np.random.default_rng(1234).shuffle(files)
        need = self.seq_len + 1
        widx = 0      # round-robin over windows: rank r takes r, r + W, ...
        for path in files:
            tokens = load_shard(path)
            for s in self._window_starts(path, tokens):
                if widx % self.world_size == self.rank:
                    window = np.asarray(tokens[s:s + need], dtype=np.int64)
                    yield {"input_ids": window[:-1].astype(np.int32),
                           "labels": window[1:].astype(np.int32)}
                widx += 1

    def __len__(self) -> int:
        need = self.seq_len + 1
        total = 0
        for path in self.files:
            if self.align_to_bos:
                tokens = load_shard(path)
                starts = self._bos_starts(path, tokens)
                total += int(np.sum(starts + need <= len(tokens)))
            else:
                total += (int(_header(path)[2]) - 1) // self.seq_len
        base, extra = divmod(total, self.world_size)
        return base + (1 if self.rank < extra else 0)
