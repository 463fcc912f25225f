"""Pre-packed synthetic dataset: fixed-size blocks of concatenated sentences
(counterpart: ``automodel_tpu/datasets/llm/mock_packed.py``).

Sentences from ``datasets/llm/mock.py``'s generator (Python's ``random``,
seeded and drawn in the JAX package's order) are concatenated and cut into
blocks of exactly ``block_size`` tokens, with position ids that restart
after every eos: the JAX package's blocks from the same seed.
"""

from __future__ import annotations

import random
from typing import Dict, List

from automodel_tpu_torch.datasets.llm.mock import gen_sentence_ids, make_vocab

EOS_ID = 1  # make_vocab convention: 0 = <pad>, 1 = <eos>


def _block_to_example(block: List[int]) -> Dict[str, List[int]]:
    """Position ids restart after every eos, so each packed sentence sees
    its own positions."""
    pos_ids, pos = [], 0
    for tid in block:
        pos_ids.append(pos)
        pos = 0 if tid == EOS_ID else pos + 1
    return {
        "input_ids": block,
        "attention_mask": [1] * len(block),
        "labels": list(block),
        "position_ids": pos_ids,
    }


def build_packed_dataset(
    *,
    num_blocks: int = 10,
    block_size: int = 128,
    mean_len: float = 20.0,
    std_len: float = 6.0,
    vocab_size: int = 100,
    max_sentence_len: int = 64,
    seed: int = 0,
    tokenizer=None,
) -> List[Dict[str, List[int]]]:
    """``num_blocks`` examples of exactly ``block_size`` tokens.  Seeds the
    process-wide ``random`` module, as the JAX package does."""
    random.seed(seed)
    vocab = make_vocab(vocab_size)
    blocks: List[Dict[str, List[int]]] = []
    current: List[int] = []
    while len(blocks) < num_blocks:
        current.extend(gen_sentence_ids(vocab, mean_len, std_len,
                                        max_sentence_len))
        while len(current) >= block_size and len(blocks) < num_blocks:
            blocks.append(_block_to_example(current[:block_size]))
            current = current[block_size:]
    return blocks
