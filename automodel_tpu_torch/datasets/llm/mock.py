"""Synthetic Gaussian-length sentences, classification rows and preference
pairs (counterpart: ``automodel_tpu/datasets/llm/mock.py::
build_unpacked_dataset``, ``build_classification_dataset`` and
``build_preference_pairs_dataset``).

The same samples from the same seed: the generator is Python's ``random``
module, seeded and drawn in the same order as the JAX package's.
"""

from __future__ import annotations

import random
from typing import Dict, List


def make_vocab(vocab_size: int = 100) -> Dict[str, int]:
    vocab = {"<pad>": 0, "<eos>": 1}
    for i in range(2, vocab_size):
        vocab[f"tok_{i}"] = i
    return vocab


def gen_sentence_ids(vocab, mean_len: float, std_len: float,
                     max_len: int) -> List[int]:
    words = list(vocab.values())[2:]
    L = max(1, min(max_len, int(random.gauss(mean_len, std_len))))
    return random.choices(words, k=L) + [vocab["<eos>"]]


def build_unpacked_dataset(
    *,
    num_sentences: int = 10,
    mean_len: float = 20.0,
    std_len: float = 6.0,
    vocab_size: int = 100,
    max_sentence_len: int = 64,
    seed: int = 0,
    tokenizer=None,
) -> List[Dict[str, List[int]]]:
    """Each example is one variable-length sentence with labels ==
    input_ids (self-supervised) and per-sentence position ids.  Seeds the
    process-wide ``random`` module, as the JAX package does."""
    random.seed(seed)
    vocab = make_vocab(vocab_size)
    eos_id = vocab["<eos>"]
    examples = []
    for _ in range(num_sentences):
        sent = gen_sentence_ids(vocab, mean_len, std_len, max_sentence_len)
        pos_ids, pos = [], 0
        for tid in sent:
            pos_ids.append(pos)
            pos = 0 if tid == eos_id else pos + 1
        examples.append({
            "input_ids": sent,
            "attention_mask": [1] * len(sent),
            "labels": sent.copy(),
            "position_ids": pos_ids,
        })
    return examples


def build_classification_dataset(
    *,
    num_examples: int = 64,
    num_labels: int = 2,
    mean_len: float = 20.0,
    std_len: float = 6.0,
    vocab_size: int = 100,
    max_sentence_len: int = 64,
    seed: int = 0,
    tokenizer=None,
) -> List[Dict[str, List[int]]]:
    """Sequence-classification rows: one sentence and one label each, the
    label the first token's id modulo ``num_labels`` (learnable in a few
    steps).  The same rows as JAX from the same seed."""
    random.seed(seed)
    vocab = make_vocab(vocab_size)
    examples = []
    for _ in range(num_examples):
        sent = gen_sentence_ids(vocab, mean_len, std_len, max_sentence_len)
        examples.append({
            "input_ids": sent,
            "attention_mask": [1] * len(sent),
            "labels": sent[0] % num_labels,
        })
    return examples


def build_preference_pairs_dataset(
    *,
    num_pairs: int = 64,
    prompt_len: int = 8,
    mean_len: float = 8.0,
    std_len: float = 2.0,
    vocab_size: int = 100,
    max_completion_len: int = 16,
    seed: int = 0,
    tokenizer=None,
) -> List[Dict[str, List[int]]]:
    """Synthetic DPO preference pairs, ``{prompt_ids, chosen_ids,
    rejected_ids}`` rows (counterpart:
    ``automodel_tpu/datasets/llm/mock.py::build_preference_pairs_dataset``;
    the same rows from the same seed).  Chosen completions draw from the
    lower half of the vocabulary and rejected ones from the upper half, so
    a small model's DPO accuracy and margin move within a few steps."""
    random.seed(seed)
    vocab = make_vocab(vocab_size)
    words = list(vocab.values())[2:]
    mid = max(len(words) // 2, 1)
    lo, hi = words[:mid], words[mid:] or words

    def completion(pool):
        L = max(1, min(max_completion_len,
                       int(random.gauss(mean_len, std_len))))
        return random.choices(pool, k=L) + [vocab["<eos>"]]

    examples = []
    for _ in range(num_pairs):
        prompt = random.choices(words, k=max(1, prompt_len))
        examples.append({
            "prompt_ids": prompt,
            "chosen_ids": completion(lo),
            "rejected_ids": completion(hi),
        })
    return examples
