"""SQuAD as SFT: question-answering rows -> prompt-masked training rows
(counterpart: ``automodel_tpu/datasets/llm/squad.py``).

Tokenize (a ``Context: / Question: / Answer:`` prompt, or the tokenizer's
chat template when it has one), locate the answer's first token, then
shift into next-token labels, mask the prompt, optionally pad to
``seq_length`` and attach the ``___PAD_TOKEN_IDS___`` entry that the
collater pads each key with.  The rows (``context``, ``question``,
``answers: {text, answer_start}``) come from an in-memory list of row
dicts or local json / jsonl files given as ``dataset_name``; a Hugging
Face repo id such as ``rajpurkar/squad`` raises ``NotImplementedError``
(no ``datasets`` package, no network).  ``limit_dataset_samples`` keeps
the first rows.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

from automodel_tpu_torch.datasets.utils import (
    CROSS_ENTROPY_IGNORE_IDX,
    PAD_SENTINEL_KEY,
    load_local_rows,
)


def _ensure_pad_token(tokenizer) -> int:
    """Tokenizers without a pad token reuse eos (the HF convention)."""
    if getattr(tokenizer, "pad_token_id", None) is None:
        tokenizer.pad_token_id = tokenizer.eos_token_id
    if getattr(tokenizer, "pad_token", None) is None and getattr(
            tokenizer, "eos_token", None) is not None:
        tokenizer.pad_token = tokenizer.eos_token
    return tokenizer.pad_token_id


def _answer_text(example) -> str:
    texts = example["answers"]["text"]
    return texts[0].strip() if texts else ""


def _tokenize_plain(example, tokenizer) -> Tuple[list, int, bool]:
    """The ``Context / Question / Answer`` prompt; the supervised span
    starts where the prompt's tokens end."""
    prompt = (f"Context: {example['context']}\n"
              f"Question: {example['question']}\nAnswer:")
    ids = tokenizer(prompt + " " + _answer_text(example))["input_ids"]
    return ids, len(tokenizer(prompt)["input_ids"]), False


def _tokenize_chat(example, tokenizer, start_of_turn_token: Optional[str]
                   ) -> Tuple[list, int, bool]:
    """The chat template; the supervised span starts at the second
    start-of-turn marker (the assistant's turn)."""
    ids = tokenizer.apply_chat_template([
        {"role": "user",
         "content": f"{example['context']} {example['question']}"},
        {"role": "assistant", "content": _answer_text(example)},
    ])
    response_start = 0
    if isinstance(start_of_turn_token, str):
        marker = tokenizer(start_of_turn_token,
                           add_special_tokens=False)["input_ids"][0]
        response_start = ids.index(marker, ids.index(marker) + 1)
    return ids, response_start, True


def _to_training_row(ids: list, response_start: int, *, eos_token_id: int,
                     pad_token_id: int, seq_length: Optional[int],
                     appended_eos: bool) -> dict:
    """Shift ``ids`` into next-token labels, mask the prompt, optionally
    pad to ``seq_length``, and attach the collater's pad ids."""
    if not appended_eos and ids[-1] != eos_token_id:
        ids = ids + [eos_token_id]
    labels = ([CROSS_ENTROPY_IGNORE_IDX] * max(response_start - 1, 0)
              + ids[max(response_start, 1):])
    inputs = ids[:-1]
    attention_mask = [1] * len(inputs)
    if len(inputs) != len(labels):
        raise ValueError(f"{len(inputs)} inputs against {len(labels)} "
                         "labels")
    if isinstance(seq_length, int):
        inputs = inputs + [pad_token_id] * (seq_length - len(inputs))
        labels = labels + [CROSS_ENTROPY_IGNORE_IDX] * (seq_length
                                                        - len(labels))
    attention_mask += [0] * (len(labels) - len(attention_mask))
    return {
        "input_ids": inputs,
        "labels": labels,
        "attention_mask": attention_mask,
        PAD_SENTINEL_KEY: {
            "input_ids": pad_token_id,
            "labels": CROSS_ENTROPY_IGNORE_IDX,
            "attention_mask": 0,
        },
    }


def make_squad_dataset(tokenizer, seq_length: Optional[int] = None,
                       limit_dataset_samples: Optional[int] = None,
                       start_of_turn_token: Optional[str] = None,
                       fp8: bool = False, split: str = "train",
                       dataset_name: Union[str, Sequence] = "squad"
                       ) -> List[dict]:
    """The SQuAD training rows of ``dataset_name`` (rows or local json /
    jsonl files; the file is the ``split``)."""
    rows = load_local_rows(dataset_name)
    if isinstance(limit_dataset_samples, int):
        rows = rows[:limit_dataset_samples]
    eos_token_id = tokenizer.eos_token_id
    pad_token_id = _ensure_pad_token(tokenizer)
    use_chat = getattr(tokenizer, "chat_template", None) is not None
    out = []
    for example in rows:
        if use_chat:
            ids, start, chat = _tokenize_chat(example, tokenizer,
                                              start_of_turn_token)
        else:
            ids, start, chat = _tokenize_plain(example, tokenizer)
        out.append(_to_training_row(
            ids, start, eos_token_id=eos_token_id, pad_token_id=pad_token_id,
            seq_length=seq_length, appended_eos=chat))
    return out
