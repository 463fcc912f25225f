"""Instruction dataset with a YAML-declared column mapping (counterpart:
``automodel_tpu/datasets/llm/column_mapped_text_instruction_dataset.py``).

Maps the columns of local json / jsonl files onto ``{context, question,
answer}`` (or ``{question, answer}``) and tokenizes each row into
``input_ids`` / ``labels`` / ``attention_mask``: with the tokenizer's chat
template when it has one (``apply_chat_template``; with
``answer_only_loss_mask`` the labels start at the second
``start_of_turn_token``), else as ``prompt + " " + answer`` plus eos, the
prompt's labels masked.  The tokenizer is duck-typed, as in JAX: it is
called as ``tok(text) -> {"input_ids": [...]}`` and may have
``eos_token_id``, ``chat_template`` and ``apply_chat_template``.  A
Hugging Face repo id raises ``NotImplementedError``: the port has no
``datasets`` package and reads no network.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Union

from automodel_tpu_torch.datasets.utils import (
    CROSS_ENTROPY_IGNORE_IDX,
    load_local_rows,
)


def make_iterable(val: Union[str, List[str]]) -> List[str]:
    if isinstance(val, str):
        return [val]
    if isinstance(val, (list, tuple)):
        return list(val)
    raise ValueError(f"Expected str or list of str, got {type(val)}")


def _has_chat_template(tokenizer) -> bool:
    return getattr(tokenizer, "chat_template", None) is not None


class ColumnMappedTextInstructionDataset:
    """``column_mapping`` maps canonical keys to dataset columns, e.g.
    ``{context: document, question: instruction, answer: response}``."""

    def __init__(
        self,
        path_or_dataset_id: Union[str, List[str]],
        column_mapping: Dict[str, str],
        tokenizer,
        split: Optional[str] = None,
        answer_only_loss_mask: bool = True,
        streaming: bool = False,
        limit_dataset_samples: Optional[int] = None,
        start_of_turn_token: Optional[str] = None,
    ) -> None:
        self.column_mapping = dict(column_mapping)
        self.tokenizer = tokenizer
        self.answer_only_loss_mask = answer_only_loss_mask
        self.streaming = streaming
        self.start_of_turn_token = start_of_turn_token
        if "answer" not in self.column_mapping:
            raise ValueError("column_mapping must include 'answer'")
        if (answer_only_loss_mask and _has_chat_template(tokenizer)
                and start_of_turn_token is None):
            raise ValueError("answer_only_loss_mask with a chat template "
                             "requires start_of_turn_token")
        rows = load_local_rows(make_iterable(path_or_dataset_id))
        if limit_dataset_samples is not None:
            rows = rows[:limit_dataset_samples]
        self.dataset = rows

    def _map_row(self, row: dict) -> Dict[str, str]:
        return {dst: row[src] for dst, src in self.column_mapping.items()}

    def _apply_tokenizer(self, sample: Dict[str, str]) -> Dict[str, List[int]]:
        tok = self.tokenizer
        context = sample.get("context", "")
        question = sample.get("question", "")
        answer = str(sample["answer"]).strip()
        if _has_chat_template(tok):
            user = " ".join(x for x in (context, question) if x)
            ids = tok.apply_chat_template([
                {"role": "user", "content": user},
                {"role": "assistant", "content": answer},
            ])
            response_start = 0
            if self.answer_only_loss_mask:
                start_id = tok(self.start_of_turn_token,
                               add_special_tokens=False)["input_ids"][0]
                first = ids.index(start_id)
                response_start = ids.index(start_id, first + 1)
            labels = list(ids)
            labels[:response_start] = ([CROSS_ENTROPY_IGNORE_IDX]
                                       * response_start)
            labels = labels[1:] + [CROSS_ENTROPY_IGNORE_IDX]
            return {"input_ids": list(ids), "labels": labels,
                    "attention_mask": [1] * len(ids)}
        prompt = " ".join(x for x in (context, question) if x)
        prompt_ids = tok(prompt)["input_ids"]
        full_ids = tok(prompt + " " + answer)["input_ids"]
        eos = getattr(tok, "eos_token_id", None)
        if eos is not None and (not full_ids or full_ids[-1] != eos):
            full_ids = full_ids + [eos]
        labels = list(full_ids)
        if self.answer_only_loss_mask:
            labels[:len(prompt_ids)] = ([CROSS_ENTROPY_IGNORE_IDX]
                                        * len(prompt_ids))
        input_ids = full_ids[:-1]
        return {"input_ids": input_ids, "labels": labels[1:],
                "attention_mask": [1] * len(input_ids)}

    def __len__(self) -> int:
        if self.streaming:
            raise TypeError("streaming dataset has no len()")
        return len(self.dataset)

    def __getitem__(self, idx) -> Dict[str, List[int]]:
        if self.streaming:
            raise TypeError("streaming dataset is iterable-only")
        return self._apply_tokenizer(self._map_row(self.dataset[idx]))

    def __iter__(self) -> Iterator[Dict[str, List[int]]]:
        for row in self.dataset:
            yield self._apply_tokenizer(self._map_row(row))
