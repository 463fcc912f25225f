"""HellaSwag as single-turn SFT: the context is the prompt, the gold
ending the target (counterpart: ``automodel_tpu/datasets/llm/
hellaswag.py``).

The rows (``ctx``, ``endings`` [4], ``label``) come from an in-memory list
of row dicts or local json / jsonl files; a Hugging Face repo id such as
``rowan/hellaswag`` raises ``NotImplementedError`` (no ``datasets``
package, no network).  With local rows the file is the split, and
``num_samples_limit`` keeps the first rows.  Each row goes through
``datasets/utils.py::SFTSingleTurnPreprocessor``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

from automodel_tpu_torch.datasets.utils import (
    SFTSingleTurnPreprocessor,
    load_local_rows,
)


class HellaSwag:
    """Training rows of HellaSwag (``input_ids``, ``labels``,
    ``loss_mask``; every row padded to the set's longest, a multiple of
    8)."""

    def __init__(self, path_or_dataset: Union[str, Sequence], tokenizer,
                 split: str = "train", num_samples_limit: Optional[int] = None,
                 trust_remote_code: bool = True):
        rows = load_local_rows(path_or_dataset)
        if isinstance(num_samples_limit, int):
            rows = rows[:num_samples_limit]
        self.dataset = SFTSingleTurnPreprocessor(tokenizer).process(rows,
                                                                    self)

    def get_context(self, rows: List[dict]) -> List[str]:
        return [r["ctx"] for r in rows]

    def get_target(self, rows: List[dict]) -> List[str]:
        return [r["endings"][int(r["label"])] for r in rows]

    def __getitem__(self, index) -> dict:
        ans = dict(self.dataset[index])
        ans.pop("attention_mask", None)
        return ans

    def __len__(self) -> int:
        return len(self.dataset)
