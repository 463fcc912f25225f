"""VLM dataset makers (counterpart: ``automodel_tpu/datasets/vlm/
datasets.py``): rows -> ``{"conversation": [...], "images": [array]}``
(CommonVoice: ``"audio"``), the format the collators take.

The rows come from an in-memory list of row dicts or from local json /
jsonl files (``path_or_dataset``); a Hugging Face repo id such as
``naver-clova-ix/cord-v2`` raises ``FileNotFoundError`` (no ``datasets``
package, no network).  A row's ``image`` is an array (nested lists
included) or the path of a local ``.npy`` file, loaded as it is read.
``split`` is accepted for the JAX signature's sake; a local file is one
split.  ``limit_dataset_samples`` keeps the first rows.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, List, Optional

import numpy as np

from automodel_tpu_torch.datasets.utils import load_local_rows
from automodel_tpu_torch.datasets.vlm.utils import json2token


def _rows(path_or_dataset, limit: Optional[int]) -> List[dict]:
    try:
        rows = load_local_rows(path_or_dataset)
    except NotImplementedError as e:
        raise FileNotFoundError(
            f"{path_or_dataset!r} is a dataset repo id: the port reads "
            "local json / jsonl rows only (no datasets package, no "
            "network)") from e
    return rows[:limit] if isinstance(limit, int) else rows


def _image(value: Any) -> np.ndarray:
    if isinstance(value, str):
        if not os.path.exists(value):
            raise FileNotFoundError(f"image file {value!r}")
        return np.load(value)
    return np.asarray(value)


def _conversation(prompt: str, answer: str, image: Any) -> dict:
    return {
        "conversation": [
            {"role": "user", "content": [
                {"type": "image"}, {"type": "text", "text": prompt}]},
            {"role": "assistant", "content": [
                {"type": "text", "text": answer}]},
        ],
        "images": [_image(image)],
    }


def _build(path_or_dataset, limit, fmt: Callable[[dict], dict]):
    return [fmt(ex) for ex in _rows(path_or_dataset, limit)]


def make_rdr_dataset(path_or_dataset: Any = "quintend/rdr-items",
                     split: str = "train", limit_dataset_samples=None,
                     **kwargs) -> List[dict]:
    """RDR items: image -> description (``text``)."""
    return _build(path_or_dataset, limit_dataset_samples,
                  lambda ex: _conversation("Describe this image.",
                                           ex["text"], ex["image"]))


def make_cord_v2_dataset(path_or_dataset: Any = "naver-clova-ix/cord-v2",
                         split: str = "train", limit_dataset_samples=None,
                         **kwargs) -> List[dict]:
    """CORD-v2 receipts: image -> the Donut ``json2token`` serialisation
    of ``ground_truth``'s ``gt_parse`` (a JSON string)."""
    def fmt(ex):
        gt = json.loads(ex["ground_truth"])
        return _conversation("Extract the text.",
                             json2token(gt.get("gt_parse", gt)), ex["image"])

    return _build(path_or_dataset, limit_dataset_samples, fmt)


def make_medpix_dataset(path_or_dataset: Any = "mmoukouba/MedPix-VQA",
                        split: str = "train", limit_dataset_samples=None,
                        **kwargs) -> List[dict]:
    """MedPix VQA: image + ``question`` -> ``answer``."""
    return _build(path_or_dataset, limit_dataset_samples,
                  lambda ex: _conversation(ex["question"], ex["answer"],
                                           ex["image"]))


def make_cv17_dataset(path_or_dataset: Any = "ysdede/commonvoice_17_tr_fixed",
                      split: str = "train", limit_dataset_samples=None,
                      **kwargs) -> List[dict]:
    """CommonVoice 17 audio: ``audio`` -> a transcription of ``sentence``
    (the assistant turn as a list of text parts, as in JAX, which
    ``phi4_mm_collate_fn`` does not take)."""
    def fmt(ex):
        return {
            "conversation": [
                {"role": "user", "content": [
                    {"type": "audio"},
                    {"type": "text",
                     "text": "Transcribe the audio clip into text."}]},
                {"role": "assistant", "content": [
                    {"type": "text", "text": ex["sentence"]}]},
            ],
            "audio": ex["audio"],
        }

    return _build(path_or_dataset, limit_dataset_samples, fmt)
