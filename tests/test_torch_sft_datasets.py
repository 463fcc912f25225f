"""The port's HellaSwag and SQuAD datasets (``automodel_tpu_torch/datasets/
llm/hellaswag.py``, ``squad.py``, ``datasets/utils.py``) against the JAX
package's on the same rows (made from a seed in each set's schema) and the
same duck-typed byte tokenizer (``tests/torch_hf_fixtures.py``).  The JAX
side reads the rows as ``datasets.Dataset.from_list`` (its SQuAD builder
through a stand-in ``load_dataset`` that serves them), the port's as a
list and as local jsonl files.  Every training row must be equal token for
token: ``input_ids``, ``labels``, ``loss_mask`` / ``attention_mask``, the
padding and SQuAD's pad ids; the collated microbatches too.  Repo ids are
refused by the port (no ``datasets`` package, no network).
"""

import copy

import datasets
import numpy as np
import pytest

from automodel_tpu.datasets import utils as jutils
from automodel_tpu.datasets.llm import hellaswag as jhellaswag
from automodel_tpu.datasets.llm import squad as jsquad
from automodel_tpu_torch.datasets import utils
from automodel_tpu_torch.datasets.llm import hellaswag, squad
from automodel_tpu_torch.datasets.llm.column_mapped_text_instruction_dataset import (  # noqa: E501
    ColumnMappedTextInstructionDataset,
)
from tests.torch_hf_fixtures import (
    ByteTokenizer,
    ChatByteTokenizer,
    hellaswag_rows,
    jax_side_datasets,
    squad_rows,
    write_jsonl,
)


def _rows(ds):
    return [dict(ds[i]) for i in range(len(ds))]


@pytest.mark.parametrize("limit", [None, 24])
def test_hellaswag_rows_equal_jax(tmp_path, monkeypatch, limit):
    jax_side_datasets(monkeypatch)
    rows = hellaswag_rows(40, seed=1)
    want = _rows(jhellaswag.HellaSwag(
        datasets.Dataset.from_list(rows[:limit]), ByteTokenizer()))
    path = write_jsonl(str(tmp_path / "train.jsonl"), rows)
    for source in (rows, path, [path]):
        got = hellaswag.HellaSwag(source, ByteTokenizer(),
                                  num_samples_limit=limit)
        assert len(got) == len(want) == (limit or 40)
        assert _rows(got) == want
    r = want[0]
    assert set(r) == {"input_ids", "labels", "loss_mask"}
    assert len(r["input_ids"]) % 8 == 0
    assert len({len(x["input_ids"]) for x in want}) == 1


def test_hellaswag_batches_of_1000_keep_jax_trims(monkeypatch):
    """The special-token trims are judged on each 1000-row batch's first
    row, as HF's batched ``.map`` does."""
    jax_side_datasets(monkeypatch)
    rows = hellaswag_rows(1003, seed=2, ctx_words=(1, 3), ending_words=(1, 2))
    want = _rows(jhellaswag.HellaSwag(datasets.Dataset.from_list(rows),
                                      ByteTokenizer()))
    assert _rows(hellaswag.HellaSwag(rows, ByteTokenizer())) == want


@pytest.mark.parametrize("chat", [False, True], ids=["plain", "chat"])
@pytest.mark.parametrize("seq_length", [None, 160])
def test_squad_rows_equal_jax(tmp_path, monkeypatch, chat, seq_length):
    rows = {"train": squad_rows(30, seed=3),
            "validation": squad_rows(12, seed=4)}
    jax_side_datasets(monkeypatch, rows)
    tok = ChatByteTokenizer if chat else ByteTokenizer
    sot = "<sot>" if chat else None
    for split, limit in (("train", None), ("validation", 8)):
        want = _rows(jsquad.make_squad_dataset(
            tok(), seq_length=seq_length, limit_dataset_samples=limit,
            start_of_turn_token=sot, split=split,
            dataset_name="rajpurkar/squad"))
        path = write_jsonl(str(tmp_path / f"{split}.jsonl"), rows[split])
        for source in (rows[split], path):
            got = squad.make_squad_dataset(
                tok(), seq_length=seq_length, limit_dataset_samples=limit,
                start_of_turn_token=sot, split=split, dataset_name=source)
            assert got == want
        if seq_length:
            assert {len(r["input_ids"]) for r in got} == {seq_length}
    assert got[0][utils.PAD_SENTINEL_KEY] == {
        "input_ids": 0, "labels": -100, "attention_mask": 0}


def test_squad_pad_token_falls_back_to_eos():
    class NoPad(ByteTokenizer):
        pad_token = pad_token_id = None

    tok, jtok = NoPad(), NoPad()
    assert squad._ensure_pad_token(tok) == jsquad._ensure_pad_token(jtok) \
        == tok.eos_token_id
    assert tok.pad_token == jtok.pad_token == "</s>"


@pytest.mark.parametrize("divisible", [None, 128])
def test_collated_microbatches_equal_jax(monkeypatch, divisible):
    """SQuAD rows carry their pad ids; HellaSwag's pad on the first row's
    last token; both through each package's ``default_collater``."""
    rows = squad_rows(6, seed=5)
    jax_side_datasets(monkeypatch, {"train": rows})
    jrows = _rows(jsquad.make_squad_dataset(ByteTokenizer(),
                                            dataset_name="squad"))
    prows = squad.make_squad_dataset(ByteTokenizer(), dataset_name=rows)
    hs = hellaswag_rows(6, seed=6)
    for jb, pb in ((jrows, prows),
                   (_rows(jhellaswag.HellaSwag(
                       datasets.Dataset.from_list(hs), ByteTokenizer())),
                    _rows(hellaswag.HellaSwag(hs, ByteTokenizer())))):
        want = jutils.default_collater(copy.deepcopy(jb), divisible)
        got = utils.default_collater(pb, divisible)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the rows keep their pad ids for the next epoch's collation
    assert utils.PAD_SENTINEL_KEY in prows[0]


@pytest.mark.parametrize("repo", ["rowan/hellaswag", "rajpurkar/squad"])
def test_repo_ids_are_refused(repo):
    with pytest.raises(NotImplementedError, match="repo id"):
        if "hellaswag" in repo:
            hellaswag.HellaSwag(repo, ByteTokenizer())
        else:
            squad.make_squad_dataset(ByteTokenizer(), dataset_name=repo)
    with pytest.raises(NotImplementedError, match="repo id"):
        ColumnMappedTextInstructionDataset(
            repo, {"question": "q", "answer": "a"}, ByteTokenizer())
