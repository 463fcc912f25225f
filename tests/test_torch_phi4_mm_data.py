"""Phi-4-multimodal's data path against the JAX package on the CPU, bit for
bit: the mock audio processor and rows (``datasets/vlm/mock.py``), the
collator (``phi4_mm_collate_fn``, chosen by the processor's class name),
``stack_microbatches``' audio-frame case, and the CommonVoice builder over
local rows.  A CommonVoice row's assistant turn is a list of text parts,
which both collators tokenize as a string and so refuse with the same
``AttributeError``.
"""

import json
import logging

import numpy as np
import pytest

from automodel_tpu.datasets.vlm import collate_fns as jcf
from automodel_tpu.datasets.vlm import datasets as jds
from automodel_tpu.datasets.vlm import mock as jmock
from automodel_tpu.training.train_step import (
    stack_microbatches as jax_stack,
)
from automodel_tpu_torch.datasets.vlm import collate_fns as tcf
from automodel_tpu_torch.datasets.vlm import datasets as tds
from automodel_tpu_torch.datasets.vlm import mock as tmock
from automodel_tpu_torch.training.train_step import stack_microbatches

PROC = dict(vocab_size=256, input_size=20, time_reduction=4,
            audio_token_id=6)


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def test_mock_rows_processor_and_collator_match_jax():
    ours = tmock.make_mock_audio_dataset(num_samples=12, seed=3)
    theirs = jmock.make_mock_audio_dataset(num_samples=12, seed=3)
    assert len(ours) == len(theirs) == 12
    for a, b in zip(ours, theirs):
        assert a["conversation"] == b["conversation"]
        np.testing.assert_array_equal(a["audio"]["array"],
                                      b["audio"]["array"])
    tp, jp = tmock.Phi4MMProcessor(**PROC), jmock.Phi4MMProcessor(**PROC)
    texts = [tp.apply_chat_template(r["conversation"]) for r in ours[:3]]
    assert texts == [jp.apply_chat_template(r["conversation"])
                     for r in theirs[:3]]
    short = np.ones(30, np.float32)          # under one frame of 4 x 20
    audios = [(ours[0]["audio"]["array"], 16000), short, None]
    _equal(tp(text=texts, audios=audios), jp(text=texts, audios=audios))
    assert tcf.COLLATE_FNS["Phi4MMProcessor"] is tcf.phi4_mm_collate_fn
    assert jcf.COLLATE_FNS["Phi4MMProcessor"] is jcf.phi4_mm_collate_fn
    for div in (None, 128):
        got = tcf.phi4_mm_collate_fn(ours[:4], tp, pad_seq_len_divisible=div)
        want = jcf.phi4_mm_collate_fn(theirs[:4], jp,
                                      pad_seq_len_divisible=div)
        _equal(got, want)
        assert (got["labels"] != -100).sum() > 0
        assert got["input_audio_embeds"].shape[0] == 4


def test_answer_not_found_warns_in_both_packages(caplog):
    rows = tmock.make_mock_audio_dataset(num_samples=2, seed=0)
    proc = tmock.Phi4MMProcessor(**PROC)
    with caplog.at_level(logging.WARNING):
        got = tcf.phi4_mm_collate_fn(rows, proc, max_length=4)
        want = jcf.phi4_mm_collate_fn(rows, jmock.Phi4MMProcessor(**PROC),
                                      max_length=4)
    msgs = [r.getMessage() for r in caplog.records
            if "assistant answer not found" in r.getMessage()]
    assert len(msgs) == 4            # two rows, each package
    assert msgs[0] == msgs[2]
    _equal(got, want)
    assert (got["labels"] == -100).all()


def test_stack_microbatches_pads_audio_frames_as_jax():
    rows = tmock.make_mock_audio_dataset(num_samples=6, seed=1)
    proc = tmock.Phi4MMProcessor(**PROC)
    mbs = [tcf.phi4_mm_collate_fn(rows[i:i + 2], proc,
                                  pad_seq_len_divisible=128)
           for i in range(0, 6, 2)]
    frames = {mb["input_audio_embeds"].shape[1] for mb in mbs}
    assert len(frames) > 1             # the clips' lengths differ
    got = stack_microbatches(mbs)
    _equal(got, jax_stack(mbs))
    assert got["input_audio_embeds"].shape == (3, 2, max(frames), 20)
    assert got["audio_attention_mask"].shape == (3, 2, max(frames))


def _cv_rows(rng, n):
    return [{"sentence": " ".join(rng.choice(["merhaba", "dunya", "evet"],
                                             3)),
             "audio": {"array": rng.normal(size=160).astype(
                 np.float32).tolist(), "sampling_rate": 16000}}
            for _ in range(n)]


def test_commonvoice_builder_over_local_rows(tmp_path, monkeypatch):
    import datasets as hf_datasets

    rows = _cv_rows(np.random.default_rng(2), 5)
    path = tmp_path / "cv.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    monkeypatch.setattr(hf_datasets, "load_dataset",
                        lambda name, split=None, **_: list(rows))
    ours = tds.make_cv17_dataset(str(path), limit_dataset_samples=4)
    theirs = jds.make_cv17_dataset("local", limit_dataset_samples=None)[:4]
    assert len(ours) == 4
    for a, b in zip(ours, theirs):
        assert a["conversation"] == b["conversation"]
        assert a["audio"] == b["audio"]
    with pytest.raises(FileNotFoundError, match="repo id"):
        tds.make_cv17_dataset("ysdede/commonvoice_17_tr_fixed")


def test_commonvoice_rows_raise_in_both_collators(tmp_path):
    rows = _cv_rows(np.random.default_rng(3), 2)
    path = tmp_path / "cv.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    examples = tds.make_cv17_dataset(str(path))
    with pytest.raises(AttributeError, match="split") as ours:
        tcf.phi4_mm_collate_fn(examples, tmock.Phi4MMProcessor(**PROC))
    with pytest.raises(AttributeError, match="split") as theirs:
        jcf.phi4_mm_collate_fn(examples, jmock.Phi4MMProcessor(**PROC))
    assert str(ours.value) == str(theirs.value)
