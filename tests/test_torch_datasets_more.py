"""The port's length-bucketed and iterable loading and its local-file
datasets against the JAX package's, on the same seeds and files.

* ``StatefulDataLoader(length_bucket_pool=...)`` yields the JAX loader's
  batches, batch for batch (every key, exact), over two epochs, and after a
  mid-epoch ``state_dict`` / ``load_state_dict`` resume; it refuses an
  iterable dataset and a dataset without ``input_ids`` with JAX's messages.
* The iterable branch (a ``NanogptDataset``) yields JAX's batches and
  resumes mid-epoch by skipping the consumed samples.
* ``mock_packed`` blocks are JAX's; nanoGPT shards written by either
  package (uint16, uint32, the legacy header) read the same in the other,
  windows, BOS alignment and lengths included; column-mapped samples from
  a local JSONL, with one stub tokenizer (plain and chat-template forms),
  equal JAX's.
"""

import json

import numpy as np
import pytest

from automodel_tpu.datasets.dataloader import StatefulDataLoader as JaxLoader
from automodel_tpu.datasets.llm import mock as jax_mock
from automodel_tpu.datasets.llm import mock_packed as jax_mock_packed
from automodel_tpu.datasets.llm import nanogpt_dataset as jax_nano
from automodel_tpu.datasets.llm.column_mapped_text_instruction_dataset import (
    ColumnMappedTextInstructionDataset as JaxColumnMapped,
)
from automodel_tpu.datasets.utils import default_collater as jax_collater
from automodel_tpu_torch.datasets.dataloader import StatefulDataLoader
from automodel_tpu_torch.datasets.llm import mock, mock_packed
from automodel_tpu_torch.datasets.llm import nanogpt_dataset as nano
from automodel_tpu_torch.datasets.llm.column_mapped_text_instruction_dataset import (  # noqa: E501
    ColumnMappedTextInstructionDataset,
)


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def _unpacked(n=70):
    kw = dict(num_sentences=n, mean_len=40, std_len=25, vocab_size=64,
              max_sentence_len=90, seed=3)
    return jax_mock.build_unpacked_dataset(**kw), \
        mock.build_unpacked_dataset(**kw)


LOADER_CASES = [dict(batch_size=4, length_bucket_pool=16),
                dict(batch_size=4, length_bucket_pool=16, drop_last=False,
                     pad_seq_len_divisible=16),
                dict(batch_size=3, length_bucket_pool=2),
                dict(batch_size=4, length_bucket_pool=16, shuffle=False)]


@pytest.mark.parametrize("kw", LOADER_CASES)
def test_length_bucketed_batches_are_jax_batches(kw):
    jds, pds = _unpacked()
    assert jds == pds
    jl = JaxLoader(jds, seed=9, collate_fn=jax_collater, **kw)
    pl = StatefulDataLoader(pds, seed=9, **kw)
    for epoch in range(2):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jb, pb = list(jl), list(pl)
        assert len(jb) == len(pb) > 0
        for a, b in zip(jb, pb):
            _same(a, b)
        assert jl.state_dict() == pl.state_dict()
    # batches of like lengths: less padding than the unbucketed order
    plain = StatefulDataLoader(pds, seed=9, batch_size=kw["batch_size"])
    if kw["length_bucket_pool"] > kw["batch_size"]:
        assert (sum(b["input_ids"].size for b in pb)
                < sum(b["input_ids"].size for b in plain))


@pytest.mark.parametrize("kw", LOADER_CASES[:2])
def test_length_bucketed_resume_mid_epoch(kw):
    jds, pds = _unpacked()
    jl = JaxLoader(jds, seed=4, collate_fn=jax_collater, **kw)
    pl = StatefulDataLoader(pds, seed=4, **kw)
    it = iter(pl)
    for _ in range(5):
        next(it)
    sd = pl.state_dict()
    resumed = StatefulDataLoader(pds, seed=0, **kw)
    resumed.load_state_dict(sd)
    rest = list(resumed)
    want = list(jl)[5:]
    assert len(rest) == len(want) > 0
    for a, b in zip(want, rest):
        _same(a, b)
    resumed.set_epoch(1)
    jl.set_epoch(1)
    for a, b in zip(list(jl), list(resumed)):
        _same(a, b)


def test_length_bucketing_refusals_match_jax(tmp_path):
    path = _shards(tmp_path, np.arange(3000) % 500)[0]
    for cls in (JaxLoader, StatefulDataLoader):
        with pytest.raises(ValueError, match="needs a map-style dataset"):
            cls(nano.NanogptDataset(path, seq_len=16), batch_size=2,
                length_bucket_pool=8)
    rows = [{"labels": [1, 2, 3]}] * 8
    msgs = []
    for cls in (JaxLoader, StatefulDataLoader):
        with pytest.raises(ValueError) as e:
            list(cls(rows, batch_size=2, length_bucket_pool=4))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "no sample exposes 'input_ids'" in msgs[0]


def test_mock_packed_blocks_are_jax_blocks():
    kw = dict(num_blocks=12, block_size=64, mean_len=20, std_len=6,
              vocab_size=100, max_sentence_len=40, seed=7)
    assert (mock_packed.build_packed_dataset(**kw)
            == jax_mock_packed.build_packed_dataset(**kw))


def _shards(tmp_path, *token_lists, writer=nano.write_shard):
    paths = []
    for i, toks in enumerate(token_lists):
        p = str(tmp_path / f"shard_{i:03d}.bin")
        writer(p, np.asarray(toks))
        paths.append(p)
    return paths


@pytest.mark.parametrize("high", [500, 70000], ids=["uint16", "uint32"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_nanogpt_shards_cross_packages(tmp_path, writer, high):
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, high, n) for n in (1000, 777)]
    write = nano.write_shard if writer == "port" else jax_nano.write_shard
    paths = _shards(tmp_path, *toks, writer=write)
    for p, t in zip(paths, toks):
        np.testing.assert_array_equal(nano.load_shard(p), t)
        np.testing.assert_array_equal(jax_nano.load_shard(p), t)
        assert nano.load_shard(p).dtype == jax_nano.load_shard(p).dtype
    pattern = str(tmp_path / "shard_*.bin")
    for kw in (dict(seq_len=32), dict(seq_len=32, rank=1, world_size=3),
               dict(seq_len=16, shuffle_files=True)):
        ours = list(nano.NanogptDataset(pattern, **kw))
        theirs = list(jax_nano.NanogptDataset(pattern, **kw))
        assert len(ours) == len(theirs) == len(
            nano.NanogptDataset(pattern, **kw)) > 0
        for a, b in zip(ours, theirs):
            _same(a, b)


def test_nanogpt_bos_alignment_and_legacy_header(tmp_path):
    rng = np.random.default_rng(1)
    toks = rng.integers(2, 300, 2000)
    toks[rng.choice(2000, 40, replace=False)] = 1         # BOS
    legacy = str(tmp_path / "legacy.bin")
    header = np.zeros(nano.HEADER_SIZE, np.int32)
    header[:3] = (nano.LEGACY_MAGIC, nano.VERSION, len(toks))
    with open(legacy, "wb") as f:
        f.write(header.tobytes() + toks.astype(np.uint16).tobytes())
    for kw in (dict(seq_len=24, align_to_bos=True, bos_token=1),
               dict(seq_len=24)):
        ours = nano.NanogptDataset(legacy, **kw)
        theirs = jax_nano.NanogptDataset(legacy, **kw)
        a, b = list(ours), list(theirs)
        assert len(a) == len(b) == len(ours) == len(theirs) > 0
        for x, y in zip(a, b):
            _same(x, y)


def test_iterable_loader_batches_and_resume_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    _shards(tmp_path, rng.integers(0, 500, 900), rng.integers(0, 500, 640))
    pattern = str(tmp_path / "shard_*.bin")
    kw = dict(batch_size=3, drop_last=False)
    jl = JaxLoader(jax_nano.NanogptDataset(pattern, seq_len=20),
                   collate_fn=jax_collater, **kw)
    pl = StatefulDataLoader(nano.NanogptDataset(pattern, seq_len=20), **kw)
    with pytest.raises(TypeError):
        len(pl)
    want = list(jl)
    got = list(pl)
    assert len(got) == len(want) > 4
    for a, b in zip(want, got):
        _same(a, b)
    assert pl.state_dict() == jl.state_dict()      # the epoch rolled
    pl = StatefulDataLoader(nano.NanogptDataset(pattern, seq_len=20), **kw)
    it = iter(pl)
    for _ in range(3):
        next(it)
    resumed = StatefulDataLoader(nano.NanogptDataset(pattern, seq_len=20),
                                 **kw)
    resumed.load_state_dict(pl.state_dict())
    for a, b in zip(want[3:], list(resumed)):
        _same(a, b)


class StubTokenizer:
    """Word-level ids from a growing vocabulary, eos 2; with
    ``chat=True`` a chat template ``<s> user ... <turn> assistant ...``."""

    eos_token_id = 2

    def __init__(self, chat=False):
        self.vocab = {"<pad>": 0, "<s>": 1, "<eos>": 2, "<turn>": 3}
        self.chat_template = "stub" if chat else None

    def _ids(self, text):
        return [self.vocab.setdefault(w, len(self.vocab))
                for w in text.split()]

    def __call__(self, text, add_special_tokens=True):
        ids = self._ids(text)
        return {"input_ids": ([1] + ids) if add_special_tokens else ids}

    def apply_chat_template(self, messages):
        ids = [1]
        for m in messages:
            ids += [3] + self._ids(m["role"] + " " + m["content"])
        return ids + [2]


def _jsonl(tmp_path):
    rows = [{"doc": f"context number {i}", "q": f"what is {i} plus {i}",
             "a": f" {2 * i} is the answer "} for i in range(7)]
    path = tmp_path / "rows.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return str(path)


@pytest.mark.parametrize("chat", [False, True])
@pytest.mark.parametrize("answer_only", [True, False])
def test_column_mapped_samples_match_jax(tmp_path, chat, answer_only):
    path = _jsonl(tmp_path)
    kw = dict(column_mapping={"context": "doc", "question": "q",
                              "answer": "a"},
              answer_only_loss_mask=answer_only, limit_dataset_samples=5,
              start_of_turn_token="<turn>" if chat else None)
    ours = ColumnMappedTextInstructionDataset(path, tokenizer=StubTokenizer(
        chat), **kw)
    theirs = JaxColumnMapped(path, tokenizer=StubTokenizer(chat), **kw)
    assert len(ours) == len(theirs) == 5
    for i in range(5):
        assert ours[i] == theirs[i]
    assert list(ours) == list(theirs)
    if answer_only:
        assert ours[0]["labels"][0] == -100


def test_column_mapped_refuses_a_hub_id():
    with pytest.raises(NotImplementedError, match="datasets package"):
        ColumnMappedTextInstructionDataset(
            "some-org/some-dataset", {"question": "q", "answer": "a"},
            tokenizer=StubTokenizer())
