"""The port's SFT data path (mock dataset, packer, collater, dataloader)
against the JAX package's: the same seeds give array-equal samples, packs
and batches, for the dataset blocks of ``tiny_llama_mock.yaml`` and of the
Llama-3.2-1B bench YAML (``num_sentences`` cut to 32)."""

import numpy as np
import pytest

from automodel_tpu.datasets import dataloader as jdl
from automodel_tpu.datasets import utils as jutils
from automodel_tpu.datasets.llm import mock as jmock
from automodel_tpu.datasets.llm import packed_sequence as jpack
from automodel_tpu_torch.datasets import dataloader as tdl
from automodel_tpu_torch.datasets import utils as tutils
from automodel_tpu_torch.datasets.llm import mock as tmock
from automodel_tpu_torch.datasets.llm import packed_sequence as tpack

TINY = dict(num_sentences=256, vocab_size=128, mean_len=24, seed=5)
TINY_VAL = dict(num_sentences=16, vocab_size=128, mean_len=24, seed=7)
BENCH = dict(num_sentences=32, vocab_size=8192, mean_len=1024, std_len=256,
             max_sentence_len=2047, seed=5)
BLOCKS = {"tiny": (TINY, 64), "tiny_val": (TINY_VAL, 64),
          "bench": (BENCH, 2048)}


@pytest.mark.parametrize("block", list(BLOCKS))
def test_mock_samples_equal(block):
    kw, _ = BLOCKS[block]
    assert tmock.build_unpacked_dataset(**kw) == \
        jmock.build_unpacked_dataset(**kw)


def _packs(mod_mock, mod_pack, kw, size):
    ds = mod_mock.build_unpacked_dataset(**kw)
    return mod_pack.PackedSequence(ds, packed_sequence_size=size).pack()


def _assert_items_equal(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                      err_msg=key)


@pytest.mark.parametrize("block", list(BLOCKS))
def test_packs_equal(block):
    kw, size = BLOCKS[block]
    t = _packs(tmock, tpack, kw, size)
    j = _packs(jmock, jpack, kw, size)
    assert len(t) == len(j) > 0
    for i in range(len(t)):
        _assert_items_equal(t[i], j[i])
        assert t[i]["input_ids"].shape == (size,)


@pytest.mark.parametrize("block,batch,pad", [
    ("tiny", 1, None), ("tiny_val", 1, 128), ("bench", 8, None)])
def test_dataloader_batches_equal(block, batch, pad):
    """Two epochs of shuffled, collated batches (seed 1111, the YAMLs'
    rng seed); ``pad`` is the 128 rounding the recipe gives validation."""
    kw, size = BLOCKS[block]
    t = tdl.StatefulDataLoader(_packs(tmock, tpack, kw, size), batch,
                               collate_fn=tutils.default_collater, seed=1111,
                               pad_seq_len_divisible=pad)
    j = jdl.StatefulDataLoader(_packs(jmock, jpack, kw, size), batch,
                               collate_fn=jutils.default_collater, seed=1111,
                               pad_seq_len_divisible=pad)
    assert len(t) == len(j)
    for epoch in range(2):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        tb, jb = list(t), list(j)
        assert len(tb) == len(jb) == len(j)
        for a, b in zip(tb, jb):
            _assert_items_equal(a, b)
            assert a["input_ids"].dtype == np.int32


def test_collater_pads_by_key():
    rows = [{"input_ids": [5, 6, 7], "labels": [5, 6, 7],
             "segment_ids": [1, 1, 1]},
            {"input_ids": [8], "labels": [8], "segment_ids": [1]}]
    for div in (None, 4):
        a = tutils.default_collater([dict(r) for r in rows], div)
        b = jutils.default_collater([dict(r) for r in rows], div)
        _assert_items_equal(a, b)
    assert a["labels"].tolist()[1][1:] == [-100] * 3


def test_dataloader_resumes_mid_epoch_like_jax():
    """A loop that stops after 3 batches and iterates again continues at
    the 4th (to the end of the epoch), then the next epoch runs whole, as
    with the JAX loader."""
    kw, size = BLOCKS["tiny_val"]
    loaders = [mod.StatefulDataLoader(_packs(mm, mp, kw, size), 1, seed=3,
                                      collate_fn=cu.default_collater)
               for mod, mm, mp, cu in ((tdl, tmock, tpack, tutils),
                                       (jdl, jmock, jpack, jutils))]
    seen = []
    for loader in loaders:
        first = [b for _, b in zip(range(3), loader)]
        rest = list(loader) + list(loader)
        seen.append(first + rest)
        assert loader.epoch == 2
    assert len(seen[0]) == len(seen[1]) == 2 * len(loaders[0])
    for a, b in zip(*seen):
        _assert_items_equal(a, b)
