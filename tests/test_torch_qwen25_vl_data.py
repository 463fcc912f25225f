"""Qwen2.5-VL's host data path in the port against the JAX package, and the
train step's batch keys.

* ``training/train_step.py::stack_microbatches`` against the JAX function,
  bit for bit: microbatches with different image counts (flat patch rows
  ``[n_patches, patch_dim]``, image and video), grid rows, M-RoPE ids
  ``[B, S, 3]`` of different ``S`` (padded with 1 along ``S``), per-row
  image slots, and microbatches of one shape (the fast path: stacked as
  they are).
* The step's batch keys: a model's ``extra_batch_keys`` are consumed, a
  key outside them raises "not consumed", as in JAX.
* ``qwen_mrope_position_ids`` bit-equal to JAX's on image rows, video
  rows with ``second_per_grid_ts`` (fractional intervals truncate), image
  rows beside text-only rows, left- and right-padded rows, and rows
  without any grid.
* The mock ``Qwen2_5_VLProcessor``, ``make_mock_video_dataset`` and
  ``qwen2_5_collate_fn`` against JAX's, key by key and bit for bit, with
  ``resize_images_to``, ``pad_seq_len_divisible`` and ``fixed_length``;
  a truncated vision span raises the same ``ValueError``; ``COLLATE_FNS``
  dispatches the processor's class name to it.
"""

import re

import numpy as np
import pytest
import torch

from automodel_tpu.datasets.vlm import collate_fns as jcollate
from automodel_tpu.datasets.vlm import mock as jmock
from automodel_tpu.datasets.vlm.qwen_rope import (
    qwen_mrope_position_ids as jax_ids,
)
from automodel_tpu.training.train_step import (
    stack_microbatches as jax_stack,
)
from automodel_tpu_torch.datasets.vlm import collate_fns, mock
from automodel_tpu_torch.datasets.vlm.qwen_rope import qwen_mrope_position_ids
from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
from automodel_tpu_torch.training.train_step import (
    microbatch_loss,
    stack_microbatches,
    to_device_batch,
)

IDS = dict(image_token_id=6, video_token_id=12, vision_start_token_id=5)


def _microbatch(rng, n_images, S, B=2, pdim=24, video=0):
    mb = {"input_ids": rng.integers(13, 90, (B, S)).astype(np.int32),
          "labels": rng.integers(13, 90, (B, S)).astype(np.int32),
          "loss_mask": np.ones((B, S), np.float32),
          "position_ids": rng.integers(0, S, (B, S, 3)).astype(np.int32),
          "pixel_values": rng.normal(size=(16 * n_images, pdim)).astype(
              np.float32),
          "image_grid_thw": np.asarray([[1, 4, 4]] * n_images, np.int32)}
    if video:
        mb["pixel_values_videos"] = rng.normal(
            size=(32 * video, pdim)).astype(np.float32)
        mb["video_grid_thw"] = np.asarray([[2, 4, 4]] * video, np.int32)
    return mb


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("layout", ["flat", "flat_video", "mrope_s",
                                    "slots", "one_shape"])
def test_stack_microbatches_matches_jax(layout):
    rng = np.random.default_rng(3)
    if layout == "flat":
        mbs = [_microbatch(rng, n, 24) for n in (1, 3, 2)]
    elif layout == "flat_video":
        mbs = [_microbatch(rng, 1, 24, video=v) for v in (2, 1)]
    elif layout == "mrope_s":
        mbs = [_microbatch(rng, 2, s) for s in (24, 40)]
    elif layout == "slots":
        mbs = [{"input_ids": rng.integers(0, 9, (2, s)).astype(np.int32),
                "pixel_values": rng.normal(size=(2, n, 4, 4, 3)).astype(
                    np.float32)} for n, s in ((1, 8), (2, 12))]
    else:
        mbs = [_microbatch(rng, 2, 24) for _ in range(3)]
    got, want = stack_microbatches(mbs), jax_stack(mbs)
    _equal(got, want)
    if layout == "mrope_s":
        assert got["position_ids"].shape == (2, 2, 40, 3)
        assert (got["position_ids"][0, :, 24:] == 1).all()
        assert (got["labels"][0, :, 24:] == -100).all()
    if layout == "flat":
        assert got["pixel_values"].shape == (3, 48, 24)
        assert not got["pixel_values"][0, 16:].any()
        assert not got["image_grid_thw"][0, 1:].any()
    if layout == "one_shape":
        for k in mbs[0]:
            np.testing.assert_array_equal(got[k], np.stack(
                [mb[k] for mb in mbs]))
    dev = to_device_batch(mbs, "cpu")
    if "pixel_values" in dev:
        assert dev["pixel_values"].dtype == torch.float32
    if "position_ids" in dev:
        assert dev["position_ids"].dtype == torch.int32


def test_step_consumes_extra_batch_keys_and_refuses_others():
    class Model(torch.nn.Module):
        extra_batch_keys = ("image_grid_thw",)

        def __init__(self):
            super().__init__()
            self.seen = None

        def forward(self, input_ids, attn_impl=None, **kw):
            self.seen = sorted(kw)
            return {"logits": torch.zeros(*input_ids.shape, 8,
                                          requires_grad=True)}

    model = Model()
    mb = {"input_ids": torch.zeros(1, 4, dtype=torch.long),
          "labels": torch.zeros(1, 4, dtype=torch.long),
          "image_grid_thw": torch.ones(1, 3, dtype=torch.int32)}
    microbatch_loss(model, MaskedCrossEntropy(), mb)
    assert model.seen == ["image_grid_thw"]
    mb["video_grid_thw"] = torch.ones(1, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="not consumed"):
        microbatch_loss(model, MaskedCrossEntropy(), mb)
    del Model.extra_batch_keys
    del mb["video_grid_thw"]
    with pytest.raises(ValueError, match="extra_batch_keys"):
        microbatch_loss(model, MaskedCrossEntropy(), mb)


def _span(kind, units):
    return [5] + [6 if kind == "image" else 12] * units + [7]


def _rope_case(case):
    """``(input_ids, image grids, attention_mask, video grids,
    second_per_grid_ts)`` for a position-id case."""
    rng = np.random.default_rng(11)
    S = 48

    def text(n):
        return list(rng.integers(13, 90, n))

    rows, masks, grids, vgrids, spg = [], [], [], [], []
    if case == "image":
        rows = [text(3) + _span("image", 4) + text(5) + _span("image", 4),
                text(2) + _span("image", 9) + text(10)]
        grids = [[1, 4, 4], [1, 4, 4], [1, 6, 6]]
    elif case == "video":
        rows = [text(4) + _span("video", 8) + text(6),
                _span("video", 18) + text(3)]
        vgrids, spg = [[2, 4, 4], [2, 6, 6]], [0.5, 2.0]
    elif case == "image_and_text_only":
        rows = [text(20), text(3) + _span("image", 4) + text(9), text(7)]
        grids = [[1, 4, 4]]
    elif case in ("right_padded", "left_padded"):
        rows = [text(5) + _span("image", 4) + text(4),
                text(2) + _span("image", 4) + text(20)]
        grids = [[1, 4, 4], [1, 4, 4]]
    elif case == "no_grid":
        rows = [text(9), text(30)]
    out = np.zeros((len(rows), S), np.int32)
    mask = np.zeros((len(rows), S), np.int32)
    for b, r in enumerate(rows):
        if case == "left_padded":
            out[b, S - len(r):], mask[b, S - len(r):] = r, 1
        else:
            out[b, :len(r)], mask[b, :len(r)] = r, 1
    with_mask = case in ("right_padded", "left_padded", "no_grid",
                         "image_and_text_only")
    return (out, np.asarray(grids, np.int32) if grids else None,
            mask if with_mask else None,
            np.asarray(vgrids, np.int32) if vgrids else None,
            np.asarray(spg) if spg else None)


@pytest.mark.parametrize("case", ["image", "video", "image_and_text_only",
                                  "right_padded", "left_padded", "no_grid"])
def test_mrope_position_ids_match_jax(case):
    ids, grids, mask, vgrids, spg = _rope_case(case)
    kw = dict(video_grid_thw=vgrids, second_per_grid_ts=spg,
              tokens_per_second=2, spatial_merge_size=2, **IDS)
    got = qwen_mrope_position_ids(ids, grids, mask, **kw)
    want = jax_ids(ids, grids, mask, **kw)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if case == "video":      # 0.5 s a grid truncates to 0: one t position
        assert (got[0, 5:13, 0] == got[0, 5, 0]).all()
    if mask is not None:
        assert (got[mask == 0] == 1).all()


COLLATE_CASES = {
    "image": dict(proc=dict(grid=[1, 4, 4]), data="image", kw={}),
    "image_resize_pad": dict(proc=dict(grid=[1, 6, 6], patch_size=4),
                             data="image",
                             kw=dict(resize_images_to=24,
                                     pad_seq_len_divisible=16)),
    "video": dict(proc=dict(video_grid=[2, 4, 4], second_per_grid_t=0.5),
                  data="video", kw=dict(pad_seq_len_divisible=32)),
    "fixed_length": dict(proc=dict(grid=[1, 4, 4]), data="image",
                         kw=dict(fixed_length=64, tokens_per_second=4)),
}


def _examples(kind, n=3):
    if kind == "video":
        return mock.make_mock_video_dataset(num_samples=n, image_size=16,
                                            num_frames=4, seed=3)
    ex = mock.make_mock_vlm_dataset(num_samples=n, image_size=16, seed=3)
    # images of several aspects, as RDR's rows are
    rng = np.random.default_rng(4)
    for i, e in enumerate(ex):
        e["images"] = [rng.integers(0, 256, (12 + 5 * i, 30 - 4 * i, 3))
                       .astype(np.uint8)]
    return ex


@pytest.mark.parametrize("case", sorted(COLLATE_CASES))
def test_collate_matches_jax(case):
    spec = COLLATE_CASES[case]
    proc = mock.Qwen2_5_VLProcessor(vocab_size=128, **spec["proc"])
    jproc = jmock.Qwen2_5_VLProcessor(vocab_size=128, **spec["proc"])
    ex = _examples(spec["data"])
    if spec["data"] == "video":
        want_ex = jmock.make_mock_video_dataset(num_samples=3, image_size=16,
                                                num_frames=4, seed=3)
        for a, b in zip(ex, want_ex):
            assert a["conversation"] == b["conversation"]
            np.testing.assert_array_equal(a["videos"][0], b["videos"][0])
    marker = "<|im_start|> assistant"
    got = collate_fns.qwen2_5_collate_fn(ex, proc, marker, **spec["kw"])
    want = jcollate.qwen2_5_collate_fn(ex, jproc, marker, **spec["kw"])
    _equal(got, want)
    assert got["position_ids"].shape == got["input_ids"].shape + (3,)
    if "pad_seq_len_divisible" in spec["kw"]:
        assert got["input_ids"].shape[1] % spec["kw"][
            "pad_seq_len_divisible"] == 0
    assert collate_fns.COLLATE_FNS[type(proc).__name__] is \
        collate_fns.qwen2_5_collate_fn


def test_truncated_vision_span_raises_as_jax():
    proc = mock.Qwen2_5_VLProcessor(vocab_size=128, grid=[1, 8, 8])
    jproc = jmock.Qwen2_5_VLProcessor(vocab_size=128, grid=[1, 8, 8])
    ex = _examples("image", 2)
    with pytest.raises(ValueError, match="truncated") as port_err:
        collate_fns.qwen2_5_collate_fn(ex, proc, fixed_length=12)
    with pytest.raises(ValueError, match="truncated") as jax_err:
        jcollate.qwen2_5_collate_fn(ex, jproc, fixed_length=12)
    facts = re.compile(r"batch carries \d+ image placeholder tokens but "
                       r"image_grid_thw implies \d+")
    assert (facts.search(str(port_err.value)).group()
            == facts.search(str(jax_err.value)).group())
