"""The port's zig-zag cp layout (``automodel_tpu_torch/ops/zigzag.py``)
against the JAX package's (``automodel_tpu/ops/zigzag.py``): indices,
inverse, permutation of arrays and of stacked batch dicts equal bit for
bit for cp 1-4 (odd and even lengths where they divide), and the same
errors where they do not.  Exact: integer arithmetic on both sides."""

import numpy as np
import pytest
import torch

from automodel_tpu.ops import zigzag as jz
from automodel_tpu_torch.ops import zigzag as tz

CPS = (1, 2, 3, 4)


@pytest.mark.parametrize("cp", CPS)
@pytest.mark.parametrize("seq_len", [24, 48, 30, 7, 9])
def test_indices_and_inverse_equal_jax(cp, seq_len):
    if seq_len % (2 * cp):
        for fn in ("zigzag_indices", "zigzag_inverse_indices"):
            with pytest.raises(ValueError) as je:
                getattr(jz, fn)(seq_len, cp)
            with pytest.raises(ValueError) as te:
                getattr(tz, fn)(seq_len, cp)
            assert str(je.value) == str(te.value)
        return
    np.testing.assert_array_equal(tz.zigzag_indices(seq_len, cp),
                                  jz.zigzag_indices(seq_len, cp))
    np.testing.assert_array_equal(tz.zigzag_inverse_indices(seq_len, cp),
                                  jz.zigzag_inverse_indices(seq_len, cp))
    assert tz.zigzag_indices(seq_len, cp).dtype == np.int64


@pytest.mark.parametrize("cp", CPS)
def test_permute_and_unpermute_equal_jax(cp):
    x = np.random.default_rng(cp).integers(0, 1000, (3, 5, 24))
    for axis in (-1, 2):
        want = jz.zigzag_permute(x, cp, axis=axis)
        np.testing.assert_array_equal(tz.zigzag_permute(x, cp, axis=axis),
                                      want)
        np.testing.assert_array_equal(
            tz.zigzag_permute(torch.from_numpy(x), cp, axis=axis).numpy(),
            want)
        np.testing.assert_array_equal(tz.zigzag_unpermute(want, cp,
                                                          axis=axis), x)
    y = np.random.default_rng(9).normal(size=(2, 24, 3))
    np.testing.assert_array_equal(tz.zigzag_permute(y, cp, axis=1),
                                  jz.zigzag_permute(y, cp, axis=1))


def _batch(rng, A, B, S, position_ids):
    b = {"input_ids": rng.integers(0, 100, (A, B, S)).astype(np.int32),
         "labels": rng.integers(-100, 100, (A, B, S)).astype(np.int32),
         "segment_ids": np.sort(rng.integers(0, 4, (A, B, S)), -1).astype(
             np.int32),
         "attention_mask": rng.integers(0, 2, (A, B, S)).astype(np.int32),
         "pixel_values": rng.normal(size=(A, B, 2, S)).astype(np.float32),
         "cls_labels": rng.integers(0, 5, (A, B)).astype(np.int32)}
    if position_ids == "plain":
        b["position_ids"] = np.broadcast_to(
            np.arange(S, dtype=np.int32), (A, B, S)).copy()
    elif position_ids == "mrope":
        b["position_ids"] = rng.integers(0, S, (A, B, S, 3)).astype(np.int32)
    return b


@pytest.mark.parametrize("cp", CPS)
@pytest.mark.parametrize("position_ids", [None, "plain", "mrope"])
@pytest.mark.parametrize("inject", [True, False])
def test_permute_batch_equal_jax(cp, position_ids, inject):
    S = 48
    batch = _batch(np.random.default_rng(cp), 2, 3, S, position_ids)
    want = jz.permute_batch_for_cp(batch, cp, inject_position_ids=inject)
    got = tz.permute_batch_for_cp(batch, cp, inject_position_ids=inject)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


def test_unregistered_sequence_key_raises_as_jax():
    batch = _batch(np.random.default_rng(0), 1, 2, 16, None)
    batch["token_weights"] = np.ones((1, 2, 16), np.float32)
    with pytest.raises(ValueError) as je:
        jz.permute_batch_for_cp(batch, 2)
    with pytest.raises(ValueError) as te:
        tz.permute_batch_for_cp(batch, 2)
    assert str(je.value) == str(te.value)


@pytest.mark.parametrize("layout", [None, "none", "null", "", "zigzag",
                                    "contiguous", "ZIGZAG", "ring"])
@pytest.mark.parametrize("cp", [1, 2, 4])
def test_layout_policy_equal_jax(layout, cp):
    assert tz.normalize_cp_layout(layout) == jz.normalize_cp_layout(layout)
    norm = jz.normalize_cp_layout(layout)
    try:
        want = jz.resolve_cp_layout(norm, cp)
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            tz.resolve_cp_layout(norm, cp)
        assert str(te.value) == str(e)
        return
    assert tz.resolve_cp_layout(norm, cp) == want
    assert tz.CP_LAYOUTS == jz.CP_LAYOUTS
