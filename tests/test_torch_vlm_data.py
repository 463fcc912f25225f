"""The port's VLM data path (``datasets/vlm/``) and freeze masks against the
JAX package on the CPU.

* ``default_collate_fn`` through ``MockVLMProcessor`` on the mock
  conversations (one image a row, and rows of 0-2 images), plain, with
  ``pad_seq_len_divisible``, ``fixed_length`` and
  ``max_images_per_example``: every output (ids, labels, loss mask,
  pixel slots) equal to JAX's; ``extract_skipped_token_ids`` equal.
* ``json2token`` on nested CORD-style ground truth: equal strings.
* ``make_cord_v2_dataset`` / ``make_rdr_dataset`` / ``make_medpix_dataset``
  over local jsonl rows whose ``image`` names a local ``.npy``: the
  conversations and images the JAX makers make from the same rows
  (served in process to its ``load_dataset``); a repo id raises
  ``FileNotFoundError``.
* The freeze masks of the Gemma-3 VL and llava families under the YAMLs'
  ``freeze_config`` forms: leaf for leaf the JAX mask over the JAX tree,
  and the trainable element counts equal.
"""

import json

import jax
import numpy as np
import pytest
import torch

from automodel_tpu.datasets.vlm import collate_fns as jcollate
from automodel_tpu.datasets.vlm import datasets as jdatasets
from automodel_tpu.datasets.vlm import mock as jmock
from automodel_tpu.datasets.vlm import utils as jutils
from automodel_tpu.models.auto_model import AutoModelForCausalLM as JaxAuto
from automodel_tpu.utils.model_utils import (
    apply_parameter_freezing as jax_freezing,
)
from automodel_tpu_torch.datasets.vlm import collate_fns, datasets, mock, utils
from automodel_tpu_torch.models.auto_model import build_model
from automodel_tpu_torch.utils.model_utils import apply_parameter_freezing

torch.set_num_threads(1)


def _multi_image_rows(n, seed):
    """Conversations of 0, 1 or 2 images (as the ``image`` entries of the
    content, not a top-level list)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        k = i % 3
        content = [{"type": "image",
                    "image": rng.integers(0, 256, (20, 24, 3)).astype(
                        np.uint8)} for _ in range(k)]
        content.append({"type": "text", "text": "what is here"})
        rows.append({"conversation": [
            {"role": "user", "content": content},
            {"role": "assistant", "content": [
                {"type": "text", "text": " ".join(
                    rng.choice(["a", "b", "cat", "dog"], 3 + i))}]}]})
    return rows


PROC = dict(vocab_size=512, image_size=32, patch_size=16, image_token_id=7)
COLLATE_CASES = {
    "plain": dict(),
    "divisible_128": dict(pad_seq_len_divisible=128),
    "fixed_64": dict(fixed_length=64),
    "slots_3": dict(max_images_per_example=3),
}


@pytest.mark.parametrize("rows", ["mock", "multi_image"])
@pytest.mark.parametrize("case", sorted(COLLATE_CASES))
def test_default_collate_matches_jax(rows, case):
    examples = (mock.make_mock_vlm_dataset(6, image_size=32, seed=4)
                if rows == "mock" else _multi_image_rows(6, 4))
    kw = dict(COLLATE_CASES[case], start_of_response_token="<assistant>")
    got = collate_fns.default_collate_fn(
        examples, mock.MockVLMProcessor(**PROC), **kw)
    want = jcollate.default_collate_fn(
        examples, jmock.MockVLMProcessor(**PROC), **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["pixel_values"].ndim == 5
    assert (got["labels"] != -100).any()


def test_skipped_token_ids_match_jax():
    assert (utils.extract_skipped_token_ids(mock.MockVLMProcessor(**PROC))
            == jutils.extract_skipped_token_ids(
                jmock.MockVLMProcessor(**PROC)))


GT = {"gt_parse": {"menu": [
    {"nm": "ICE TEA", "cnt": "2", "price": "12,000"},
    {"nm": "NASI GORENG", "cnt": "1", "price": "25,000",
     "sub": [{"nm": "EGG"}]}],
    "total": {"total_price": "49,000", "cashprice": "50,000"},
    "text_sequence_only": {"text_sequence": "thank you"}}}


@pytest.mark.parametrize("sort_keys", [True, False])
def test_json2token_matches_jax(sort_keys):
    for obj in (GT, GT["gt_parse"], [1, "two", {"k": None}],
                {"text_sequence": "x"}):
        assert (utils.json2token(obj, sort_keys)
                == jutils.json2token(obj, sort_keys))


MAKERS = {
    "make_cord_v2_dataset": lambda i: {"ground_truth": json.dumps(
        {"gt_parse": {"menu": [{"nm": f"item{i}", "cnt": str(i)}],
                      "total": {"total_price": str(100 * i)}}})},
    "make_rdr_dataset": lambda i: {"text": f"a photo {i}"},
    "make_medpix_dataset": lambda i: {"question": f"q{i}?",
                                      "answer": f"a{i}"},
}


@pytest.mark.parametrize("maker", sorted(MAKERS))
def test_dataset_makers_match_jax_over_local_rows(maker, tmp_path,
                                                  monkeypatch):
    import datasets as hf_datasets

    rng = np.random.default_rng(8)
    rows, jrows = [], []
    for i in range(5):
        img = rng.integers(0, 256, (12, 10, 3)).astype(np.uint8)
        path = str(tmp_path / f"img{i}.npy")
        np.save(path, img)
        rows.append(dict(MAKERS[maker](i), image=path))
        jrows.append(dict(MAKERS[maker](i), image=img))
    jsonl = tmp_path / "train.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in rows))
    monkeypatch.setattr(hf_datasets, "load_dataset",
                        lambda name, split=None, **_: list(jrows))
    got = getattr(datasets, maker)(str(jsonl), limit_dataset_samples=4)
    want = getattr(jdatasets, maker)("any/repo")[:4]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g["conversation"] == w["conversation"]
        for a, b in zip(g["images"], w["images"]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError, match="repo id"):
        getattr(datasets, maker)()


VLM_CONFIGS = {
    "gemma3": dict(
        model_type="gemma3", image_token_index=7, mm_tokens_per_image=4,
        text_config=dict(model_type="gemma3_text", vocab_size=64,
                         hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=2,
                         num_key_value_heads=1, head_dim=16),
        vision_config=dict(hidden_size=16, intermediate_size=32,
                           num_hidden_layers=2, num_attention_heads=2,
                           image_size=16, patch_size=4)),
    "llava": dict(
        model_type="llava", image_token_id=7,
        text_config=dict(model_type="llama", vocab_size=64, hidden_size=32,
                         intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=2, num_key_value_heads=1),
        vision_config=dict(hidden_size=16, intermediate_size=32,
                           num_hidden_layers=2, num_attention_heads=2,
                           image_size=16, patch_size=4)),
}
FREEZE = {
    "embeddings": {"freeze_embeddings": True},
    "cord_v2": {"freeze_embeddings": True, "freeze_vision_tower": True},
    "tiny_mock": {"freeze_embeddings": False, "freeze_vision_tower": True,
                  "freeze_language_model": False},
    "patterns": {"freeze_patterns": [r".*multi_modal_projector.*"]},
}


@pytest.mark.parametrize("freeze", sorted(FREEZE))
@pytest.mark.parametrize("family", sorted(VLM_CONFIGS))
def test_freeze_masks_match_jax(family, freeze):
    cfg = VLM_CONFIGS[family]
    jm = JaxAuto.from_config(dict(cfg))
    abstract = jm.abstract_params()
    jmask = {".".join(k.key for k in path): bool(v) for path, v in
             jax.tree_util.tree_flatten_with_path(
                 jax_freezing(abstract, FREEZE[freeze]))[0]}
    sizes = {".".join(k.key for k in path): int(np.prod(v.shape))
             for path, v in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    model = build_model(config=dict(cfg), device="cpu")
    mask = apply_parameter_freezing(model, FREEZE[freeze])
    assert mask == jmask
    trainable = sum(p.numel() for p in model.parameters()
                    if p.requires_grad)
    assert trainable == sum(n for k, n in sizes.items() if jmask[k])
    assert sum(p.numel() for p in model.parameters()) == sum(sizes.values())
