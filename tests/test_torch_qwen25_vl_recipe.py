"""The three Qwen2.5-VL YAMLs through the port's VLM recipe against the JAX
recipe on the CPU.

* ``examples/vlm_finetune/tiny_qwen25_vl_mock.yaml`` (6 steps) and
  ``tiny_qwen25_vl_video_mock.yaml`` (4 steps) as written, and
  ``qwen2_5_vl_3b_rdr.yaml`` as written but for a tiny model: its repo id
  resolves to a local directory (tiny widths, the published 3B's layout:
  nested text config, tied head, grid ``[1, 8, 8]``, window 32 at patch 4
  so the grid has one window and a pad-free full block), the processor
  section replaced by the mock processor at that grid, local jsonl rows in
  RDR's schema, 2 steps of 8 rows.  Each runs from the JAX recipe's initial params with the same
  seeded data, fp32 (``compute_dtype``, ``grad_dtype`` and, for the RDR
  YAML, ``mu_dtype``), the input pipeline synchronous in both: the steps,
  label counts and learning rates equal, loss and grad_norm within 1e-4
  relative (measured: about 1e-6; fp32 sums in another order).
* A batch whose ``image_grid_thw`` rows disagree with the model's grid is
  refused on the host with the JAX recipe's cause; rows of zeros (the
  stacking pads) pass.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from automodel_tpu.config.arg_parser import (
    parse_args_and_load_config as jax_config,
)
from automodel_tpu.recipes.vlm.finetune import FinetuneRecipeForVLM as JaxVLM
from automodel_tpu_torch.config.loader import parse_args_and_load_config
from automodel_tpu_torch.models.weights import load_jax_recipe_params
from automodel_tpu_torch.recipes.vlm import finetune

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VLM_YAMLS = os.path.join(REPO, "examples", "vlm_finetune")
REL = 1e-4
FP32 = ["--model.compute_dtype", "float32",
        "--training.grad_dtype", "float32",
        "--dataloader.prefetch_depth", "0"]
RDR_REPO = "Qwen/Qwen2.5-VL-3B-Instruct"
# the published 3B's layout at tiny widths
RDR_TINY_CONFIG = dict(
    architectures=["Qwen2_5_VLForConditionalGeneration"],
    model_type="qwen2_5_vl", image_token_id=6, video_token_id=12,
    vision_start_token_id=5, tie_word_embeddings=True,
    text_config=dict(
        model_type="qwen2_5_vl_text", vocab_size=256, hidden_size=64,
        intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, rope_theta=1000000.0, rms_norm_eps=1e-6,
        rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]}),
    vision_config=dict(
        depth=2, hidden_size=32, intermediate_size=64, num_heads=2,
        in_channels=3, patch_size=4, temporal_patch_size=2,
        spatial_merge_size=2, window_size=32, fullatt_block_indexes=[1],
        out_hidden_size=64, tokens_per_second=2))
# the processor section replaced whole (the YAML's AutoProcessor keys,
# ``min_pixels`` / ``max_pixels``, are the real processor's)
RDR_PROCESSOR = {
    "_target_": "automodel_tpu.datasets.vlm.mock.Qwen2_5_VLProcessor",
    "vocab_size": 256, "grid": [1, 8, 8], "patch_size": 4}
RDR_OVERRIDES = [
    "--model.image_grid", "[1, 8, 8]",
    "--dataloader.collate_fn.resize_images_to", "32",
    "--optimizer.mu_dtype", "float32",
    "--step_scheduler.max_steps", "2",
]


def _one_device_jax_recipe(cfg):
    real = jax.devices
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "devices", lambda *a: real(*a)[:1])
    try:
        return JaxVLM(cfg).setup()
    finally:
        mp.undo()


def _rdr_args(tmp_path, monkeypatch):
    """The RDR YAML's local stand-ins: a snapshot of the tiny model under
    ``HF_HOME`` (weights come from the JAX recipe's params) and 24 rows in
    RDR's schema of images of several aspects (``text``, ``image``): a
    jsonl with ``.npy`` images for the port, the same rows in memory for
    the JAX package's ``load_dataset``."""
    import datasets as hf_datasets

    from automodel_tpu_torch.models import hf_io
    from automodel_tpu_torch.models.auto_model import (
        AutoModelForImageTextToText,
    )

    repo = tmp_path / "hf" / "hub" / ("models--" + RDR_REPO.replace("/",
                                                                    "--"))
    snap = repo / "snapshots" / "tiny"
    model = AutoModelForImageTextToText.from_config(RDR_TINY_CONFIG,
                                                    device="cpu")
    hf_io.save_hf_weights(model, str(snap))
    (snap / "config.json").write_text(json.dumps(RDR_TINY_CONFIG))
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("tiny")
    rng = np.random.default_rng(5)
    rows, jrows = [], []
    for i in range(24):
        path = tmp_path / f"img{i}.npy"
        side = (int(rng.integers(20, 60)), int(rng.integers(20, 60)))
        img = rng.integers(0, 256, side + (3,)).astype(np.uint8)
        np.save(path, img)
        words = " ".join(rng.choice(["red", "shelf", "box", "lamp", "blue"],
                                    int(rng.integers(3, 12))))
        rows.append({"text": words, "image": str(path)})
        jrows.append({"text": words, "image": img})
    data = tmp_path / "rdr.jsonl"
    data.write_text("".join(json.dumps(r) + "\n" for r in rows))
    monkeypatch.setattr(hf_datasets, "load_dataset",
                        lambda name, split=None, **_: list(jrows))
    return str(tmp_path / "hf"), RDR_OVERRIDES + [
        "--dataset.path_or_dataset", str(data)]


CASES = ("tiny_qwen25_vl_mock", "tiny_qwen25_vl_video_mock",
         "qwen2_5_vl_3b_rdr")


@pytest.mark.parametrize("case", CASES)
def test_yaml_runs_through_the_port_as_the_jax_recipe(case, tmp_path,
                                                      monkeypatch):
    over = []
    if case == "qwen2_5_vl_3b_rdr":
        hf_home, over = _rdr_args(tmp_path, monkeypatch)
        monkeypatch.setenv("HF_HOME", hf_home)
    args = ["--config", os.path.join(VLM_YAMLS, case + ".yaml"), *FP32,
            *over]

    def config(load, extra):
        cfg = load(args + extra)
        if case == "qwen2_5_vl_3b_rdr":
            cfg.set_by_dotted("processor", dict(RDR_PROCESSOR))
        return cfg

    jr = _one_device_jax_recipe(config(
        jax_config, ["--checkpoint.checkpoint_dir", str(tmp_path / "jck")]))
    jsteps = []
    finalize = jr._finalize_metrics

    def record(pending):
        out = finalize(pending)
        jsteps.append(out)
        return out

    jr._finalize_metrics = record
    jparams = jax.tree.map(np.asarray, jr.params)
    jr.run_train_validation_loop()

    pr = finetune.FinetuneRecipeForVLM(config(
        parse_args_and_load_config,
        ["--device", "cpu", "--checkpoint.checkpoint_dir",
         str(tmp_path / "pck")])).setup()
    assert type(pr.processor).__name__ == "Qwen2_5_VLProcessor"
    load_jax_recipe_params(pr, jparams)
    assert len(pr.dataloader) == len(jr.dataloader)
    pr.run_train_validation_loop()

    steps = int(pr.cfg.get("step_scheduler.max_steps"))
    assert [m["step"] for m in pr.history] == list(range(1, steps + 1))
    assert [m["step"] for m in jsteps] == [m["step"] for m in pr.history]
    for k in ("num_label_tokens", "lr"):
        assert [m[k] for m in pr.history] == [m[k] for m in jsteps], k
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([m[k] for m in pr.history],
                                   [m[k] for m in jsteps], rtol=REL,
                                   err_msg=k)
    if case == "qwen2_5_vl_3b_rdr":
        # the YAML's freeze_config leaves the tower trainable (its regex
        # misses ``visual``), as in JAX
        model = pr.model
        assert model.visual.patch_embed.weight.requires_grad
        assert not model.language_model.embed_tokens.weight.requires_grad
        assert model.image_grid == (1, 8, 8)


@pytest.mark.parametrize("key,rows,ok", [
    ("image_grid_thw", [[1, 6, 4]], False),
    ("image_grid_thw", [[1, 4, 4], [0, 0, 0]], True),
    ("video_grid_thw", [[1, 4, 4]], False),
])
def test_recipe_rejects_mismatched_grid(key, rows, ok):
    class FakeModel:
        image_grid = (1, 4, 4)
        video_grid = (2, 4, 4)

    r = finetune.FinetuneRecipeForVLM.__new__(finetune.FinetuneRecipeForVLM)
    r.model = FakeModel()
    batch = {"input_ids": np.zeros((1, 8), np.int32),
             key: np.asarray(rows, np.int64)}
    jr = JaxVLM.__new__(JaxVLM)
    jr.model = FakeModel()
    if ok:
        r._check_host_batches([batch])
        return
    with pytest.raises(ValueError, match="static grid") as port_err:
        r._check_host_batches([batch])
    with pytest.raises(ValueError, match="static grid") as jax_err:
        jr._device_batch([batch])
    assert str(rows) in str(port_err.value)
    assert str(rows) in str(jax_err.value)
