"""The three Gemma-3n YAMLs through the port's VLM recipe against the JAX
recipe on the CPU.

* ``examples/vlm_finetune/tiny_gemma3n_mock.yaml`` as written (6 steps of
  8 microbatches; its sparsity pattern ``[0.95, 0, 0]`` runs a sparse and
  two dense gates).
* ``gemma3n_vl_medpix.yaml`` and ``gemma3n_vl_medpix_peft.yaml`` as written
  but for a tiny model: the repo id resolves to a local ``HF_HOME``
  snapshot (tiny widths in the published E4B's layout: nested text and
  vision configs, image token at ``vocab_offset + 1``, one full layer of
  five), the processor section replaced whole by the mock processor
  (the YAMLs name none: the real one comes with the checkpoint), 24 local
  rows in MedPix's schema (``question``, ``answer``, ``image``; the JAX
  side's ``load_dataset`` monkeypatched; the full YAML's validation set
  the same rows), 2 steps of 8 microbatches.  The full fine-tuning YAML
  takes ``--checkpoint.save_consolidated true`` (its Orbax save is ROADMAP
  item 7); the PEFT one saves adapters as written.

Each runs from the JAX recipe's initial params with the same seeded data,
fp32 (``compute_dtype``, ``grad_dtype`` and, for the MedPix YAMLs,
``mu_dtype``), the input pipeline synchronous in both: the steps, label
counts and learning rates equal, loss and grad_norm within 1e-4 relative
(measured: about 1e-6; fp32 sums in another order).  The PEFT run's
trainable set is JAX's (the adapters of the seven decoder projections, the
merged path) and so is its count.  ``gemma3n_vl_medpix.yaml`` as written
raises item 7's ``NotImplementedError``.
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
from automodel_tpu_torch.utils.model_utils import jax_named_parameters

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VLM_YAMLS = os.path.join(REPO, "examples", "vlm_finetune")
REL = 1e-4
FP32 = ["--model.compute_dtype", "float32",
        "--training.grad_dtype", "float32",
        "--dataloader.prefetch_depth", "0"]
E4B_REPO = "google/gemma-3n-e4b-it"
# the published E4B's layout at tiny widths
MEDPIX_TINY_CONFIG = dict(
    architectures=["Gemma3nForConditionalGeneration"], model_type="gemma3n",
    image_token_id=281, vision_soft_tokens_per_image=4,
    text_config=dict(
        model_type="gemma3n_text", vocab_size=300,
        vocab_size_per_layer_input=264, hidden_size=64,
        hidden_size_per_layer_input=16, intermediate_size=[128] * 5,
        num_hidden_layers=5, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, laurel_rank=8, altup_num_inputs=4, sliding_window=8,
        num_kv_shared_layers=2, rope_theta=1000000.0,
        rope_local_base_freq=10000.0, final_logit_softcapping=30.0,
        activation_sparsity_pattern=[0.95] * 3 + [0.0] * 2),
    vision_config=dict(model_type="gemma3n_vision", hidden_size=32,
                       vocab_size=16, vocab_offset=280, stem_channels=16,
                       depth=2))
MEDPIX_PROCESSOR = {
    "_target_": "automodel_tpu.datasets.vlm.mock.MockVLMProcessor",
    "vocab_size": 300, "image_size": 16, "patch_size": 8,
    "image_token_id": 281}
MEDPIX_OVERRIDES = ["--optimizer.mu_dtype", "float32",
                    "--step_scheduler.max_steps", "2"]
WORDS = ("lesion", "left", "lung", "mass", "ct", "axial", "contrast", "no",
         "yes", "shows", "the", "a", "of", "in", "what")


def _one_device_jax_recipe(cfg):
    real = jax.devices
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "devices", lambda *a: real(*a)[:1])
    try:
        return JaxVLM(cfg).setup()
    finally:
        mp.undo()


def _medpix_args(tmp_path, monkeypatch, validation):
    """The MedPix YAMLs' local stand-ins: a snapshot of the tiny model under
    ``HF_HOME`` (weights come from the JAX recipe's params) and 24 rows in
    MedPix's schema: a jsonl with ``.npy`` images for the port, the same
    rows in memory for the JAX package's ``load_dataset``."""
    import datasets as hf_datasets

    from automodel_tpu_torch.models import hf_io
    from automodel_tpu_torch.models.auto_model import (
        AutoModelForImageTextToText,
    )

    repo = tmp_path / "hf" / "hub" / ("models--" + E4B_REPO.replace("/",
                                                                    "--"))
    snap = repo / "snapshots" / "tiny"
    model = AutoModelForImageTextToText.from_config(MEDPIX_TINY_CONFIG,
                                                    device="cpu")
    hf_io.save_hf_weights(model, str(snap))
    (snap / "config.json").write_text(json.dumps(MEDPIX_TINY_CONFIG))
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("tiny")
    rng = np.random.default_rng(11)
    rows, jrows = [], []
    for i in range(24):
        path = tmp_path / f"img{i}.npy"
        side = (int(rng.integers(20, 40)), int(rng.integers(20, 40)))
        img = rng.integers(0, 256, side + (3,)).astype(np.uint8)
        np.save(path, img)
        q = " ".join(rng.choice(WORDS, int(rng.integers(3, 9))))
        a = " ".join(rng.choice(WORDS, int(rng.integers(2, 12))))
        rows.append({"question": q, "answer": a, "image": str(path)})
        jrows.append({"question": q, "answer": a, "image": img})
    data = tmp_path / "medpix.jsonl"
    data.write_text("".join(json.dumps(r) + "\n" for r in rows))
    monkeypatch.setattr(hf_datasets, "load_dataset",
                        lambda name, split=None, **_: list(jrows))
    over = ["--dataset.path_or_dataset", str(data)]
    if validation:
        over += ["--validation_dataset.path_or_dataset", str(data)]
    return str(tmp_path / "hf"), MEDPIX_OVERRIDES + over


CASES = {
    "tiny_gemma3n_mock": [],
    "gemma3n_vl_medpix": ["--checkpoint.save_consolidated", "true"],
    "gemma3n_vl_medpix_peft": [],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_yaml_runs_through_the_port_as_the_jax_recipe(case, tmp_path,
                                                      monkeypatch):
    over = list(CASES[case])
    medpix = case != "tiny_gemma3n_mock"
    if medpix:
        hf_home, more = _medpix_args(tmp_path, monkeypatch,
                                     validation=not case.endswith("peft"))
        monkeypatch.setenv("HF_HOME", hf_home)
        over += more
    args = ["--config", os.path.join(VLM_YAMLS, case + ".yaml"), *FP32,
            *over]

    def config(load, extra):
        cfg = load(args + extra)
        if medpix:
            cfg.set_by_dotted("processor", dict(MEDPIX_PROCESSOR))
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
    assert type(pr.processor).__name__ == "MockVLMProcessor"
    load_jax_recipe_params(pr, jparams)
    assert len(pr.dataloader) == len(jr.dataloader)
    trainable = {n for n, p in jax_named_parameters(pr.model)
                 if p.requires_grad}
    if case == "gemma3n_vl_medpix_peft":
        want = {f"lora.{t}.{ab}" for t in jr.model.targets
                for ab in ("A", "B")}
        assert trainable == want and len(want) == 14
        assert not pr.model.bypass and not jr.model._bypass
        assert sum(p.numel() for p in pr.model.parameters()
                   if p.requires_grad) == jr.model.num_trainable_params
    else:
        # freeze_embeddings: both tables (the per-layer one by a prefix
        # match of ``embed_tokens``), not the multimodal embedder's
        assert "language_model.embed_tokens.embedding" not in trainable
        assert ("language_model.embed_tokens_per_layer.embedding"
                not in trainable)
        assert "embed_vision.embedding.embedding" in trainable
        assert "vision_tower.stem.kernel" in trainable
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
    if medpix:
        saved = os.listdir(tmp_path / "pck")
        assert len(saved) == 1 and saved[0].endswith(f"_step_{steps}")


def test_medpix_yaml_as_written_raises_the_orbax_refusal():
    cfg = parse_args_and_load_config(
        ["--config", os.path.join(VLM_YAMLS, "gemma3n_vl_medpix.yaml"),
         "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="Orbax"):
        finetune.FinetuneRecipeForVLM(cfg).setup()
