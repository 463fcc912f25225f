"""The port's VLM recipe (``recipes/vlm/finetune.py``) against the JAX
recipe on the CPU, and its CLI route.

* ``examples/vlm_finetune/tiny_vlm_mock.yaml`` (llava: a tiny SigLIP
  tower and Llama decoder, MaskedCE, the tower frozen, validation every 5
  steps) and ``gemma3_vl_bench.yaml`` narrowed to a tiny Gemma-3 VL (6
  layers: 5 sliding with window 32 and a full one; the fused linear CE;
  rows padded to ``fixed_length`` 128; its default freeze of the
  embeddings and the VLM recipe's clip at 1.0), each from the JAX
  recipe's initial params with the same seeded mock data, fp32
  (``compute_dtype``, ``grad_dtype`` and ``mu_dtype`` float32), the
  input pipeline synchronous in both: the steps, label counts and
  learning rates equal, loss and grad_norm within 1e-4 relative, the
  validation losses too.  Overrides are listed per case.
* ``automodel-torch finetune vlm -c <yaml>`` runs the same steps as the
  recipe's ``main``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from automodel_tpu.config.arg_parser import (
    parse_args_and_load_config as jax_config,
)
from automodel_tpu.recipes.vlm.finetune import FinetuneRecipeForVLM as JaxVLM
from automodel_tpu_torch._cli import app
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
BENCH_TINY = [
    "--model.config.text_config.vocab_size", "512",
    "--model.config.text_config.hidden_size", "64",
    "--model.config.text_config.intermediate_size", "128",
    "--model.config.text_config.num_hidden_layers", "6",
    "--model.config.text_config.num_attention_heads", "4",
    "--model.config.text_config.num_key_value_heads", "2",
    "--model.config.text_config.head_dim", "16",
    "--model.config.text_config.query_pre_attn_scalar", "16.0",
    "--model.config.text_config.sliding_window", "32",
    "--model.config.mm_tokens_per_image", "16",
    "--model.config.vision_config.hidden_size", "32",
    "--model.config.vision_config.intermediate_size", "64",
    "--model.config.vision_config.num_hidden_layers", "2",
    "--model.config.vision_config.num_attention_heads", "4",
    "--model.config.vision_config.image_size", "32",
    "--model.config.vision_config.patch_size", "4",
    "--processor.vocab_size", "512", "--processor.image_size", "32",
    "--processor.patch_size", "8",
    "--dataset.num_samples", "32", "--dataset.image_size", "32",
    "--dataset.desc_words", "60",
    "--dataloader.fixed_length", "128",
    "--step_scheduler.global_batch_size", "8",
    "--step_scheduler.local_batch_size", "4",
    "--step_scheduler.max_steps", "3",
    "--optimizer.mu_dtype", "float32",
]
CASES = {
    "tiny_vlm_mock": ("tiny_vlm_mock.yaml", ["--step_scheduler.max_steps",
                                             "6"]),
    "gemma3_vl_bench_tiny": ("gemma3_vl_bench.yaml", BENCH_TINY),
}


def _one_device_jax_recipe(cfg):
    real = jax.devices
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "devices", lambda *a: real(*a)[:1])
    try:
        return JaxVLM(cfg).setup()
    finally:
        mp.undo()


@pytest.mark.parametrize("case", sorted(CASES))
def test_yaml_runs_through_the_port_as_the_jax_recipe(case, tmp_path):
    name, over = CASES[case]
    yaml_path = os.path.join(VLM_YAMLS, name)
    args = ["--config", yaml_path, *FP32, *over]
    jr = _one_device_jax_recipe(jax_config(
        args + ["--checkpoint.checkpoint_dir", str(tmp_path / "jck")]))
    jsteps = []
    finalize = jr._finalize_metrics

    def record(pending):
        out = finalize(pending)
        jsteps.append(out)
        return out

    jr._finalize_metrics = record
    jvals = []
    validate = jr._run_validation_epoch

    def record_val():
        jvals.append(validate())
        return jvals[-1]

    jr._run_validation_epoch = record_val
    jparams = jax.tree.map(np.asarray, jr.params)
    jr.run_train_validation_loop()

    pr = finetune.FinetuneRecipeForVLM(parse_args_and_load_config(
        args + ["--device", "cpu", "--checkpoint.checkpoint_dir",
                str(tmp_path / "pck")])).setup()
    load_jax_recipe_params(pr, jparams)
    assert len(pr.dataloader) == len(jr.dataloader)
    trainable = sum(p.numel() for p in pr.model.parameters()
                    if p.requires_grad)
    assert 0 < trainable < pr.model.num_params
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
    assert len(pr.val_history) == len(jvals)
    np.testing.assert_allclose([v for _, v in pr.val_history], jvals,
                               rtol=REL)


def test_cli_runs_the_vlm_recipe(monkeypatch, tmp_path):
    yaml_path = os.path.join(VLM_YAMLS, "tiny_vlm_mock.yaml")
    over = ["--device", "cpu", "--step_scheduler.max_steps", "2",
            "--checkpoint.enabled", "false"]
    direct = finetune.main(yaml_path, over)
    ran = []
    real_main = finetune.main

    def capture(*a, **kw):
        ran.append(real_main(*a, **kw))
        return ran[-1]

    monkeypatch.setattr(finetune, "main", capture)
    assert app.main(["finetune", "vlm", "-c", yaml_path, *over]) == 0
    assert len(ran) == 1
    keys = ("step", "loss", "grad_norm", "num_label_tokens")
    assert ([tuple(m[k] for k in keys) for m in ran[0].history]
            == [tuple(m[k] for k in keys) for m in direct.history])
