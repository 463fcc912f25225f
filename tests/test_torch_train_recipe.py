"""The port's SFT recipe end to end on the CPU: ``main`` on
``tiny_llama_sft.yaml`` runs its 12 steps and 2 validation passes with
finite metrics, and from the JAX recipe's initial weights it follows the
JAX recipe on ``tiny_llama_mock.yaml`` (checkpointing off, fp32, one
device) step for step.  Knobs the slice does not port raise, and the entry
points default to ``cuda`` and raise without a card.

Tolerance for the recipe trajectories: fp32 on both sides, 16
grad-accumulation microbatches summed in another order; 1e-4 relative (as
the train-step test), token counts and learning rates exact.
"""

import os

import jax
import numpy as np
import pytest
import torch

from automodel_tpu.config.arg_parser import (
    parse_args_and_load_config as jax_config,
)
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JaxRecipe,
)
from automodel_tpu_torch.config.loader import parse_args_and_load_config
from automodel_tpu_torch.models.auto_model import build_model
from automodel_tpu_torch.models.weights import load_jax_recipe_params
from automodel_tpu_torch.recipes.llm import train_ft

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_YAML = os.path.join(REPO, "automodel_tpu_torch", "examples",
                         "tiny_llama_sft.yaml")
JAX_YAML = os.path.join(REPO, "examples", "llm_finetune",
                        "tiny_llama_mock.yaml")
REL = 1e-4


def test_main_runs_the_tiny_yaml_on_cpu():
    recipe = train_ft.main(PORT_YAML, ["--device", "cpu"])
    assert [m["step"] for m in recipe.history] == list(range(1, 13))
    assert [s for s, _ in recipe.val_history] == [5, 10]
    for m in recipe.history:
        assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
        assert m["num_label_tokens"] > 0 and m["tps"] > 0
    assert all(np.isfinite(v) for _, v in recipe.val_history)
    assert recipe.history[-1]["loss"] < recipe.history[0]["loss"] - 0.5


@pytest.fixture(scope="module")
def runs():
    """The JAX recipe on tiny_llama_mock.yaml (one device, fp32, no
    checkpoints) and the port's on tiny_llama_sft.yaml from its weights."""
    jcfg = jax_config(["--config", JAX_YAML,
                       "--checkpoint.enabled", "false",
                       "--dataloader.prefetch_depth", "0",
                       "--model.config.torch_dtype", "float32",
                       "--model.compute_dtype", "float32"])
    real = jax.devices
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "devices", lambda *a: real(*a)[:1])    # one device
    try:
        jr = JaxRecipe(jcfg).setup()
    finally:
        mp.undo()
    assert jr.mesh_manager.dp_size == 1
    jsteps, jvals = [], []
    finalize, validate = jr._finalize_metrics, jr._run_validation_epoch

    def record_step(pending):
        out = finalize(pending)
        jsteps.append(out)
        return out

    def record_val():
        out = validate()
        jvals.append((jr.step_scheduler.step, out))
        return out

    jr._finalize_metrics = record_step
    jr._run_validation_epoch = record_val
    weights = jax.tree.map(np.asarray, jr.params)
    jr.run_train_validation_loop()

    pr = train_ft.TrainFinetuneRecipeForNextTokenPrediction(
        parse_args_and_load_config(["-c", PORT_YAML, "--device", "cpu"]))
    pr.setup()
    load_jax_recipe_params(pr, weights)
    pr.run_train_validation_loop()
    return jsteps, jvals, pr


def test_recipe_steps_match_jax(runs):
    jsteps, _, pr = runs
    assert [m["step"] for m in jsteps] == [m["step"] for m in pr.history]
    for key in ("num_label_tokens", "lr"):
        assert [m[key] for m in jsteps] == [m[key] for m in pr.history]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([m[key] for m in pr.history],
                                   [m[key] for m in jsteps], rtol=REL,
                                   err_msg=key)


def test_recipe_validation_matches_jax(runs):
    _, jvals, pr = runs
    assert [s for s, _ in jvals] == [s for s, _ in pr.val_history] == [5, 10]
    np.testing.assert_allclose([v for _, v in pr.val_history],
                               [v for _, v in jvals], rtol=REL)


UNPORTED = [
    ("checkpoint", ["--checkpoint.enabled", "true"]),
    ("tp", ["--distributed.tp_size", "2"]),
    ("cp", ["--distributed.cp_size", "2"]),
    ("pp", ["--distributed.pp_size", "2"]),
    ("peft", ["--peft.dim", "8"]),
    ("fp8", ["--fp8.enabled", "true"]),
    ("prefetch", ["--dataloader.prefetch_depth", "2"]),
    ("remat_policy", ["--model.remat_policy", "save_names:attn_core"]),
    ("linear_ce", ["--loss_fn._target_",
                   "automodel_tpu.loss.linear_ce.FusedLinearCrossEntropy"]),
    ("grad_clip", ["--max_grad_norm", "1.0"]),
]


@pytest.mark.parametrize("overrides", [o for _, o in UNPORTED],
                         ids=[n for n, _ in UNPORTED])
def test_unported_knobs_raise(overrides):
    cfg = parse_args_and_load_config(["-c", PORT_YAML, "--device", "cpu",
                                      *overrides])
    with pytest.raises(NotImplementedError):
        train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg).setup()


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = parse_args_and_load_config(["-c", PORT_YAML])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg).setup()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg.model.config)
    assert build_model(cfg.model.config, device="cpu").embed_tokens \
        .weight.device.type == "cpu"
