"""The port's SFT recipe end to end on the CPU: ``main`` on
``tiny_llama_sft.yaml`` runs its 12 steps and 2 validation passes with
finite metrics, and from the JAX recipe's initial weights it follows the
JAX recipe on ``tiny_llama_mock.yaml`` (checkpointing off, fp32, one
device) step for step, and on that YAML as written (bf16, checkpoints
on).  Knobs the slice does not port raise, checkpointing runs, and the
entry points default to ``cuda`` and raise without a card.

Tolerance for the recipe trajectories: fp32 on both sides, 16
grad-accumulation microbatches summed in another order; 1e-4 relative (as
the train-step test), token counts and learning rates exact.
"""

import os

import jax
import jax.numpy as jnp
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
from automodel_tpu_torch.models.weights import (
    jax_leaves,
    load_jax_recipe_params,
)
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
    ("checkpoint_orbax", ["--checkpoint.enabled", "true",
                          "--checkpoint.model_save_format", "orbax"]),
    ("tp", ["--distributed.tp_size", "2"]),
    ("cp", ["--distributed.cp_size", "2"]),
    ("pp", ["--distributed.pp_size", "2"]),
    ("peft", ["--peft.dim", "8"]),
    ("autotune", ["--kernels.autotune", "on"]),
    ("remat_policy", ["--model.remat_policy", "save_names:attn_core"]),
    ("linear_ce_xla_bwd", ["--loss_fn._target_",
                           "automodel_tpu.loss.linear_ce."
                           "FusedLinearCrossEntropy",
                           "--loss_fn.bwd_mode", "xla"]),
    ("grad_clip", ["--max_grad_norm", "1.0"]),
]


@pytest.mark.parametrize("overrides", [o for _, o in UNPORTED],
                         ids=[n for n, _ in UNPORTED])
def test_unported_knobs_raise(overrides):
    cfg = parse_args_and_load_config(["-c", PORT_YAML, "--device", "cpu",
                                      *overrides])
    with pytest.raises(NotImplementedError):
        train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg).setup()


def test_checkpoint_knob_runs(tmp_path):
    """``--checkpoint.enabled true`` (refused before the port had
    checkpoints) trains and commits a checkpoint at max_steps."""
    cfg = parse_args_and_load_config(
        ["-c", PORT_YAML, "--device", "cpu", "--checkpoint.enabled", "true",
         "--checkpoint.checkpoint_dir", str(tmp_path),
         "--step_scheduler.max_steps", "2"])
    recipe = train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg).setup()
    recipe.run_train_validation_loop()
    assert [m["step"] for m in recipe.history] == [1, 2]
    assert sorted(os.listdir(tmp_path)) == ["epoch_0_step_2"]


def test_jax_tiny_yaml_runs_as_written_and_follows_jax(tmp_path):
    """The JAX package's ``tiny_llama_mock.yaml`` as written on the port
    (bf16 params, fp32 gradients and moments, ``Adam`` with
    ``weight_decay: 0``, the async input pipeline, asynchronous
    checkpoints with ``keep_last_k: 2``; only the checkpoint directory is
    moved to ``tmp_path``), from the JAX recipe's initial weights, against
    the JAX recipe on the same YAML (one device): loss and grad_norm of its
    12 steps within 5e-4 (bf16 forward and backward on both sides:
    measured within 1.1e-4), and both leave the same committed
    checkpoints, which the JAX package verifies."""
    from automodel_tpu.checkpoint.checkpointing import verify_manifest

    jcfg = jax_config(["--config", JAX_YAML, "--checkpoint.checkpoint_dir",
                       str(tmp_path / "jax")])
    real = jax.devices
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "devices", lambda *a: real(*a)[:1])    # one device
    try:
        jr = JaxRecipe(jcfg).setup()
    finally:
        mp.undo()
    jsteps = []
    finalize = jr._finalize_metrics

    def record_step(pending):
        out = finalize(pending)
        jsteps.append(out)
        return out

    jr._finalize_metrics = record_step
    weights = jax.tree.map(np.array, jr.params)
    jr.run_train_validation_loop()

    pr = train_ft.TrainFinetuneRecipeForNextTokenPrediction(
        parse_args_and_load_config(
            ["-c", JAX_YAML, "--device", "cpu",
             "--checkpoint.checkpoint_dir", str(tmp_path / "port")]))
    pr.setup()
    assert next(pr.model.parameters()).dtype == torch.bfloat16
    assert pr.checkpoint_config.async_save
    load_jax_recipe_params(pr, weights)
    pr.run_train_validation_loop()
    assert [m["step"] for m in pr.history] == list(range(1, 13))
    assert [m["num_label_tokens"] for m in pr.history] == [
        m["num_label_tokens"] for m in jsteps]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([m[key] for m in pr.history],
                                   [float(m[key]) for m in jsteps],
                                   rtol=5e-4, err_msg=key)
    port_dirs = sorted(os.listdir(tmp_path / "port"))
    assert port_dirs == sorted(os.listdir(tmp_path / "jax"))
    for name in port_dirs:
        verify_manifest(str(tmp_path / "port" / name))


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = parse_args_and_load_config(["-c", PORT_YAML])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg).setup()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg.model.config)
    assert build_model(cfg.model.config, device="cpu").embed_tokens \
        .weight.device.type == "cpu"


BF16 = ["--model.config.torch_dtype", "bfloat16",
        "--training.grad_dtype", "bfloat16",
        "--optimizer.mu_dtype", "bfloat16",
        "--step_scheduler.max_steps", "6"]


def _jax_leaf_map(model, tree):
    """``[(port parameter, numpy leaf slice in the port's layout)]`` for a
    JAX params-shaped tree (numpy)."""
    flat = {tuple(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    out = []
    for path, target, transposed in jax_leaves(model):
        targets = target if isinstance(target, list) else [target]
        slices = list(flat[path]) if isinstance(target, list) else [
            flat[path]]
        for p, a in zip(targets, slices):
            out.append((p, np.array(a.T if transposed else a)))
    return out


def _to_np(tree):
    """A numpy copy (the JAX step donates its params and opt state)."""
    return jax.tree.map(lambda x: np.array(x.astype(jnp.float32)), tree)


def test_bf16_recipe_follows_jax_within_the_measured_deviation():
    """bf16 params, gradients and moments on both sides (the bench YAML's
    regime) from the same weights, 6 steps.

    Each step is taken from the same state on both sides: before step i
    the port's weights and optimizer state (``mu`` bf16, ``nu`` fp32, the
    count) are set to the JAX recipe's state before its step i, so each
    step's loss and grad_norm measure that step alone.  The optimizer
    arithmetic is held bit for bit by ``test_torch_optim.py``; what differs
    here is the bf16 forward and backward (matmul sums in another order,
    one bf16 ulp now and then), and the sign of gradient elements at the
    noise floor, which Adam's sign-like first steps turn into whole-lr
    steps -- so a free-running grad_norm trajectory wanders chaotically
    (measured: within 6.2e-4 at step 2 with the repaired optimizer,
    within 3.1e-4 with the bf16-moment one it replaced).  Measured per
    step from the same state: loss within 3.1e-5 and grad_norm within
    1.4e-4; the free-running loss within 3.7e-5.  Limits, as this test
    has held them since it was written: 5e-4 on every step's loss and
    grad_norm, and on the free-running loss; 1e-4 on the first step's
    grad_norm."""
    jcfg = jax_config(["--config", JAX_YAML, "--checkpoint.enabled", "false",
                       "--dataloader.prefetch_depth", "0", *BF16])
    real = jax.devices
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "devices", lambda *a: real(*a)[:1])    # one device
    try:
        jr = JaxRecipe(jcfg).setup()
    finally:
        mp.undo()
    jsteps, before = [], []
    finalize, step_fn = jr._finalize_metrics, jr.step_fns.train_step

    def record_step(pending):
        out = finalize(pending)
        jsteps.append(out)
        return out

    def record_state(params, opt_state, batch):
        adam = opt_state.inner_state[0]
        before.append((_to_np(params), _to_np(adam.mu), _to_np(adam.nu),
                       int(adam.count)))
        return step_fn(params, opt_state, batch)

    jr._finalize_metrics = record_step
    object.__setattr__(jr.step_fns, "train_step", record_state)
    weights = jax.tree.map(np.array, jr.params)
    jr.run_train_validation_loop()
    assert len(before) == len(jsteps) == 6

    def port_recipe():
        pr = train_ft.TrainFinetuneRecipeForNextTokenPrediction(
            parse_args_and_load_config(["-c", PORT_YAML, "--device", "cpu",
                                        "--model.compute_dtype", "bfloat16",
                                        *BF16]))
        pr.setup()
        assert next(pr.model.parameters()).dtype == torch.bfloat16
        load_jax_recipe_params(pr, weights)
        return pr

    forced = port_recipe()
    for i, (params, mu, nu, count) in enumerate(before):
        with torch.no_grad():
            for (p, a), (_, m), (_, v) in zip(
                    _jax_leaf_map(forced.model, params),
                    _jax_leaf_map(forced.model, mu),
                    _jax_leaf_map(forced.model, nu)):
                p.copy_(torch.from_numpy(a).to(p.dtype))
                if count:
                    forced.optimizer.state[p] = {
                        "step": count,
                        "mu": torch.from_numpy(m).to(torch.bfloat16),
                        "nu": torch.from_numpy(v)}
        forced.step_scheduler.max_steps = i + 1
        forced.run_train_validation_loop()
    free = port_recipe()
    free.run_train_validation_loop()
    for pr in (forced, free):
        assert [m["num_label_tokens"] for m in pr.history] == [
            m["num_label_tokens"] for m in jsteps]
    for key in ("loss", "grad_norm"):
        got = np.array([m[key] for m in forced.history])
        want = np.array([float(m[key]) for m in jsteps])
        np.testing.assert_allclose(got, want, rtol=5e-4, err_msg=key)
    np.testing.assert_allclose([m["loss"] for m in free.history],
                               [float(m["loss"]) for m in jsteps], rtol=5e-4)
    np.testing.assert_allclose(free.history[0]["grad_norm"],
                               float(jsteps[0]["grad_norm"]), rtol=1e-4)
