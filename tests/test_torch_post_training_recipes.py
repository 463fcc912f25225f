"""The port's GRPO and DPO recipes on the JAX package's mock YAMLs
(``examples/rl/tiny_llama_{grpo,dpo}_mock.yaml``, as written but for the
checkpoint directory and ``--device cpu``) on the CPU:

* DPO's 25-step trajectory (loss, accuracy, margin, grad_norm) against
  the JAX recipe from the same initial weights, fp32 on both sides (the
  DPO path samples nothing);
* GRPO's reward improving with rollouts from the engine, synced to the
  live weights before each one;
* RL state, the data cursor and the weights round-tripping through an
  asynchronous checkpoint and a resume;
* the eval watcher scoring each committed checkpoint once, standalone and
  as the recipe's ``online_eval`` hook;
* the ``main`` entry points: they run on the CPU when asked and raise
  without a card otherwise; unported sections raise.

Tolerance of the DPO trajectory: 1e-4 relative on loss, margin and
grad_norm (fp32, 25 Adam steps whose updates divide by sqrt(nu)), with an
absolute floor of 1e-6 for the step-1 margin (0 up to rounding); accuracy
exact from step 2 (at step 1 the policy is the reference, and the sign of
each margin is the rounding's).
"""

import os

import jax
import numpy as np
import pytest
import torch

from automodel_tpu.config.arg_parser import (
    parse_args_and_load_config as jax_config,
)
from automodel_tpu.recipes.llm.train_dpo import (
    DPORecipeForCausalLM as JaxDPORecipe,
)
from automodel_tpu_torch.config.loader import parse_args_and_load_config
from automodel_tpu_torch.models.weights import load_jax_params
from automodel_tpu_torch.post_training.base import PostTrainingRecipeBase
from automodel_tpu_torch.post_training.eval_watch import (
    CheckpointEvalWatcher,
)
from automodel_tpu_torch.recipes.llm import train_dpo, train_grpo

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRPO_YAML = os.path.join(ROOT, "examples", "rl", "tiny_llama_grpo_mock.yaml")
DPO_YAML = os.path.join(ROOT, "examples", "rl", "tiny_llama_dpo_mock.yaml")
REL = 1e-4
FP32 = ["--model.config.torch_dtype", "float32",
        "--model.compute_dtype", "float32"]


def _cfg(yaml_path, tmp_path, *overrides):
    return parse_args_and_load_config(
        ["-c", yaml_path, "--device", "cpu",
         "--checkpoint.checkpoint_dir", str(tmp_path / "ckpt"),
         *overrides])


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def test_dpo_trajectory_equals_jax(tmp_path):
    # the JAX recipe looks for a checkpoint to resume even when saving is
    # off: keep it out of the YAML's shared /tmp directory
    jcfg = jax_config(["--config", DPO_YAML, "--checkpoint.enabled", "false",
                       "--checkpoint.checkpoint_dir", str(tmp_path / "jax"),
                       *FP32])
    real = jax.devices
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "devices", lambda *a: real(*a)[:1])     # one device
    try:
        jr = JaxDPORecipe(jcfg).setup()
    finally:
        mp.undo()
    weights = jax.tree.map(np.asarray, jr.params)
    want = []
    one_step = jr._one_step

    def record(step):
        m = one_step(step)
        want.append(m)
        return m

    jr._one_step = record
    jr.run_post_training_loop()

    pr = train_dpo.DPORecipeForCausalLM(_cfg(
        DPO_YAML, tmp_path, "--checkpoint.enabled", "false", *FP32)).setup()
    load_jax_params(pr.model, weights)
    load_jax_params(pr.ref_model, weights)
    pr.run_post_training_loop()
    got = pr.history
    assert len(got) == len(want) == 25
    # at step 1 the policy is the reference: every margin is 0 up to the
    # rounding of two passes, and the accuracy is the rounding's sign
    assert [m["accuracy"] for m in got[1:]] == [m["accuracy"]
                                                for m in want[1:]]
    assert [m["num_pairs"] for m in got] == [m["num_pairs"] for m in want]
    for key in ("loss", "margin", "grad_norm"):
        np.testing.assert_allclose([m[key] for m in got],
                                   [m[key] for m in want], rtol=REL,
                                   atol=1e-6, err_msg=key)
    assert got[-1]["accuracy"] > got[1]["accuracy"]
    assert got[-1]["loss"] < got[0]["loss"]
    assert pr.rl_state.data_cursor == 25 * 8


def test_grpo_reward_improves_with_engine_rollouts(tmp_path):
    recipe = train_grpo.GRPORecipeForCausalLM(_cfg(
        GRPO_YAML, tmp_path, "--post_training.max_steps", "22",
        "--checkpoint.enabled", "false", "--optimizer.lr", "3e-3",
        "--rl.kl_coef", "null")).setup()
    assert recipe.ref_model is None          # reference-free option
    recipe.run_post_training_loop()
    rewards = [m["reward_mean"] for m in recipe.history]
    assert recipe.rl_state.step == 22 == recipe.rl_state.rollouts
    assert recipe.engine.weight_syncs == recipe.rl_state.rollouts
    early, late = np.mean(rewards[:5]), np.mean(rewards[-5:])
    assert late > early + 0.5, (early, late)
    # the handoff copies bit for bit, and the engine keeps its own copy
    recipe.rollout_worker.sync_weights(recipe.model)
    own = recipe.engine.model.state_dict()
    assert all(torch.equal(own[k], v)
               for k, v in recipe.model.state_dict().items())
    assert all(own[k].data_ptr() != v.data_ptr()
               for k, v in recipe.model.state_dict().items())


RESUME = {
    "grpo": (train_grpo.GRPORecipeForCausalLM, GRPO_YAML, 4, 2),
    "dpo": (train_dpo.DPORecipeForCausalLM, DPO_YAML, 6, 3),
}


@pytest.mark.parametrize("algo", list(RESUME))
def test_resume_restores_rl_state_and_weights(tmp_path, algo):
    """An asynchronous checkpoint at every ``ckpt_every`` steps; a second
    recipe on the same directory resumes: RL state (reward EMA, counters,
    the data cursor) exactly, weights bit for bit, and one more step
    continues the same data stream."""
    cls, yaml_path, steps, every = RESUME[algo]
    over = ("--post_training.max_steps", str(steps),
            "--post_training.ckpt_every_steps", str(every))
    r1 = cls(_cfg(yaml_path, tmp_path, *over)).setup()
    r1.run_post_training_loop()
    saved = dict(r1.rl_state.state_dict())
    weights = _state(r1.model)
    assert saved["step"] == steps
    per_step = r1.rollout_config.rollout_batch_size
    assert saved["data_cursor"] == steps * per_step
    if algo == "grpo":
        assert saved["reward_ema"] is not None
    r2 = cls(_cfg(yaml_path, tmp_path, *over[:1],
                  str(steps + 1), *over[2:])).setup()
    assert r2.rl_state.state_dict() == saved
    assert all(torch.equal(weights[k], v)
               for k, v in r2.model.state_dict().items())
    r2.run_post_training_loop()
    assert r2.rl_state.step == steps + 1
    assert r2.rl_state.data_cursor == (steps + 1) * per_step
    assert len(r2.history) == 1


def test_eval_watcher_scores_each_committed_checkpoint_once(tmp_path):
    r = train_dpo.DPORecipeForCausalLM(_cfg(
        DPO_YAML, tmp_path, "--post_training.max_steps", "4",
        "--post_training.ckpt_every_steps", "2")).setup()
    r.run_post_training_loop()
    ckdir = str(tmp_path / "ckpt")
    os.makedirs(os.path.join(ckdir, "epoch_0_step_9.tmp"))  # never seen
    rng = np.random.default_rng(5)
    rows = [([int(t) for t in rng.integers(2, 120, 5)],
             [int(t) for t in rng.integers(2, 120, 3)]) for _ in range(3)]
    results = []
    w = CheckpointEvalWatcher(PostTrainingRecipeBase._frozen_copy(r.model),
                              ckdir, rows, max_new_tokens=3, device="cpu",
                              on_result=results.append)
    first = w.poll()
    assert [x["step"] for x in first] == [2, 4]
    assert all(0.0 <= x["eval/score"] <= 1.0 for x in first)
    assert w.poll() == []                                   # at most once
    assert [x["step"] for x in results] == [2, 4]
    assert w.drain_results() == first and w.drain_results() == []


def test_online_eval_hook_scores_the_recipes_checkpoints(tmp_path):
    recipe = train_grpo.GRPORecipeForCausalLM(_cfg(
        GRPO_YAML, tmp_path, "--post_training.max_steps", "4",
        "--post_training.ckpt_every_steps", "2",
        "--online_eval.enabled", "true", "--online_eval.poll_interval_s",
        "0.05", "--online_eval.limit", "4")).setup()
    assert recipe.eval_watcher is not None
    recipe.run_post_training_loop()
    # teardown joined the last save, then polled once more
    assert sorted(recipe.eval_watcher._scored) == [2, 4]


@pytest.mark.parametrize("main", [train_grpo.main, train_dpo.main],
                         ids=["grpo", "dpo"])
def test_main_runs_on_cpu_and_raises_without_a_card(tmp_path, main):
    yaml_path = GRPO_YAML if main is train_grpo.main else DPO_YAML
    argv = ["--checkpoint.checkpoint_dir", str(tmp_path / "ckpt"),
            "--post_training.max_steps", "2"]
    recipe = main(yaml_path, ["--device", "cpu", *argv])
    assert recipe.rl_state.step == 2 and len(recipe.history) == 2
    for m in recipe.history:
        assert all(np.isfinite(v) for v in m.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(yaml_path, argv)


@pytest.mark.parametrize("override,exc,match", [
    (("--peft.dim", "8"), ValueError, "'peft' config section"),
    (("--fp8.enabled", "true"), ValueError, "'fp8' config section"),
    (("--distributed.dp_size", "2"), NotImplementedError, "multi-GPU"),
    (("--post_training.algorithm", "dpo"), ValueError, "does not match"),
])
def test_unported_and_mismatched_configs_raise(tmp_path, override, exc,
                                               match):
    cfg = _cfg(GRPO_YAML, tmp_path, *override)
    with pytest.raises(exc, match=match):
        train_grpo.GRPORecipeForCausalLM(cfg).setup()
