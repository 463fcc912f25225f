"""The port's training loop (``recipes/llm/train_ft.py``) as the JAX
recipe runs it: lagged metrics, staged input, profiling, preemption.

* The async loop (``prefetch_depth: 2``: batch N+1 staged while step N
  runs, metrics read one step late) gives the synchronous loop's
  ``history`` and ``val_history`` exactly, and the JAX recipe's (its
  async loop) over 12 steps with validation at 5 and 10 (fp32; 1e-4
  relative, as ``test_torch_train_recipe.py``; token counts and learning
  rates exact).  The unpacked, length-bucketed leg follows the JAX recipe
  the same way.
* The NaN guard raises one step late, as in JAX.
* ``profiling:`` logs the timers every ``log_interval`` steps, writes a
  trace over its window and changes no number; ``wandb:`` without the
  package is a warning.
* SIGTERM during a step takes a checkpoint at that step's boundary and
  returns with ``preempted``; a resume from it gives the uninterrupted
  run's later steps and final weights bit for bit.  The signal handler
  restores the previous handlers, and a second ^C still interrupts.
"""

import logging
import os
import signal

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
from automodel_tpu.utils import sig_utils as jax_sig
from automodel_tpu_torch.config.loader import parse_args_and_load_config
from automodel_tpu_torch.models.weights import load_jax_recipe_params
from automodel_tpu_torch.recipes.llm import train_ft
from automodel_tpu_torch.utils import sig_utils
from tests.test_torch_train_recipe import JAX_YAML, PORT_YAML, REL

torch.set_num_threads(1)

FP32 = ["--model.config.torch_dtype", "float32",
        "--model.compute_dtype", "float32"]
UNPACKED = ["--packed_sequence.packed_sequence_size", "0",
            "--dataloader.length_bucket_pool", "32",
            "--step_scheduler.max_steps", "4"]


def _recipe(*overrides):
    cfg = parse_args_and_load_config(["-c", PORT_YAML, "--device", "cpu",
                                      *overrides])
    return train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg).setup()


def _jax_run(*overrides):
    """The JAX recipe on its tiny YAML (one device, fp32, no checkpoints):
    its finalized step metrics, validations and initial weights."""
    jcfg = jax_config(["--config", JAX_YAML, "--checkpoint.enabled", "false",
                       *FP32, *overrides])
    real = jax.devices
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "devices", lambda *a: real(*a)[:1])
    try:
        jr = JaxRecipe(jcfg).setup()
    finally:
        mp.undo()
    steps, vals = [], []
    finalize, validate = jr._finalize_metrics, jr._run_validation_epoch

    def record_step(pending):
        out = finalize(pending)
        steps.append(out)
        return out

    def record_val():
        out = validate()
        vals.append((jr.step_scheduler.step, out))
        return out

    jr._finalize_metrics = record_step
    jr._run_validation_epoch = record_val
    weights = jax.tree.map(np.asarray, jr.params)
    jr.run_train_validation_loop()
    return steps, vals, weights


def _check_follows_jax(history, val_history, jsteps, jvals):
    assert [m["step"] for m in history] == [m["step"] for m in jsteps]
    for key in ("num_label_tokens", "lr"):
        assert [m[key] for m in history] == [m[key] for m in jsteps]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([m[key] for m in history],
                                   [float(m[key]) for m in jsteps], rtol=REL,
                                   err_msg=key)
    assert [s for s, _ in val_history] == [s for s, _ in jvals]
    np.testing.assert_allclose([v for _, v in val_history],
                               [v for _, v in jvals], rtol=REL)


KEYS = ("step", "loss", "grad_norm", "num_label_tokens", "lr")


def _trajectory(recipe):
    return [tuple(m[k] for k in KEYS) for m in recipe.history]


@pytest.fixture(scope="module")
def sync_run():
    r = _recipe()
    r.run_train_validation_loop()
    return r


def test_async_loop_equals_sync_loop_and_jax(sync_run):
    jsteps, jvals, weights = _jax_run("--dataloader.prefetch_depth", "2")
    r = _recipe("--dataloader.prefetch_depth", "2")
    load_jax_recipe_params(r, weights)
    r.run_train_validation_loop()
    assert hasattr(r.dataloader, "commit_state")       # the async epoch
    assert [m["step"] for m in r.history] == list(range(1, 13))
    assert [s for s, _ in r.val_history] == [5, 10]
    _check_follows_jax(r.history, r.val_history, jsteps, jvals)
    s = _recipe()
    load_jax_recipe_params(s, weights)
    s.run_train_validation_loop()
    assert _trajectory(r) == _trajectory(s)
    assert r.val_history == s.val_history


def test_unpacked_length_bucketed_leg_follows_jax():
    jsteps, jvals, weights = _jax_run(*UNPACKED)
    r = _recipe(*UNPACKED)
    load_jax_recipe_params(r, weights)
    r.run_train_validation_loop()
    _check_follows_jax(r.history, r.val_history, jsteps, jvals)


@pytest.mark.parametrize("depth", ["0", "2"])
def test_nan_guard_raises_one_step_late(depth):
    r = _recipe("--dataloader.prefetch_depth", depth)
    dispatch = r.step_fns.dispatch

    def poisoned(batch):
        out = dispatch(batch)
        if r.step_scheduler.step == 3:
            out = out.clone()
            out[0] = float("nan")
        return out

    r.step_fns.dispatch = poisoned
    with pytest.raises(FloatingPointError, match="at step 3"):
        r.run_train_validation_loop()
    assert [m["step"] for m in r.history] == [1, 2]


def test_profiling_logs_traces_and_changes_nothing(sync_run, tmp_path,
                                                   caplog):
    trace_dir = str(tmp_path / "trace")
    with caplog.at_level(logging.INFO):
        r = _recipe("--profiling.log_interval", "4",
                    "--profiling.trace_dir", trace_dir,
                    "--profiling.trace_start_step", "2",
                    "--profiling.trace_stop_step", "4",
                    "--wandb.project", "tiny")
        r.run_train_validation_loop()
    assert r.profiling.enabled and r.wandb is None
    assert "wandb disabled" in caplog.text
    assert [t["step"] for t in r.timer_log] == [4, 8, 12]
    for t in r.timer_log:
        assert t["ms_per_step"]["dispatch"] > 0
        assert 0.0 <= t["input_idle_fraction"] <= 1.0
        assert t["ckpt_stall_fraction"] == 0.0
    assert "time (ms) | " in caplog.text
    assert os.path.getsize(os.path.join(trace_dir, "trace.json")) > 0
    assert _trajectory(r) == _trajectory(sync_run)


def test_profiling_barrier_times_the_step():
    r = _recipe("--profiling.barrier", "true", "--profiling.log_interval",
                "2", "--step_scheduler.max_steps", "2")
    r.run_train_validation_loop()
    assert r.timer_log[0]["ms_per_step"]["step_e2e"] > 0


@pytest.mark.parametrize("section", ["elastic", "slurm", "k8s"])
def test_launcher_and_elastic_sections_raise(section):
    cfg = parse_args_and_load_config(["-c", PORT_YAML, "--device", "cpu",
                                      f"--{section}.job_name", "x"])
    with pytest.raises(NotImplementedError, match="item 12"):
        train_ft.check_ported(cfg)


def _preempt_at(recipe, step, sig=signal.SIGTERM):
    dispatch = recipe.step_fns.dispatch

    def send(batch):
        if recipe.step_scheduler.step == step:
            os.kill(os.getpid(), sig)
        return dispatch(batch)

    recipe.step_fns.dispatch = send


@pytest.mark.parametrize("depth", ["0", "2"])
def test_sigterm_saves_at_the_step_boundary_and_resumes_bitwise(tmp_path,
                                                                depth):
    ck = ["--checkpoint.enabled", "true", "--checkpoint.checkpoint_dir",
          str(tmp_path / "ck"), "--dataloader.prefetch_depth", depth]
    full = _recipe("--checkpoint.enabled", "false",
                   "--dataloader.prefetch_depth", depth)
    full.run_train_validation_loop()
    before = signal.getsignal(signal.SIGTERM)
    cut = _recipe(*ck)
    _preempt_at(cut, 4)
    cut.run_train_validation_loop()
    assert signal.getsignal(signal.SIGTERM) is before
    assert cut.preempted
    assert [m["step"] for m in cut.history] == [1, 2, 3, 4]
    assert sorted(os.listdir(tmp_path / "ck")) == ["epoch_0_step_4"]
    resumed = _recipe(*ck)
    assert resumed.step_scheduler.step == 4
    resumed.run_train_validation_loop()
    assert not resumed.preempted
    assert _trajectory(resumed) == _trajectory(full)[4:]
    assert resumed.val_history == [v for v in full.val_history if v[0] > 4]
    for (n, a), b in zip(full.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("mod", [sig_utils, jax_sig], ids=["port", "jax"])
def test_second_sigint_interrupts_and_handlers_are_restored(mod):
    before = signal.getsignal(signal.SIGINT)
    with mod.DistributedSignalHandler((signal.SIGTERM, signal.SIGINT)) as h:
        os.kill(os.getpid(), signal.SIGINT)
        assert h.received and h.received_signal == signal.SIGINT
        # the second ^C through the installed handler itself, so that its
        # KeyboardInterrupt is raised here and not wherever the
        # interpreter happens to run the signal
        with pytest.raises(KeyboardInterrupt):
            signal.getsignal(signal.SIGINT)(signal.SIGINT, None)
    assert signal.getsignal(signal.SIGINT) is before
    assert mod.get_signal_name(signal.SIGTERM) == "SIGTERM"
    assert mod.get_signal_name(12345) == "12345"
