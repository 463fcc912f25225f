"""The port's CLI (``automodel_tpu_torch/_cli/app.py``): ``finetune llm``
and ``pretrain llm`` run the SFT recipe with the config and the dotted
overrides, giving the direct ``train_ft.main`` run's steps exactly;
``python -m automodel_tpu_torch._cli.app`` trains from a shell;
``--nproc-per-node`` is accepted; ``finetune vlm`` runs the VLM recipe;
the ``slurm:`` / ``k8s:`` launchers raise, naming the ROADMAP item they
wait for.
"""

import os
import subprocess
import sys

import pytest
import torch

from automodel_tpu_torch._cli import app
from automodel_tpu_torch.recipes.llm import train_ft
from tests.test_torch_train_recipe import PORT_YAML, REPO

torch.set_num_threads(1)

OVERRIDES = ["--device", "cpu", "--step_scheduler.max_steps", "3"]
KEYS = ("step", "loss", "grad_norm", "num_label_tokens", "lr")


def _trajectory(recipe):
    return [tuple(m[k] for k in KEYS) for m in recipe.history]


@pytest.mark.parametrize("command", ["finetune", "pretrain"])
def test_cli_run_equals_a_direct_main_run(monkeypatch, command):
    direct = train_ft.main(PORT_YAML, OVERRIDES)
    ran = []
    real_main = train_ft.main

    def capture(*a, **kw):
        ran.append(real_main(*a, **kw))
        return ran[-1]

    monkeypatch.setattr(train_ft, "main", capture)
    assert app.main([command, "llm", "-c", PORT_YAML, "--nproc-per-node",
                     "1", *OVERRIDES]) == 0
    assert len(ran) == 1
    assert _trajectory(ran[0]) == _trajectory(direct)


def test_module_entry_point_trains_from_a_shell():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "automodel_tpu_torch._cli.app", "finetune",
         "llm", "-c", PORT_YAML, "--device", "cpu",
         "--step_scheduler.max_steps", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "step 2 | loss" in out.stderr


def test_vlm_raises():
    """``finetune vlm`` runs the VLM recipe, which raises on a config that
    names no processor (a text YAML); ``pretrain vlm`` has no recipe."""
    with pytest.raises(ValueError, match="needs a processor"):
        app.main(["finetune", "vlm", "-c", PORT_YAML, "--device", "cpu"])
    with pytest.raises(SystemExit):
        app.main(["pretrain", "vlm", "-c", PORT_YAML, "--device", "cpu"])


@pytest.mark.parametrize("launcher", ["slurm", "k8s"])
def test_launchers_raise(launcher):
    with pytest.raises(NotImplementedError, match="item 12"):
        app.main(["finetune", "llm", "-c", PORT_YAML, "--device", "cpu",
                  f"--{launcher}.job_name", "x"])


def test_unknown_command_exits():
    with pytest.raises(SystemExit):
        app.main(["evaluate", "llm", "-c", PORT_YAML])
