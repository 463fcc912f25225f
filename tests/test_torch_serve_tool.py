"""The port's ``tools/serve.py`` on the CPU, with the JAX tool's CI
contract (``tests/unit_tests/test_serve_tool.py``): exit 0 only when every
request finished, a per-state summary otherwise, fault specs armed for
drills, the drain wired to a tripped signal handler, and each serving
feature driven by its flag."""

import json
import os

import pytest

from automodel_tpu_torch.config.loader import load_yaml_config
from automodel_tpu_torch.generation import GenerationConfig
from automodel_tpu_torch.serving import DecodeEngine, build_serving_config
from automodel_tpu_torch.tools import serve as serve_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "automodel_tpu_torch", "examples",
                    "tiny_llama_serve.yaml")
BASE = ["--config", YAML, "--device", "cpu", "--requests", "3",
        "--max-new", "3"]


def _run(capsys, extra):
    rc = serve_tool.main(BASE + extra)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


def test_exits_zero_and_reports_outcomes_when_all_finish(capsys):
    rc, report = _run(capsys, [])
    assert rc == 0
    assert report["not_finished"] == 0 and report["drained"] is False
    assert report["outcomes"] == {"finished": 4}     # + the warm-up
    assert report["expired"] == 0 and report["rejected"] == 0
    assert "serve_step" in report["timers_ms"]


@pytest.mark.fault
@pytest.mark.parametrize("fault,state", [("serve_request_abort:2", "aborted"),
                                         ("serve_deadline:2", "expired")])
def test_exits_nonzero_with_summary(capsys, fault, state):
    rc, report = _run(capsys, ["--fault", fault])
    assert rc == 1
    assert report["outcomes"].get(state) == 1
    assert report["not_finished"] == 1


@pytest.mark.fault
def test_watchdog_recovery_still_exits_zero(capsys):
    rc, report = _run(capsys, ["--watchdog-s", "30", "--fault",
                               "serve_watchdog_stall:2"])
    assert rc == 0
    assert report["watchdog_recoveries"] == 1
    assert report["not_finished"] == 0


@pytest.mark.parametrize("flags,check", [
    (["--prefix-cache", "on"], lambda r: r["prefix_cache"]["enabled"]),
    (["--speculative", "ngram", "--spec-k", "2"],
     lambda r: r["speculative"]["spec_k"] == 2),
    (["--adapters", "2", "--tenant", "1"],
     lambda r: r["multi_tenant"]["adapters"]["loaded"] == [1, 2]
     and r["multi_tenant"]["tenant_quota"] == 1),
    (["--policy", "sjf", "--max-waiting", "8", "--shed-policy",
      "by_deadline", "--deadline-s", "600", "--max-queue-s", "600"],
     lambda r: r["rejected"] == 0),
    (["--kv-dtype", "int8"], lambda r: r["kv_pool_bytes"] > 0),
])
def test_feature_flags(capsys, flags, check):
    rc, report = _run(capsys, flags)
    assert rc == 0 and check(report)


def test_eval_scores_the_validation_rows(capsys):
    rc = serve_tool.main(["--config", YAML, "--device", "cpu", "--eval",
                          "--limit", "4", "--max-new", "4"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and report["rows"] == 4 and report["via"] == "engine"
    assert 0.0 <= report["score"] <= 1.0


class _TrippedHandler:
    received = True


def test_drive_drains_when_signal_handler_trips():
    cfg = load_yaml_config(YAML)
    model = cfg.model.instantiate(device="cpu")
    eng = DecodeEngine(model, build_serving_config(cfg),
                       generation=GenerationConfig(max_new_tokens=3),
                       device="cpu")
    out = serve_tool._drive(
        eng, [[3, 4, 5], [6, 7]], deadline_s=None, max_queue_s=None,
        drain_grace_s=None, handler=_TrippedHandler())
    assert out["drained"] is True
    states = {r.state.value for r in eng.requests.values()}
    assert states <= {"finished", "rejected"}
    assert eng.scheduler.draining and not eng.scheduler.has_work()
    assert eng.allocator.all_free
    rid = eng.submit([8, 9])
    assert eng.requests[rid].state.value == "rejected"
