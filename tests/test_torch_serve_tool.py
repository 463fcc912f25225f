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


JAX_YAML = os.path.join(REPO, "examples", "serve", "tiny_llama_serve.yaml")
FLEET_COUNTERS = ("replicas", "alive", "router_policy", "health_polls",
                  "replica_losses", "replays", "readmissions",
                  "fleet_rejected", "routed", "outcomes", "not_finished")


@pytest.fixture
def jax_serve_tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_serve_tool_under_test", os.path.join(REPO, "tools", "serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.fault
@pytest.mark.parametrize("policy", ["round_robin", "least_loaded"])
def test_fleet_drill_exits_and_counts_as_the_jax_tool(capsys, policy,
                                                     jax_serve_tool):
    """``--replicas 2 --drill-loss-at 3`` on the JAX package's tiny serve
    YAML through both tools, the port's model holding the JAX tool's
    weights (its ``init`` at the same seed): the same exit code (0), and
    the same fleet counters -- one loss, its replays, one readmission
    after probation, no fleet shed -- routing and outcomes."""
    import jax
    import numpy as np

    from automodel_tpu.config.loader import load_yaml_config as jax_load
    from automodel_tpu_torch.models.weights import load_jax_params

    argv = ["--config", JAX_YAML, "--requests", "8", "--max-new", "8",
            "--replicas", "2", "--router-policy", policy,
            "--drill-loss-at", "3"]
    jrc = jax_serve_tool.main(argv)
    jreport = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    params = jax.tree.map(np.asarray, jax_load(JAX_YAML).model.instantiate()
                          .init(jax.random.key(0)))
    model = load_yaml_config(JAX_YAML).model.instantiate(device="cpu")
    load_jax_params(model, params)
    out = serve_tool.serve(argv + ["--device", "cpu"], model=model)
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["rc"] == jrc == 0
    assert {k: report[k] for k in FLEET_COUNTERS} == \
        {k: jreport[k] for k in FLEET_COUNTERS}
    assert report["replica_losses"] == 1 and report["readmissions"] == 1
    assert report["replays"] >= 1 and report["fleet_rejected"] == 0
    assert out["engine"].all_free()
