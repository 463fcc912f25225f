"""The port's ``training/timers.py`` against the JAX package's on the same
inputs: the same script of timer calls under one fake clock gives the same
elapsed, mean, log line and cross-host stats; ``build_profiling_config``
gives the same config (the section's presence turns it on, unknown keys
raise); every fraction helper gives the same number.  ``trace`` writes a
Chrome trace on the CPU.
"""

import dataclasses
import json
import time

import pytest

from automodel_tpu.training import timers as jt
from automodel_tpu_torch.training import timers as pt


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _script(mod, clock):
    timers = mod.Timers()
    out = []
    for i in range(3):
        with timers.record("dispatch"):
            clock.t += 0.010 + i * 0.001
        t = timers("data_wait")
        t.start()
        clock.t += 0.002
        t.stop()
        clock.t += 0.5
    t = timers("data_wait")
    t.start()
    clock.t += 0.25
    t.discard()
    timers("ckpt_stall").add(0.125)
    timers("ckpt_stall").add(-1.0)
    running = timers("running")
    running.start()
    clock.t += 0.03
    out.append(timers.get_elapsed(reset=False))
    out.append(timers.get_elapsed(["dispatch", "missing"], reset=True,
                                  normalizer=3))
    clock.t += 0.01
    out.append(timers.get_elapsed(reset=False))
    out.append([timers(n).mean() for n in ("dispatch", "data_wait",
                                           "ckpt_stall", "running")])
    with timers.record("step_e2e"):
        clock.t += 0.2
    out.append(timers.log(reset=False, normalizer=2))
    out.append(timers.get_global_elapsed(["step_e2e", "nothing"],
                                         reset=False))
    timers("dispatch").reset()
    out.append(timers.get_elapsed(reset=True))

    class Writer:
        def __init__(self):
            self.rows = []

        def log(self, d, step):
            self.rows.append((d, step))

    w = Writer()
    timers.write(["running", "step_e2e"], w, iteration=7, reset=False)
    out.append(w.rows)
    return out


def test_timers_match_jax(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    theirs = _script(jt, clock)
    clock.t = 100.0
    ours = _script(pt, clock)
    assert ours == theirs


def test_barrier_timer_on_the_cpu():
    timers = pt.Timers(device="cpu")
    with timers.record("step_e2e", barrier=True):
        pass
    assert timers.get_elapsed()["step_e2e"] >= 0.0


@pytest.mark.parametrize("section", [
    None, {}, {"enabled": False}, {"log_interval": 5},
    {"barrier": True, "trace_dir": "/tmp/x", "trace_start_step": 4,
     "trace_stop_step": 6}, {"enabled": True, "log_interval": 1}])
def test_profiling_config_matches_jax(section):
    assert (dataclasses.asdict(pt.build_profiling_config(section))
            == dataclasses.asdict(jt.build_profiling_config(section)))


def test_unknown_profiling_keys_raise():
    for mod in (jt, pt):
        with pytest.raises(ValueError, match="unknown profiling keys"):
            mod.build_profiling_config({"log_every": 3})


ELAPSED = [{}, {"data_wait": 0.3, "data_staging": 0.2, "ckpt_stall": 1.5,
                "elastic_detect": 0.5, "elastic_rebuild": 2.0,
                "elastic_replay": 1.0, "ckpt_restore_storage": 3.0},
           {"data_wait": 9.0, "ckpt_stall": 0.1,
            "ckpt_restore_peer_ram": 0.25}]
OUTCOMES = [{}, {"completed": 7, "rejected": 2, "expired": 1},
            {"rejected": 3}]


@pytest.mark.parametrize("window", [0.0, -1.0, 2.0, 10.0])
@pytest.mark.parametrize("elapsed", ELAPSED)
def test_window_fractions_match_jax(elapsed, window):
    for name in ("input_idle_fraction", "ckpt_stall_fraction",
                 "goodput_fraction"):
        assert (getattr(pt, name)(elapsed, window)
                == getattr(jt, name)(elapsed, window)), name
    assert pt.recovery_time_s(elapsed) == jt.recovery_time_s(elapsed)
    assert (pt.restore_time_by_source(elapsed)
            == jt.restore_time_by_source(elapsed))


@pytest.mark.parametrize("outcomes", OUTCOMES)
def test_serving_rates_match_jax(outcomes):
    assert pt.serve_shed_rate(outcomes) == jt.serve_shed_rate(outcomes)
    assert pt.serve_expired_rate(outcomes) == jt.serve_expired_rate(outcomes)
    for done in (0, 5):
        assert (pt.serve_goodput_fraction(done, outcomes)
                == jt.serve_goodput_fraction(done, outcomes))


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
@pytest.mark.parametrize("pp, mb", [(1, 4), (2, 4), (4, 8), (8, 3)])
def test_pp_bubble_fraction_matches_jax(pp, mb, schedule):
    assert (pt.pp_bubble_fraction(pp, mb, schedule)
            == jt.pp_bubble_fraction(pp, mb, schedule))


def test_timer_name_tuples_match_jax():
    for name in ("INPUT_TIMERS", "CKPT_TIMERS", "ELASTIC_TIMERS",
                 "RESTORE_TIMERS", "SERVE_TIMERS"):
        assert getattr(pt, name) == getattr(jt, name)


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with pt.trace(str(tmp_path / "t")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "t" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
