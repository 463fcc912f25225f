"""The serving robustness layer of the port against the JAX package, on a
virtual clock: the same scenario through both engines (same weights, same
fault spec) gives the same outcome for every request (finished, expired,
rejected or aborted, and why), the same tokens and the same counters --
each shed policy, deadlines and queue TTLs, the admission budget check,
``sjf`` aging, ``max_preemptions`` pins, an abort during chunked prefill,
a watchdog recovery that stays token-identical, a real step failure that
recovers and then raises, and the drain under a grace period."""

import numpy as np
import pytest

from automodel_tpu_torch.serving import (
    RequestRejected,
    RequestState,
    ServingConfig,
    build_serving_config,
)
from automodel_tpu_torch.training.timers import (
    Timers,
    serve_expired_rate,
    serve_goodput_fraction,
    serve_shed_rate,
)
from tests.torch_serving_pair import (
    assert_same,
    build_models,
    make_engine,
    run_both,
    seeded_prompts,
    submit_all,
)

LENS = [9, 6, 13, 5]


@pytest.fixture(scope="module")
def models():
    return build_models()


def _prompts():
    return seeded_prompts(1, LENS)


def _rejections(eng):
    return [(r.rid, r.reason, r.policy) for r in eng.rejections]


def _drain_to_end(eng, clock, dt=0.0):
    while eng.scheduler.has_work():
        eng.step()
        clock.advance(dt)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["reject_newest", "reject_oldest",
                                    "by_deadline"])
def test_shed_policies_match_jax(models, policy):
    deadlines = [None, 9.0, 3.0, None, 5.0, 30.0, None]

    def scenario(eng, clock):
        for i, d in enumerate(deadlines):
            eng.submit(seeded_prompts(i, [4 + i])[0], deadline_s=d)
        shed_before_steps = _rejections(eng)
        _drain_to_end(eng, clock, dt=0.1)
        return shed_before_steps, _rejections(eng), eng.allocator.all_free

    res = run_both(models, scenario, max_num_seqs=2, max_waiting=2,
                   shed_policy=policy)
    assert_same(res)
    shed, _, all_free = res[1][1]
    assert shed and all_free
    assert all(r[1] == "queue_full" and r[2] == policy for r in shed)


def test_deadlines_ttls_and_budget_match_jax(models):
    def scenario(eng, clock):
        p = _prompts()
        rids = [eng.submit(p[0], deadline_s=2.0),
                eng.submit(p[1]),
                eng.submit(p[2], max_queue_s=0.5),
                eng.submit(p[3], deadline_s=50.0)]
        eng.step()
        clock.advance(1.0)            # r2's queue TTL runs out waiting
        eng.step()
        clock.advance(5.0)            # r0's deadline runs out mid-flight
        _drain_to_end(eng, clock, dt=0.25)
        # a step time observed (the virtual clock stands still inside a
        # step): the EWMA prices prefill, and a budget short of one step
        # expires at admission (reason budget)
        eng.scheduler.note_step_time(0.5)
        late = eng.submit(p[0], deadline_s=0.2)
        _drain_to_end(eng, clock)
        return ([eng.requests[r].finish_reason for r in rids + [late]],
                eng.completed_in_deadline(), eng.allocator.all_free)

    res = run_both(models, scenario, max_num_seqs=2)
    assert_same(res)
    reasons, met, all_free = res[1][1]
    assert reasons[0] == "deadline" and reasons[2] == "queue_ttl"
    assert reasons[4] == "budget" and all_free
    outcomes = res[1][2]["outcomes"]
    assert serve_expired_rate(outcomes) == 3 / 5
    assert serve_goodput_fraction(met, outcomes) == 2 / 5
    assert serve_shed_rate(outcomes) == 0.0


@pytest.mark.parametrize("aging", [1, 4, 32])
def test_sjf_aging_order_matches_jax(models, aging):
    def scenario(eng, clock):
        order = []
        long_rid = eng.submit(seeded_prompts(3, [30])[0], max_new_tokens=12)
        for i in range(6):
            eng.submit(seeded_prompts(10 + i, [4])[0], max_new_tokens=3)
            order += [r.rid for r in eng.step()]
        while eng.scheduler.has_work():
            order += [r.rid for r in eng.step()]
        return order, order.index(long_rid)

    res = run_both(models, scenario, max_num_seqs=1,
                   scheduler_policy="sjf", sjf_aging_steps=aging)
    assert_same(res)


def test_max_preemptions_pins_match_jax(models):
    def scenario(eng, clock):
        submit_all(eng, _prompts())
        eng.run()
        return ([r.pinned for r in eng.requests.values()],
                eng.allocator.all_free)

    res = run_both(models, scenario, num_kv_blocks=7, max_preemptions=1)
    assert_same(res)
    pinned, all_free = res[1][1]
    assert any(pinned) and all_free
    assert res[1][2]["pinned"] >= 1 and res[1][2]["preemptions"] >= 1


def test_abort_during_chunked_prefill_matches_jax(models):
    def scenario(eng, clock):
        rids = submit_all(eng, seeded_prompts(2, [30, 5, 7]))
        eng.step()                       # the long prompt's first chunk
        held = eng.allocator.used_blocks
        eng.abort(rids[0])
        freed_now = held - eng.allocator.used_blocks
        eng.abort(rids[0])               # a second abort is a no-op
        eng.run()
        return freed_now, eng.allocator.all_free

    res = run_both(models, scenario)
    assert_same(res)
    freed, all_free = res[1][1]
    assert freed > 0 and all_free
    assert res[1][2]["outcomes"] == {"aborted": 1, "finished": 2}


# ---------------------------------------------------------------------------
# watchdog and failures
# ---------------------------------------------------------------------------
@pytest.mark.fault
@pytest.mark.parametrize("at", [1, 3, 6])
def test_watchdog_stall_recovery_token_identical(models, at):
    def scenario(eng, clock):
        submit_all(eng, _prompts())
        eng.run()
        return ([r.pinned for r in eng.requests.values()],
                eng.allocator.all_free)

    res = run_both(models, scenario, fault=f"serve_watchdog_stall:{at}",
                   watchdog_s=10.0)
    assert_same(res)
    clean = run_both(models, scenario)
    assert {r: o[2] for r, o in res[1][0].items()} == \
        {r: o[2] for r, o in clean[1][0].items()}
    assert res[1][2]["watchdog_recoveries"] == 1


def test_watchdog_livelock_and_caller_pause(models):
    def scenario(eng, clock):
        submit_all(eng, _prompts())
        eng.step()
        clock.advance(60.0)           # a caller pause: not a wedge
        eng.step()
        pause_recoveries = eng.watchdog_recoveries
        eng.run()
        submit_all(eng, _prompts())
        # a leak drains the pool: nothing is schedulable, no progress
        stolen = eng.allocator.allocate(eng.allocator.free_blocks)
        empty = eng.step()
        clock.advance(60.0)
        eng.step()                    # recovers before this plan
        eng.allocator.free(stolen)
        eng.run()
        return pause_recoveries, empty, eng.allocator.all_free

    res = run_both(models, scenario, watchdog_s=10.0, num_kv_blocks=20)
    assert_same(res)
    assert res[1][1][0] == 0 and res[1][2]["watchdog_recoveries"] == 1


class _Broken:
    """Stands in for a step that fails on the device."""

    def __call__(self, *a, **k):
        raise RuntimeError("device halted")


def test_real_step_failure_recovers_then_raises(models):
    def scenario(eng, clock):
        submit_all(eng, _prompts())
        eng.step()
        if hasattr(eng, "step_fn"):           # the JAX engine
            real = eng.step_fn
            eng.step_fn = lambda width: _Broken()
        else:
            real = eng.model
            eng.model = _Broken()
        with pytest.raises(RuntimeError, match="device halted"):
            eng.step()
        state = (eng.watchdog_recoveries, eng.allocator.all_free,
                 sorted(r.state.value for r in eng.requests.values()))
        if hasattr(eng, "step_fn"):
            eng.step_fn = real
        else:
            eng.model = real
        eng.run()
        return state, eng.allocator.all_free

    res = run_both(models, scenario)
    assert_same(res)
    (recoveries, freed, states), _ = res[1][1]
    assert recoveries == 1 and freed and set(states) == {"waiting"}
    clean = run_both(models, lambda e, c: submit_all(e, _prompts())
                     and e.run() and None)
    assert {r: o[2] for r, o in res[1][0].items()} == \
        {r: o[2] for r, o in clean[1][0].items()}


# ---------------------------------------------------------------------------
# drain
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grace", [None, 0.0, 2.5])
def test_drain_matches_jax(models, grace):
    def scenario(eng, clock):
        active = submit_all(eng, seeded_prompts(4, [5, 4]))
        eng.submit([8, 9])
        eng.step()
        eng.step()
        parked = eng.requests[active[0]]
        eng.scheduler.requeue_for_replay(parked)    # admitted, parked
        step = eng.step

        def ticking():
            out = step()
            clock.advance(1.0)
            return out

        eng.step = ticking
        counts = eng.drain(grace)
        late = eng.submit([10, 11])
        return counts, eng.requests[late].state.value, _rejections(eng), \
            eng.allocator.all_free

    res = run_both(models, scenario, max_num_seqs=2, max_new=6)
    assert_same(res)
    counts, late, rejections, all_free = res[1][1]
    assert late == "rejected" and all_free
    assert all(r[1] == "draining" for r in rejections)
    if grace is None:
        assert counts == {"finished": 2, "rejected": 1}
    if grace == 0.0:
        assert counts.get("expired") == 2


def test_drain_timer_and_config_default(models):
    timers = Timers()
    eng = make_engine("port", models, drain_grace_s=3.0)
    eng.timers = timers
    submit_all(eng, _prompts())
    eng.step()
    assert eng.drain() == {"finished": 4}
    assert set(timers.get_elapsed()) >= {"serve_step", "serve_drain"}


# ---------------------------------------------------------------------------
# drills of the scheduler sites and typed rejections
# ---------------------------------------------------------------------------
@pytest.mark.fault
@pytest.mark.parametrize("point", ["serve_request_abort:3",
                                   "serve_deadline:2", "serve_shed:2",
                                   "serve_block_alloc:4"])
def test_scheduler_drills_match_jax(models, point):
    def scenario(eng, clock):
        submit_all(eng, _prompts())
        eng.run()
        return _rejections(eng), eng.allocator.all_free

    res = run_both(models, scenario, fault=point)
    assert_same(res)
    rejections, all_free = res[1][1]
    assert all_free
    outcomes = res[1][2]["outcomes"]
    name = point.split(":")[0]
    want = {"serve_request_abort": "aborted", "serve_deadline": "expired",
            "serve_shed": "rejected"}.get(name)
    if want:
        assert outcomes.get(want) == 1
    else:
        assert res[1][2]["preemptions"] >= 1
        assert outcomes == {"finished": 4}


def test_rejection_is_typed_and_generate_refuses_to_pad(models):
    eng = make_engine("port", models, max_num_seqs=1, max_waiting=1)
    submit_all(eng, _prompts())
    assert all(isinstance(r, RequestRejected) for r in eng.rejections)
    # one slot, one waiting place, nothing admitted before a step
    assert eng.rejections and eng.outcome_counts()["rejected"] == 3
    eng.run()
    with pytest.raises(RuntimeError, match="did not finish"):
        eng.generate(np.asarray([[3, 4, 5], [6, 7, 8], [9, 10, 11]]))
    assert eng.outcome_counts()["finished"] == 2
    assert RequestState.REJECTED.value in eng.outcome_counts()


@pytest.mark.parametrize("key,value,match", [
    ("scheduler_policy", "lifo", "scheduler_policy"),
    ("shed_policy", "random", "shed_policy"),
    ("max_waiting", 0, "max_waiting"),
    ("max_preemptions", -1, "max_preemptions"),
    ("sjf_aging_steps", True, "sjf_aging_steps"),
    ("drain_grace_s", 0, "drain_grace_s"),
    ("prefix_lru_blocks", "x", "prefix_lru_blocks"),
    ("spec_k", 0, "spec_k"),
    ("adapter_rank", 0, "adapter_rank"),
    ("tenant_quota", 0, "tenant_quota"),
    ("router_policy", "fastest", "router_policy"),
    ("fleet_probation_polls", 0, "fleet_probation_polls"),
])
def test_serving_config_validation(key, value, match):
    """Each bad value raises, naming its key, in the port as in JAX."""
    from automodel_tpu.serving import ServingConfig as JaxServingConfig

    with pytest.raises(ValueError, match=match):
        build_serving_config({key: value})
    with pytest.raises(ValueError, match=match):
        JaxServingConfig(**{key: value})


def test_every_jax_serving_key_is_accepted():
    from automodel_tpu.serving import ServingConfig as JaxServingConfig
    import dataclasses

    jax_keys = {f.name for f in dataclasses.fields(JaxServingConfig)}
    assert {f.name for f in dataclasses.fields(ServingConfig)} == jax_keys
    cfg = build_serving_config(dict(
        scheduler_policy="sjf", sjf_aging_steps=4, max_waiting=8,
        shed_policy="by_deadline", max_preemptions=2, watchdog_s=5,
        drain_grace_s=2.0, prefix_caching=True, prefix_lru_blocks=8,
        speculative=True, spec_k=3, max_adapters=4, adapter_rank=8,
        tenant_quota=2, replicas=1, router_policy="round_robin"))
    assert (cfg.prefix_caching, cfg.speculative) == ("on", "ngram")


def test_fault_points_are_registered_under_the_jax_names():
    """Every ``fault_point`` call site of the port names a point of its
    registry, the registry holds no point without a site, and each name is
    the JAX registry's for the same site."""
    import ast
    import pathlib

    from automodel_tpu.utils.fault_injection import (
        KNOWN_FAULT_POINTS as JAX_POINTS,
    )
    from automodel_tpu_torch.utils.fault_injection import KNOWN_FAULT_POINTS

    root = pathlib.Path(__file__).resolve().parents[1] / "automodel_tpu_torch"
    sites = set()
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "fault_point"):
                sites |= {n.value for a in node.args for n in ast.walk(a)
                          if isinstance(n, ast.Constant)
                          and isinstance(n.value, str)}
    assert sites == set(KNOWN_FAULT_POINTS)
    assert sites <= set(JAX_POINTS)
