"""The port's elastic serving fleet (``serving/fleet.py``) against the JAX
package's, scenario by scenario (the scenarios of
``tests/unit_tests/test_fleet.py``), on the same float32 weights of the
tiny Llama of ``tests/test_torch_llama.py`` (carried across by
``load_jax_params``), a virtual clock each and the same fault spec armed in
each package's registry.

Each scenario runs once through each package.  The comparison is exact:
every request's state, finish reason and greedy tokens, the replica each
request was routed to, the typed rejections, the events (their type and
replica), and the fleet counters (``replica_losses``, ``replays``,
``readmissions``, ``fleet_rejected``, ``health_polls``, the per-replica
steps and tokens).  The greedy tokens are also held against the JAX
package's dense ``generate()`` where the JAX test holds them so; measured
deviation: none (fp32 on both sides, the argmax never parts).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from automodel_tpu.checkpoint import replication as jrep
from automodel_tpu.generation import GenerationConfig as JaxGenerationConfig
from automodel_tpu.generation import generate as jax_generate
from automodel_tpu.serving import FleetRouter as JaxFleetRouter
from automodel_tpu.serving import Request as JaxRequest
from automodel_tpu.serving import Scheduler as JaxScheduler
from automodel_tpu.serving import ServingConfig as JaxServingConfig
from automodel_tpu.serving.kv_cache import BlockAllocator as JaxAllocator
from automodel_tpu.utils import elastic as jel
from automodel_tpu.utils import fault_injection as jfi
from automodel_tpu_torch.checkpoint import replication as trep
from automodel_tpu_torch.config.loader import (
    load_yaml_config,
    parse_args_and_load_config,
)
from automodel_tpu_torch.generation import GenerationConfig
from automodel_tpu_torch.serving import FleetRouter, Request, Scheduler
from automodel_tpu_torch.serving import ServingConfig, build_serving_config
from automodel_tpu_torch.serving.kv_cache import BlockAllocator
from automodel_tpu_torch.utils import elastic as tel
from automodel_tpu_torch.utils import fault_injection as tfi
from tests.torch_serving_pair import VirtualClock, build_models

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_YAML = os.path.join(REPO, "examples", "serve", "tiny_llama_serve.yaml")
LENS = [9, 6, 13, 5]
MAX_NEW = 8

# (package tag, fault registry, replication module, elastic module)
PKGS = (("jax", jfi, jrep, jel), ("port", tfi, trep, tel))


@pytest.fixture(scope="module")
def models():
    return build_models()


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(1)
    ids = np.zeros((len(LENS), max(LENS)), np.int64)
    for b, n in enumerate(LENS):
        ids[b, :n] = rng.integers(1, 255, n)
    return ids


@pytest.fixture(scope="module")
def dense_oracle(models, prompts):
    jm, params, _ = models
    return np.asarray(jax_generate(
        jm, params, prompts, prompt_lens=np.asarray(LENS),
        config=JaxGenerationConfig(max_new_tokens=MAX_NEW)))


@pytest.fixture(autouse=True)
def _clean():
    yield
    jrep.reset()
    trep.reset()
    jfi.reset_faults()
    tfi.reset_faults()


def _cfg(**kw):
    return dict(dict(kv_block_size=8, max_num_seqs=4, max_model_len=64,
                     prefill_chunk=8, replicas=2, fleet_probation_polls=2),
                **kw)


def make_fleet(tag, models, clock=None, coordinator=None, **kw):
    jm, params, tm = models
    extra = {"clock": clock or VirtualClock(), "coordinator": coordinator}
    if tag == "jax":
        return JaxFleetRouter(
            jm, params, JaxServingConfig(**_cfg(**kw)),
            generation=JaxGenerationConfig(max_new_tokens=MAX_NEW), **extra)
    return FleetRouter(tm, ServingConfig(**_cfg(**kw)),
                       generation=GenerationConfig(max_new_tokens=MAX_NEW),
                       device="cpu", **extra)


def summary(fleet):
    """What the two packages must agree on."""
    st = fleet.stats()
    per = {r: {k: v[k] for k in ("alive", "steps", "tokens_generated",
                                 "compiled_widths", "kv_blocks_free")}
           for r, v in st["per_replica"].items()}
    return {
        "requests": {rid: (r.state.value, r.finish_reason,
                           [int(t) for t in r.out_tokens])
                     for rid, r in fleet.requests.items()},
        "rejections": [(r.rid, r.reason) for r in fleet.rejections],
        "events": [(type(e).__name__, e.replica_id) for e in fleet.events],
        "stats": {k: st[k] for k in (
            "replicas", "alive", "router_policy", "health_polls",
            "replica_losses", "replays", "readmissions", "fleet_rejected",
            "routed", "outcomes", "per_tenant")},
        "per_replica": per,
        "all_free": fleet.all_free(),
    }


def run_both(models, scenario, monkeypatch=None, lost=None,
             coordinator=None, **kw):
    """``scenario(fleet, pkg, clock)`` on a fresh JAX fleet, then on a
    fresh port fleet (``coordinator()`` gives each its own); returns
    ``[(summary, scenario's value, fleet), ...]`` JAX first and asserts the
    two agree."""
    out = []
    if lost is not None:
        monkeypatch.setenv("AUTOMODEL_LOST_REPLICA", str(lost))
    for pkg in PKGS:
        clock = VirtualClock()
        fleet = make_fleet(pkg[0], models, clock=clock,
                           coordinator=coordinator and coordinator(), **kw)
        try:
            value = scenario(fleet, pkg, clock)
        finally:
            pkg[1].reset_faults()
        out.append((summary(fleet), value, fleet))
    (js, jv, _), (ts, tv, _) = out
    assert ts == js
    assert tv == jv
    return out


def armed(pkg, spec, fn):
    """Run ``fn()`` with ``spec`` armed in ``pkg``'s fault registry."""
    pkg[1].configure_faults(spec)
    try:
        return fn()
    finally:
        pkg[1].reset_faults()


def submit_all(fleet, prompts, **kw):
    return [fleet.submit(prompts[b, :LENS[b]], **kw)
            for b in range(len(LENS))]


def assert_rows_match(fleet, rids, dense_oracle):
    for b, rid in enumerate(rids):
        req = fleet.requests[rid]
        assert req.state.value == "finished", (b, req.state)
        np.testing.assert_array_equal(np.asarray(req.out_tokens),
                                      dense_oracle[b])


# ---------------------------------------------------------------------------
# routing and the fleet-level shed
# ---------------------------------------------------------------------------
def test_round_robin_routes_as_jax(models, prompts):
    def scenario(fleet, pkg, clock):
        submit_all(fleet, prompts)
        return fleet.stats()["routed"]

    _, (_, routed, _) = run_both(models, scenario)
    assert routed == {0: 2, 1: 2}


def test_least_loaded_routes_as_jax(models, prompts):
    def scenario(fleet, pkg, clock):
        submit_all(fleet, prompts)
        first = dict(fleet.stats()["routed"])
        fleet.replicas[1].engine.scheduler.waiting.clear()
        fleet.submit(prompts[0, :LENS[0]])
        return first, fleet.replicas[1].routed

    _, (_, (first, r1), _) = run_both(models, scenario,
                                      router_policy="least_loaded")
    assert first == {0: 2, 1: 2} and r1 == 3


def test_by_deadline_routes_as_jax(models, prompts):
    def scenario(fleet, pkg, clock):
        for b in range(3):
            fleet.submit(prompts[b, :LENS[b]])
        fleet.submit(prompts[3, :LENS[3]], deadline_s=5.0)
        return [r.routed for r in fleet.replicas]

    _, (_, routed, _) = run_both(models, scenario,
                                 router_policy="by_deadline")
    assert routed == [2, 2]


def test_fleet_full_sheds_typed_as_jax(models, prompts):
    def scenario(fleet, pkg, clock):
        rids = [fleet.submit(prompts[b, :LENS[b]]) for b in range(3)]
        return [fleet.requests[r].state.value for r in rids]

    _, (s, states, _) = run_both(models, scenario, max_waiting=1)
    assert states == ["waiting", "waiting", "rejected"]
    assert s["rejections"] == [(2, "fleet_full")]
    assert s["stats"]["fleet_rejected"] == 1


@pytest.mark.fault
def test_fleet_route_fault_is_typed_as_jax(models, prompts, dense_oracle):
    def scenario(fleet, pkg, clock):
        r0 = armed(pkg, "fleet_route:1",
                   lambda: fleet.submit(prompts[0, :LENS[0]]))
        r1 = fleet.submit(prompts[1, :LENS[1]])
        fleet.run()
        return r0, r1

    _, (s, (r0, r1), fleet) = run_both(models, scenario)
    assert s["requests"][r0][:2] == ("rejected", "route(injected)")
    assert s["rejections"] == [(r0, "route(injected)")]
    np.testing.assert_array_equal(
        np.asarray(fleet.requests[r1].out_tokens), dense_oracle[1])
    assert s["all_free"]


# ---------------------------------------------------------------------------
# the scheduler and engine seams
# ---------------------------------------------------------------------------
def test_adopt_replay_keeps_submit_time_as_jax():
    """``Scheduler.adopt_replay`` in both packages: ``submit_time`` kept,
    ``num_computed`` reset, pinned and WAITING, the adopting scheduler's
    arrival stamp, the deadline budget already spent carried over."""
    got = []
    for sched_cls, alloc_cls, req_cls in (
            (JaxScheduler, JaxAllocator, JaxRequest),
            (Scheduler, BlockAllocator, Request)):
        clock = VirtualClock()
        a, b = (sched_cls(alloc_cls(64), max_num_seqs=2, prefill_chunk=4,
                          block_size=4, max_model_len=64, clock=clock)
                for _ in range(2))
        req = req_cls(rid=7, prompt=[1, 2, 3, 4], max_new_tokens=4,
                      deadline_s=10.0)
        a.add(req)
        t_submit = req.submit_time
        req.was_admitted = True
        req.num_computed = 3
        req.out_tokens.extend([5, 6])
        clock.advance(4.0)
        a._release(req)
        b.add(req_cls(rid=8, prompt=[1], max_new_tokens=1))
        b.adopt_replay(req)
        got.append((req.submit_time == t_submit, req.num_computed,
                    req.pinned, req.state.value, req in b.waiting,
                    req in a.waiting, req.arrival, list(req.out_tokens),
                    req.remaining_budget(clock())))
    assert got[1] == got[0]
    assert got[0] == (True, 0, True, "waiting", True, False, 1, [5, 6], 6.0)


def test_harvest_for_replay_frees_every_block_as_jax(models, prompts):
    def scenario(fleet, pkg, clock):
        submit_all(fleet, prompts)
        for _ in range(3):
            fleet.step()
        eng = fleet.replicas[0].engine
        held = not eng.allocator.all_free
        harvested = eng.harvest_for_replay()
        return (held, [r.rid for r in harvested], eng.allocator.all_free,
                len(eng.requests),
                [(r.num_computed, list(r.blocks), len(r.out_tokens),
                  r.was_admitted) for r in harvested])

    _, (_, value, _) = run_both(models, scenario)
    held, rids, free, left, rows = value
    assert held and rids and free and left == 0
    assert all(r[0] == 0 and r[1] == [] for r in rows)


# ---------------------------------------------------------------------------
# losses, replays and grow-back
# ---------------------------------------------------------------------------
@pytest.mark.fault
def test_replay_mid_decode_is_token_identical_as_jax(models, prompts,
                                                     dense_oracle,
                                                     monkeypatch):
    def scenario(fleet, pkg, clock):
        rid = fleet.submit(prompts[0, :LENS[0]])
        for _ in range(4):
            fleet.step()
        before = list(fleet.requests[rid].out_tokens)
        ev = armed(pkg, "fleet_replica_loss:1",
                   lambda: fleet.poll_health(step=4))
        fleet.run()
        return (rid, before, type(ev).__name__, ev.replica_id,
                rid in fleet.replicas[1].engine.requests)

    _, (s, v, fleet) = run_both(models, scenario, monkeypatch, lost=0,
                                router_policy="least_loaded")
    rid, before, ev, victim, on_b = v
    assert (ev, victim, on_b) == ("ReplicaLostError", 0, True)
    assert before and fleet.requests[rid].out_tokens[:len(before)] == before
    assert_rows_match(fleet, [rid], dense_oracle)
    assert s["stats"]["replays"] == 1 and s["all_free"]


@pytest.mark.fault
def test_replay_mid_chunked_prefill_is_token_identical_as_jax(
        models, prompts, dense_oracle, monkeypatch):
    def scenario(fleet, pkg, clock):
        rid = fleet.submit(prompts[2, :LENS[2]])       # 13 > chunk 8
        fleet.step()
        req = fleet.requests[rid]
        mid = (req.was_admitted, req.num_computed, len(req.out_tokens))
        armed(pkg, "fleet_replica_loss:1", lambda: fleet.poll_health(step=1))
        fleet.run()
        return rid, mid

    _, (s, (rid, mid), fleet) = run_both(models, scenario, monkeypatch,
                                         lost=0,
                                         router_policy="least_loaded")
    assert mid == (True, 8, 0)
    np.testing.assert_array_equal(
        np.asarray(fleet.requests[rid].out_tokens), dense_oracle[2])
    assert s["all_free"]


@pytest.mark.fault
def test_admit_fault_keeps_the_fleet_serving_shrunk_as_jax(
        models, prompts, dense_oracle):
    def scenario(fleet, pkg, clock):
        armed(pkg, "fleet_replica_loss:1", lambda: fleet.poll_health(step=0))
        fleet.note_return(1)
        armed(pkg, "fleet_replica_admit:1",
              lambda: [fleet.poll_health(step=p) for p in range(1, 4)])
        shrunk = fleet.replicas[1].alive
        rids = submit_all(fleet, prompts)
        fleet.run()
        fleet.note_return(1)
        for p in range(4, 4 + fleet.probation_polls):
            fleet.poll_health(step=p)
        return shrunk, rids, fleet.replicas[1].alive

    _, (s, (shrunk, rids, healed), fleet) = run_both(models, scenario)
    assert not shrunk and healed
    assert [e[0] for e in s["events"]] == [
        "ReplicaLostError", "ReplicaAdmitError", "ReplicaReturnedError"]
    assert_rows_match(fleet, rids, dense_oracle)
    assert s["all_free"]


@pytest.mark.fault
def test_drill_loss_replay_shed_heal_as_jax(models, prompts, dense_oracle):
    """The JAX fleet drill: loss mid-decode, replay on the survivor, typed
    shed while shrunk, probation, admission from digest-verified live
    params, new traffic on both replicas; the same events and counters in
    both packages, and the admitted port engine's weights equal its peer's
    bit for bit."""
    def scenario(fleet, pkg, clock):
        rids = submit_all(fleet, prompts, deadline_s=120.0)
        for _ in range(3):
            fleet.step()
            clock.advance(0.05)
        armed(pkg, "fleet_replica_loss:1", lambda: fleet.poll_health(step=3))
        dead_free = fleet.replicas[1].engine.allocator.all_free
        shed = [fleet.submit(prompts[0, :LENS[0]]) for _ in range(4)]
        fleet.run()
        fleet.note_return(1)
        for p in range(4, 4 + fleet.probation_polls):
            fleet.poll_health(step=p)
        syncs = fleet.replicas[1].engine.weight_syncs
        routed_before = fleet.replicas[1].routed
        rids2 = submit_all(fleet, prompts)
        fleet.run()
        fleet.teardown()
        return (rids, rids2, dead_free, shed, syncs,
                fleet.replicas[1].routed > routed_before,
                pkg[2].live_stores_snapshot())

    _, (s, v, fleet) = run_both(models, scenario, max_waiting=2)
    rids, rids2, dead_free, shed, syncs, grew, stores = v
    assert dead_free and syncs == 1 and grew and stores == {}
    assert "rejected" in [s["requests"][r][0] for r in shed]
    assert [e[0] for e in s["events"]] == ["ReplicaLostError",
                                           "ReplicaReturnedError"]
    assert s["stats"]["replica_losses"] == 1
    assert s["stats"]["readmissions"] == 1 and s["stats"]["replays"] > 0
    assert_rows_match(fleet, rids, dense_oracle)
    assert_rows_match(fleet, rids2, dense_oracle)
    assert s["all_free"]
    peer, new = (trep.serialize_tree(r.engine.model.state_dict())
                 for r in fleet.replicas)
    assert {k: d[0] for k, d in new.items()} == \
        {k: d[0] for k, d in peer.items()}
    assert fleet.replicas[1].engine.model is not fleet.replicas[0].engine.model


# ---------------------------------------------------------------------------
# a duck-typed coordinator
# ---------------------------------------------------------------------------
class _FakeCoordinator:
    def __init__(self):
        self.polls = 0
        self.raise_exc = None
        self.ready = None
        self.admitted = []

    def poll(self, step):
        self.polls += 1
        if self.raise_exc is not None:
            exc, self.raise_exc = self.raise_exc, None
            raise exc

    def ready_to_readmit(self):
        return self.ready

    def admit(self, slice_id, step):
        self.admitted.append(slice_id)
        self.ready = None


def test_coordinator_rpc_error_propagates_as_jax(models):
    got = []
    for pkg in PKGS:
        coord = _FakeCoordinator()
        fleet = make_fleet(pkg[0], models, coordinator=coord)
        coord.raise_exc = RuntimeError("connection reset by peer")
        with pytest.raises(RuntimeError, match="connection reset"):
            fleet.poll_health(step=0)
        got.append(([r.alive for r in fleet.replicas], fleet.replica_losses))
    assert got[1] == got[0] == ([True, True], 0)


def test_coordinator_slice_loss_maps_to_its_replica_as_jax(
        models, prompts, dense_oracle):
    def scenario(fleet, pkg, clock):
        coord = fleet.coordinator
        rids = submit_all(fleet, prompts)
        fleet.step()
        coord.raise_exc = pkg[3].SliceLostError(
            0, "heartbeat deadline missed", 1)
        ev = fleet.poll_health(step=1)
        lost = (type(ev).__name__, ev.replica_id,
                [r.alive for r in fleet.replicas])
        fleet.run()
        coord.ready = 0
        ev = fleet.poll_health(step=2)
        return rids, lost, type(ev).__name__, coord.admitted

    _, (ts, tv, fleet) = run_both(models, scenario,
                                  coordinator=_FakeCoordinator)
    rids, lost, back, admitted = tv
    assert lost == ("ReplicaLostError", 0, [False, True])
    assert (back, admitted) == ("ReplicaReturnedError", [0])
    assert_rows_match(fleet, rids, dense_oracle)
    assert ts["all_free"]


# ---------------------------------------------------------------------------
# the live-params transport (checkpoint/replication.py)
# ---------------------------------------------------------------------------
def _trees():
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    b = np.ones((4,), np.float32)
    return ({"w": w, "b": b},
            {"w": torch.from_numpy(w.copy()), "b": torch.from_numpy(b.copy())})


def _jax_abstract(tree):
    return jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        tree)


def test_live_params_push_fetch_and_flipped_byte_as_jax(tmp_path):
    """Push, fetch (digest-verified, equal bytes), a version pin that
    moved, and one flipped byte of one shard: the fetch gives None in both
    packages; the catalog mirror names the same digests."""
    jt, tt = _trees()
    je = jrep.push_live_params(replica_id=0, params=jt, version=3,
                               catalog_dir=str(tmp_path / "jax"))
    te = trep.push_live_params(replica_id=0, params=tt, version=3,
                               catalog_dir=str(tmp_path / "port"))
    assert trep.live_stores_snapshot() == jrep.live_stores_snapshot() == \
        {0: (3, 2)}
    assert te.shards["w"][0] == je.shards["['w']"][0]
    assert te.shards["b"][0] == je.shards["['b']"][0]
    for sub in ("jax", "port"):
        assert (tmp_path / sub / f"{trep.LIVE_CATALOG_FILE_PREFIX}.r0.json"
                ).exists()
    got = trep.fetch_live_params(abstract=tt, replica_id=0, version=3)
    assert got is not None and torch.equal(got["w"], tt["w"])
    jgot = jrep.fetch_live_params(abstract=_jax_abstract(jt), replica_id=0,
                                  version=3)
    np.testing.assert_array_equal(got["w"].numpy(), jgot["w"])
    assert trep.fetch_live_params(abstract=tt, replica_id=0,
                                  version=4) is None
    assert jrep.fetch_live_params(abstract=_jax_abstract(jt), replica_id=0,
                                  version=4) is None
    for entry, key in ((te, "w"), (je, "['w']")):
        digest, buf, dtype, shape = entry.shards[key]
        flipped = bytearray(buf)
        flipped[5] ^= 0x01
        entry.shards[key] = (digest, bytes(flipped), dtype, shape)
    assert trep.fetch_live_params(abstract=tt, replica_id=0) is None
    assert jrep.fetch_live_params(abstract=_jax_abstract(jt),
                                  replica_id=0) is None


def test_drop_live_params_retracts_the_advertisement_as_jax(tmp_path):
    jt, tt = _trees()
    got = []
    for mod, tree, abstract in ((jrep, jt, _jax_abstract(jt)),
                                (trep, tt, tt)):
        d = tmp_path / mod.__name__.split(".")[0]
        mod.push_live_params(replica_id=2, params=tree, version=1,
                             catalog_dir=str(d))
        mirror = d / f"{mod.LIVE_CATALOG_FILE_PREFIX}.r2.json"
        before = mirror.exists()
        dropped = mod.drop_live_params(2, catalog_dir=str(d))
        got.append((before, dropped, mod.live_stores_snapshot(),
                    mirror.exists(),
                    mod.fetch_live_params(abstract=abstract,
                                          replica_id=2) is None,
                    mod.drop_live_params(2)))
    assert got[1] == got[0] == (True, True, {}, False, True, False)


@pytest.mark.fault
def test_replica_loss_retracts_its_advertisement_as_jax(models,
                                                        monkeypatch):
    monkeypatch.setenv("AUTOMODEL_LOST_REPLICA", "0")
    jm, params, tm = models
    got = []
    for pkg, tree in ((PKGS[0], jax.tree.map(np.asarray, params)),
                      (PKGS[1], tm.state_dict())):
        fleet = make_fleet(pkg[0], models)
        pkg[2].push_live_params(replica_id=0, params=tree, version=0)
        before = 0 in pkg[2].live_stores_snapshot()
        armed(pkg, "fleet_replica_loss:1", lambda: fleet.poll_health(step=0))
        got.append((before, 0 in pkg[2].live_stores_snapshot()))
    assert got[1] == got[0] == (True, False)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw,match", [
    (dict(router_policy="fastest"), "router_policy"),
    (dict(replicas=0), "replicas"),
    (dict(fleet_probation_polls=-1), "fleet_probation_polls"),
    (dict(fleet_probation_polls=1.5), "fleet_probation_polls"),
])
def test_fleet_config_refusals_as_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        JaxServingConfig(**kw)
    with pytest.raises(ValueError, match=match):
        ServingConfig(**kw)


def test_fleet_config_normalization_as_jax():
    kw = dict(replicas="null", router_policy="none", fleet_probation_polls=4)
    j, t = JaxServingConfig(**kw), ServingConfig(**kw)
    for f in ("replicas", "router_policy", "fleet_probation_polls"):
        assert getattr(t, f) == getattr(j, f)
    assert (t.replicas, t.router_policy, t.fleet_probation_polls) == \
        (None, None, 4)
    assert {f.name for f in dataclasses.fields(ServingConfig)} == \
        {f.name for f in dataclasses.fields(JaxServingConfig)}


def test_fleet_knobs_validated_at_load_and_after_cli_override(tmp_path):
    """A bad ``serving.router_policy`` fails at YAML load and again after a
    CLI override, naming the field; bad counts fail when the serving
    config is built from the loaded YAML (the serve tool's path)."""
    p = tmp_path / "bad.yaml"
    p.write_text("serving:\n  router_policy: fastest\n")
    with pytest.raises(ValueError, match=r"serving\.router_policy"):
        load_yaml_config(str(p))
    for text, field in (("serving:\n  replicas: 0\n", "replicas"),
                        ("serving:\n  fleet_probation_polls: 1.5\n",
                         "fleet_probation_polls")):
        p.write_text(text)
        with pytest.raises(ValueError, match=field):
            build_serving_config(load_yaml_config(str(p)))
    cfg = parse_args_and_load_config(
        ["--config", TINY_YAML, "--serving.router_policy", "by_deadline",
         "--serving.replicas", "2"])
    scfg = build_serving_config(cfg)
    assert (scfg.router_policy, scfg.replicas) == ("by_deadline", 2)
    with pytest.raises(ValueError, match=r"serving\.router_policy"):
        parse_args_and_load_config(
            ["--config", TINY_YAML, "--serving.router_policy", "fastest"])
    with pytest.raises(ValueError, match=r"serving\.replicas"):
        build_serving_config(parse_args_and_load_config(
            ["--config", TINY_YAML, "--serving.replicas", "0"]))
