"""The elastic serving fleet: N decode engines in one process behind a
router that survives the loss of a replica (counterpart:
``automodel_tpu/serving/fleet.py``).

* **Routing and fleet-level admission.**  The router owns the request ids:
  it builds each :class:`~automodel_tpu_torch.serving.scheduler.Request`
  and hands it to an engine (``DecodeEngine.submit_request``), so a
  request can move between engines after a loss.  ``serving.router_policy``
  picks the replica: ``round_robin`` cycles the live ones, ``least_loaded``
  takes the fewest resident requests (ties to the lowest id),
  ``by_deadline`` sends requests with a deadline least-loaded and the rest
  round-robin.  Every engine shares one clock, so deadlines compare across
  replicas.  When every live replica's queue is full
  (``serving.max_waiting``) the router sheds a typed
  :class:`RequestRejected` (reason ``fleet_full``), never an exception.
* **Loss and replay.**  :meth:`FleetRouter.poll_health` renders the loss
  verdict: the ``fleet_replica_loss`` fault point drills it, and an
  attached coordinator's ``SliceLostError`` names the slice, whose replica
  is lost (any other error out of the coordinator propagates).  The lost
  replica's advertisement is retracted, its unfinished requests are
  harvested (its allocator ends ``all_free``), the admitted ones replay on
  the least-loaded survivor (``Scheduler.adopt_replay``: pinned,
  ``num_computed`` reset, tokens and ``submit_time`` kept; the replay
  re-prefills prompt + tokens so far) and the queued ones re-route.
  :meth:`FleetRouter.step` does not catch: a failing engine step ends the
  drive.
* **Grow-back.**  A returning replica (:meth:`note_return`) must pass
  ``serving.fleet_probation_polls`` consecutive polls (a flap restarts
  the streak).  Admission (drilled by ``fleet_replica_admit``) warms a
  fresh engine from a live peer: the peer's ``state_dict`` goes through
  ``checkpoint/replication.py`` as sha256-checked bytes into a new model
  module of the same structure (its tensors allocated, not copied), the
  peer's adapter slots are cloned, and one warm-up token runs before
  traffic.  A failure is a typed :class:`ReplicaAdmitError` in ``events``;
  the fleet serves on, shrunk.

How replicas hold weights: the N replicas built at start share the one
model module given, as the JAX replicas share one params tree (a replica
is an engine: its KV pools, scheduler and step state); an admitted
replica holds its own module, equal to its peer's bit for bit.  A loss or
an admission never writes a weight another replica reads.  ``stats()``
reports the weights' bytes on the device, each tensor counted once.
"""

from __future__ import annotations

import copy
import itertools
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from automodel_tpu_torch.generation.generate import GenerationConfig
from automodel_tpu_torch.serving.engine import DecodeEngine, ServingConfig
from automodel_tpu_torch.serving.kv_cache import (
    blocks_needed,
    normalize_null_spelling,
)
from automodel_tpu_torch.serving.scheduler import (
    Request,
    RequestRejected,
    RequestState,
)
from automodel_tpu_torch.utils.elastic import (
    ReplicaAdmitError,
    ReplicaLostError,
    ReplicaReturnedError,
    SliceLostError,
)
from automodel_tpu_torch.utils.fault_injection import (
    InjectedFault,
    fault_point,
)

logger = logging.getLogger(__name__)

ROUTER_POLICIES = ("round_robin", "least_loaded", "by_deadline")
DEFAULT_ROUTER_POLICY = "round_robin"

# consecutive polls a returning replica must pass before admission
# (``serving.fleet_probation_polls``)
DEFAULT_FLEET_PROBATION_POLLS = 3

# which replica a drilled ``fleet_replica_loss`` loses (default: the
# highest-id live one)
LOST_REPLICA_ENV = "AUTOMODEL_LOST_REPLICA"


def normalize_router_policy(v):
    return normalize_null_spelling(v)


def validate_router_policy(v: Optional[str]) -> Optional[str]:
    if v is None:
        return None
    if v not in ROUTER_POLICIES:
        raise ValueError(
            f"serving.router_policy must be one of {list(ROUTER_POLICIES)} "
            f"(or null for the default), got {v!r}")
    return v


def fresh_model(model: nn.Module) -> nn.Module:
    """A module of ``model``'s structure whose ``state_dict`` tensors are
    newly allocated and uninitialized (the weights are not copied; the
    buffers outside the ``state_dict``, rope tables, are)."""
    memo: Dict[int, Any] = {}
    for t in model.state_dict(keep_vars=True).values():
        if id(t) not in memo:
            e = torch.empty_like(t)
            memo[id(t)] = (nn.Parameter(e, requires_grad=t.requires_grad)
                           if isinstance(t, nn.Parameter) else e)
    return copy.deepcopy(model, memo)


def weight_bytes(models) -> int:
    """Bytes of the ``state_dict`` tensors of ``models``, each storage
    counted once (replicas that share a module share its weights)."""
    seen = set()
    total = 0
    for m in models:
        for t in m.state_dict().values():
            key = (t.device, t.untyped_storage().data_ptr())
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
    return total


class Replica:
    """One fleet member: an engine and its liveness and routing counts.
    ``retired_steps`` / ``retired_kernel_launches`` keep the steps and
    paged-decode launches of the engines this replica held before an
    admission replaced them."""

    def __init__(self, replica_id: int, engine: DecodeEngine):
        self.replica_id = replica_id
        self.engine = engine
        self.alive = True
        self.losses = 0
        self.admissions = 0
        self.routed = 0
        self.retired_steps = 0
        self.retired_kernel_launches = 0

    @property
    def load(self) -> int:
        """Resident requests (waiting + active): the least_loaded key."""
        s = self.engine.scheduler
        return len(s.waiting) + len(s.active)


class FleetRouter:
    """Host-side router over ``serving.replicas`` decode engines of one
    model (shared, see the module note) on one clock.  ``device``,
    ``sample_seed`` and ``attn_impl`` reach every engine, as
    ``DecodeEngine``'s; ``coordinator`` is duck-typed (``poll(step)``,
    ``ready_to_readmit()``, ``admit(slice_id, step)``)."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 generation: Optional[GenerationConfig] = None, *,
                 device=None, sample_seed: int = 0,
                 attn_impl: str = "kernel",
                 clock: Callable[[], float] = time.monotonic,
                 timers=None, coordinator=None):
        self.config = config or ServingConfig()
        self.generation = generation or GenerationConfig()
        self.clock = clock
        self.timers = timers
        self.coordinator = coordinator
        self.policy = self.config.router_policy or DEFAULT_ROUTER_POLICY
        self.probation_polls = (self.config.fleet_probation_polls
                                or DEFAULT_FLEET_PROBATION_POLLS)
        self._engine_kw = dict(device=device, sample_seed=sample_seed,
                               attn_impl=attn_impl, clock=clock,
                               timers=timers)
        n = self.config.replicas or 1
        self.replicas = [Replica(i, self._engine(model)) for i in range(n)]
        self.requests: Dict[int, Request] = {}
        self.rejections: List[RequestRejected] = []
        self.events: List[Any] = []
        self._rids = itertools.count()
        self._rr = itertools.count()
        self._probation: Dict[int, int] = {}
        self._returning: set = set()
        self.health_polls = 0
        self.replica_losses = 0
        self.replays = 0
        self.readmissions = 0
        self.fleet_rejected = 0

    def _engine(self, model) -> DecodeEngine:
        return DecodeEngine(model, self.config, generation=self.generation,
                            **self._engine_kw)

    # -- topology ----------------------------------------------------------
    @property
    def alive_replicas(self) -> List[Replica]:
        return [r for r in self.replicas if r.alive]

    def _replica_for_slice(self, slice_id: int) -> Optional[Replica]:
        """Replica i serves slice i."""
        if 0 <= int(slice_id) < len(self.replicas):
            return self.replicas[int(slice_id)]
        return None

    def _drilled_lost_replica(self) -> Optional[Replica]:
        env = os.environ.get(LOST_REPLICA_ENV)
        if env is not None:
            rep = self.replicas[int(env)]
            return rep if rep.alive else None
        alive = self.alive_replicas
        return alive[-1] if alive else None

    # -- intake and routing ------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = "default",
               deadline_s: Optional[float] = None,
               max_queue_s: Optional[float] = None,
               adapter_id: int = 0) -> int:
        """Build one request and route it; returns its fleet-wide id.  The
        intake contract of ``DecodeEngine.submit``: a load drop is a typed
        rejection in ``self.rejections``.  ``adapter_id`` rides the request
        across a replica move (every replica serves the same slots,
        :meth:`load_adapter`)."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("cannot serve an empty prompt")
        if eos_token_id == "default":
            eos_token_id = self.generation.eos_token_id
        if adapter_id != 0:
            alive = self.alive_replicas
            if not alive or alive[0].engine.adapter_slots is None \
                    or not alive[0].engine.adapter_slots.is_loaded(adapter_id):
                raise ValueError(
                    f"adapter_id={adapter_id} is not loaded on the fleet -- "
                    "load it first (FleetRouter.load_adapter)")
        req = Request(
            rid=next(self._rids), prompt=prompt,
            max_new_tokens=(self.generation.max_new_tokens
                            if max_new_tokens is None else max_new_tokens),
            eos_token_id=eos_token_id, deadline_s=deadline_s,
            max_queue_s=max_queue_s, adapter_id=int(adapter_id))
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.requests[req.rid] = req
        self._route(req)
        return req.rid

    def load_adapter(self, slot: int, adapters, *, name=None,
                     scale: float = 1.0) -> Dict[int, Any]:
        """Load or hot-swap ``slot`` on every live replica (a lost one
        clones a live peer's slots at admission)."""
        return {r.replica_id: r.engine.load_adapter(slot, adapters,
                                                    name=name, scale=scale)
                for r in self.alive_replicas}

    def remove_adapter(self, slot: int) -> None:
        for r in self.alive_replicas:
            r.engine.remove_adapter(slot)

    def _queue_room(self, replica: Replica) -> bool:
        """``Scheduler.add``'s shed trigger: a waiting list at
        ``max_waiting`` is full."""
        mw = self.config.max_waiting
        return mw is None or len(replica.engine.scheduler.waiting) < mw

    def _pick(self, open_: List[Replica], req: Request) -> Replica:
        if self.policy == "least_loaded" or (
                self.policy == "by_deadline" and req.deadline_s is not None):
            return min(open_, key=lambda r: (r.load, r.replica_id))
        ranked = sorted(open_, key=lambda r: r.replica_id)
        return ranked[next(self._rr) % len(ranked)]

    def _route(self, req: Request, preserve_submit_time: bool = False) -> None:
        """Route one WAITING request to a live replica with queue room, or
        shed it typed.  ``preserve_submit_time`` keeps a re-routed row's
        original stamp (its deadline and TTL do not restart)."""
        try:
            fault_point("fleet_route")
        except InjectedFault:
            self._reject_fleet(req, "route(injected)")
            return
        alive = self.alive_replicas
        if not alive:
            self._reject_fleet(req, "no_replicas")
            return
        open_ = [r for r in alive if self._queue_room(r)]
        if not open_:
            self._reject_fleet(req, "fleet_full")
            return
        target = self._pick(open_, req)
        orig_submit = req.submit_time
        rejected = target.engine.submit_request(req)
        if preserve_submit_time:
            req.submit_time = orig_submit
        target.routed += 1
        self.rejections.extend(rejected)

    def _reject_fleet(self, req: Request, reason: str) -> None:
        req.state = RequestState.REJECTED
        req.finish_reason = reason
        req.finish_time = self.clock()
        self.fleet_rejected += 1
        self.rejections.append(
            RequestRejected(rid=req.rid, reason=reason, policy=self.policy))

    def abort(self, rid: int) -> None:
        req = self.requests.get(rid)
        if req is None or req.finished:
            return
        for rep in self.replicas:
            if rid in rep.engine.requests:
                rep.engine.abort(rid)
                return

    # -- the fleet loop ----------------------------------------------------
    def step(self) -> List[Request]:
        """One step on every live replica; returns the requests that
        finished.  No exception is caught here."""
        done: List[Request] = []
        for rep in self.replicas:
            if rep.alive:
                done.extend(rep.engine.step())
        return done

    def has_work(self) -> bool:
        return any(r.alive and r.engine.scheduler.has_work()
                   for r in self.replicas)

    def run(self, max_steps: Optional[int] = None) -> Dict[int, List[int]]:
        """Step until every request is terminal; returns rid -> tokens (the
        stall bound of ``DecodeEngine.run``)."""
        if max_steps is None:
            budget = sum(
                blocks_needed(len(r.prompt), self.config.prefill_chunk)
                + r.max_new_tokens + 1
                for r in self.requests.values() if not r.finished)
            max_steps = 64 + 8 * budget
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"fleet made no progress within {max_steps} steps -- "
                    "scheduler stall")
        return {rid: list(r.out_tokens) for rid, r in self.requests.items()}

    def drain(self, grace_s=None) -> Dict[str, int]:
        """Drain every live replica, then retract every advertisement."""
        for rep in self.replicas:
            if rep.alive:
                if grace_s is None:
                    rep.engine.drain()
                else:
                    rep.engine.drain(grace_s)
        self.teardown()
        return self.outcome_counts()

    def teardown(self) -> None:
        """Retract every replica's live-params advertisement."""
        from automodel_tpu_torch.checkpoint.replication import (
            drop_live_params,
        )

        for rep in self.replicas:
            drop_live_params(rep.replica_id)

    # -- health: loss and grow-back ----------------------------------------
    def poll_health(self, step: int = -1) -> Optional[Any]:
        """One health sweep; returns the event it handled (also appended to
        ``events``) or None.  Losses are absorbed; an error other than
        ``SliceLostError`` out of the coordinator's poll propagates."""
        self.health_polls += 1
        event: Optional[Any] = None
        try:
            fault_point("fleet_replica_loss")
        except InjectedFault as e:
            victim = self._drilled_lost_replica()
            if victim is not None:
                event = self._lose_replica(
                    victim, f"injected replica loss ({e})", step)
        if self.coordinator is not None:
            try:
                self.coordinator.poll(step)
            except SliceLostError as e:
                rep = self._replica_for_slice(e.slice_id)
                if rep is not None and rep.alive:
                    event = self._lose_replica(rep, str(e), step)
            sid = self.coordinator.ready_to_readmit()
            if sid is not None:
                rep = self._replica_for_slice(sid)
                if rep is not None and not rep.alive:
                    self.coordinator.admit(sid, step)
                    event = self._admit_replica(rep.replica_id,
                                                step) or event
        for rid in [r.replica_id for r in self.replicas if not r.alive]:
            if rid in self._returning:
                self._probation[rid] = self._probation.get(rid, 0) + 1
            else:
                self._probation.pop(rid, None)
        for rid in sorted(self._probation):
            if self._probation[rid] >= self.probation_polls:
                event = self._admit_replica(rid, step) or event
        return event

    def note_return(self, replica_id: int) -> None:
        """A lost replica announces itself again: each later poll advances
        its probation."""
        rep = self.replicas[int(replica_id)]
        if not rep.alive:
            self._returning.add(rep.replica_id)

    def note_flap(self, replica_id: int) -> None:
        """The returning replica vanished again: probation restarts."""
        self._returning.discard(int(replica_id))
        self._probation.pop(int(replica_id), None)

    def _lose_replica(self, replica: Replica, reason: str,
                      step: int) -> ReplicaLostError:
        """Retract the replica's advertisement, harvest its requests,
        replay the admitted ones on survivors, re-route the queued."""
        from automodel_tpu_torch.checkpoint.replication import (
            drop_live_params,
        )

        replica.alive = False
        replica.losses += 1
        self.replica_losses += 1
        self._probation.pop(replica.replica_id, None)
        self._returning.discard(replica.replica_id)
        drop_live_params(replica.replica_id)
        harvested = replica.engine.harvest_for_replay()
        event = ReplicaLostError(replica.replica_id, reason, step)
        self.events.append(event)
        admitted = [r for r in harvested if r.was_admitted]
        fresh = [r for r in harvested if not r.was_admitted]
        logger.warning(
            "fleet: replica %d lost (%s) -- replaying %d admitted "
            "request(s) on survivors, re-routing %d queued",
            replica.replica_id, reason, len(admitted), len(fresh))
        survivors = self.alive_replicas
        for req in admitted:
            if not survivors:
                req.state = RequestState.EXPIRED
                req.finish_reason = "replica_lost"
                req.finish_time = self.clock()
                continue
            target = min(survivors, key=lambda r: (r.load, r.replica_id))
            target.engine.adopt_for_replay(req)
            self.replays += 1
        for req in fresh:
            self._route(req, preserve_submit_time=True)
        return event

    @torch.no_grad()
    def _admit_replica(self, replica_id: int,
                       step: int) -> Optional[ReplicaReturnedError]:
        """Warm a fresh engine from a live peer's weights (digest-checked
        bytes) and open it to traffic; any failure, the drilled
        ``fleet_replica_admit`` included, is a typed
        :class:`ReplicaAdmitError`."""
        from automodel_tpu_torch.checkpoint.replication import (
            fetch_live_params,
            push_live_params,
        )

        replica = self.replicas[int(replica_id)]
        try:
            fault_point("fleet_replica_admit")
            peer = next(iter(self.alive_replicas), None)
            if peer is None:
                raise ReplicaAdmitError(
                    replica_id, "no live peer to warm from", step)
            state = peer.engine.model.state_dict()
            push_live_params(replica_id=peer.replica_id, params=state,
                             version=peer.engine.weight_syncs)
            tree = fetch_live_params(abstract=state,
                                     replica_id=peer.replica_id,
                                     version=peer.engine.weight_syncs)
            if tree is None:
                raise ReplicaAdmitError(
                    replica_id,
                    f"live-params fetch from replica {peer.replica_id} "
                    "failed digest verification", step)
            engine = self._engine(fresh_model(peer.engine.model))
            engine.update_params(tree)
            if peer.engine.adapter_slots is not None:
                engine.adapter_slots.clone_from(peer.engine.adapter_slots)
            # the first launches before traffic: the warm-up pays them
            engine.generate(np.asarray([[1]]), config=GenerationConfig(
                max_new_tokens=1, eos_token_id=self.generation.eos_token_id))
        except (InjectedFault, ReplicaAdmitError) as e:
            self._probation.pop(int(replica_id), None)
            self._returning.discard(int(replica_id))
            ev = (e if isinstance(e, ReplicaAdmitError)
                  else ReplicaAdmitError(
                      replica_id, f"injected admit failure ({e})", step))
            self.events.append(ev)
            logger.warning(
                "fleet: replica %d admission failed (%s) -- serving goes "
                "on with %d live replica(s)", replica_id, ev,
                len(self.alive_replicas))
            return None
        replica.retired_steps += replica.engine.steps_run
        replica.retired_kernel_launches += replica.engine.kernel_launches
        replica.engine = engine
        replica.alive = True
        replica.admissions += 1
        self.readmissions += 1
        self._probation.pop(int(replica_id), None)
        self._returning.discard(int(replica_id))
        ev = ReplicaReturnedError(
            replica.replica_id,
            f"passed fleet probation ({self.probation_polls} polls); "
            f"warmed from replica {peer.replica_id}'s live params "
            "(digest-verified)", step)
        self.events.append(ev)
        logger.info("fleet: %s", ev)
        return ev

    # -- telemetry ---------------------------------------------------------
    def all_free(self) -> bool:
        """Every replica's allocator, live and lost, fully drained."""
        return all(r.engine.allocator.all_free for r in self.replicas)

    def outcome_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for req in self.requests.values():
            counts[req.state.value] = counts.get(req.state.value, 0) + 1
        return counts

    def completed_in_deadline(self) -> int:
        """FINISHED requests that met their deadline (none counts as
        met)."""
        n = 0
        for req in self.requests.values():
            if req.state is not RequestState.FINISHED:
                continue
            if (req.deadline_s is None or req.finish_time is None
                    or req.finish_time - req.submit_time <= req.deadline_s):
                n += 1
        return n

    def stats(self) -> Dict[str, Any]:
        per_tenant: Dict[int, Dict[str, int]] = {}
        for r in self.replicas:
            for tid, d in r.engine.scheduler.per_tenant.items():
                agg = per_tenant.setdefault(
                    tid, {"submitted": 0, "admitted": 0, "finished": 0,
                          "tokens": 0})
                for k, v in d.items():
                    agg[k] = agg.get(k, 0) + v
        reps = self.replicas
        return {
            "replicas": len(reps),
            "per_tenant": {k: per_tenant[k] for k in sorted(per_tenant)},
            "alive": len(self.alive_replicas),
            "router_policy": self.policy,
            "health_polls": self.health_polls,
            "replica_losses": self.replica_losses,
            "replays": self.replays,
            "readmissions": self.readmissions,
            "fleet_rejected": self.fleet_rejected,
            "routed": {r.replica_id: r.routed for r in reps},
            "per_replica": {
                r.replica_id: {
                    "alive": r.alive,
                    "steps": r.engine.steps_run,
                    "tokens_generated": r.engine.tokens_generated,
                    "compiled_widths": sorted(r.engine.step_widths),
                    "kv_blocks_free": r.engine.allocator.free_blocks,
                    "prefill_tokens_saved":
                        r.engine.scheduler.prefix_tokens_reused,
                    "spec_tokens_accepted":
                        r.engine.scheduler.spec_tokens_accepted,
                    "kernel_launches": r.engine.kernel_launches,
                    "watchdog_recoveries": r.engine.watchdog_recoveries,
                    "retired_steps": r.retired_steps,
                    "retired_kernel_launches": r.retired_kernel_launches,
                } for r in reps},
            "prefill_tokens_saved": sum(
                r.engine.scheduler.prefix_tokens_reused for r in reps),
            "spec_tokens_proposed": sum(
                r.engine.scheduler.spec_tokens_proposed for r in reps),
            "spec_tokens_accepted": sum(
                r.engine.scheduler.spec_tokens_accepted for r in reps),
            "accept_rate": (
                sum(r.engine.scheduler.spec_tokens_accepted for r in reps)
                / max(1, sum(r.engine.scheduler.spec_tokens_proposed
                             for r in reps))),
            "weight_bytes": weight_bytes(r.engine.model for r in reps
                                         if r.alive),
            "outcomes": self.outcome_counts(),
        }
