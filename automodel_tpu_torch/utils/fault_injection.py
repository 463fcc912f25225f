"""Deterministic fault points (counterpart: the spec and trigger half of
``automodel_tpu/utils/fault_injection.py``).

A ``fault_point("name")`` call marks a place where a failure must surface
cleanly.  Unarmed it is a dict lookup that misses.  A spec arms a point to
fire on its N-th hit, raising :class:`InjectedFault` or hard-exiting the
process::

    AUTOMODEL_FAULT="input_producer:2"        # raise on the 2nd hit
    AUTOMODEL_FAULT="a:1,b:3:kill"            # several points; kill = os._exit

Each entry is ``name[:count][:mode]``: ``count`` defaults to 1, ``mode`` is
``raise`` (default) or ``kill``/``exit``.  A point fires exactly once.
Points are drills: they fire only when armed, and each site's contract is
the JAX package's.

Input pipeline (``datasets/prefetch.py``):

    input_producer    the background producer, before each batch.

Serving engine (``serving/scheduler.py``, ``serving/engine.py``):

    serve_block_alloc at every KV block grab (``Scheduler._allocate``):
                      behaves like an exhausted pool; the row is
                      preempted (recompute), never a crash.
    serve_request_abort
                      in ``DecodeEngine.step`` before the plan: the
                      oldest active request is aborted, its blocks freed.
    serve_deadline    in the step-boundary deadline sweep: the oldest
                      active request EXPIRES, blocks reclaimed.
    serve_shed        in ``Scheduler.add``: a typed ``RequestRejected``
                      as from a full queue, never an exception.
    serve_watchdog_stall
                      at the device-step dispatch: stands in for a wedged
                      step; the engine zeroes the pools, flushes the prefix
                      index and replays the admitted requests (pinned),
                      greedy output token-identical.
    kv_prefix_lookup  before the prefix index is consulted at admission:
                      the request prefills cold, same tokens.
    kv_cow_fork       at the private-block grab of a copy-on-write fork:
                      the chain's refs are returned and the request
                      prefills cold (``cow_fork_failures``).
    spec_draft        before the n-gram proposer runs for a row: that row
                      verifies an empty draft (``spec_draft_faults``).
    spec_verify       before draft acceptance on a step with drafts: every
                      draft of the step is discarded
                      (``spec_verify_failures``).

Multi-tenant adapters (``serving/adapters.py``):

    adapter_load      at the top of a load into an empty slot: a typed
                      ``AdapterLoadError``, no slab byte written.
    adapter_swap      at the top of a hot-swap of a loaded slot: a typed
                      ``AdapterLoadError``, the slot keeps its old adapter.

Post-training rollouts (``post_training/rollout.py``):

    rollout_weight_sync
                      at the top of the weight handoff into the decode
                      engine: the engine keeps its previous weights, a
                      typed ``RolloutError``, the next rollout re-syncs.
    rollout_engine_step
                      in the rollout drive loop, before each engine step:
                      every in-flight request of the rollout is aborted
                      (blocks reclaimed), a typed ``RolloutError``.
    reward_fn         in ``compute_rewards``: the completed rollout is
                      discarded, a typed ``RolloutError``.

Serving fleet (``serving/fleet.py``):

    fleet_route       in ``FleetRouter._route``, before a placement: a
                      typed ``RequestRejected`` (reason
                      ``route(injected)``), never an exception.
    fleet_replica_loss
                      in ``FleetRouter.poll_health``: a replica's slice is
                      declared lost (``AUTOMODEL_LOST_REPLICA`` picks the
                      victim, default the highest-id live one); its
                      admitted requests replay on the survivors, queued
                      ones re-route, every allocator ends ``all_free``.
    fleet_replica_admit
                      at the top of a grow-back admission: a typed
                      ``ReplicaAdmitError`` in the fleet's ``events``, the
                      replica stays lost and its probation restarts.

Live-params transport (``checkpoint/replication.py``):

    ckpt_replica_restore
                      at each shard of a live-params fetch: a corrupt
                      shard; the fetch gives None and the admission fails,
                      typed.

The JAX module's checkpoint-save and elastic-training points wait for
those slices of the port.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, Optional

FAULT_ENV = "AUTOMODEL_FAULT"
_KILL_EXIT_CODE = 113

# every fault_point() call site of the port, by name (the JAX registry's
# names for the same sites)
KNOWN_FAULT_POINTS = frozenset({
    "input_producer",
    "serve_block_alloc",
    "serve_request_abort",
    "serve_deadline",
    "serve_shed",
    "serve_watchdog_stall",
    "kv_prefix_lookup",
    "kv_cow_fork",
    "spec_draft",
    "spec_verify",
    "fleet_route",
    "fleet_replica_loss",
    "fleet_replica_admit",
    "ckpt_replica_restore",
    "adapter_load",
    "adapter_swap",
    "rollout_weight_sync",
    "rollout_engine_step",
    "reward_fn",
})


class InjectedFault(RuntimeError):
    """Raised by an armed fault point (``mode=raise``)."""


@dataclasses.dataclass
class FaultPoint:
    """One armed site: fires once, on the ``trigger_at``-th hit."""

    name: str
    trigger_at: int = 1
    mode: str = "raise"  # "raise" | "kill"
    hits: int = 0
    fired: bool = False


_lock = threading.Lock()
_registry: Dict[str, FaultPoint] = {}
_env_loaded = False


def parse_fault_spec(spec: str) -> Dict[str, FaultPoint]:
    """``"name[:count][:mode],..."`` -> name -> :class:`FaultPoint`."""
    points: Dict[str, FaultPoint] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        name = parts[0]
        if not name:
            raise ValueError(f"fault spec entry {entry!r} has no point name")
        trigger_at = int(parts[1]) if len(parts) > 1 and parts[1] else 1
        if trigger_at < 1:
            raise ValueError(
                f"fault spec {entry!r}: count must be >= 1 (1-based hits)")
        mode = parts[2].lower() if len(parts) > 2 and parts[2] else "raise"
        if mode == "exit":
            mode = "kill"
        if mode not in ("raise", "kill"):
            raise ValueError(
                f"fault spec {entry!r}: mode must be raise|kill, got {mode!r}")
        points[name] = FaultPoint(name=name, trigger_at=trigger_at, mode=mode)
    return points


def configure_faults(spec: Optional[str]) -> None:
    """Arm the registry from a spec (replacing any earlier one); None or
    empty disarms everything.  A later ``AUTOMODEL_FAULT`` is not read."""
    global _env_loaded
    with _lock:
        _registry.clear()
        _env_loaded = True
        if spec:
            _registry.update(parse_fault_spec(spec))


def reset_faults() -> None:
    """Disarm everything."""
    configure_faults(None)


def _ensure_env_loaded() -> None:
    global _env_loaded
    if _env_loaded:
        return
    with _lock:
        if _env_loaded:
            return
        _env_loaded = True
        spec = os.environ.get(FAULT_ENV)
        if spec:
            _registry.update(parse_fault_spec(spec))


def fault_point(name: str) -> None:
    """Mark a named failure site.  No-op unless a spec armed ``name``."""
    _ensure_env_loaded()
    if not _registry:
        return
    with _lock:
        fp = _registry.get(name)
        if fp is None:
            return
        fp.hits += 1
        should_fire = not fp.fired and fp.hits == fp.trigger_at
        if should_fire:
            fp.fired = True
        mode, hits = fp.mode, fp.hits
    if not should_fire:
        return
    if mode == "kill":
        os._exit(_KILL_EXIT_CODE)
    raise InjectedFault(f"injected fault at {name!r} (hit {hits})")


def fault_counts() -> Dict[str, int]:
    """Hit counts per armed point (for tests)."""
    with _lock:
        return {name: fp.hits for name, fp in _registry.items()}
