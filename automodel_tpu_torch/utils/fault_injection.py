"""Deterministic fault points (counterpart: the spec and trigger half of
``automodel_tpu/utils/fault_injection.py``).

A ``fault_point("name")`` call marks a place where a failure must surface
cleanly.  Unarmed it is a dict lookup that misses.  A spec arms a point to
fire on its N-th hit, raising :class:`InjectedFault` or hard-exiting the
process::

    AUTOMODEL_FAULT="input_producer:2"        # raise on the 2nd hit
    AUTOMODEL_FAULT="a:1,b:3:kill"            # several points; kill = os._exit

Each entry is ``name[:count][:mode]``: ``count`` defaults to 1, ``mode`` is
``raise`` (default) or ``kill``/``exit``.  A point fires exactly once.  The
port's only point so far is ``input_producer`` (``datasets/prefetch.py``:
the background producer, before each batch).  The JAX module's watchdog
and checkpoint points wait for those slices of the port.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, Optional

FAULT_ENV = "AUTOMODEL_FAULT"
_KILL_EXIT_CODE = 113


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
