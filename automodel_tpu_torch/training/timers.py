"""Named timers, the ``profiling:`` section and the fractions the loop
reports (counterpart: ``automodel_tpu/training/timers.py``).

Kernels run asynchronously, so a timer without a barrier measures what the
host spent issuing work, and one with ``barrier=True`` waits for the card
first (``torch.cuda.synchronize`` on the recipe's device; nothing on the
CPU).  :func:`trace` captures a ``torch.profiler`` window and writes a
Chrome trace.  The fraction helpers read the dicts ``Timers.get_elapsed``
returns (and, for serving, the engine's outcome counts), with the JAX
package's definitions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

# Loop timers whose sum is the card's idle time attributable to the input
# side: ``data_wait`` (the host blocked on the next grad-acc group) and
# ``data_staging`` (the host copying a batch to the card on the
# synchronous path).  The double buffer's lookahead copy is timed apart as
# ``data_staging_overlap``: it runs while the previous step computes.
INPUT_TIMERS = ("data_wait", "data_staging")


def input_idle_fraction(elapsed: Dict[str, float], window: float) -> float:
    """(data_wait + data_staging) as a fraction of a wall-clock window."""
    if window <= 0:
        return 0.0
    idle = sum(elapsed.get(name, 0.0) for name in INPUT_TIMERS)
    return min(idle / window, 1.0)


# Checkpoint timers (recipes/base_recipe.py): ``ckpt_stall`` is the time
# the loop was blocked by a save (the host snapshot and any join under
# ``async_save``, the whole save inline); ``ckpt_background`` the
# committer thread's time, which overlaps training.
CKPT_TIMERS = ("ckpt_stall", "ckpt_background")


def ckpt_stall_fraction(elapsed: Dict[str, float], window: float) -> float:
    """Fraction of a wall-clock window the loop spent blocked on
    checkpointing."""
    if window <= 0:
        return 0.0
    return min(elapsed.get("ckpt_stall", 0.0) / window, 1.0)


# Elastic-recovery timers: detection, rebuild and the replay of lost
# steps; none of them is forward progress.
ELASTIC_TIMERS = ("elastic_detect", "elastic_rebuild", "elastic_replay")


def goodput_fraction(elapsed: Dict[str, float], window: float) -> float:
    """1 - (detection + rebuild + replay) / window, clipped to [0, 1]."""
    if window <= 0:
        return 1.0
    lost = sum(elapsed.get(name, 0.0) for name in ELASTIC_TIMERS)
    return max(0.0, min(1.0, 1.0 - lost / window))


def recovery_time_s(elapsed: Dict[str, float]) -> float:
    """Seconds one recovery took (detect + rebuild + replay)."""
    return sum(elapsed.get(name, 0.0) for name in ELASTIC_TIMERS)


# Restore timers, one per source of the restored state.
RESTORE_TIMERS = ("ckpt_restore_peer_ram", "ckpt_restore_storage")


def restore_time_by_source(elapsed: Dict[str, float]) -> Dict[str, float]:
    """``{"peer_ram": s, "storage": s}``."""
    return {name[len("ckpt_restore_"):]: elapsed.get(name, 0.0)
            for name in RESTORE_TIMERS}


# Serving timers and outcome rates over ``{state: request count}`` dicts.
SERVE_TIMERS = ("serve_step", "serve_drain", "serve_recovery")


def serve_shed_rate(outcomes: Dict[str, int]) -> float:
    """Fraction of submitted requests admission control rejected."""
    total = sum(outcomes.values())
    return outcomes.get("rejected", 0) / total if total else 0.0


def serve_expired_rate(outcomes: Dict[str, int]) -> float:
    """Fraction of submitted requests that ran out of their deadline after
    admission."""
    total = sum(outcomes.values())
    return outcomes.get("expired", 0) / total if total else 0.0


def serve_goodput_fraction(completed_in_deadline: int,
                           outcomes: Dict[str, int]) -> float:
    """Completed-before-deadline fraction of all submitted requests."""
    total = sum(outcomes.values())
    return completed_in_deadline / total if total else 1.0


PP_SCHEDULES = ("1f1b", "gpipe")


def pp_bubble_fraction(pp_size: int, num_microbatches: int,
                       schedule: str = "1f1b") -> float:
    """Warm-up + cool-down idle fraction of a pipelined step: a stage is
    busy ``k`` of the ``k + stride * (pp - 1)`` slots of a pass (stride 1
    for ``gpipe``, 2 for ``1f1b``)."""
    if pp_size <= 1:
        return 0.0
    schedule = (schedule or "1f1b").lower()
    if schedule not in PP_SCHEDULES:
        raise ValueError(f"pipeline.schedule must be one of "
                         f"{list(PP_SCHEDULES)}, got {schedule!r}")
    warmup = (2 if schedule == "1f1b" else 1) * (pp_size - 1)
    return warmup / (num_microbatches + warmup)


@dataclasses.dataclass
class ProfilingConfig:
    """The ``profiling:`` YAML section.  ``barrier=True`` waits for each
    step's device work before stopping ``step_e2e`` (true step latency, at
    the cost of the overlap).  A trace covers the optimizer steps
    ``[trace_start_step, trace_stop_step)`` into ``trace_dir``."""

    enabled: bool = False
    log_interval: int = 10
    barrier: bool = False
    trace_dir: Optional[str] = None
    trace_start_step: int = 1
    trace_stop_step: int = 3


def build_profiling_config(cfg) -> ProfilingConfig:
    """``ProfilingConfig`` from a ConfigNode or dict (None: off); the
    section's presence turns profiling on unless it says ``enabled``."""
    if cfg is None:
        return ProfilingConfig()
    raw = cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)
    fields = {f.name for f in dataclasses.fields(ProfilingConfig)}
    unknown = set(raw) - fields
    if unknown:
        raise ValueError(f"unknown profiling keys: {sorted(unknown)}")
    out = ProfilingConfig(**raw)
    if "enabled" not in raw:
        out.enabled = True
    return out


class _Timer:
    # Lock-guarded: the checkpoint committer records ``ckpt_background``
    # from its thread while the loop reads and resets the timers.

    def __init__(self, name: str, barrier_fn: Callable[[], None]):
        self.name = name
        self._barrier = barrier_fn
        self._start: Optional[float] = None
        self._elapsed = 0.0
        self._history: List[float] = []
        self._lock = threading.Lock()

    def start(self, barrier: bool = False) -> None:
        if barrier:
            self._barrier()
        with self._lock:
            if self._start is not None:
                raise RuntimeError(f"timer {self.name} already started")
            self._start = time.perf_counter()

    def stop(self, barrier: bool = False) -> None:
        if barrier:
            self._barrier()
        with self._lock:
            if self._start is None:
                raise RuntimeError(f"timer {self.name} not started")
            dt = time.perf_counter() - self._start
            self._elapsed += dt
            self._history.append(dt)
            self._start = None

    def elapsed(self, reset: bool = True) -> float:
        """Seconds so far; a running interval counts without being
        recorded, and on reset restarts from now."""
        with self._lock:
            out = self._elapsed
            now = time.perf_counter()
            if self._start is not None:
                out += now - self._start
                if reset:
                    self._start = now
            if reset:
                self._elapsed = 0.0
            return out

    def mean(self) -> float:
        with self._lock:
            return float(np.mean(self._history)) if self._history else 0.0

    def add(self, seconds: float) -> None:
        """Credit an interval measured elsewhere."""
        if seconds <= 0:
            return
        with self._lock:
            self._elapsed += seconds
            self._history.append(seconds)

    def discard(self) -> None:
        """Drop a running interval without recording it."""
        with self._lock:
            self._start = None

    def reset(self) -> None:
        with self._lock:
            self._elapsed = 0.0
            self._history.clear()


def device_barrier(device=None) -> Callable[[], None]:
    """A barrier for ``device``: ``torch.cuda.synchronize`` on a CUDA
    device, nothing on the CPU (its work is done when the call returns)."""
    import torch

    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return lambda: None
    return lambda: torch.cuda.synchronize(device)


class Timers:
    """``timers("fwd").start(); ...; timers("fwd").stop()``.  ``device``
    is the recipe's: a barrier waits for its work."""

    def __init__(self, log_level: int = 2, log_option: str = "minmax",
                 device=None):
        self.log_level = log_level
        self.log_option = log_option
        self._barrier = device_barrier(device)
        self._timers: Dict[str, _Timer] = {}
        self._log_levels: Dict[str, int] = {}
        self._registry_lock = threading.Lock()

    def __call__(self, name: str, log_level: Optional[int] = None) -> _Timer:
        with self._registry_lock:
            if name not in self._timers:
                self._timers[name] = _Timer(name, self._barrier)
                self._log_levels[name] = (
                    log_level if log_level is not None else self.log_level)
            return self._timers[name]

    @contextlib.contextmanager
    def record(self, name: str, barrier: bool = False):
        t = self(name)
        t.start(barrier=barrier)
        try:
            yield t
        finally:
            t.stop(barrier=barrier)

    def get_elapsed(self, names: Optional[List[str]] = None,
                    reset: bool = True, normalizer: float = 1.0
                    ) -> Dict[str, float]:
        with self._registry_lock:
            if names is None:
                names = list(self._timers)
            timers = [(n, self._timers[n]) for n in names
                      if n in self._timers]
        return {n: t.elapsed(reset=reset) / normalizer for n, t in timers}

    def get_global_elapsed(self, names: List[str], reset: bool = True,
                           normalizer: float = 1.0
                           ) -> Dict[str, Dict[str, float]]:
        """``{name: {min, max, mean}}`` over the ranks.  Collective when a
        process group of more than one rank exists: every rank calls it
        with the same ``names`` (a timer a rank never started counts 0);
        gathered over the host's gloo group, off the CUDA streams."""
        import torch
        import torch.distributed as dist

        from automodel_tpu_torch.distributed.init import host_group

        local = self.get_elapsed(names, reset=reset, normalizer=normalizer)
        values = np.asarray([local.get(k, 0.0) for k in names], np.float32)
        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            parts = [torch.zeros(len(names), dtype=torch.float32)
                     for _ in range(dist.get_world_size())]
            dist.all_gather(parts, torch.from_numpy(values),
                            group=host_group())
            all_values = torch.stack(parts).numpy()
        else:
            all_values = values[None]
        return {k: {"min": float(all_values[:, i].min()),
                    "max": float(all_values[:, i].max()),
                    "mean": float(all_values[:, i].mean())}
                for i, k in enumerate(names)}

    def log(self, names: Optional[List[str]] = None, reset: bool = True,
            normalizer: float = 1.0, logger=None,
            cross_host: bool = False) -> str:
        """The ``time (ms) | name: v | ...`` line (one process: the
        cross-host form is the local one)."""
        elapsed = self.get_elapsed(names, reset=reset, normalizer=normalizer)
        msg = "time (ms)" + "".join(
            f" | {n}: {v * 1000.0:.2f}" for n, v in elapsed.items())
        if logger is not None:
            logger.info(msg)
        return msg

    def write(self, names: List[str], writer, iteration: int,
              reset: bool = True, normalizer: float = 1.0) -> None:
        """Timer values to a wandb-style writer."""
        for n, v in self.get_elapsed(names, reset=reset,
                                     normalizer=normalizer).items():
            writer.log({f"timers/{n}": v}, step=iteration)


class Trace:
    """A ``torch.profiler`` capture (CPU, and CUDA where there is a card)
    that writes ``trace.json`` (Chrome trace format) into ``log_dir`` when
    it stops."""

    def __init__(self, log_dir: str):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.log_dir = log_dir
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()

    def stop(self) -> str:
        self._prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, "trace.json")
        self._prof.export_chrome_trace(path)
        return path


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` capture around a block; the Chrome trace lands in
    ``log_dir/trace.json``."""
    t = Trace(log_dir)
    try:
        yield t
    finally:
        t.stop()
