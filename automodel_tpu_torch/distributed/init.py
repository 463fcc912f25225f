"""Process-group bootstrap (counterpart:
``automodel_tpu/distributed/init.py``).

``torchrun --nproc-per-node N -m automodel_tpu_torch._cli.app finetune
llm -c <yaml>`` starts one process per GPU and sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``GROUP_RANK`` (the node) and the
rendezvous address; :func:`initialize_distributed` reads them and joins
the process group once: NCCL on ``cuda``, gloo on ``cpu``.  Without that
environment a run is one process and needs no group, as the JAX
package's single process needs none.  A caller that has joined a group
already (the tests: a ``file://`` store) is taken as it is.

``DistInfo`` has the JAX fields with their meanings: ``rank`` the
process's index, ``world_size`` the devices in the run (one a process
here), ``local_rank`` the device on this host, ``num_processes`` the
process count.  :func:`host_index` is ``jax.process_index()``'s
counterpart for what JAX keys by host (the ranked RNG): the node rank, 0
on one host.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

_OWNED = False          # the group was joined here (and is destroyed here)
_HOST_GROUP = None      # (the default group it was made beside, the group)


@dataclasses.dataclass
class DistInfo:
    backend: str
    rank: int
    world_size: int
    local_rank: int
    num_processes: int
    is_main: bool


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def host_index() -> int:
    """This process's host: torchrun's ``GROUP_RANK`` (or ``NODE_RANK``),
    0 on one host."""
    return _env_int("GROUP_RANK", _env_int("NODE_RANK", 0))


def host_count() -> int:
    """The hosts of the run: torchrun's ``GROUP_WORLD_SIZE``, 1 on one
    host."""
    return _env_int("GROUP_WORLD_SIZE", 1)


def local_rank() -> int:
    return _env_int("LOCAL_RANK", 0)


def initialize_distributed(backend: Optional[str] = None,
                           timeout_minutes: Optional[float] = None,
                           device=None, init_method: Optional[str] = None,
                           **_unused) -> DistInfo:
    """Join the process group when the environment launches several
    processes (``WORLD_SIZE`` > 1), else nothing.  ``backend`` from a JAX
    YAML (``xla``) or None picks NCCL for a ``cuda`` device and gloo for
    ``cpu``; ``nccl`` / ``gloo`` are taken as given.  On ``cuda`` the
    process uses device ``LOCAL_RANK``."""
    global _OWNED
    dev = torch.device("cuda" if device is None else device)
    chosen = backend if backend in ("nccl", "gloo") else (
        "nccl" if dev.type == "cuda" else "gloo")
    world = _env_int("WORLD_SIZE", 1)
    if dev.type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(local_rank())
    if not dist.is_initialized() and (world > 1 or init_method is not None):
        kwargs = {}
        if timeout_minutes is not None:
            kwargs["timeout"] = datetime.timedelta(minutes=timeout_minutes)
        if dev.type == "cuda" and chosen == "nccl":
            kwargs["device_id"] = torch.device("cuda", local_rank())
        if init_method is not None:
            kwargs.update(rank=_env_int("RANK", 0), world_size=world)
        dist.init_process_group(
            backend=chosen, init_method=init_method or "env://", **kwargs)
        _OWNED = True
        atexit.register(_shutdown)
        host_group()
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        chosen = dist.get_backend()
    else:
        rank, world = 0, 1
    info = DistInfo(backend=chosen, rank=rank, world_size=world,
                    local_rank=local_rank() if world > 1 else 0,
                    num_processes=world, is_main=rank == 0)
    logger.info("distributed: process %d/%d (%s)", rank, world, chosen)
    return info


def host_group():
    """A gloo group of every rank, for gathers of host values (a signal
    flag, timer readings) that must not wait on a CUDA stream: the
    default group itself when it is gloo, else one made once beside it
    (collective the first time: every rank calls it at the same point,
    which ``initialize_distributed`` does right after joining)."""
    global _HOST_GROUP
    world = dist.group.WORLD
    if dist.get_backend() == "gloo":
        return world
    if _HOST_GROUP is None or _HOST_GROUP[0] is not world:
        _HOST_GROUP = (world, dist.new_group(backend="gloo"))
    return _HOST_GROUP[1]


def _shutdown() -> None:
    global _OWNED, _HOST_GROUP
    if _OWNED and dist.is_initialized():
        try:
            dist.destroy_process_group()
        except Exception:  # pragma: no cover - teardown best effort
            pass
    _OWNED = False
    _HOST_GROUP = None


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
