"""The device mesh (counterpart: ``automodel_tpu/distributed/mesh.py``).

Six named axes, outermost to innermost, as in the JAX package:
``("dcn_dp", "pp", "dp_replicate", "dp_shard", "cp", "tp")``.  ``dcn_dp``
is data parallelism across slices (here: contiguous blocks of ranks,
parameters replicated across it), ``dp_replicate`` x ``dp_shard`` is HSDP
(FSDP2 replicates over the first and shards over the second, with ``cp``
folded into the shard as the JAX ``FSDP_AXES``), ``cp`` the ring's
sequence axis and ``tp`` tensor (and sequence) parallelism.  ``pp`` stays
1: pipeline parallelism is ROADMAP Queue 1 item 12.

:class:`MeshManager` infers ``dp_size`` and checks the sizes with the JAX
manager's rules and messages; it builds a ``torch.distributed``
``DeviceMesh`` over those axes (``init_device_mesh``) when a process group
exists, and :meth:`MeshManager.group` gives the process group of any axis
or tuple of axes (a flattened sub-mesh).  Without a process group (one
process) it holds the sizes alone, which must then multiply to 1 unless
``world_size`` is given for sizing (a larger mesh raises
``NotImplementedError``: the port runs one process per device).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

AXIS_DCN_DP = "dcn_dp"
AXIS_PP = "pp"
AXIS_DP_REPLICATE = "dp_replicate"
AXIS_DP_SHARD = "dp_shard"
AXIS_CP = "cp"
AXIS_TP = "tp"
MESH_AXES: Tuple[str, ...] = (AXIS_DCN_DP, AXIS_PP, AXIS_DP_REPLICATE,
                              AXIS_DP_SHARD, AXIS_CP, AXIS_TP)
# flattened views, as the JAX package's: the data axes, the FSDP shard
# (dp_shard x cp), the loss / token reduction and the batch rows
DP_AXES: Tuple[str, ...] = (AXIS_DCN_DP, AXIS_DP_REPLICATE, AXIS_DP_SHARD)
FSDP_AXES: Tuple[str, ...] = (AXIS_DP_SHARD, AXIS_CP)
LOSS_AXES: Tuple[str, ...] = (AXIS_DCN_DP, AXIS_DP_REPLICATE, AXIS_DP_SHARD,
                              AXIS_CP)
BATCH_AXES: Tuple[str, ...] = (AXIS_DCN_DP, AXIS_DP_REPLICATE, AXIS_DP_SHARD)

_ITEM_12 = "ROADMAP Queue 1 item 12"


@dataclasses.dataclass
class MeshConfig:
    """The sizing knobs (any size None is inferred), as the JAX
    ``MeshConfig``."""

    dp_size: Optional[int] = None
    dp_replicate_size: int = 1
    dcn_dp_size: int = 1
    tp_size: int = 1
    cp_size: int = 1
    pp_size: int = 1
    sequence_parallel: bool = False
    cp_layout: Optional[str] = None


def _none_to(v, default):
    if v is None or (isinstance(v, str) and v.lower() in ("none", "null", "")):
        return default
    return int(v)


def _mesh_shape(world, dp_size, dp_replicate_size, dcn_dp_size, tp_size,
                cp_size, pp_size) -> Tuple[int, int, int, int, int, int]:
    """The six axis sizes of a mesh of ``world`` devices (``dp_size``
    None: inferred), with the JAX manager's checks and messages."""
    tp_size = _none_to(tp_size, 1)
    cp_size = _none_to(cp_size, 1)
    pp_size = _none_to(pp_size, 1)
    dp_replicate_size = _none_to(dp_replicate_size, 1)
    dcn_dp_size = _none_to(dcn_dp_size, 1)
    dp_size = _none_to(dp_size, None)
    if pp_size < 1:
        raise ValueError(f"pp_size must be >= 1, got {pp_size}")
    if pp_size > 1:
        raise NotImplementedError(
            f"pp_size={pp_size}: pipeline parallelism is not ported yet "
            f"(it comes with {_ITEM_12})")
    if dcn_dp_size < 1 or world % dcn_dp_size:
        raise ValueError(
            f"device count {world} not divisible into "
            f"dcn_dp_size={dcn_dp_size} slices")
    if dp_size is None:
        denom = tp_size * cp_size * pp_size
        if world % denom:
            raise ValueError(
                f"world size {world} not divisible by tp*cp*pp={denom}")
        dp_size = world // denom
    if dp_size % (dcn_dp_size * dp_replicate_size):
        raise ValueError(
            f"dp_size {dp_size} not divisible by dcn_dp_size*"
            f"dp_replicate_size {dcn_dp_size * dp_replicate_size}")
    dp_shard = dp_size // (dcn_dp_size * dp_replicate_size)
    total = (dcn_dp_size * pp_size * dp_replicate_size * dp_shard
             * cp_size * tp_size)
    if total != world:
        raise ValueError(
            f"mesh {dcn_dp_size}x{pp_size}x{dp_replicate_size}x"
            f"{dp_shard}x{cp_size}x{tp_size}={total} != device count "
            f"{world}")
    return (dcn_dp_size, pp_size, dp_replicate_size, dp_shard,
            cp_size, tp_size)


class MeshManager:
    """``distributed._target_: automodel_tpu.distributed.mesh.MeshManager``
    (the JAX target maps here).  ``world_size`` None is the process
    group's (1 without one); ``device_type`` None is ``cuda`` under NCCL,
    else ``cpu``."""

    def __init__(
        self,
        dp_size: Optional[int] = None,
        dp_replicate_size: int = 1,
        dcn_dp_size: int = 1,
        tp_size: int = 1,
        cp_size: int = 1,
        pp_size: int = 1,
        sequence_parallel: bool = False,
        expert_parallel: bool = False,
        cp_layout: Optional[str] = None,
        world_size: Optional[int] = None,
        device_type: Optional[str] = None,
        strict: Optional[bool] = None,
        **_unused,
    ):
        # unknown keys (the torch FSDP2Manager's knobs in reference YAMLs)
        # warn, or raise under strict config, never silently
        if _unused:
            code = type(self).__init__.__code__
            known = list(code.co_varnames[1:code.co_argcount
                                          + code.co_kwonlyargcount])
            msg = (f"MeshManager: unknown config key(s) {sorted(_unused)} "
                   f"ignored (known keys: {sorted(known)})")
            if strict is None:
                strict = os.environ.get(
                    "AUTOMODEL_STRICT_CONFIG", "0") not in ("0", "", "false")
            if strict:
                raise TypeError(msg)
            logger.warning(msg)
        import torch.distributed as dist

        from automodel_tpu_torch.ops.zigzag import (
            normalize_cp_layout,
            resolve_cp_layout,
        )

        self.sequence_parallel = bool(sequence_parallel)
        self.expert_parallel = bool(expert_parallel)
        self.cp_layout = resolve_cp_layout(
            normalize_cp_layout(cp_layout), _none_to(cp_size, 1))
        has_group = dist.is_available() and dist.is_initialized()
        one_process = world_size is None and not has_group
        if world_size is None:
            world_size = dist.get_world_size() if has_group else 1
        world = int(world_size)
        try:
            self.shape: Tuple[int, int, int, int, int, int] = _mesh_shape(
                world, dp_size, dp_replicate_size, dcn_dp_size, tp_size,
                cp_size, pp_size)
        except ValueError as e:
            if not one_process:
                raise
            # the JAX manager sizes a mesh over the devices of one process;
            # the port runs one process per device
            raise NotImplementedError(
                f"{e}: a mesh of several devices in one process is not "
                "ported (launch one process per device with torchrun "
                "--nproc-per-node N)") from None
        self.mesh_shape = self.shape
        self.mesh = None
        self._groups: Dict[Tuple[str, ...], object] = {}
        if has_group and world == dist.get_world_size():
            from torch.distributed.device_mesh import init_device_mesh

            if device_type is None:
                device_type = ("cuda" if dist.get_backend() == "nccl"
                               else "cpu")
            self.mesh = init_device_mesh(device_type, self.shape,
                                         mesh_dim_names=MESH_AXES)

    # -- sizes, as the JAX manager's ----------------------------------------
    @property
    def world_size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def dcn_dp_size(self) -> int:
        return self.shape[0]

    @property
    def pp_size(self) -> int:
        return self.shape[1]

    @property
    def dp_replicate_size(self) -> int:
        return self.shape[2]

    @property
    def dp_shard_size(self) -> int:
        return self.shape[3]

    @property
    def cp_size(self) -> int:
        return self.shape[4]

    @property
    def tp_size(self) -> int:
        return self.shape[5]

    @property
    def dp_size(self) -> int:
        """The whole data-parallel extent: dcn_dp x dp_replicate x dp_shard."""
        return self.shape[0] * self.shape[2] * self.shape[3]

    @property
    def loss_reduce_size(self) -> int:
        """The dp x cp group the loss and the token count are summed over."""
        return self.dp_size * self.cp_size

    # -- coordinates and groups ---------------------------------------------
    def coordinate(self, rank: Optional[int] = None) -> Dict[str, int]:
        """``{axis: index}`` of ``rank`` (default this process) on the mesh:
        ranks run over the axes row-major, ``tp`` fastest."""
        if rank is None:
            import torch.distributed as dist

            rank = dist.get_rank() if dist.is_initialized() else 0
        out = {}
        for name, size in zip(reversed(MESH_AXES), reversed(self.shape)):
            out[name] = rank % size
            rank //= size
        return {n: out[n] for n in MESH_AXES}

    def index(self, axes: Sequence[str], rank: Optional[int] = None) -> int:
        """The flattened index of ``rank`` over ``axes`` (outer first)."""
        c = self.coordinate(rank)
        sizes = dict(zip(MESH_AXES, self.shape))
        i = 0
        for a in axes:
            i = i * sizes[a] + c[a]
        return i

    def size(self, axes: Sequence[str]) -> int:
        sizes = dict(zip(MESH_AXES, self.shape))
        n = 1
        for a in axes:
            n *= sizes[a]
        return n

    def submesh(self, axes: Sequence[str]):
        """The ``DeviceMesh`` over ``axes`` (flattened when several; None
        without a process group)."""
        if self.mesh is None:
            return None
        axes = tuple(axes)
        if len(axes) == 1:
            return self.mesh[axes[0]]
        return self.mesh[axes]._flatten("_".join(axes))

    def group(self, axes: Sequence[str]):
        """The process group of ``axes`` (None without a process group)."""
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(axes)
        if axes not in self._groups:
            sub = self.submesh(axes)
            self._groups[axes] = None if sub is None else sub.get_group()
        return self._groups[axes]

    # -- slices -------------------------------------------------------------
    def slice_processes(self, slice_id: int) -> Tuple[int, ...]:
        """The ranks (one process a device) of one ``dcn_dp`` slice: a
        contiguous block."""
        n = self.dcn_dp_size
        if not 0 <= slice_id < n:
            raise ValueError(f"slice {slice_id} out of range for dcn_dp={n}")
        per = self.world_size // n
        return tuple(range(slice_id * per, (slice_id + 1) * per))

    def slice_devices(self, slice_id: int) -> List[int]:
        """The devices of one slice, as their ranks."""
        return list(self.slice_processes(slice_id))

    def shrink_slices(self, lost_slice: int) -> "MeshManager":
        raise NotImplementedError(
            "elastic slice loss (shrink_slices) is not ported yet: it comes "
            f"with {_ITEM_12}")

    def grow_slices(self, returned_slice=None, devices=None) -> "MeshManager":
        raise NotImplementedError(
            "elastic grow-back (grow_slices) is not ported yet: it comes "
            f"with {_ITEM_12}")

    def __repr__(self) -> str:
        return f"MeshManager(shape={dict(zip(MESH_AXES, self.mesh_shape))})"


def build_mesh(cfg=None, **kwargs) -> MeshManager:
    """A manager from a config node or kwargs; every key is forwarded
    (minus ``_target_``) so the unknown-key guard sees misspellings."""
    if cfg is not None:
        raw = cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)
        fields = {k: v for k, v in raw.items() if k != "_target_"}
        fields.update(kwargs)
        kwargs = fields
    return MeshManager(**kwargs)
