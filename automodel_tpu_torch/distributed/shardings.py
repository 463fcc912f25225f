"""The parallel plan: logical axes -> mesh axes -> sharded modules
(counterpart: ``automodel_tpu/distributed/shardings.py``).

One rule table (:func:`default_rules`, the JAX table) maps every logical
axis a model names in ``param_axes()`` to mesh axes, for all families.
Where JAX hands the specs to GSPMD, :meth:`ParallelPlan.apply` applies
them to the module:

* tensor parallelism: a parameter whose spec names ``tp`` keeps its
  rank's slice of that dim (``heads`` / ``mlp`` column-parallel on the
  output, row-parallel on the input, ``vocab`` on the embedding and the
  head, a tied head included: it is the embedding), and the model runs
  the collectives of ``distributed/tensor_parallel.py`` between its
  products (``model._tp``): copy / all-reduce, or all-gather /
  reduce-scatter over the sequence with ``sequence_parallel``.  The
  port's models read their weights in ``_proj`` and run hand-written
  kernels on plain tensors, so the tp slices are plain tensors and the
  collectives explicit (``parallelize_module`` would attach them to
  ``nn.Linear.forward``, which the models do not call);
* FSDP2 / HSDP / ``dcn_dp``: ``fully_shard`` on each decoder layer
  (``model.fsdp_units()``) and at the root, over the mesh of
  ``(dcn_dp x dp_replicate, dp_shard x cp)``: replicated over the first
  (HSDP; ``dcn_dp`` outermost), sharded over the second along the dim the
  ``embed`` rule names (cp folded in, as JAX's ``FSDP_AXES``).  Gradients
  are summed, not averaged (divide factor 1): the train step divides once
  by the global token count, as JAX;
* context parallelism: the batch's sequence is cut over ``cp`` (after the
  host-side zig-zag permutation) and the attention of an active
  :func:`sharding_context` runs the ring (``ops/ring_attention.py``).

The optimizer state follows its parameter (it is made from the local
shard).  :meth:`ParallelPlan.full_params` gathers whole tensors for a
consolidated checkpoint and scatters them back after a load, so a
checkpoint written on one mesh resumes on any other.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import types
import warnings
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from automodel_tpu_torch.distributed.mesh import (
    AXIS_CP,
    AXIS_DCN_DP,
    AXIS_DP_REPLICATE,
    AXIS_DP_SHARD,
    AXIS_PP,
    AXIS_TP,
    BATCH_AXES,
    FSDP_AXES,
    LOSS_AXES,
    MESH_AXES,
    MeshManager,
)

MeshAxes = Optional[Tuple[str, ...]]
Rules = Dict[str, MeshAxes]
Spec = Tuple[Any, ...]           # per dim: None, an axis, or a tuple of axes

_ROADMAP_DENSE = ("tensor and context parallelism take a model that runs "
                  "the Llama decoder's own layers, attention, MLP and head "
                  "(LlamaForCausalLM.supports_tp_cp: Llama, Qwen2, Qwen3, "
                  "Mistral, Granite); other families come with the next "
                  "multi-GPU slice (ROADMAP Queue 1 item 9, second half)")


def default_rules(sequence_parallel: bool = False,
                  expert_parallel: bool = False,
                  pipeline_parallel: bool = False) -> Rules:
    """The JAX package's logical-axis -> mesh-axes table."""
    return {
        "layers": (AXIS_PP,) if pipeline_parallel else None,
        "norm": None,
        "head_dim": None,
        "pos": None,
        "lora_rank": None,
        "embed": FSDP_AXES,
        "heads": (AXIS_TP,),
        "qkv3": (AXIS_TP,),
        "mlp": (AXIS_TP,),
        "vocab": (AXIS_TP,),
        "experts": (AXIS_TP,) if expert_parallel else None,
        "expert_mlp": None if expert_parallel else (AXIS_TP,),
        "act_batch": (AXIS_DCN_DP, AXIS_DP_REPLICATE, AXIS_DP_SHARD),
        "act_seq": (AXIS_CP, AXIS_TP) if sequence_parallel else (AXIS_CP,),
        "act_seq_nosp": (AXIS_CP,),
        "act_embed": None,
        "act_vocab": (AXIS_TP,),
        "act_tokens": (AXIS_DCN_DP, AXIS_DP_REPLICATE, AXIS_DP_SHARD,
                       AXIS_CP),
    }


def spec_for(axes: Sequence[Optional[str]], rules: Rules) -> Spec:
    """Logical axis names -> a partition spec as a tuple (an axis name, a
    tuple of them, or None per dim; trailing Nones dropped, as JAX's
    ``PartitionSpec``).  An unknown name raises."""
    parts: List[Any] = []
    for name in axes:
        if name is None:
            parts.append(None)
            continue
        if name not in rules:
            raise KeyError(
                f"Unknown logical axis {name!r}; known: {sorted(rules)}")
        mesh_axes = rules[name]
        if not mesh_axes:
            parts.append(None)
        elif len(mesh_axes) == 1:
            parts.append(mesh_axes[0])
        else:
            parts.append(tuple(mesh_axes))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements_for(spec: Spec):
    """The DTensor placements over the six mesh axes of a spec: ``Shard(d)``
    on each axis the spec names at dim ``d``, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {}
    for d, entry in enumerate(spec):
        for a in _spec_axes(entry):
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in MESH_AXES)


def param_partition_specs(model, rules: Optional[Rules] = None
                          ) -> Dict[str, Spec]:
    """``{parameter name: spec}`` from ``model.param_axes()``."""
    rules = rules if rules is not None else default_rules()
    return {n: spec_for(axes, rules) for n, axes in model.param_axes().items()}


def batch_rows_by_process(mesh_manager: MeshManager, global_batch: int
                          ) -> Dict[int, np.ndarray]:
    """``{rank: row indices}`` of a global microbatch: each rank holds the
    rows of its ``(dcn_dp, dp_replicate, dp_shard)`` coordinate, a
    contiguous block as JAX's ``P(BATCH_AXES)``; its cp and tp peers hold
    the same rows."""
    dp = mesh_manager.dp_size
    if global_batch % dp:
        raise ValueError(f"global microbatch {global_batch} rows do not "
                         f"divide over dp={dp}")
    per = global_batch // dp
    out = {}
    for r in range(mesh_manager.world_size):
        i = mesh_manager.index(BATCH_AXES, r)
        out[r] = np.arange(i * per, (i + 1) * per, dtype=np.int64)
    return out


def process_batch_rows(mesh_manager: MeshManager, global_batch: int
                       ) -> np.ndarray:
    """This rank's rows of the global microbatch."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    return batch_rows_by_process(mesh_manager, global_batch)[rank]


# ---------------------------------------------------------------------------
# the active plan (what JAX's sharding context carries)
# ---------------------------------------------------------------------------
class _ShardingCtx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Optional[Rules] = None
        self.cp_layout: str = "contiguous"


_CTX = _ShardingCtx()


@contextlib.contextmanager
def sharding_context(mesh_manager: MeshManager, rules: Optional[Rules] = None,
                     cp_layout: Optional[str] = None):
    """Make ``mesh_manager`` (its cp group and layout) the one model
    forwards inside see: the attention of a cp > 1 context runs the ring,
    the fused linear CE of a tp > 1 one the vocab-parallel merge."""
    prev = (_CTX.mesh, _CTX.rules, _CTX.cp_layout)
    _CTX.mesh = mesh_manager
    _CTX.rules = rules if rules is not None else default_rules()
    _CTX.cp_layout = cp_layout if cp_layout is not None else "contiguous"
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.cp_layout = prev


def current_sharding() -> Optional[Tuple[MeshManager, Rules]]:
    """``(mesh manager, rules)`` of the active context, or None."""
    if _CTX.mesh is None:
        return None
    return _CTX.mesh, _CTX.rules


def current_cp_layout() -> str:
    return "contiguous" if _CTX.mesh is None else _CTX.cp_layout


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """The JAX ``constrain``'s name; ``x`` as it is (an eager rank holds
    its shard already: the plan's collectives moved it)."""
    return x


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
def _local_slice(full: torch.Tensor, dim: int, size: int, rank: int):
    if full.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(full.shape)} does not divide "
                         f"over tp={size}")
    return full.chunk(size, dim=dim)[rank]


@dataclasses.dataclass
class ParallelPlan:
    mesh_manager: MeshManager
    rules: Rules
    param_specs: Dict[str, Spec]
    cp_layout: str = "contiguous"
    tp_dims: Dict[str, Optional[int]] = dataclasses.field(
        default_factory=dict)
    partial_grads: Tuple[str, ...] = ()
    fsdp: bool = False

    # -- sizes ----------------------------------------------------------------
    @property
    def tp_size(self) -> int:
        return self.mesh_manager.tp_size

    @property
    def cp_size(self) -> int:
        return self.mesh_manager.cp_size

    @property
    def distributed(self) -> bool:
        return self.mesh_manager.mesh is not None

    def group(self, axes):
        return self.mesh_manager.group(axes)

    def context(self):
        return sharding_context(self.mesh_manager, self.rules,
                                self.cp_layout)

    # -- applying the plan ----------------------------------------------------
    def apply(self, model) -> None:
        """Slice the tp-sharded parameters, hand the model its tp context
        and ``fully_shard`` it (layers, then the root) over the data mesh.
        Needs a process group for any mesh larger than 1; at world 1
        without one it does nothing (the single-process path)."""
        mm = self.mesh_manager
        if (mm.tp_size > 1 or mm.cp_size > 1) and not getattr(
                model, "supports_tp_cp", lambda: False)():
            raise NotImplementedError(
                f"{type(model).__name__} at tp={mm.tp_size}, "
                f"cp={mm.cp_size}: {_ROADMAP_DENSE}")
        if mm.world_size > 1 and mm.mesh is None:
            raise RuntimeError(
                f"a mesh of {mm.world_size} devices needs a process group: "
                "launch with torchrun (initialize_distributed)")
        if not self.distributed:
            return
        if mm.tp_size > 1:
            self._apply_tp(model)
        self._apply_fsdp(model)

    def _apply_tp(self, model) -> None:
        from automodel_tpu_torch.distributed.tensor_parallel import TPContext

        tp = self.tp_size
        group = self.group((AXIS_TP,))
        rank = dist.get_rank(group)
        cfg = model.config
        for what, n in (("num_attention_heads", cfg.num_attention_heads),
                        ("num_key_value_heads", cfg.num_key_value_heads),
                        ("intermediate_size", cfg.intermediate_size),
                        ("vocab_size", cfg.vocab_size)):
            if n % tp:
                raise ValueError(f"{what}={n} does not divide over tp={tp}")
        params = dict(model.named_parameters())
        with torch.no_grad():
            for name, spec in self.param_specs.items():
                dim = _shard_dim(spec, AXIS_TP)
                self.tp_dims[name] = dim
                if dim is None:
                    continue
                p = params[name]
                p.data = _local_slice(p.data, dim, tp, rank).clone()
        sp = self.rules["act_seq"] == (AXIS_CP, AXIS_TP)
        partial = []
        for name in self.param_specs:
            if self.tp_dims[name] is not None:
                continue
            # q / k norms act on this rank's heads; under SP the block
            # norms on this rank's rows: their gradients are partial sums
            if name.endswith(("q_norm.weight", "k_norm.weight")) or (
                    sp and (name.startswith("layers.")
                            or name.startswith("norm."))):
                partial.append(name)
        self.partial_grads = tuple(partial)
        model._tp = TPContext(group=group, size=tp, rank=rank,
                              sequence_parallel=sp)

    def dp_mesh(self):
        mm = self.mesh_manager
        rep = mm.size((AXIS_DCN_DP, AXIS_DP_REPLICATE))
        shard = mm.submesh(FSDP_AXES)
        if rep == 1:
            return shard
        mm.submesh((AXIS_DCN_DP, AXIS_DP_REPLICATE))
        with warnings.catch_warnings():
            # slicing flattened dims from the root mesh: supported here,
            # announced as deprecated
            warnings.simplefilter("ignore", UserWarning)
            return mm.mesh[("dcn_dp_dp_replicate", "dp_shard_cp")]

    def _apply_fsdp(self, model) -> None:
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        mesh = self.dp_mesh()
        # FSDP shards each parameter along the dim its ``embed`` rule
        # names (dp_shard x cp), dim 0 where none does
        embed_dim = {n: _shard_dim(spec, AXIS_DP_SHARD) or 0
                     for n, spec in self.param_specs.items()}
        by_id = {id(p): n for n, p in model.named_parameters()}

        def placement(p):
            return Shard(embed_dim.get(by_id.get(id(p)), 0))

        units = list(model.fsdp_units()) if hasattr(model, "fsdp_units") \
            else []
        for unit in units:
            # the model calls a unit through ``unit(fn, *args)`` (see
            # ``LlamaForCausalLM._run_layer``), so FSDP's hooks gather its
            # parameters around each call, its recomputation included
            unit.forward = types.MethodType(_unit_forward, unit)
            unit._fsdp_unit = True
            fully_shard(unit, mesh=mesh, shard_placement_fn=placement)
        fully_shard(model, mesh=mesh, shard_placement_fn=placement)
        for m in units + [model]:
            m.set_gradient_divide_factor(1.0)
            # a plain sum (gloo has no pre-multiplied sum)
            m.set_force_sum_reduction_for_comms(True)
        self.fsdp = True

    # -- the batch ------------------------------------------------------------
    def shard_batch(self, stacked: Dict[str, Any]) -> Dict[str, Any]:
        """A stacked microbatch dict (``[A, B, S, ...]`` numpy, this rank's
        rows: the loader read only them) -> zig-zag permuted when the
        layout says so, then this rank's cp slice of every sequence
        key."""
        from automodel_tpu_torch.ops.zigzag import (
            _PASSTHROUGH_KEYS,
            _SEQ_KEYS,
            permute_batch_for_cp,
        )

        mm = self.mesh_manager
        out = dict(stacked)
        cp = mm.cp_size
        if cp <= 1:
            return out
        if self.cp_layout == "zigzag":
            out = permute_batch_for_cp(out, cp)
        elif "position_ids" not in out and "input_ids" in out:
            S = out["input_ids"].shape[-1]
            out["position_ids"] = np.broadcast_to(
                np.arange(S, dtype=np.int32), out["input_ids"].shape).copy()
        S = out["input_ids"].shape[-1]
        if S % cp:
            raise ValueError(f"sequence length {S} does not divide over "
                             f"cp={cp}")
        i = mm.index((AXIS_CP,))
        n = S // cp
        ndim = out["input_ids"].ndim
        for k, v in list(out.items()):
            if getattr(v, "ndim", 0) < ndim:
                continue
            if k == "position_ids" and v.ndim > ndim:
                out[k] = v[..., i * n:(i + 1) * n, :]
            elif (k in _SEQ_KEYS or k == "position_ids") and \
                    v.shape[-1] == S and k not in (_PASSTHROUGH_KEYS
                                                   - {"position_ids"}):
                out[k] = v[..., i * n:(i + 1) * n]
        return out

    # -- reductions -------------------------------------------------------------
    def sum_over_loss_group(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the dp x cp ranks (JAX's
        ``loss_reduce_size`` group)."""
        if not self.distributed or self.mesh_manager.loss_reduce_size == 1:
            return t
        t = t.clone()
        dist.all_reduce(t, group=self.group(LOSS_AXES))
        return t

    def reduce_partial_grads(self, named_grads: Dict[str, torch.Tensor]
                             ) -> None:
        """Sum the tp ranks' partial gradients (see :meth:`_apply_tp`) in
        place."""
        if not self.partial_grads:
            return
        group = self.group((AXIS_TP,))
        for name in self.partial_grads:
            g = named_grads.get(name)
            if g is not None:
                dist.all_reduce(_local(g), group=group)

    def replication(self, name: str) -> int:
        """How many ranks hold the same local shard of a parameter (its
        squares count once in the global gradient norm)."""
        mm = self.mesh_manager
        rep = mm.size((AXIS_DCN_DP, AXIS_DP_REPLICATE)) if self.fsdp else \
            mm.size(BATCH_AXES) * mm.cp_size
        if self.tp_dims.get(name) is None:
            rep *= mm.tp_size
        return rep

    def global_sum(self, t: torch.Tensor) -> torch.Tensor:
        if not self.distributed or self.mesh_manager.world_size == 1:
            return t
        t = t.clone()
        dist.all_reduce(t)
        return t

    # -- whole tensors ------------------------------------------------------------
    def full_tensor(self, name: str, p: torch.Tensor,
                    local: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The whole tensor of parameter ``name`` (``p``, a DTensor under
        FSDP) or of a local shard ``local`` laid out as ``p``'s (an
        optimizer moment).  Collective."""
        from torch.distributed.tensor import DTensor

        t = p if local is None else local
        if isinstance(p, DTensor):
            if local is not None:
                t = DTensor.from_local(local, p.device_mesh, p.placements,
                                       shape=p.shape, stride=p.stride())
            t = t.full_tensor()
        dim = self.tp_dims.get(name)
        if dim is not None and self.tp_size > 1:
            from automodel_tpu_torch.distributed.tensor_parallel import (
                _all_gather,
            )

            t = _all_gather(t, self.group((AXIS_TP,)), self.tp_size, dim)
        return t

    def full_shape(self, name: str, p: torch.Tensor) -> Tuple[int, ...]:
        """The whole shape of parameter ``name`` (``p``: its shard)."""
        shape = list(p.shape)
        dim = self.tp_dims.get(name)
        if dim is not None and self.tp_size > 1:
            shape[dim] *= self.tp_size
        return tuple(shape)

    def local_of(self, name: str, p: torch.Tensor, full: torch.Tensor
                 ) -> torch.Tensor:
        """This rank's shard of a whole tensor, laid out as ``p``'s local
        one (the inverse of :meth:`full_tensor`; no communication)."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        dim = self.tp_dims.get(name)
        if dim is not None and self.tp_size > 1:
            full = _local_slice(full, dim, self.tp_size,
                                dist.get_rank(self.group((AXIS_TP,))))
        if isinstance(p, DTensor):
            full = distribute_tensor(full.to(p.device), p.device_mesh,
                                     p.placements,
                                     src_data_rank=None).to_local()
        return full

    @contextlib.contextmanager
    def full_params(self, model, load: bool = False
                    ) -> Iterator[Dict[str, torch.Tensor]]:
        """Swap every parameter of ``model`` for its whole tensor (on the
        parameter's device) for the length of the block: a consolidated
        save reads them, and with ``load`` whatever the block wrote into
        them is scattered back into the shards.  Collective."""
        owners = []
        for mname, mod in model.named_modules():
            for pname, p in list(mod._parameters.items()):
                if p is None:
                    continue
                full_name = f"{mname}.{pname}" if mname else pname
                owners.append((mod, pname, full_name, p))
        fulls = {}
        with torch.no_grad():
            for mod, pname, full_name, p in owners:
                if full_name not in fulls:
                    fulls[full_name] = self.full_tensor(full_name, p).clone()
                mod._parameters[pname] = torch.nn.Parameter(
                    fulls[full_name], requires_grad=p.requires_grad)
        try:
            yield fulls
        finally:
            with torch.no_grad():
                for mod, pname, full_name, p in owners:
                    if load:
                        _local(p).copy_(self.local_of(
                            full_name, p, mod._parameters[pname].data))
                    mod._parameters[pname] = p


def _shard_dim(spec: Spec, axis: str) -> Optional[int]:
    """The dim a spec shards over mesh axis ``axis`` (None: replicated)."""
    from torch.distributed.tensor import Shard

    p = placements_for(spec)[MESH_AXES.index(axis)]
    return p.dim if isinstance(p, Shard) else None


def _unit_forward(self, fn, *args, **kwargs):
    return fn(self, *args, **kwargs)


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def build_parallel_plan(model, mesh_manager: MeshManager,
                        sequence_parallel: Optional[bool] = None,
                        expert_parallel: Optional[bool] = None,
                        rules: Optional[Rules] = None,
                        cp_layout: Optional[str] = None) -> ParallelPlan:
    """The plan of ``model`` on ``mesh_manager`` (the JAX
    ``build_parallel_plan``; :meth:`ParallelPlan.apply` applies it)."""
    from automodel_tpu_torch.ops.zigzag import resolve_cp_layout

    if sequence_parallel is None:
        sequence_parallel = mesh_manager.sequence_parallel
    if expert_parallel is None:
        expert_parallel = mesh_manager.expert_parallel
    if cp_layout is None:
        cp_layout = mesh_manager.cp_layout
    rules = rules if rules is not None else default_rules(
        bool(sequence_parallel), bool(expert_parallel),
        pipeline_parallel=mesh_manager.pp_size > 1)
    specs = (param_partition_specs(model, rules)
             if hasattr(model, "param_axes") else {})
    return ParallelPlan(
        mesh_manager=mesh_manager, rules=rules, param_specs=specs,
        cp_layout=resolve_cp_layout(cp_layout, mesh_manager.cp_size))
