"""Optimizer construction from the YAML ``optimizer`` block (counterpart:
``automodel_tpu/optim/builder.py``).

The JAX package turns ``_target_: torch.optim.AdamW`` into the optax chain
``scale_by_adam(mu_dtype) -> add_decayed_weights (masked) ->
scale_by_learning_rate`` and ``torch.optim.Adam`` into the same chain
without the decay (a ``weight_decay`` given to Adam is dropped, as there).
:class:`OptaxAdam` is that chain written out in PyTorch, one parameter at
a time, with optax's dtypes and the JAX step's arithmetic:

* the gradient it takes is the fp32 quotient ``g / token_count`` (the
  train step divides in fp32, whatever ``grad_dtype`` is);
* ``mu`` is kept in ``mu_dtype`` (fp32 when unset: the fp32 quotients
  promote it), ``nu`` in fp32 (optax initialises it in ``grad_dtype`` and
  the first fp32 update promotes it); ``b1`` multiplies ``mu`` in ``mu``'s
  dtype, as a weak-typed Python scalar does in JAX;
* ``mu = fma(1 - b1, g, b1 mu)``, ``nu = fma(1 - b2, g g, b2 nu)``,
  ``u = mu / ((1 - b1^n) (sqrt(nu / (1 - b2^n)) + eps))``, then
  ``u = fma(wd, p, u)`` (AdamW) and ``p = fma(u, -lr, p)`` in fp32, cast
  to the parameter dtype.  That is the program XLA compiles from the optax
  chain (it folds ``mu_hat / (sqrt(nu_hat) + eps)`` into one division and
  contracts the multiply-adds); ``torch.addcmul`` is the fused
  multiply-add here, and 0-dim device tensors keep every scalar in fp32
  (a Python-number divisor becomes a reciprocal multiply on the card).
* the learning rate and weight decay are optax's injected hyperparameters:
  before the first update they are held in ``grad_dtype`` (optax's state
  is initialised from the parameters cast to it), in fp32 after.

Weight decay goes on every parameter except those named in
``_NO_WEIGHT_DECAY_LEAF_NAMES``, as in the JAX decay mask; each param
group carries ``wd_mult`` (1, or 0 for no-decay leaves and for Adam) and
``lr_mult``, and the schedule sets ``lr`` and ``weight_decay`` on the
groups before each step (:func:`set_hyperparams`).  ``param_groups``
(``[{"params": [patterns], "lr_mult": x, "wd_mult": y}]``) sets the
multipliers per parameter, the first group whose wildcard pattern matches
the parameter's name winning; the names are the JAX leaf paths when the
caller passes them (the recipe does:
``utils/model_utils.py::jax_named_parameters``), and frozen parameters
(``requires_grad=False``) are never in a group -- the JAX builder's
resolution against the trainable subtree.  A no-decay leaf keeps
``wd_mult`` 0 whatever its group says.  The chain is then ``u = fma(wd
wd_mult, p, u)``, ``u = (u (-lr)) lr_mult`` and ``p + u`` when ``lr_mult``
is not 1 (optax's ``_scale_by_tree`` after ``scale_by_learning_rate``).

``grad_clip_norm`` is ``optax.clip_by_global_norm`` at the chain's head:
the train step takes the global norm of the fp32 quotients first and,
when it is not below the limit, hands each quotient to the update as
``(g / norm) * max`` (``training/train_step.py::apply_updates``).
``mask`` (``{leaf path: trainable}``, for a custom optimizer factory as
in JAX) freezes the parameters it marks False: ``optax.masked`` gives them
zero updates, so they are left out here.  SGD and Adafactor are not
ported.  ``nu`` in fp32 costs 2 bytes per
parameter more than bf16 moments; the update runs one parameter at a time,
so no fp32 copy of the whole gradient exists.

Over a mesh (``distributed/shardings.py``) a parameter is a DTensor (FSDP)
holding this rank's shard (and, under tp, its tp slice): the update runs
on the local shard with the same arithmetic, so ``mu`` / ``nu`` are local
shards too.  With :attr:`OptaxAdam.plan` set, :meth:`~OptaxAdam.state_dict`
gathers each moment into the whole tensor (a collective call) and
:meth:`~OptaxAdam.load_state_dict` keeps this rank's shard of it, so the
state saved on one mesh resumes on any other.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

_IGNORED_TORCH_KWARGS = {
    "foreach", "fused", "capturable", "maximize", "differentiable", "amsgrad",
    # scheduler hints carried in the optimizer section (read by the
    # lr scheduler builder)
    "min_lr", "max_lr",
}

_NO_WEIGHT_DECAY_LEAF_NAMES = ("e_score_correction_bias",)


def _dtype(d) -> Optional[torch.dtype]:
    if d is None or isinstance(d, torch.dtype):
        return d
    dtype = getattr(torch, str(d), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"not a torch dtype: {d!r}")
    return dtype


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in fp32: the power rounded once from the
    exact value (XLA's ``pow``), then the fp32 subtraction."""
    d = np.float32(decay)
    return float(np.float32(1.0) - np.float32(np.float64(d) ** count))


def _round(x: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(float(x), dtype=torch.float64).to(dtype))


class OptaxAdam(torch.optim.Optimizer):
    """optax's Adam / AdamW chain, applied by :meth:`update` one parameter
    at a time from its fp32 gradient quotient (see the module docstring
    for the arithmetic).  State per parameter: ``step`` (optax's count),
    ``mu`` and ``nu``; ``state_dict`` / ``load_state_dict`` keep their
    dtypes."""

    def __init__(self, groups, *, lr: float, betas: Tuple[float, float],
                 eps: float, decoupled_weight_decay: bool,
                 mu_dtype: Optional[torch.dtype], grad_dtype: torch.dtype):
        super().__init__(groups, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=0.0))
        self.decoupled_weight_decay = decoupled_weight_decay
        self.mu_dtype = mu_dtype
        self.grad_dtype = grad_dtype
        self._groups_of = {}
        self._scalars = (None, None)
        # over a mesh: the parallel plan and {id(param): its module name}
        self.plan = None
        self.param_names: Dict[int, str] = {}

    def _step_scalars(self, group: dict, count: int, mu_dtype, device):
        """The fp32 scalars of one step as 0-dim views of one device
        tensor, made once per (group, step) and shared by its parameters:
        ``(b1 in mu's dtype, 1 - b1, b2, 1 - b2, 1 - b2^n, eps, 1 - b1^n,
        wd, -lr)``."""
        b1, b2 = group["betas"]
        hp = self.grad_dtype if count == 1 else torch.float32
        key = (id(group), count, mu_dtype, device, group["lr"],
               group["weight_decay"], b1, b2, group["eps"])
        if self._scalars[0] != key:
            values = [float(torch.tensor(b1, dtype=mu_dtype)),
                      np.float32(1 - b1), b2, np.float32(1 - b2),
                      _bias_correction(b2, count), group["eps"],
                      _bias_correction(b1, count),
                      _round(group["weight_decay"], hp),
                      -_round(group["lr"], hp)]
            t = torch.tensor([float(v) for v in values], dtype=torch.float32)
            if torch.device(device).type == "cuda":
                # from pinned memory without waiting: a pageable copy
                # would wait for the card's queued work (the backward)
                t = t.pin_memory().to(device, non_blocking=True)
            self._scalars = (key, t.unbind())
        return self._scalars[1]

    def _group(self, p: torch.Tensor) -> dict:
        if not self._groups_of:
            self._groups_of = {id(q): g for g in self.param_groups
                               for q in g["params"]}
        return self._groups_of[id(p)]

    @torch.no_grad()
    def update(self, p: torch.Tensor, g: torch.Tensor) -> None:
        """One optax update of ``p`` from ``g``, its fp32 gradient quotient
        (consumed: ``g`` is overwritten)."""
        group = self._group(p)
        state = self.state[p]
        p = _local(p)
        g = _local(g)
        if not state:
            state["step"] = 0
            state["mu"] = torch.zeros_like(
                p, dtype=self.mu_dtype or torch.float32)
            state["nu"] = torch.zeros_like(p, dtype=torch.float32)
        mu, nu = state["mu"], state["nu"]
        count = state["step"] + 1
        (b1, c1, b2, c2, bc2, eps, bc1, wd,
         neg_lr) = self._step_scalars(group, count, mu.dtype, p.device)
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu (one rounding
        # each: the multiply-adds are fused)
        if mu.dtype == torch.float32:
            m = mu.mul_(b1).addcmul_(g, c1)
        else:
            m = mu.float().mul_(b1).addcmul_(g, c1)
            mu.copy_(m)
        g.mul_(g)
        nu.mul_(b2).addcmul_(g, c2)
        del g
        # u = mu_hat / (sqrt(nu_hat) + eps), as one division
        u = torch.div(nu, bc2).sqrt_().add_(eps).mul_(bc1)
        torch.div(m, u, out=u)
        del m
        pf = p if p.dtype == torch.float32 else p.float()
        if self.decoupled_weight_decay and group["wd_mult"] != 0.0:
            u.addcmul_(pf, wd)
        if group.get("lr_mult", 1.0) == 1.0:
            pf.addcmul_(u, neg_lr)
        else:
            pf.add_(u.mul_(neg_lr).mul_(group["lr_mult"]))
        if pf is not p:
            p.copy_(pf)
        state["step"] = count

    def state_dict(self):
        """torch's state dict; over a mesh (``plan`` set) every moment is
        gathered into its whole tensor (collective: every rank calls)."""
        sd = super().state_dict()
        if self.plan is None or not self.plan.distributed:
            return sd
        params = [p for g in self.param_groups for p in g["params"]]
        ids = [i for g in sd["param_groups"] for i in g["params"]]
        state = {}
        for i, p in zip(ids, params):
            saved = sd["state"].get(i)
            if saved is None:
                continue
            name = self.param_names[id(p)]
            state[i] = {k: (self.plan.full_tensor(name, p, local=v)
                            if torch.is_tensor(v) else v)
                        for k, v in saved.items()}
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_state_dict(self, state_dict) -> None:
        """Restore ``state_dict()``'s state with the saved dtypes (torch's
        own load casts every floating state to the parameter's dtype,
        which would round fp32 ``nu`` to bf16)."""
        params = [p for g in self.param_groups for p in g["params"]]
        saved_groups = state_dict["param_groups"]
        ids = [i for g in saved_groups for i in g["params"]]
        if len(ids) != len(params) or len(saved_groups) != len(
                self.param_groups):
            raise ValueError(
                f"optimizer state holds {len(ids)} parameters in "
                f"{len(saved_groups)} groups; this optimizer has "
                f"{len(params)} in {len(self.param_groups)}")
        state = defaultdict(dict)
        for i, p in zip(ids, params):
            saved = state_dict["state"].get(i)
            if saved is None:
                continue
            for key, value in saved.items():
                if torch.is_tensor(value):
                    if self.plan is not None and self.plan.distributed:
                        name = self.param_names[id(p)]
                        want = self.plan.full_shape(name, p)
                        if tuple(value.shape) != want:
                            raise ValueError(
                                f"optimizer state {key} of parameter {i} "
                                f"is {tuple(value.shape)}, the parameter "
                                f"{want}")
                        state[p][key] = self.plan.local_of(
                            name, p, value.to(_local(p).device)).clone()
                        continue
                    if value.shape != p.shape:
                        raise ValueError(
                            f"optimizer state {key} of parameter {i} is "
                            f"{tuple(value.shape)}, the parameter "
                            f"{tuple(p.shape)}")
                    value = value.to(p.device, copy=True)
                state[p][key] = value
        self.state = state
        for group, saved in zip(self.param_groups, saved_groups):
            group.update({k: v for k, v in saved.items() if k != "params"})


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a plain tensor as it is)."""
    to_local = getattr(t, "to_local", None)
    return t if to_local is None else to_local()


def _group_multipliers(name: str, param_groups) -> Tuple[float, float]:
    """``(lr_mult, wd_mult)`` of the first group with a pattern matching
    ``name`` (1, 1 when none does)."""
    from automodel_tpu_torch.peft.module_matcher import wildcard_match

    for g in param_groups or ():
        pats = g.get("params") or g.get("patterns") or []
        if any(wildcard_match(p, name) for p in pats):
            return float(g.get("lr_mult", 1.0)), float(g.get("wd_mult", 1.0))
    return 1.0, 1.0


def build_optimizer(
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    name: str = "adamw",
    lr: float = 1e-4,
    betas: Sequence[float] = (0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    mu_dtype=None,
    grad_dtype=torch.float32,
    grad_clip_norm: Optional[float] = None,
    param_groups: Optional[Sequence[dict]] = None,
    mask: Optional[Dict[str, bool]] = None,
    **kwargs,
) -> OptaxAdam:
    """``name`` is the YAML target's last component (``AdamW``, ``Adam``);
    ``lr``/``weight_decay`` are the base values the schedule starts from;
    ``grad_clip_norm``, ``param_groups`` and ``mask`` as in the module
    docstring."""
    for k in list(kwargs):
        if k in _IGNORED_TORCH_KWARGS:
            kwargs.pop(k)
    if kwargs:
        raise TypeError(
            f"build_optimizer got unsupported kwargs {sorted(kwargs)}; "
            f"torch-compat no-ops are {sorted(_IGNORED_TORCH_KWARGS)}")
    name = name.lower().replace("torch.optim.", "")
    if name not in ("adamw", "adam"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported (AdamW and Adam are; SGD and "
            "Adafactor are not)")
    named = list(named_params)
    if mask is not None:
        for n, p in named:
            if not mask.get(n, True):
                p.requires_grad_(False)
    groups = [g.to_dict() if hasattr(g, "to_dict") else dict(g)
              for g in (param_groups or ())]
    adamw = name == "adamw"
    by_mults: Dict[Tuple[float, float], list] = {}
    for n, p in named:
        if not p.requires_grad:
            continue
        lr_mult, wd_mult = _group_multipliers(n, groups)
        # Adam: no decay whatever the schedule says (the JAX chain has none)
        if not adamw or any(x in n.split(".")
                            for x in _NO_WEIGHT_DECAY_LEAF_NAMES):
            wd_mult = 0.0
        by_mults.setdefault((lr_mult, wd_mult), []).append(p)
    opt = OptaxAdam([{"params": ps, "lr_mult": lm, "wd_mult": wm}
                     for (lm, wm), ps in by_mults.items()],
                    lr=float(lr),
                    betas=(float(betas[0]), float(betas[1])), eps=float(eps),
                    decoupled_weight_decay=adamw, mu_dtype=_dtype(mu_dtype),
                    grad_dtype=_dtype(grad_dtype))
    opt.grad_clip_norm = float(grad_clip_norm) if grad_clip_norm else None
    set_hyperparams(opt, lr=float(lr), wd=float(weight_decay or 0.0))
    return opt


def set_hyperparams(optimizer: torch.optim.Optimizer,
                    lr: Optional[float] = None,
                    wd: Optional[float] = None) -> None:
    """Set the scheduled learning rate / weight decay on every group."""
    for group in optimizer.param_groups:
        if lr is not None:
            group["lr"] = lr
        if wd is not None and "weight_decay" in group:
            group["weight_decay"] = wd * group["wd_mult"]
