"""Optimizer construction from the YAML ``optimizer`` block (counterpart:
``automodel_tpu/optim/builder.py``).

The JAX builder turns ``_target_: torch.optim.AdamW`` into an optax chain
``scale_by_adam -> add_decayed_weights -> scale(-lr)``:
``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.  That is
``torch.optim.AdamW``'s update (decoupled decay ``p *= 1 - lr * wd``, then
the Adam step), so the port builds the torch optimizer itself; ``Adam``
maps to ``torch.optim.Adam`` (optax's ``adam`` has no weight decay, so a
non-zero one raises rather than change meaning).  Weight decay goes on
every parameter except those named in ``_NO_WEIGHT_DECAY_LEAF_NAMES``, as
in the JAX decay mask.  The schedule sets ``lr`` and ``weight_decay`` on
the param groups before each step (:func:`set_hyperparams`).

The dtype rule.  optax keeps its moments in ``mu_dtype`` (first) and in
the gradient dtype (second; the JAX step initialises the state from the
parameters cast to ``grad_dtype``); torch keeps both in the parameter's
dtype.  The two agree when every parameter is in ``grad_dtype`` and
``mu_dtype`` is unset or equal to it -- the bf16 Llama-3.2-1B YAML
(bf16 params, ``grad_dtype: bfloat16``, ``mu_dtype: bfloat16``) and the
fp32 tiny YAML -- and :func:`build_optimizer` raises otherwise.  With bf16
parameters this is the JAX step at ``grad_dtype: bfloat16``: bf16 moments
and no fp32 master weights.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

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


def build_optimizer(
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    name: str = "adamw",
    lr: float = 1e-4,
    betas: Sequence[float] = (0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    mu_dtype=None,
    grad_dtype=torch.float32,
    **kwargs,
) -> torch.optim.Optimizer:
    """``name`` is the YAML target's last component (``AdamW``, ``Adam``);
    ``lr``/``weight_decay`` are the base values the schedule starts from.
    Each param group carries ``wd_mult`` (1, or 0 for no-decay leaves)."""
    for k in list(kwargs):
        if k in _IGNORED_TORCH_KWARGS:
            kwargs.pop(k)
    if kwargs:
        raise NotImplementedError(
            f"optimizer kwargs {sorted(kwargs)} are not ported (grad clip, "
            "param_groups and masks come with later port slices)")
    name = name.lower().replace("torch.optim.", "")
    grad_dtype, mu_dtype = _dtype(grad_dtype), _dtype(mu_dtype)
    params = [(n, p) for n, p in named_params if p.requires_grad]
    for n, p in params:
        if p.dtype != grad_dtype or (mu_dtype is not None
                                     and mu_dtype != grad_dtype):
            raise NotImplementedError(
                f"parameter {n} is {p.dtype}, grad_dtype {grad_dtype}, "
                f"mu_dtype {mu_dtype}: torch keeps the Adam moments in the "
                "parameter's dtype and optax in grad_dtype/mu_dtype, so the "
                "port needs them equal (fp32 master weights for low-precision "
                "parameters come with a later slice)")
    decay = [p for n, p in params
             if not any(x in n.split(".") for x in _NO_WEIGHT_DECAY_LEAF_NAMES)]
    no_decay = [p for n, p in params
                if any(x in n.split(".") for x in _NO_WEIGHT_DECAY_LEAF_NAMES)]
    groups = [{"params": decay, "wd_mult": 1.0}]
    if no_decay:
        groups.append({"params": no_decay, "wd_mult": 0.0})
    b1, b2 = float(betas[0]), float(betas[1])
    if name == "adamw":
        opt = torch.optim.AdamW(groups, lr=float(lr), betas=(b1, b2),
                                eps=float(eps), weight_decay=0.0)
    elif name == "adam":
        if float(weight_decay or 0.0) != 0.0:
            raise NotImplementedError(
                "Adam with weight_decay != 0: the JAX builder's adam has no "
                "weight decay; use AdamW")
        for group in groups:          # no decay, whatever the schedule says
            group["wd_mult"] = 0.0
        opt = torch.optim.Adam(groups, lr=float(lr), betas=(b1, b2),
                               eps=float(eps))
    else:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported (AdamW and Adam are)")
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
