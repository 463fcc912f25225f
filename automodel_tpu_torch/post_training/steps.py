"""GRPO and DPO optimizer steps on the train step's update (counterpart:
``automodel_tpu/post_training/steps.py``).

Where the JAX step is one jitted ``(params, opt_state, batch) -> (params,
opt_state, metrics)``, the port's step holds the model and the optimizer
(as ``training/train_step.py::TrainStep`` does) and runs eagerly: the
logprob pass with gradients (``post_training/logprobs.py``), the GRPO or
DPO objective (``post_training/losses.py``), one ``backward()``, then
:func:`_finish_update` -- the gradients moved into ``grad_dtype``, the
global norm, the optimizer's clip and ``optim/builder.py::OptaxAdam``'s
update one parameter at a time (``train_step.apply_updates`` with a
divisor of 1: the objectives are already normalized).  The metrics come
back packed in one fp32 device tensor in the order of
``GRPO_PACKED_KEYS`` / ``DPO_PACKED_KEYS``; :meth:`PostTrainStepFns.
unpack_metrics` reads it with one copy.

Batches (numpy arrays or tensors, moved to the model's device):

* GRPO: ``input_ids`` / ``labels`` / ``position_ids [B, S]``,
  ``advantages [B]``, optional ``ref_logps [B, S]`` and
  ``behavior_logps [B, S]`` (data, no gradient);
* DPO: ``chosen_*`` and ``rejected_*`` id / label / position triples
  ``[B, S]`` plus ``ref_chosen_logp`` / ``ref_rejected_logp [B]``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from automodel_tpu_torch.loss.masked_ce import IGNORE_INDEX
from automodel_tpu_torch.models.llama import as_dtype
from automodel_tpu_torch.post_training.logprobs import (
    batch_to_device,
    completion_logprobs,
)
from automodel_tpu_torch.post_training.losses import (
    dpo_losses,
    grpo_token_objective,
)
from automodel_tpu_torch.training.train_step import (
    accumulate_grads,
    apply_updates,
)

# The order of the values in each step's packed metrics tensor.
GRPO_PACKED_KEYS = ("loss", "pg_loss", "kl", "grad_norm",
                    "num_completion_tokens", "mean_ratio")
DPO_PACKED_KEYS = ("loss", "accuracy", "margin", "grad_norm", "num_pairs")


@dataclasses.dataclass
class PostTrainStepFns:
    """One optimizer step ``step(batch) -> packed metrics`` and the keys of
    its packed tensor."""

    step: Callable
    packed_keys: Tuple[str, ...]

    def unpack_metrics(self, metrics: torch.Tensor) -> Dict[str, float]:
        """One device-to-host copy of the packed tensor -> Python floats."""
        return dict(zip(self.packed_keys, metrics.tolist()))


def _finish_update(params: List[torch.Tensor], optimizer,
                   grad_dtype: torch.dtype) -> torch.Tensor:
    """The gradients of one backward in ``grad_dtype``, their global norm
    (before the optimizer's ``grad_clip_norm``, as optax reports it) and
    the update; returns the norm."""
    acc: List[Optional[torch.Tensor]] = [None] * len(params)
    accumulate_grads(params, acc, grad_dtype)
    one = torch.ones((), dtype=torch.float32, device=params[0].device)
    return apply_updates(params, acc, one, optimizer)


def _pack(metrics: Dict[str, Any], keys: Tuple[str, ...],
          device) -> torch.Tensor:
    return torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32,
                                        device=device).reshape(())
                        for k in keys])


def _trainable(model) -> List[torch.Tensor]:
    return [p for p in model.parameters() if p.requires_grad]


def grpo_objective(model, batch: Dict[str, Any], *, kl_coef: float = 0.0,
                   clip_eps: float = 0.2, impl: Optional[str] = None,
                   attn_impl: Optional[str] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The GRPO loss of one batch (tensors on the model's device), with a
    gradient, and its metrics but ``grad_norm``.  ``impl`` / ``attn_impl``
    reach the logprob pass (None: the kernels on the card, the plain
    versions on the CPU)."""
    mask = (batch["labels"] != IGNORE_INDEX).float()
    denom = mask.sum().clamp(min=1.0)
    policy_lp = completion_logprobs(model, batch, impl=impl,
                                    attn_impl=attn_impl)
    # On-policy single-update GRPO (the recipes): the behaviour terms are
    # the detached logprobs of this same pass -- exp(lp - detach(lp)) has
    # value 1 and gradient d(lp) -- not a second forward.  Off-policy
    # callers pass behavior_logps.
    behavior = batch.get("behavior_logps")
    if behavior is None:
        behavior = policy_lp.detach()
    ref = batch.get("ref_logps")
    if ref is None:
        ref = behavior              # reference-free: the k3 term is 0
    loss_sum, aux = grpo_token_objective(
        policy_lp, behavior, ref, batch["advantages"], mask,
        kl_coef=kl_coef, clip_eps=clip_eps)
    loss = loss_sum / denom
    return loss, {
        "loss": loss.detach(),
        "pg_loss": aux["pg_sum"].detach() / denom,
        "kl": aux["kl_sum"].detach() / denom,
        "num_completion_tokens": mask.sum(),
        "mean_ratio": aux["ratio_sum"].detach() / denom,
    }


def pair_half(batch: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    return {"input_ids": batch[f"{prefix}_input_ids"],
            "labels": batch[f"{prefix}_labels"],
            "position_ids": batch.get(f"{prefix}_position_ids")}


def dpo_objective(model, batch: Dict[str, Any], *, beta: float = 0.1,
                  impl: Optional[str] = None,
                  attn_impl: Optional[str] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The DPO loss of one batch of pairs (tensors on the model's device):
    the logprob pass over the chosen and the rejected half, against the
    reference sums that arrive as data; with a gradient, and its metrics
    but ``grad_norm``."""
    B = batch["chosen_input_ids"].shape[0]
    c_lp, r_lp = (completion_logprobs(model, pair_half(batch, half),
                                      impl=impl, attn_impl=attn_impl)
                  for half in ("chosen", "rejected"))
    losses, margins = dpo_losses(
        c_lp.sum(dim=-1), r_lp.sum(dim=-1),
        batch["ref_chosen_logp"], batch["ref_rejected_logp"], beta=beta)
    loss = losses.mean()
    margins = margins.detach()
    return loss, {
        "loss": loss.detach(),
        "accuracy": (margins > 0).float().mean(),
        "margin": margins.mean(),
        "num_pairs": float(B),
    }


def _build_step(model, optimizer, objective: Callable, packed_keys,
                grad_dtype) -> PostTrainStepFns:
    params = _trainable(model)
    grad_dtype = as_dtype(grad_dtype)

    def step(batch):
        batch = batch_to_device(batch, params[0].device)
        loss, metrics = objective(model, batch)
        loss.backward()
        metrics["grad_norm"] = _finish_update(params, optimizer, grad_dtype)
        return _pack(metrics, packed_keys, loss.device)

    return PostTrainStepFns(step, packed_keys)


def build_grpo_step(model, optimizer, *, kl_coef: float = 0.0,
                    clip_eps: float = 0.2, grad_dtype: Any = torch.float32
                    ) -> PostTrainStepFns:
    """``grpo_step(batch)``: one rollout batch, one optimizer step
    (:func:`grpo_objective`, then the update)."""
    return _build_step(
        model, optimizer,
        functools.partial(grpo_objective, kl_coef=kl_coef,
                          clip_eps=clip_eps),
        GRPO_PACKED_KEYS, grad_dtype)


def build_dpo_step(model, optimizer, *, beta: float = 0.1,
                   grad_dtype: Any = torch.float32) -> PostTrainStepFns:
    """``dpo_step(batch)``: one batch of pairs, one optimizer step
    (:func:`dpo_objective`, then the update)."""
    return _build_step(
        model, optimizer,
        functools.partial(dpo_objective, beta=beta),
        DPO_PACKED_KEYS, grad_dtype)
