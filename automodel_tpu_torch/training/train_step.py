"""The train and eval steps (counterpart:
``automodel_tpu/training/train_step.py``).

Where the JAX step is one jitted program with a ``lax.scan`` over the
grad-accumulation microbatches, the port runs eagerly: one forward and one
``backward()`` per microbatch, gradients summed in ``.grad``, then the
optimizer update.  The loss convention is the JAX package's: each
microbatch's loss is a **sum** of token CE; after all microbatches the
summed gradients (and the summed loss) are divided once by the label-token
count of the whole optimizer step; the global gradient norm is taken
before the update.

Gradients accumulate in ``grad_dtype``, as the JAX ``micro`` scan's
``a + g.astype(grad_dtype)`` does: in ``.grad`` when the parameter has
that dtype (autograd's in-place sum), else in one buffer of that dtype per
parameter.  After the microbatches each accumulated gradient is divided by
the fp32 token count in fp32, the global norm is taken from those fp32
quotients, and the optimizer (``optim/builder.py::OptaxAdam``, optax's
chain) updates the parameter from the quotient -- one parameter at a time,
so no fp32 copy of the whole gradient exists.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from automodel_tpu_torch.datasets.utils import PAD_TOKEN_IDS
from automodel_tpu_torch.loss.masked_ce import IGNORE_INDEX, MaskedCrossEntropy

# Keys the model forward consumes, and keys the step itself consumes.
_MODEL_KEYS = ("input_ids", "position_ids", "segment_ids", "attention_mask")
_STEP_KEYS = ("labels",)


def microbatch_loss(model, loss_fn, mb: Dict[str, torch.Tensor],
                    attn_impl: Optional[str] = None) -> torch.Tensor:
    """Sum-CE of one microbatch (plus the MoE aux loss times its
    label-token count).  A loss that wants hidden states
    (``needs_hidden``) gets ``(hidden_states, lm_head_kernel, labels)``.
    ``attn_impl`` reaches the model's attention (None: the kernels on CUDA
    tensors, the plain versions on CPU tensors; ``"plain"`` forces them)."""
    # A batch key nothing consumes would train with that input silently
    # dropped (answers supervised without their context): fail loudly.
    unconsumed = set(mb) - set(_MODEL_KEYS) - set(_STEP_KEYS)
    if unconsumed:
        raise ValueError(
            f"batch keys {sorted(unconsumed)} are not consumed by "
            f"{type(model).__name__} (accepts {sorted(_MODEL_KEYS)}) nor by "
            "the train step -- training would silently supervise answers "
            "whose inputs were dropped")
    kwargs = {k: mb[k] for k in _MODEL_KEYS[1:] if mb.get(k) is not None}
    labels = mb["labels"]
    if getattr(loss_fn, "needs_hidden", False):
        out = model(mb["input_ids"], return_hidden=True, attn_impl=attn_impl,
                    **kwargs)
        loss = loss_fn(out["hidden_states"], out["lm_head_kernel"], labels)
    else:
        out = model(mb["input_ids"], attn_impl=attn_impl, **kwargs)
        loss = loss_fn(out["logits"], labels)
    if "aux_loss" in out:
        # MoE load-balancing penalty (coef-scaled by the model) times this
        # microbatch's label-token count: after the step divides by the
        # global count, the loss is CE_mean + the token-weighted mean of the
        # aux values (HF's ``loss + coef * aux``), as in JAX
        n_mb = (labels != IGNORE_INDEX).sum().to(loss.dtype)
        loss = loss + out["aux_loss"].to(loss.dtype) * n_mb
    return loss


def accumulate_grads(params: List[torch.Tensor],
                     acc: List[Optional[torch.Tensor]],
                     grad_dtype: torch.dtype) -> None:
    """After one microbatch's backward: move each gradient of a parameter
    not in ``grad_dtype`` into its ``grad_dtype`` buffer in ``acc``
    (``a + g.astype(grad_dtype)``); a parameter in ``grad_dtype`` keeps
    summing in its ``.grad``."""
    with torch.no_grad():
        for i, p in enumerate(params):
            if p.grad is None or p.dtype == grad_dtype:
                continue
            g = p.grad.to(grad_dtype)
            p.grad = None
            acc[i] = g if acc[i] is None else acc[i].add_(g)


@torch.no_grad()
def apply_updates(params: List[torch.Tensor],
                  acc: List[Optional[torch.Tensor]], denom: torch.Tensor,
                  optimizer) -> torch.Tensor:
    """Divide every accumulated gradient by the fp32 token count in fp32,
    hand the quotient to ``optimizer.update`` and return the global L2
    norm of the quotients; one fp32 quotient exists at a time.  A
    parameter without a gradient is updated from zeros, as in the JAX
    step."""
    norms = []
    for i, p in enumerate(params):
        g = acc[i] if acc[i] is not None else p.grad
        q = (torch.zeros_like(p, dtype=torch.float32) if g is None
             else g.to(torch.float32, copy=True).div_(denom))
        acc[i] = p.grad = None
        norms.append(torch.linalg.vector_norm(q))
        optimizer.update(p, q)
    return torch.linalg.vector_norm(torch.stack(norms))


class TrainStep:
    """``train_step(batch) -> {"loss", "grad_norm", "num_label_tokens"}``
    and ``eval_step(batch) -> {"loss", "num_label_tokens"}`` over batches
    of ``[A, B, S]`` tensors on the model's device (``A`` = grad
    accumulation).  ``attn_impl`` reaches the model's attention
    (``ops/attention.py::attention``'s ``impl``: None, ``"plain"``,
    ``"kernel"`` or ``"flash"``)."""

    def __init__(self, model, optimizer, loss_fn=None,
                 grad_dtype=torch.float32, attn_impl: Optional[str] = None):
        loss_fn = loss_fn if loss_fn is not None else MaskedCrossEntropy()
        for attr in ("reduction", "needs_hidden"):
            if not hasattr(loss_fn, attr):
                raise TypeError(
                    f"loss_fn {type(loss_fn).__name__} does not satisfy the "
                    f"loss contract: missing attribute {attr!r}")
        if loss_fn.reduction != "sum":
            raise ValueError(
                "the train step normalizes by the global label-token count "
                "itself; configure the loss with reduction='sum' (got "
                f"{loss_fn.reduction!r})")
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.grad_dtype = grad_dtype
        self.attn_impl = attn_impl

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        labels = batch["labels"]
        num_label_tokens = (labels != IGNORE_INDEX).sum().float()
        denom = num_label_tokens.clamp(min=1.0)
        self.optimizer.zero_grad(set_to_none=True)
        acc: List[Optional[torch.Tensor]] = [None] * len(self.params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=labels.device)
        for a in range(labels.shape[0]):
            mb = {k: v[a] for k, v in batch.items()}
            loss = microbatch_loss(self.model, self.loss_fn, mb,
                                   attn_impl=self.attn_impl)
            loss.backward()
            loss_sum += loss.detach().float()
            accumulate_grads(self.params, acc, self.grad_dtype)
        norm = apply_updates(self.params, acc, denom, self.optimizer)
        loss, gn, n = torch.stack([loss_sum / denom, norm,
                                   num_label_tokens]).tolist()
        return {"loss": loss, "grad_norm": gn, "num_label_tokens": int(n)}

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        labels = batch["labels"]
        num_label_tokens = (labels != IGNORE_INDEX).sum().float()
        total = torch.zeros((), dtype=torch.float32, device=labels.device)
        for a in range(labels.shape[0]):
            total += microbatch_loss(self.model, self.loss_fn,
                                     {k: v[a] for k, v in batch.items()},
                                     attn_impl=self.attn_impl).float()
        loss, n = torch.stack([total / num_label_tokens.clamp(min=1.0),
                               num_label_tokens]).tolist()
        return {"loss": loss, "num_label_tokens": int(n)}


def stack_microbatches(microbatches: List[Dict[str, np.ndarray]]
                       ) -> Dict[str, np.ndarray]:
    """Stack collated microbatches into ``[A, B, S]`` arrays; microbatches
    of different lengths are right-padded with the per-key pad value.
    Every microbatch must carry the same keys."""
    keys = set(microbatches[0])
    for mb in microbatches[1:]:
        if set(mb) != keys:
            raise ValueError(
                f"Inconsistent microbatch keys: {sorted(keys)} vs {sorted(mb)}")
    out = {}
    for k in sorted(keys):
        arrs = [np.asarray(mb[k]) for mb in microbatches]
        max_s = max(a.shape[-1] for a in arrs)
        if any(a.shape[-1] != max_s for a in arrs):
            pad_val = PAD_TOKEN_IDS.get(k) or 0
            arrs = [np.pad(a, [(0, 0)] * (a.ndim - 1)
                           + [(0, max_s - a.shape[-1])],
                           constant_values=pad_val) for a in arrs]
        out[k] = np.stack(arrs, axis=0)
    return out


def to_device_batch(microbatches: List[Dict[str, np.ndarray]],
                    device) -> Dict[str, torch.Tensor]:
    """Collated numpy microbatches -> ``[A, B, S]`` tensors on ``device``
    (int32, as the collater made them)."""
    stacked = stack_microbatches(microbatches)
    stacked.pop("loss_mask", None)      # already folded into the labels
    return {k: torch.from_numpy(v).to(device) for k, v in stacked.items()}
