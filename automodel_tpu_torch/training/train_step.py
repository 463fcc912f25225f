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
so no fp32 copy of the whole gradient exists.  With the optimizer's
``grad_clip_norm`` set (``max_grad_norm``), the norm is taken in a first
pass over the quotients and each quotient is clipped as
``optax.clip_by_global_norm`` does, ``(g / norm) * max`` unless ``norm <
max``, before its update; the reported ``grad_norm`` is the norm before
clipping, as optax's.

The step trains the parameters that require gradients only: a frozen one
(PEFT's base, ``freeze_config``) gets no gradient, no accumulation buffer
and no optimizer state, as the JAX step's trainable-subtree mode.

Over a mesh (``plan``, a ``distributed/shardings.py::ParallelPlan``) each
rank runs its rows and sequence slice inside the plan's sharding context;
the label-token count and the loss are summed over the ``dp x cp`` group
(the JAX ``loss_reduce_size`` group), FSDP sums the gradients over it (no
average), the tp ranks' partial gradients (norms under sequence
parallelism, q / k norms) are summed, and the gradient norm adds each
rank's local squares once per distinct shard: the quotients, the norm and
the update are then JAX's (``automodel_tpu/training/train_step.py:
631-634``), up to the reduction order.  :meth:`TrainStep.shard_batch` is
the host side: the zig-zag permutation and this rank's cp slice.

No step ends in a device sync: :meth:`TrainStep.dispatch` returns the
step's loss, gradient norm and label-token count packed in one device
tensor (``PACKED_KEYS``), and :class:`MetricsCopy` brings it to pinned host
memory with a non-blocking copy and an event, for the recipe to read one
step later.  :func:`stage_batch` copies a batch from pinned host memory on
a side stream while the card computes, and :func:`use_staged` makes the
compute stream wait for it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from automodel_tpu_torch.datasets.utils import PAD_TOKEN_IDS
from automodel_tpu_torch.loss.masked_ce import IGNORE_INDEX, MaskedCrossEntropy

# The order of the values in the step's packed metrics tensor (fp32: token
# counts are exact below 2^24 per step).
PACKED_KEYS = ("loss", "grad_norm", "num_label_tokens")

# Keys the model forward consumes (``pixel_values``: the VLM families'
# image slots or patch rows); a model with more inputs names them in its
# ``extra_batch_keys`` (Qwen2.5-VL's ``image_grid_thw``, video patches and
# grids).  Keys the step itself consumes.
_MODEL_KEYS = ("input_ids", "position_ids", "segment_ids", "attention_mask",
               "pixel_values")
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
    keys = _MODEL_KEYS + tuple(getattr(model, "extra_batch_keys", ()))
    unconsumed = set(mb) - set(keys) - set(_STEP_KEYS)
    if unconsumed:
        raise ValueError(
            f"batch keys {sorted(unconsumed)} are not consumed by "
            f"{type(model).__name__} (accepts {sorted(keys)}) nor by "
            "the train step -- training would silently supervise answers "
            "whose inputs were dropped. Use a model family that implements "
            "this modality (a model declares extra inputs in "
            "`extra_batch_keys`), or a collator that does not emit these "
            "keys.")
    kwargs = {k: mb[k] for k in keys[1:] if mb.get(k) is not None}
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


def _local(t):
    to_local = getattr(t, "to_local", None)
    return t if to_local is None else to_local()


@torch.no_grad()
def apply_updates(params: List[torch.Tensor],
                  acc: List[Optional[torch.Tensor]], denom: torch.Tensor,
                  optimizer, plan=None,
                  names: Optional[List[str]] = None) -> torch.Tensor:
    """Divide every accumulated gradient by the fp32 token count in fp32,
    hand the quotient to ``optimizer.update`` and return the global L2
    norm of the quotients; one fp32 quotient exists at a time.  A
    parameter without a gradient is updated from zeros, as in the JAX
    step.  The optimizer's ``grad_clip_norm`` clips the quotients by their
    global norm, taken in a first pass.  Over a mesh (``plan`` with
    ``names``, the parameters' module names) the quotients are local
    shards and the norm sums every distinct shard's squares over the
    ranks."""
    sharded = plan is not None and plan.distributed

    def quotient(i, p):
        g = acc[i] if acc[i] is not None else p.grad
        return (torch.zeros_like(_local(p), dtype=torch.float32) if g is None
                else _local(g).to(torch.float32, copy=True).div_(denom))

    def norm_of(i, q):
        if not sharded:
            return torch.linalg.vector_norm(q)
        return q.square().sum() / plan.replication(names[i])

    def global_norm(norms):
        if not sharded:
            return torch.linalg.vector_norm(torch.stack(norms))
        return plan.global_sum(torch.stack(norms).sum()).sqrt()

    clip = getattr(optimizer, "grad_clip_norm", None)
    norm = None
    if clip:
        norm = global_norm([norm_of(i, quotient(i, p))
                            for i, p in enumerate(params)])
        below = norm < clip
    norms = []
    for i, p in enumerate(params):
        q = quotient(i, p)
        acc[i] = p.grad = None
        if clip:
            q = torch.where(below, q, q.div(norm).mul_(clip))
        else:
            norms.append(norm_of(i, q))
        optimizer.update(p, q)
    return norm if clip else global_norm(norms)


class TrainStep:
    """``train_step(batch) -> {"loss", "grad_norm", "num_label_tokens"}``
    and ``eval_step(batch) -> {"loss", "num_label_tokens"}`` over batches
    of ``[A, B, S]`` tensors on the model's device (``A`` = grad
    accumulation).  ``attn_impl`` reaches the model's attention
    (``ops/attention.py::attention``'s ``impl``: None, ``"plain"``,
    ``"kernel"`` or ``"flash"``)."""

    def __init__(self, model, optimizer, loss_fn=None,
                 grad_dtype=torch.float32, attn_impl: Optional[str] = None,
                 plan=None):
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
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self.params = [p for _, p in named]
        self.names = [n for n, _ in named]
        self.plan = plan
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.grad_dtype = grad_dtype
        self.attn_impl = attn_impl

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One optimizer step; waits for its metrics (direct callers and
        tests: the recipe uses :meth:`dispatch`)."""
        return unpack_metrics(self.dispatch(batch).tolist())

    def _context(self):
        return (self.plan.context() if self.plan is not None
                else contextlib.nullcontext())

    def _summed(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.plan is None else self.plan.sum_over_loss_group(t)

    def shard_batch(self, stacked: Dict[str, np.ndarray]
                    ) -> Dict[str, np.ndarray]:
        """A stacked host batch of this rank's rows -> its part (the JAX
        ``shard_batch``'s host side: the zig-zag permutation under that
        layout, then its cp slice); the batch as it is without a plan."""
        if self.plan is None:
            return stacked
        return self.plan.shard_batch(stacked)

    def dispatch(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One optimizer step, issued without waiting for the card ->
        ``[loss, grad_norm, num_label_tokens]`` (fp32, on the device)."""
        labels = batch["labels"]
        num_label_tokens = self._summed(
            (labels != IGNORE_INDEX).sum().float())
        denom = num_label_tokens.clamp(min=1.0)
        self.optimizer.zero_grad(set_to_none=True)
        acc: List[Optional[torch.Tensor]] = [None] * len(self.params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=labels.device)
        with self._context():
            for a in range(labels.shape[0]):
                mb = {k: v[a] for k, v in batch.items()}
                loss = microbatch_loss(self.model, self.loss_fn, mb,
                                       attn_impl=self.attn_impl)
                loss.backward()
                loss_sum += loss.detach().float()
                accumulate_grads(self.params, acc, self.grad_dtype)
        if self.plan is not None and self.plan.partial_grads:
            self.plan.reduce_partial_grads({
                n: (acc[i] if acc[i] is not None else p.grad)
                for i, (n, p) in enumerate(zip(self.names, self.params))})
        norm = apply_updates(self.params, acc, denom, self.optimizer,
                             plan=self.plan, names=self.names)
        loss_sum = self._summed(loss_sum)
        return torch.stack([loss_sum / denom, norm.float(), num_label_tokens])

    def eval_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        loss, n = self.eval_dispatch(batch).tolist()
        return {"loss": loss, "num_label_tokens": int(n)}

    @torch.no_grad()
    def eval_dispatch(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The mean loss of a batch, issued without waiting -> ``[loss,
        num_label_tokens]`` (fp32, on the device)."""
        labels = batch["labels"]
        num_label_tokens = self._summed(
            (labels != IGNORE_INDEX).sum().float())
        total = torch.zeros((), dtype=torch.float32, device=labels.device)
        with self._context():
            for a in range(labels.shape[0]):
                total += microbatch_loss(self.model, self.loss_fn,
                                         {k: v[a] for k, v in batch.items()},
                                         attn_impl=self.attn_impl).float()
        total = self._summed(total)
        return torch.stack([total / num_label_tokens.clamp(min=1.0),
                            num_label_tokens])


def unpack_metrics(values: List[float]) -> Dict[str, float]:
    """``PACKED_KEYS`` values -> the step's metrics dict."""
    out = dict(zip(PACKED_KEYS, values))
    out["num_label_tokens"] = int(out["num_label_tokens"])
    return out


class MetricsCopy:
    """A device tensor's values on their way to the host: on a CUDA
    tensor, a non-blocking copy into pinned memory and an event after it
    (:meth:`read` waits for that event only, not for the device); on a CPU
    tensor, a copy."""

    def __init__(self, values: torch.Tensor):
        if values.is_cuda:
            self._host = torch.empty(values.shape, dtype=values.dtype,
                                     pin_memory=True)
            self._host.copy_(values, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = values.detach().clone(), None

    def read(self) -> List[float]:
        if self._event is not None:
            self._event.synchronize()
        return self._host.tolist()


def stack_microbatches(microbatches: List[Dict[str, np.ndarray]]
                       ) -> Dict[str, np.ndarray]:
    """Stack collated microbatches into ``[A, B, S]`` arrays (the JAX
    ``stack_microbatches``).  Microbatches of one shape stack as they are;
    otherwise each key is padded to the largest: the per-row image slots
    ``[B, I, H, W, C]`` along ``I`` and flat patch rows (``pixel_values``
    / ``pixel_values_videos``, ``[n_patches, patch_dim]``) along their
    rows, with zeros no placeholder reads; ``*_grid_thw`` rows with zero
    rows; audio frames ``input_audio_embeds [N, T, F]`` along ``T`` with
    zeros (their ``audio_attention_mask [N, T]`` is a last-axis key);
    M-RoPE ids ``[B, S, 3]`` along ``S`` with 1 (HF's value for a masked
    position); the rest
    along the last axis with the per-key pad value.  Every microbatch must
    carry the same keys."""
    keys = set(microbatches[0])
    for mb in microbatches[1:]:
        if set(mb) != keys:
            raise ValueError(
                f"Inconsistent microbatch keys: {sorted(keys)} vs {sorted(mb)}")
    out = {}
    for k in sorted(keys):
        arrs = [np.asarray(mb[k]) for mb in microbatches]
        if all(a.shape == arrs[0].shape for a in arrs[1:]):
            out[k] = np.stack(arrs, axis=0)
            continue
        if k in ("pixel_values", "pixel_values_videos"):
            axis = 1 if arrs[0].ndim == 5 else 0
            n = max(a.shape[axis] for a in arrs)
            arrs = [np.pad(a, [(0, 0)] * axis + [(0, n - a.shape[axis])]
                           + [(0, 0)] * (a.ndim - axis - 1)) for a in arrs]
        elif k in ("image_grid_thw", "video_grid_thw"):
            n = max(a.shape[0] for a in arrs)
            arrs = [np.pad(a, [(0, n - a.shape[0]), (0, 0)]) for a in arrs]
        elif k == "input_audio_embeds":
            n = max(a.shape[1] for a in arrs)
            arrs = [np.pad(a, [(0, 0), (0, n - a.shape[1]), (0, 0)])
                    for a in arrs]
        elif k == "position_ids" and arrs[0].ndim == 3:
            n = max(a.shape[1] for a in arrs)
            arrs = [np.pad(a, [(0, 0), (0, n - a.shape[1]), (0, 0)],
                           constant_values=1) for a in arrs]
        else:
            max_s = max(a.shape[-1] for a in arrs)
            if any(a.shape[-1] != max_s for a in arrs):
                pad_val = PAD_TOKEN_IDS.get(k) or 0
                arrs = [np.pad(a, [(0, 0)] * (a.ndim - 1)
                               + [(0, max_s - a.shape[-1])],
                               constant_values=pad_val) for a in arrs]
        out[k] = np.stack(arrs, axis=0)
    return out


def to_device_batch(microbatches: List[Dict[str, np.ndarray]],
                    device, shard=None) -> Dict[str, torch.Tensor]:
    """Collated numpy microbatches -> ``[A, B, S]`` tensors on ``device``
    in the collater's dtypes (int32 ids and grids, float32 pixels and
    patch rows); ``shard`` (``TrainStep.shard_batch``) takes this rank's
    part of the stacked host batch first."""
    stacked = stack_microbatches(microbatches)
    stacked.pop("loss_mask", None)      # already folded into the labels
    if shard is not None:
        stacked = shard(stacked)
    return {k: torch.from_numpy(v).to(device) for k, v in stacked.items()}


def stage_batch(microbatches: List[Dict[str, np.ndarray]], device,
                stream: Optional["torch.cuda.Stream"] = None, shard=None
                ) -> Dict[str, torch.Tensor]:
    """:func:`to_device_batch`, but with ``stream`` (a CUDA stream) the
    copies come from pinned host memory on that stream, without waiting:
    pass the batch through :func:`use_staged` before a step reads it."""
    if stream is None:
        return to_device_batch(microbatches, device, shard=shard)
    stacked = stack_microbatches(microbatches)
    stacked.pop("loss_mask", None)
    if shard is not None:
        stacked = shard(stacked)
    with torch.cuda.stream(stream):
        return {k: torch.from_numpy(v).pin_memory().to(device,
                                                       non_blocking=True)
                for k, v in stacked.items()}


def use_staged(batch: Dict[str, torch.Tensor],
               stream: Optional["torch.cuda.Stream"]) -> None:
    """Order the current stream after ``stream``'s copies of ``batch``,
    and tell the allocator the current stream uses the tensors (so their
    memory is not reused before it is done with them)."""
    if stream is None:
        return
    current = torch.cuda.current_stream(stream.device)
    current.wait_stream(stream)
    for t in batch.values():
        t.record_stream(current)
