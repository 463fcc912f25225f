"""Fused linear + cross-entropy: the CE from hidden states without the
``[B, S, V]`` logits tensor (counterpart: ``automodel_tpu/loss/linear_ce.py``).

The model hands over ``hidden_states [B, S, H]`` and the LM head
``[H, V]`` (``needs_hidden``); the loss is a **sum** of token CE, as every
loss of the framework, and the train step divides by the label-token count.

Two routes, as in the JAX package:

* ``use_kernel`` None or True: ``ops/linear_ce_kernel.py::lse_and_pick``
  gives each row's ``(logsumexp, picked logit)``; on CUDA tensors that is
  the hand-written kernels (forward, dlogits, dh, dW), on CPU tensors their
  plain versions (``impl="plain"``, a port-only argument, forces those on
  the card too).  The JAX package resolves the kernel through its registry
  and falls back to the chunk scan off the TPU; here the device of the
  tensors decides, and nothing falls back.
* ``use_kernel=False``: the chunked path -- logits of one ``chunk_len``
  slice of the sequence at a time, each chunk under
  ``torch.utils.checkpoint`` (``jax.checkpoint`` in the JAX scan), so the
  backward recomputes them and peak memory is one ``[B, C, V]`` chunk.

Under an active sharding context with tp > 1 (``distributed/
shardings.py``) the head is this rank's vocab slice ``[H, V / tp]`` and
:func:`_sharded_lse_pick` merges the ranks' ``(lse, pick)``, as the JAX
one: kernel 2 (or its plain version) at the local slice with the label
offset (:func:`shard_lse_pick`), then :func:`merge_lse_pick`:
``lse = max + log(sum_tp exp(lse - max))`` with a stop-gradient max,
``pick = sum_tp pick``; the backward is kernels 3-4 with their per-row
cotangents.  FSDP has gathered the head's embed dim already.  Off
the vocab's split nothing changes: a data-parallel rank's loss is its
rows' sum, which the train step sums over the ranks.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from automodel_tpu_torch.loss.masked_ce import IGNORE_INDEX
from automodel_tpu_torch.ops.linear_ce_kernel import lse_and_pick


def shard_lse_pick(h: torch.Tensor, kernel: torch.Tensor,
                   labels: torch.Tensor, rank: int, bwd_mode: str = "pallas",
                   impl: Optional[str] = None):
    """One vocab shard's per-row ``(lse, pick)`` ``[N]`` of ``h [N, H]``
    over ``kernel [H, V / tp]``, the ``rank``-th slice of the head: the
    labels shifted by the slice's offset (a label outside it picks 0),
    kernel 2 forward and kernels 3-4 backward (their plain versions on
    CPU tensors)."""
    lab = labels.to(torch.int32)
    local = torch.where(lab == IGNORE_INDEX, lab,
                        lab - rank * kernel.shape[1])
    return lse_and_pick(h, kernel, local, bwd_mode, impl=impl)


def merge_lse_pick(lse: torch.Tensor, pick: torch.Tensor,
                   max_over: Callable, sum_over: Callable):
    """The shards' ``(lse, pick)`` merged: ``m + log(sum exp(lse - m))``
    with ``m = max_over(lse)`` under a stop-gradient, and
    ``sum_over(pick)``.  ``max_over`` / ``sum_over`` reduce over the
    shards: the tp collectives for one rank's shard, or a reduction over
    a stacked leading dim where one process holds every shard."""
    gmax = max_over(lse.detach())
    return gmax + torch.log(sum_over(torch.exp(lse - gmax))), sum_over(pick)


def token_ce(lse: torch.Tensor, pick: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """``lse - pick`` per row, 0 where the label is ignored."""
    return torch.where(labels != IGNORE_INDEX, lse - pick,
                       torch.zeros_like(lse))


def _sharded_lse_pick(hidden: torch.Tensor, kernel: torch.Tensor,
                      labels: torch.Tensor, tp, bwd_mode: str = "pallas",
                      impl: Optional[str] = None) -> torch.Tensor:
    """Per-token ``lse - pick`` ``[B, S]`` (0 on ignored labels) of
    ``hidden [B, S, H]`` (the same on every tp rank) over a vocab-sharded
    head ``kernel [H, V / tp]`` (``tp``: a
    ``distributed.tensor_parallel.TPContext``): :func:`shard_lse_pick` at
    this rank's slice, :func:`merge_lse_pick` over the tp group.  The
    merge's collectives pass whole gradients back, and the hidden states'
    partial gradients are summed over tp."""
    from automodel_tpu_torch.distributed import tensor_parallel as T

    B, S, H = hidden.shape
    h = T.copy_to_tp(hidden, tp).reshape(B * S, H)
    lab = labels.reshape(B * S)
    lse, pick = shard_lse_pick(h, kernel, lab, tp.rank, bwd_mode, impl=impl)
    lse, pick = merge_lse_pick(lse, pick,
                               lambda t: T.max_over_tp(t, tp),
                               lambda t: T.reduce_from_tp(t, tp))
    return token_ce(lse, pick, lab).reshape(B, S)


def _tp_context():
    """The tp group of an active sharding context with tp > 1, else None."""
    from automodel_tpu_torch.distributed.shardings import current_sharding

    ctx = current_sharding()
    if ctx is None or ctx[0].tp_size <= 1:
        return None
    import torch.distributed as dist

    from automodel_tpu_torch.distributed.mesh import AXIS_TP
    from automodel_tpu_torch.distributed.tensor_parallel import TPContext

    group = ctx[0].group((AXIS_TP,))
    return TPContext(group=group, size=ctx[0].tp_size,
                     rank=dist.get_rank(group))


def _chunk_loss(h: torch.Tensor, kernel: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    logits = (h @ kernel).float()                  # [B, C, V], transient
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, lse - picked, torch.zeros_like(lse)).sum()


class FusedLinearCrossEntropy:
    """``loss_fn._target_: automodel_tpu.loss.linear_ce.
    FusedLinearCrossEntropy`` (the JAX target name maps to this class)."""

    needs_hidden = True
    reduction = "sum"

    def __init__(self, chunk_len: int = 512, ignore_index: int = IGNORE_INDEX,
                 use_kernel: Optional[bool] = None, bwd_mode: str = "pallas",
                 impl: Optional[str] = None):
        if ignore_index != IGNORE_INDEX:
            raise NotImplementedError(
                f"only ignore_index={IGNORE_INDEX} is ported")
        if bwd_mode == "xla":
            raise NotImplementedError(
                "FusedLinearCrossEntropy(bwd_mode='xla') -- the JAX "
                "chunk-scan backward kept as a comparison point -- is not "
                "ported (ROADMAP Queue 2, with the linear-CE kernels)")
        if bwd_mode != "pallas":
            raise ValueError(f"bwd_mode must be 'pallas' or 'xla', got "
                             f"{bwd_mode!r}")
        self.chunk_len = int(chunk_len)
        self.use_kernel = use_kernel
        self.bwd_mode = bwd_mode
        self.impl = impl

    def _kernel_path(self, hidden_states, lm_head_kernel, labels):
        tp = _tp_context()
        if tp is not None:
            return _sharded_lse_pick(hidden_states, lm_head_kernel, labels,
                                     tp, self.bwd_mode, impl=self.impl).sum()
        B, S, H = hidden_states.shape
        lse, pick = lse_and_pick(hidden_states.reshape(B * S, H),
                                 lm_head_kernel, labels.reshape(B * S),
                                 self.bwd_mode, impl=self.impl)
        return token_ce(lse, pick, labels.reshape(B * S)).sum()

    def __call__(
        self,
        hidden_states: torch.Tensor,    # [B, S, H]
        lm_head_kernel: torch.Tensor,   # [H, V]
        labels: torch.Tensor,           # [B, S]
        mask: Optional[torch.Tensor] = None,
        num_label_tokens: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if mask is not None:
            labels = torch.where(mask.bool(), labels,
                                 torch.full_like(labels, IGNORE_INDEX))
        if self.use_kernel is None or self.use_kernel:
            total = self._kernel_path(hidden_states, lm_head_kernel, labels)
        elif _tp_context() is not None:
            # a vocab slice has no chunked form of its own: the merge's
            # plain products
            total = _sharded_lse_pick(hidden_states, lm_head_kernel, labels,
                                      _tp_context(), self.bwd_mode,
                                      impl="plain").sum()
        else:
            B, S, _ = hidden_states.shape
            C = min(self.chunk_len, S)
            kernel = lm_head_kernel.to(hidden_states.dtype)
            total = torch.zeros((), dtype=torch.float32,
                                device=hidden_states.device)
            for s0 in range(0, S, C):
                total = total + checkpoint(
                    _chunk_loss, hidden_states[:, s0:s0 + C], kernel,
                    labels[:, s0:s0 + C], use_reentrant=False)
        if num_label_tokens is not None:
            total = total / num_label_tokens
        return total
