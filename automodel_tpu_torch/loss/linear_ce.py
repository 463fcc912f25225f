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

The vocab-parallel combine (``_sharded_lse_pick``) waits for the port's
multi-GPU slice and raises.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from automodel_tpu_torch.loss.masked_ce import IGNORE_INDEX
from automodel_tpu_torch.ops.linear_ce_kernel import lse_and_pick


def _sharded_lse_pick(*args, **kwargs):
    raise NotImplementedError(
        "the vocab-parallel fused linear CE (_sharded_lse_pick) is not "
        "ported: it comes with multi-GPU (ROADMAP Queue 1 item 9)")


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
        if (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            return _sharded_lse_pick(hidden_states, lm_head_kernel, labels)
        B, S, H = hidden_states.shape
        lse, pick = lse_and_pick(hidden_states.reshape(B * S, H),
                                 lm_head_kernel, labels.reshape(B * S),
                                 self.bwd_mode, impl=self.impl)
        valid = labels.reshape(B * S) != IGNORE_INDEX
        return torch.where(valid, lse - pick, torch.zeros_like(lse)).sum()

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
