"""Per-token logprob pass (counterpart:
``automodel_tpu/post_training/logprobs.py``).

The pass is the train step's forward: the model runs with
``return_hidden=True`` and each position's ``log p(label)`` comes from the
fused linear-CE machinery, so the ``[B, S, V]`` logits never exist:

* ``ops/linear_ce_kernel.py::lse_and_pick`` gives each row's ``(lse,
  picked logit)``: on CUDA tensors kernel 2 in the forward and kernels 3
  and 4 in the backward, which take per-row ``(dlse, dpick)`` cotangents
  (the GRPO and DPO objectives give every row its own; prompt and pad rows
  get 0); on CPU tensors its plain versions, one chunk of rows at a time
  with the same hand-written backward.  ``impl="plain"`` forces the plain
  versions on the card, ``impl="kernel"`` the kernels.

The JAX package takes its vocab-parallel ``_sharded_lse_pick`` only under
a mesh; the port runs one process until multi-GPU (ROADMAP Queue 1 item
9) and raises there, as ``loss/linear_ce.py`` does.

Batch convention (:func:`make_sequence_batch`): ``input_ids [B, S]``
padded right, ``labels [B, S]`` holding the next token at every position
whose next token is a completion token and ``IGNORE_INDEX`` elsewhere,
``position_ids`` a plain arange.  Right padding leaves every valid
position as it is: attention is causal, and pad labels are ignored.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from automodel_tpu_torch.loss.linear_ce import _sharded_lse_pick
from automodel_tpu_torch.loss.masked_ce import IGNORE_INDEX
from automodel_tpu_torch.ops.linear_ce_kernel import lse_and_pick

__all__ = [
    "IGNORE_INDEX",
    "batch_to_device",
    "build_logprob_fn",
    "completion_logprobs",
    "make_sequence_batch",
    "token_nll",
]

_FORWARD_KEYS = ("position_ids", "segment_ids", "attention_mask")


def token_nll(hidden: torch.Tensor, kernel: torch.Tensor,
              labels: torch.Tensor, impl: Optional[str] = None
              ) -> torch.Tensor:
    """Per-token negative log-likelihood ``[B, S]`` fp32 (``lse -
    picked``, 0.0 where ``labels == IGNORE_INDEX``), differentiable.
    ``hidden [B, S, H]``, ``kernel [H, V]`` (the model's head view).
    ``impl`` goes to ``lse_and_pick`` (None: the kernels on CUDA tensors,
    the plain versions on CPU tensors)."""
    if (torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        return _sharded_lse_pick(hidden, kernel, labels)
    B, S, H = hidden.shape
    lse, pick = lse_and_pick(hidden.reshape(B * S, H), kernel,
                             labels.reshape(B * S), impl=impl)
    valid = labels.reshape(B * S) != IGNORE_INDEX
    return torch.where(valid, lse - pick,
                       torch.zeros_like(lse)).reshape(B, S)


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """numpy arrays of a batch -> tensors on ``device`` (tensors moved,
    None kept)."""
    out = {}
    for k, v in batch.items():
        if v is None:
            out[k] = None
        elif torch.is_tensor(v):
            out[k] = v.to(device)
        else:
            out[k] = torch.from_numpy(np.asarray(v)).to(device)
    return out


def completion_logprobs(model, batch: Dict[str, Any],
                        impl: Optional[str] = None,
                        attn_impl: Optional[str] = None) -> torch.Tensor:
    """``log p(labels | input_ids)`` per token, ``[B, S]`` fp32, 0.0 at
    every ``IGNORE_INDEX`` position, through the model's train forward
    (``return_hidden=True``).  ``batch`` holds tensors on the model's
    device and may carry ``position_ids`` / ``segment_ids`` /
    ``attention_mask``; ``impl`` goes to :func:`token_nll` and
    ``attn_impl`` to the model's attention."""
    kwargs = {k: batch[k] for k in _FORWARD_KEYS if batch.get(k) is not None}
    out = model(batch["input_ids"], return_hidden=True, attn_impl=attn_impl,
                **kwargs)
    return -token_nll(out["hidden_states"], out["lm_head_kernel"],
                      batch["labels"], impl=impl)


def build_logprob_fn(impl: Optional[str] = None,
                     attn_impl: Optional[str] = None) -> Callable:
    """``fn(model, batch) -> [B, S]`` fp32: the logprob pass without a
    gradient (the frozen reference's pass).  The JAX function takes
    ``(params, batch)`` and jits; a port model carries its weights, so the
    live policy and the frozen reference are two models here.  ``batch``
    may hold numpy arrays; they are moved to the model's device."""

    @torch.no_grad()
    def fn(model, batch):
        return completion_logprobs(
            model, batch_to_device(batch, model.inv_freq.device),
            impl=impl, attn_impl=attn_impl)

    return fn


# ---------------------------------------------------------------------------
# Host-side batch building
# ---------------------------------------------------------------------------
def make_sequence_batch(sequences: Sequence[Sequence[int]],
                        prompt_lens: Sequence[int], *,
                        pad_id: int = 0,
                        pad_to: Optional[int] = None,
                        ) -> Dict[str, np.ndarray]:
    """``{prompt + completion}`` token lists -> the logprob batch, the JAX
    function's arrays byte for byte:

    * ``input_ids [B, S]`` int32, right-padded with ``pad_id``;
    * ``labels [B, S]`` int32: ``labels[b, i] = seq[i + 1]`` where ``i + 1
      >= prompt_len``, ``IGNORE_INDEX`` elsewhere (a sequence of P prompt
      and C completion tokens gives exactly C supervised positions);
    * ``position_ids [B, S]`` int32, a plain arange.

    ``pad_to`` pins the width (every rollout batch of a run has one
    shape); a longer sequence raises."""
    if not sequences:
        raise ValueError("make_sequence_batch: no sequences")
    if len(sequences) != len(prompt_lens):
        raise ValueError(
            f"make_sequence_batch: {len(sequences)} sequences vs "
            f"{len(prompt_lens)} prompt lengths")
    B = len(sequences)
    longest = max(len(s) for s in sequences)
    S = pad_to if pad_to is not None else longest
    if longest > S:
        raise ValueError(
            f"make_sequence_batch: longest sequence ({longest} tokens) "
            f"exceeds pad_to={S} — raise rl.max_prompt_len / "
            "rl.max_new_tokens so the static shape covers every rollout")
    ids = np.full((B, S), pad_id, np.int32)
    labels = np.full((B, S), IGNORE_INDEX, np.int32)
    for b, (seq, plen) in enumerate(zip(sequences, prompt_lens)):
        seq = [int(t) for t in seq]
        plen = int(plen)
        if not 0 < plen <= len(seq):
            raise ValueError(
                f"make_sequence_batch: row {b} prompt_len={plen} outside "
                f"(0, len={len(seq)}]")
        ids[b, :len(seq)] = seq
        for i in range(max(plen - 1, 0), len(seq) - 1):
            labels[b, i] = seq[i + 1]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return {"input_ids": ids, "labels": labels, "position_ids": pos}
