"""Rematerialization policies of the decoder layers (counterpart:
``automodel_tpu/ops/remat.py``).

The JAX model wraps its layer body in ``jax.checkpoint`` with a policy that
says which in-layer tensors survive to the backward pass.  The port runs
each checkpointed unit (``scan_block`` layers) under
``torch.utils.checkpoint(..., use_reentrant=False)``; what a policy keeps
is recorded in the unit's forward and handed back by its recomputation
instead of being computed again, through the checkpoint's ``context_fn``:

* the tensors the models tag (the splash attention's outputs, the
  :func:`checkpoint_name` tags) record and replay themselves
  (:func:`kept`): the unit's contexts hold a list of their outputs, and
  nothing else of the unit pays for it;
* the matmul policies keep ``aten`` ops, which only a dispatch mode sees:
  PyTorch's selective activation checkpointing
  (``create_selective_checkpoint_contexts``) with a policy that marks them
  ``MUST_SAVE``.  Its mode runs Python for every op of the unit, forward
  and recomputation (on the CPU a tiny 16-layer model's step took about
  40 % longer under it), which is why the tags do without it.

The policy names are the JAX package's:

* ``nothing_saveable`` / ``none`` / None: keep the unit's input only,
  recompute everything (the default);
* ``everything_saveable``: keep everything, so the unit runs without a
  checkpoint;
* ``dots_saveable`` (alias ``checkpoint_dots``): keep the outputs of the
  matmuls (``aten.mm`` / ``addmm`` / ``bmm`` and the plain quantized
  route's ``_scaled_mm``), as JAX keeps its ``dot_general`` s -- not the
  hand-written kernels' outputs, as JAX keeps no Pallas call's;
* ``dots_with_no_batch_dims_saveable`` (alias
  ``checkpoint_dots_with_no_batch_dims``): the same without ``bmm``;
* ``save_names:<tag>[,<tag>...]`` with the tags the models put on their
  tensors: ``attn_core`` (the attention output, before ``o_proj``),
  ``mlp_silu`` (``silu(gate) * up``) and ``splash_residuals`` (the splash
  attention's ``(out, lse)``: the backward runs the dq / dkv kernels
  straight from them, so the forward kernel launches once per layer and
  microbatch instead of twice).

Eager recomputation has no dead-code elimination: ops upstream of a kept
tensor run again all the same, so keeping ``attn_core`` or ``mlp_silu``
costs memory and skips only the tagged op itself.  A tag copies its input
(:func:`checkpoint_name`); the models apply it only where their policy
keeps the tag.  The host-offload policies raise ``NotImplementedError``;
any other name raises ``ValueError``, as in JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Callable, FrozenSet, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

NOTHING_SAVEABLE = "nothing_saveable"
_PREFIX = "save_names:"
TAGS = ("attn_core", "mlp_silu", "splash_residuals")
_DOTS = ("aten::mm", "aten::addmm", "aten::_scaled_mm")
_DOT_POLICIES = {
    "dots_saveable": _DOTS + ("aten::bmm",),
    "checkpoint_dots": _DOTS + ("aten::bmm",),
    "dots_with_no_batch_dims_saveable": _DOTS,
    "checkpoint_dots_with_no_batch_dims": _DOTS,
}
_OFFLOAD = ("offload_dot_with_no_batch_dims",
            "save_and_offload_only_these_names")
_FACTORIES = ("save_only_these_names", "save_anything_except_these_names",
              "save_any_names_but_these", "save_from_both_policies")


@dataclasses.dataclass(frozen=True)
class RematPolicy:
    """A resolved policy: ``save_all`` (no checkpoint), or the op names
    (``ops``) and tags (``names``) whose outputs the forward keeps."""

    name: str
    save_all: bool = False
    ops: FrozenSet[str] = frozenset()
    names: FrozenSet[str] = frozenset()

    def __str__(self) -> str:
        return self.name


def resolve_remat_policy(name: Optional[str]) -> RematPolicy:
    """Policy string -> :class:`RematPolicy`; raises on names JAX does
    not resolve to a policy and on the host-offload policies."""
    if not name or name in ("none", NOTHING_SAVEABLE):
        return RematPolicy(NOTHING_SAVEABLE)
    if name == "everything_saveable":
        return RematPolicy(name, save_all=True)
    if name in _DOT_POLICIES:
        return RematPolicy(name, ops=frozenset(_DOT_POLICIES[name]))
    if name.startswith(_PREFIX):
        names = frozenset(n.strip() for n in name[len(_PREFIX):].split(",")
                          if n.strip())
        unknown = sorted(names - set(TAGS))
        if unknown or not names:
            raise ValueError(
                f"remat policy {name!r}: unknown tag(s) {unknown}; the "
                f"models tag {', '.join(TAGS)}")
        return RematPolicy(name, names=names)
    if name in _OFFLOAD:
        raise NotImplementedError(
            f"remat policy {name!r} offloads residuals to host memory, "
            "which the port does not do yet (ROADMAP Queue 1 item 4)")
    if name in _FACTORIES:
        raise ValueError(
            f"remat policy {name!r} is a policy factory, not a policy: use "
            f"'{_PREFIX}<tag>[,<tag>...]' with tags {' / '.join(TAGS)}")
    raise ValueError(
        f"Unknown remat policy {name!r}: use a jax.checkpoint_policies "
        f"attribute or '{_PREFIX}<tag>[,<tag>...]' with tags "
        f"{' / '.join(TAGS)}")


class _Kept:
    """One checkpointed unit's kept outputs: recorded by the forward,
    handed back in order by each recomputation."""

    def __init__(self, names: FrozenSet[str]):
        self.names = names
        self.outs: List = []
        self.replay: Optional[int] = None       # None: recording


class _Entered:
    """The unit's forward (``replay`` False) or recomputation context:
    while it is entered, :func:`kept` records into (or replays from) its
    unit's ``_Kept``."""

    _local = threading.local()

    def __init__(self, kept_outs: _Kept, replay: bool):
        self.kept_outs, self.replay = kept_outs, replay

    def __enter__(self):
        self._prev = getattr(self._local, "kept", None)
        self._local.kept = self.kept_outs
        self.kept_outs.replay = 0 if self.replay else None
        return self

    def __exit__(self, *exc):
        self._local.kept = self._prev
        return False


def _detached(out):
    if isinstance(out, tuple):
        return tuple(t.detach() for t in out)
    return out.detach()


def kept(tag: str, compute: Callable):
    """``compute()``'s tensor (or tuple of tensors); inside a checkpointed
    unit whose policy keeps ``tag``, recorded in the forward and, in the
    recomputation, the recorded one again without running ``compute``.
    Called by the tagged ops themselves, in an ``autograd.Function``'s
    forward, so the recomputed graph still differentiates through them."""
    rec = getattr(_Entered._local, "kept", None)
    if rec is None or tag not in rec.names:
        return compute()
    if rec.replay is None:
        out = compute()
        rec.outs.append(_detached(out))
        return out
    out = rec.outs[rec.replay]
    rec.replay += 1
    return _detached(out)


class _Tag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name):
        return kept(name, x.clone)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` under the tag ``name`` (a copy), which a ``save_names`` policy
    keeps."""
    return _Tag.apply(x, name)


def _policy_fn(policy: RematPolicy, ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op.name() in policy.ops
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _kept_contexts(names: FrozenSet[str]):
    kept_outs = _Kept(names)
    return _Entered(kept_outs, False), _Entered(kept_outs, True)


def checkpoint_layer(fn, *args, policy: RematPolicy):
    """``fn(*args)`` whose intermediates the backward recomputes, except
    what ``policy`` keeps."""
    if policy.save_all:
        return fn(*args)
    if policy.ops:
        from torch.utils.checkpoint import (
            create_selective_checkpoint_contexts,
        )

        context_fn = functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_policy_fn, policy))
    elif policy.names:
        context_fn = functools.partial(_kept_contexts, policy.names)
    else:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)
