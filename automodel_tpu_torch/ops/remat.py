"""Rematerialization of the decoder layers (counterpart:
``automodel_tpu/ops/remat.py``).

The JAX model wraps its layer body in ``jax.checkpoint`` with a policy that
says which in-layer tensors survive to the backward pass.  The port runs
each layer under ``torch.utils.checkpoint(..., use_reentrant=False)``: the
layer's input is kept and everything inside is recomputed in the backward
pass, which is the ``nothing_saveable`` policy (the JAX model's default).
The other policies (``save_names:attn_core,...``, ``dots_saveable``, ...)
keep named intermediates and wait for a later change.
"""

from __future__ import annotations

from typing import Optional

from torch.utils.checkpoint import checkpoint

NOTHING_SAVEABLE = "nothing_saveable"


def resolve_remat_policy(name: Optional[str]) -> str:
    """Policy string -> the one policy the port runs; others raise."""
    if not name or name in ("none", NOTHING_SAVEABLE):
        return NOTHING_SAVEABLE
    raise NotImplementedError(
        f"remat policy {name!r} is not ported: the port runs "
        f"{NOTHING_SAVEABLE!r} (or remat off); save_names / *_saveable "
        "policies come with a later port slice")


def checkpoint_layer(fn, *args):
    """``fn(*args)`` whose intermediates are recomputed in the backward
    pass (``nothing_saveable``)."""
    return checkpoint(fn, *args, use_reentrant=False)
