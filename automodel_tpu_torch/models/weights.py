"""Carry the JAX package's Llama parameters into the port's module
(counterpart: the param tree of ``automodel_tpu/models/llama.py``
``LlamaForCausalLM.init``), and into the port's SFT recipe, so that the
two packages can train from the same weights.

The JAX tree stacks every layer's leaf along a leading ``[L, ...]`` axis
and stores projection kernels as ``[in, out]`` (applied as ``x @ w``).
The port keeps ``nn.Linear`` weights ``[out, in]``, so each kernel slice
is TRANSPOSED on the way in; embeddings and norm weights copy as they
are.  Values are cast to the module's parameter dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from automodel_tpu_torch.models.llama import LlamaForCausalLM

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


def jax_leaves(model: LlamaForCausalLM
               ) -> Iterator[Tuple[Tuple[str, ...], Any, bool]]:
    """``(path in the JAX tree, target, transposed)`` for every leaf.  The
    target is one parameter, or a list of per-layer parameters for a
    stacked ``layers.*`` leaf."""
    yield ("embed_tokens", "embedding"), model.embed_tokens.weight, False
    layers = model.layers
    for norm in ("input_layernorm", "post_attention_layernorm"):
        yield (("layers", norm, "weight"),
               [getattr(l, norm).weight for l in layers], False)
    for proj in _ATTN:
        yield (("layers", "self_attn", proj, "kernel"),
               [getattr(l, proj).weight for l in layers], True)
    for proj in _MLP:
        yield (("layers", "mlp", proj, "kernel"),
               [getattr(l, proj).weight for l in layers], True)
    yield ("norm", "weight"), model.norm.weight, False
    if model.lm_head is not None:
        yield ("lm_head", "kernel"), model.lm_head.weight, True


def _flatten(tree: Dict[str, Any], prefix=()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


@torch.no_grad()
def load_jax_params(model: LlamaForCausalLM, tree: Dict[str, Any]) -> None:
    """Fill ``model`` from the JAX package's nested params given as numpy
    arrays (``jax.tree.map(np.asarray, params)``).  Handles
    ``embed_tokens.embedding [V, H]``, the stacked ``layers.*`` leaves,
    ``norm.weight`` and an optional ``lm_head.kernel [H, V]``; any other
    key, a missing key or a shape mismatch raises."""
    flat = _flatten(tree)
    seen = set()
    for path, target, transposed in jax_leaves(model):
        if path not in flat:
            raise KeyError(f"JAX params lack {'.'.join(path)}")
        arr = np.asarray(flat[path])
        seen.add(path)
        targets = target if isinstance(target, list) else [target]
        if isinstance(target, list):
            if arr.shape[0] != len(targets):
                raise ValueError(
                    f"{'.'.join(path)}: {arr.shape[0]} stacked layers, model "
                    f"has {len(targets)}")
            slices = list(arr)
        else:
            slices = [arr]
        for p, a in zip(targets, slices):
            t = torch.from_numpy(np.array(a.T if transposed else a))
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(
                    f"{'.'.join(path)}: shape {tuple(t.shape)} does not fit "
                    f"parameter {tuple(p.shape)}")
            p.copy_(t.to(p.dtype))
    extra = sorted(".".join(k) for k in set(flat) - seen)
    if extra:
        raise KeyError(f"JAX params carry keys the port does not use: {extra}")


def load_jax_recipe_params(recipe, tree: Dict[str, Any]) -> None:
    """Start the port's set-up SFT recipe (``recipes/llm/train_ft.py``)
    from the JAX recipe's initialised params (numpy, as for
    :func:`load_jax_params`): fills ``recipe.model`` and drops any
    optimizer state, so the first step starts from these weights."""
    load_jax_params(recipe.model, tree)
    recipe.optimizer.state.clear()
