"""Carry the JAX package's Llama, Mixtral, Qwen3-MoE and DeepSeek-V2 / V3
parameters into the port's modules (counterpart: the param trees of
``LlamaForCausalLM.init`` in ``automodel_tpu/models/llama.py``, of its MoE
subclasses in ``mixtral.py`` / ``qwen3_moe.py`` and of
``deepseek_v3.py`` / ``deepseek_v2.py``), and into the port's SFT recipe,
so that the two packages can train from the same weights.  The DeepSeek
tree's two sub-stacks (``dense_layers``, ``layers``) and V2's gate without
a correction bias come from the model's own ``jax_tree_leaves``, as do the
other families' trees that are not Llama's (Gemma, the VLMs; Gemma-3n's
``[A - 1, H, H]`` AltUp kernels stacked like layers, its tower's HWIO
kernels copied as they are).

The JAX tree stacks every layer's leaf along a leading ``[L, ...]`` axis
and stores projection kernels as ``[in, out]`` (applied as ``x @ w``).
The port keeps ``nn.Linear`` weights ``[out, in]``, so each kernel slice
is TRANSPOSED on the way in; embeddings and norm weights copy as they
are.  The MoE families' router kernel ``[L, H, E]`` is transposed into
an ``nn.Linear`` ``[E, H]``; their expert stacks ``[L, E, H, I]`` /
``[L, E, I, H]``, Qwen3's ``q_norm`` / ``k_norm`` ``[L, D]`` and Qwen2's
q / k / v ``bias [L, out]`` copy as they are.  Values are cast to the module's parameter dtype.

An int8 base (``quantization/weight_only.py``: the JAX ``weight_only_quant
= "int8"`` tree, ``kernel`` int8 ``[L, in, out]`` plus ``scale [L, 1,
out]``) maps onto the :class:`Int8Linear` buffers, both transposed.  A
PEFT model (``peft/lora.py::LoRAModel``) is the JAX PEFT tree ``{"base":
<base tree>, "lora": {<module path>: {"A": [L, in, r], "B": [L, r,
out]}}}``: the base under ``base.``, each adapter's per-layer parameters
(``[in, r]`` / ``[r, out]``, the JAX layout) as they are.
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
    target is one parameter (or buffer), or a list of per-layer ones for
    a stacked ``layers.*`` leaf."""
    if hasattr(model, "lora_leaves"):            # a PEFT wrapper
        for path, target, transposed in jax_leaves(model.base_model):
            yield ("base",) + path, target, transposed
        yield from model.lora_leaves()
        return
    if hasattr(model, "jax_tree_leaves"):        # a split stack (DeepSeek)
        yield from model.jax_tree_leaves()
        return
    yield ("embed_tokens", "embedding"), model.embed_tokens.weight, False
    layers = model.layers
    for norm in ("input_layernorm", "post_attention_layernorm"):
        yield (("layers", norm, "weight"),
               [getattr(l, norm).weight for l in layers], False)
    for proj in _ATTN:
        yield from projection_leaves(layers, "self_attn", proj)
    if model.config.qk_norm:
        for norm in ("q_norm", "k_norm"):
            yield (("layers", "self_attn", norm, "weight"),
                   [getattr(l, norm).weight for l in layers], False)
    block = getattr(layers[0], "moe_block", None)
    if block is None:
        for proj in _MLP:
            yield from projection_leaves(layers, "mlp", proj)
    else:
        # routed experts: the router [L, H, E] (an nn.Linear [E, H] here)
        # and the expert stacks [L, E, ...], which keep the JAX layout
        blocks = [getattr(l, block) for l in layers]
        yield (("layers", block, "gate", "kernel"),
               [b.gate.weight for b in blocks], True)
        for name in layers[0].expert_names:
            yield (("layers", block, "experts", name, "kernel"),
                   [getattr(b.experts, name) for b in blocks], False)
    yield ("norm", "weight"), model.norm.weight, False
    if model.lm_head is not None:
        yield ("lm_head", "kernel"), model.lm_head.weight, True


def projection_leaves(layers, block: str, proj: str):
    """A projection's kernel leaf, its ``scale`` leaf when the layers hold
    it as an int8 base (``Int8Linear``), and its ``bias [L, out]`` leaf
    when it has one (Qwen2's q / k / v, StarCoder-2's every projection)."""
    mods = [getattr(l, proj) for l in layers]
    yield ("layers", block, proj, "kernel"), [m.weight for m in mods], True
    if hasattr(mods[0], "scale"):
        yield ("layers", block, proj, "scale"), [m.scale for m in mods], True
    if getattr(mods[0], "bias", None) is not None:
        yield ("layers", block, proj, "bias"), [m.bias for m in mods], False


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
    ``embed_tokens.embedding [V, H]``, the stacked ``layers.*`` leaves
    (int8 kernels with their scales too), ``norm.weight``, an optional
    ``lm_head.kernel [H, V]`` and, for a PEFT model, the ``{"base",
    "lora"}`` tree; any other key, a missing key or a shape mismatch
    raises."""
    flat = _flatten(tree)
    seen = set()
    for path, target, transposed in jax_leaves(model):
        if path not in flat:
            raise KeyError(f"JAX params lack {'.'.join(path)}")
        arr = np.asarray(flat[path])
        if arr.dtype.name == "bfloat16":    # ml_dtypes; torch cannot read it
            arr = arr.astype(np.float32)    # exact
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


def jax_adapter_tree(tree: Dict[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """A single-adapter LoRA tree in the JAX layout (the value of the JAX
    PEFT params' ``"lora"`` entry: ``{module path: {"A": [L, in, r], "B":
    [L, r, out]}}``, as numpy, JAX or torch arrays) -> the same tree as
    host numpy arrays, the input of ``serving/adapters.py``'s slot loads.
    bfloat16 leaves widen to float32 (exact); anything that is not such a
    tree raises ``TypeError`` / ``KeyError``."""
    if not isinstance(tree, dict):
        raise TypeError(f"an adapter tree is a dict, got {type(tree)}")
    out = {}
    for path, ab in tree.items():
        if not isinstance(ab, dict):
            raise TypeError(f"{path}: expected {{'A', 'B'}}, got {type(ab)}")
        leaves = {}
        for part in ("A", "B"):
            a = ab[part]
            if isinstance(a, torch.Tensor):
                a = a.detach().float().cpu().numpy()
            a = np.asarray(a)
            if a.dtype.name == "bfloat16":      # ml_dtypes
                a = a.astype(np.float32)
            leaves[part] = a
        out[path] = leaves
    return out
