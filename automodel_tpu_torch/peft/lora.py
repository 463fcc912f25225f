"""LoRA and QLoRA over the port's models (counterpart:
``automodel_tpu/peft/lora.py``).

:class:`LoRAModel` wraps a base ``LlamaForCausalLM`` (or an MoE family):
every base parameter is frozen (``requires_grad=False``), and each
targeted projection gets per-layer adapters ``A [in, r]`` / ``B [r, out]``
(the JAX layout; the JAX tree stacks them ``[L, in, r]`` / ``[L, r,
out]``), so gradients, accumulation buffers and optimizer state exist for
the adapters only -- the JAX train step's trainable-subtree mode.  Targets
are matched on the JAX tree paths (``peft/module_matcher.py``); the head
is never one.

Two forwards, picked as in JAX (``PeftConfig.use_rank_r_bypass``
overrides): the **bypass** ``y += s ((x m?) A) B`` when dropout is on, the
base is quantized or the model has more than 4e9 parameters; else the
**merge**, where each step makes ``(W.float() + s A.float() @ B.float())``
cast back to ``W``'s dtype for every target and layer before the forward
(never cached across steps).  Both reach the model's ``_proj`` as
``models/llama.py::LayerAdapter``s.  ``quantize_base: int8`` turns the
frozen base into ``quantization/weight_only.py`` int8 codes.

On an image-text model the targets are the projections of its decoder,
``language_model.layers.*`` (:func:`decoder_prefix`), and the adapters reach
the decoder through the model's forward keywords.  As in JAX, where a VLM's
forward takes no ``adapters`` keyword, such a model runs the merge only:
the bypass, dropout and an int8 base are refused.

With a cache (the decode engine, ``generate()``) the forward merges the
adapters into the weights (the bypass over an int8 base): a LoRA model
serves as a single-adapter engine.  :func:`adapter_slab_shapes` gives
the multi-tenant slot layout of ``serving/adapters.py``, and
:meth:`LoRAModel.load_adapter_tree` sets the adapters from the JAX layout
that a slot loads.

Dropout masks come from a seed per (step, microbatch, layer) and the
projection's name (``set_dropout_step``): they repeat under remat and
after a resume, but are not JAX's masks (another generator).

:func:`save_adapters` / :func:`load_adapters` write and read the HF-PEFT
files, ``adapter_model.safetensors`` (``base_model.model.<HF module>.
lora_{A,B}.weight`` in torch's ``(out, in)`` layout, fp32) and
``adapter_config.json``, through the port's own safetensors code.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from automodel_tpu_torch.models.hf_io import (
    key_map_for,
    read_safetensors,
    write_safetensors,
)
from automodel_tpu_torch.models.llama import LayerAdapter, as_dtype
from automodel_tpu_torch.models.weights import jax_leaves
from automodel_tpu_torch.peft.module_matcher import ModuleMatcher
from automodel_tpu_torch.quantization.weight_only import quantize_base_params

PATH_SEP = "."
ADAPTER_FILE = "adapter_model.safetensors"
ADAPTER_CONFIG = "adapter_config.json"
# projections that run through the model's ``_proj`` seam
_PROJ_BLOCKS = {"self_attn": ("q_proj", "k_proj", "v_proj", "o_proj"),
                "mlp": ("gate_proj", "up_proj", "down_proj")}
def decoder_prefix(targets) -> Tuple[str, ...]:
    """The JAX path of the decoder whose ``layers.*`` projections are all
    of ``targets`` (``{module path: (kernel path, ...)}``): ``()`` for a
    text model, ``("language_model",)`` for an image-text one.  A target
    that is not a layer-stacked attention or dense-MLP projection of that
    one decoder raises."""
    first = next(iter(targets.values()))[0]
    prefix = ("language_model",) if first[0] == "language_model" else ()
    n = len(prefix)
    for mod_path, (path, _) in sorted(targets.items()):
        if (path[:n] != prefix or len(path) != n + 4
                or path[n] != "layers"):
            # the JAX adapters hold [L, in, out] kernels only
            raise ValueError(
                f"LoRA target {mod_path} is no layer-stacked [L, in, "
                f"out] kernel of the decoder (expert stacks and tower "
                f"kernels cannot take adapters here)")
        if path[n + 2] not in _PROJ_BLOCKS.get(path[n + 1], ()):
            raise NotImplementedError(
                f"LoRA on {mod_path} is not ported: adapters reach the "
                "attention and dense MLP projections only")
    return prefix


@dataclasses.dataclass
class PeftConfig:
    """The JAX ``PeftConfig``'s fields and defaults; ``use_triton`` is
    accepted and ignored, as there."""

    target_modules: List[str] = dataclasses.field(
        default_factory=lambda: ["*_proj"])
    exclude_modules: List[str] = dataclasses.field(default_factory=list)
    match_all_linear: bool = False
    dim: int = 8
    alpha: int = 32
    dropout: float = 0.0
    dropout_position: str = "post"
    lora_A_init: str = "xavier"
    lora_dtype: Optional[str] = None
    use_triton: bool = False
    use_rank_r_bypass: Optional[bool] = None
    quantize_base: Optional[str] = None

    def __post_init__(self):
        if self.dropout_position not in ("pre", "post"):
            raise ValueError(
                f"dropout_position must be 'pre' or 'post', got "
                f"{self.dropout_position!r}")

    @property
    def scale(self) -> float:
        return self.alpha / self.dim


def match_targets(model, config: PeftConfig
                  ) -> Dict[str, Tuple[Tuple[str, ...], Any]]:
    """``{module path: (JAX tree path of its kernel, per-layer weights)}``
    for every targeted linear kernel (``lm_head`` always skipped)."""
    matcher = ModuleMatcher(
        target_modules=list(config.target_modules or []),
        exclude_modules=list(config.exclude_modules or []),
        match_all_linear=config.match_all_linear)
    out = {}
    for path, target, _ in jax_leaves(model):
        if path[-1] != "kernel" or path[0] == "lm_head":
            continue
        module_path = PATH_SEP.join(path[:-1])
        if matcher.match(module_path):
            out[module_path] = (path, target)
    return out


def adapter_slab_shapes(model, config: PeftConfig, num_slots: int
                        ) -> Dict[str, Tuple[tuple, tuple]]:
    """``{module path: ((L, E, in, r), (L, E, r, out))}``: the stacked
    multi-tenant slot layout of ``serving/adapters.py`` (E = ``num_slots``,
    slot 0 the zero adapter), the JAX function's.  Targets must be
    layer-stacked projections (``layers.*``)."""
    r = config.dim
    shapes: Dict[str, Tuple[tuple, tuple]] = {}
    for mod_path, (path, target) in sorted(
            match_targets(model, config).items()):
        if len(path) != 4 or path[0] != "layers" or \
                path[2] not in _PROJ_BLOCKS.get(path[1], ()):
            raise ValueError(
                f"multi-adapter slabs need layer-stacked (L, in, out) "
                f"projection kernels; {mod_path} is not one")
        fout, fin = target[0].shape
        L = len(target)
        shapes[mod_path] = ((L, num_slots, fin, r), (L, num_slots, r, fout))
    return shapes


def _stream_seed(*coords: int) -> int:
    seq = np.random.SeedSequence([int(c) for c in coords])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


class _Adapter(nn.Module):
    """One target's per-layer ``A`` and ``B``."""

    def __init__(self, a_list, b_list):
        super().__init__()
        self.A = nn.ParameterList(a_list)
        self.B = nn.ParameterList(b_list)


class LoRAModel(nn.Module):
    """The base model with frozen weights and trainable adapters; attributes
    it does not have (``config``, ``quant``, ``qdot_impl``, ...) are the
    base model's, read and set there.  ``seed`` draws the adapters'
    initial ``A`` and the dropout masks."""

    def __init__(self, base_model, peft_config: PeftConfig, seed: int = 0):
        super().__init__()
        cfg = peft_config
        # validate everything before touching base_model, as JAX does
        refusal = getattr(base_model, "peft_refusal", None)
        if refusal:
            raise NotImplementedError(refusal)
        targets = match_targets(base_model, cfg)
        if not targets:
            raise ValueError(
                f"PEFT matched no modules for targets {cfg.target_modules}")
        prefix = decoder_prefix(targets)
        # the JAX LoRA runs the bypass only through a forward with an
        # ``adapters`` keyword: the text decoders', not the VLMs'
        supports = not prefix
        name = type(base_model).__name__
        if cfg.use_rank_r_bypass is not None:
            bypass = bool(cfg.use_rank_r_bypass)
            if bypass and not supports:
                raise ValueError(
                    f"{name} does not support the rank-r bypass forward "
                    "(no `adapters` kwarg)")
        else:
            bypass = supports and (cfg.dropout > 0.0
                                   or cfg.quantize_base is not None
                                   or base_model.num_params > 4e9)
        if not bypass and cfg.dropout:
            raise ValueError(
                "LoRA dropout needs the rank-r bypass forward; "
                + ("use_rank_r_bypass=False picks the merged path"
                   if supports else f"{name} only supports the merged "
                   "path"))
        if cfg.quantize_base:
            if cfg.quantize_base != "int8":
                raise ValueError(
                    f"quantize_base={cfg.quantize_base!r}: only 'int8' "
                    "weight-only quantization is supported")
            if not supports:
                raise ValueError(
                    f"{name} does not support weight-only base "
                    "quantization")
            if not bypass:
                raise ValueError(
                    "quantize_base needs the rank-r bypass forward (an int8 "
                    "kernel cannot be merged with the fp adapter delta)")
        self.base_model = base_model
        self.peft_config = cfg
        self.bypass = bypass
        self.seed = int(seed)
        self._dropout_at = (0, 0)            # (step, microbatch)
        self._prefix = prefix
        n = len(prefix)
        # {module path: (tree path, _proj name, layer attribute)}
        self.targets = {m: (p, PATH_SEP.join(p[n + 1:n + 3]), p[n + 2])
                        for m, (p, _) in sorted(targets.items())}
        for p in base_model.parameters():
            p.requires_grad_(False)
        if cfg.quantize_base:
            quantize_base_params(base_model)
        decoder = self.decoder
        dtype = (as_dtype(cfg.lora_dtype) if cfg.lora_dtype
                 else base_model.param_dtype)
        dev = decoder.inv_freq.device
        r = cfg.dim
        self.adapters = nn.ModuleDict()
        for mod_path, (_, _, attr) in self.targets.items():
            lins = [getattr(layer, attr) for layer in decoder.layers]
            self.adapters[self._key(mod_path)] = _Adapter(
                [nn.Parameter(torch.empty(l.in_features, r, dtype=dtype,
                                          device=dev)) for l in lins],
                [nn.Parameter(torch.empty(r, l.out_features, dtype=dtype,
                                          device=dev)) for l in lins])
        self.init_lora(self.seed)

    # -- attribute delegation ------------------------------------------------
    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            base = self.__dict__.get("_modules", {}).get("base_model")
            if base is None:
                raise
            return getattr(base, name)

    def __setattr__(self, name, value):
        base = self.__dict__.get("_modules", {}).get("base_model")
        if (base is not None and name not in self.__dict__
                and not isinstance(value, (nn.Module, torch.Tensor))
                and hasattr(base, name)):
            setattr(base, name, value)
        else:
            super().__setattr__(name, value)

    @property
    def decoder(self):
        """The decoder whose layers hold the targets: the base model, or
        an image-text model's ``language_model``."""
        base = self.base_model
        return base.language_model if self._prefix else base

    @staticmethod
    def _key(mod_path: str) -> str:
        return mod_path.replace(PATH_SEP, "__")

    def adapter(self, mod_path: str) -> _Adapter:
        return self.adapters[self._key(mod_path)]

    # -- params ------------------------------------------------------------
    @torch.no_grad()
    def init_lora(self, seed: int) -> None:
        """Fresh adapters: ``A`` drawn per target (sorted by path, a seed
        each) over its whole ``[L, in, r]`` stack -- xavier: uniform in
        ``+-sqrt(6 / in)``, gaussian: N(0, 1) / sqrt(r) -- and ``B = 0``
        (the wrapped model equals the base)."""
        cfg = self.peft_config
        for i, mod_path in enumerate(self.targets):
            ad = self.adapter(mod_path)
            L, (fin, r) = len(ad.A), ad.A[0].shape
            dev = ad.A[0].device
            gen = torch.Generator(device=dev).manual_seed(
                _stream_seed(seed, i))
            if cfg.lora_A_init == "gaussian":
                a = torch.randn((L, fin, r), generator=gen, device=dev,
                                dtype=torch.float32) / float(np.sqrt(cfg.dim))
            else:
                limit = float(np.sqrt(6.0 / fin))
                a = torch.empty((L, fin, r), device=dev,
                                dtype=torch.float32).uniform_(
                    -limit, limit, generator=gen)
            for li in range(L):
                ad.A[li].copy_(a[li])
                ad.B[li].zero_()

    def lora_leaves(self) -> Iterator[Tuple[Tuple[str, ...], list, bool]]:
        """``models/weights.py::jax_leaves``' entries of the adapters:
        ``("lora", <module path>, "A" | "B")`` and the per-layer
        parameters, in the JAX layout."""
        for mod_path in self.targets:
            ad = self.adapter(mod_path)
            yield ("lora", mod_path, "A"), list(ad.A), False
            yield ("lora", mod_path, "B"), list(ad.B), False

    @torch.no_grad()
    def load_adapter_tree(self, tree: Dict[str, Dict[str, Any]]) -> None:
        """Set the adapters from a tree in the JAX layout (``{module path:
        {"A": [L, in, r], "B": [L, r, out]}}``; numpy, JAX or torch
        leaves); a missing target or a shape mismatch raises."""
        from automodel_tpu_torch.models.weights import jax_adapter_tree

        host = jax_adapter_tree(tree)
        if set(host) != set(self.targets):
            raise KeyError(f"adapter tree targets {sorted(host)}, the model "
                           f"{sorted(self.targets)}")
        for mod_path, ab in host.items():
            ad = self.adapter(mod_path)
            for part in ("A", "B"):
                params = getattr(ad, part)
                if ab[part].shape != (len(params),) + tuple(params[0].shape):
                    raise ValueError(
                        f"{mod_path}.{part}: shape {ab[part].shape} does not "
                        f"fit {(len(params),) + tuple(params[0].shape)}")
                for p, a in zip(params, ab[part]):
                    p.copy_(torch.from_numpy(np.ascontiguousarray(a)))

    def trainable_mask(self) -> Dict[str, bool]:
        """``{JAX leaf path: trainable}``: the adapters only."""
        return {PATH_SEP.join(path): path[0] == "lora"
                for path, _, _ in jax_leaves(self)}

    @property
    def num_trainable_params(self) -> int:
        return sum(p.numel() for ad in self.adapters.values()
                   for p in ad.parameters())

    # -- forward -----------------------------------------------------------
    def set_dropout_step(self, step: int) -> None:
        """The optimizer step the next training forwards belong to (their
        dropout masks are drawn from it and the microbatch's index)."""
        self._dropout_at = (int(step), 0)

    def layer_adapters(self, merged: Optional[bool] = None
                       ) -> List[Dict[str, LayerAdapter]]:
        """One ``{_proj name: LayerAdapter}`` per layer for the next
        forward: merged weights, or the bypass adapters with this
        microbatch's dropout seeds while training.  ``merged`` overrides
        the model's choice (an int8 base cannot merge)."""
        cfg = self.peft_config
        layers = self.decoder.layers
        bypass = self.bypass if merged is None else not merged
        seeds = None
        if (bypass and cfg.dropout > 0.0 and self.training
                and torch.is_grad_enabled()):
            step, mb = self._dropout_at
            self._dropout_at = (step, mb + 1)
            seeds = [_stream_seed(self.seed, 1, step, mb, i)
                     for i in range(len(layers))]
        out = []
        for i, layer in enumerate(layers):
            d = {}
            for mod_path, (_, name, attr) in self.targets.items():
                ad = self.adapter(mod_path)
                A, B = ad.A[i], ad.B[i]
                if bypass:
                    d[name] = LayerAdapter(
                        A=A, B=B, scale=cfg.scale, dropout=float(cfg.dropout),
                        position=cfg.dropout_position,
                        seed=None if seeds is None else seeds[i])
                else:
                    # W + s (A B)^T in fp32, one product and its sum
                    W = getattr(layer, attr).weight
                    d[name] = LayerAdapter(merged=torch.addmm(
                        W.float(), B.float().t(), A.float().t(),
                        alpha=cfg.scale).to(W.dtype))
            out.append(d)
        return out

    def forward(self, input_ids, *args, **kwargs):
        """The base model's forward with this model's adapters.  With a
        cache (serving, ``generate``) the adapters are merged into the
        weights, unless the base is int8 (then the bypass, no dropout):
        the single-adapter engine the multi-tenant mixed batch is held
        against."""
        merged = None
        if kwargs.get("kv_cache") is not None:
            merged = not self.peft_config.quantize_base
        return self.base_model(input_ids, *args,
                               adapters=self.layer_adapters(merged),
                               **kwargs)


# ---------------------------------------------------------------------------
# recipe hooks
# ---------------------------------------------------------------------------
def build_lora(model, peft_config: PeftConfig, seed: int = 0
               ) -> Tuple[LoRAModel, Dict[str, bool]]:
    """``(wrapped model, trainable mask)``, the JAX ``build_lora``."""
    wrapped = LoRAModel(model, peft_config, seed=seed)
    return wrapped, wrapped.trainable_mask()


def init_lora_params(model: LoRAModel, seed: int) -> LoRAModel:
    """Fresh adapters drawn from ``seed`` over the model's base."""
    model.init_lora(seed)
    return model


# ---------------------------------------------------------------------------
# HF-PEFT adapter files
# ---------------------------------------------------------------------------
def _hf_module_keys(model: LoRAModel) -> Iterator[Tuple[str, int, str]]:
    """``(module path, layer, HF module name)`` of every adapter slice."""
    key_map = key_map_for(model.base_model)
    for mod_path, (tree_path, _, _) in model.targets.items():
        template = key_map[tree_path][0]
        base_key = template[: -len(".weight")]
        for i in range(len(model.adapter(mod_path).A)):
            yield mod_path, i, base_key.format(i=i)


def adapter_state(model: LoRAModel, device="cpu") -> Dict[str, torch.Tensor]:
    """The HF-PEFT tensors of ``model``'s adapters (fp32, ``(out, in)``)
    on ``device``: what :func:`save_adapters` writes."""
    out = {}
    for mod_path, i, key in _hf_module_keys(model):
        ad = model.adapter(mod_path)
        for part, t in (("lora_A", ad.A[i]), ("lora_B", ad.B[i])):
            out[f"base_model.model.{key}.{part}.weight"] = (
                t.detach().float().t().contiguous().to(device, copy=True))
    return out


def save_adapters(model: LoRAModel, out_dir: str,
                  peft_config: Optional[PeftConfig] = None,
                  state: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Write ``adapter_model.safetensors`` and ``adapter_config.json``
    (``state``, from :func:`adapter_state`, writes a snapshot taken
    earlier)."""
    peft_config = peft_config or model.peft_config
    os.makedirs(out_dir, exist_ok=True)
    write_safetensors(os.path.join(out_dir, ADAPTER_FILE),
                      state if state is not None else adapter_state(model))
    cfg = {
        "peft_type": "LORA",
        "r": peft_config.dim,
        "lora_alpha": peft_config.alpha,
        "lora_dropout": peft_config.dropout,
        "target_modules": sorted(
            {m.rsplit(PATH_SEP, 1)[-1] for m in model.targets}),
        "bias": "none",
        "task_type": "CAUSAL_LM",
        "base_model_name_or_path": getattr(model.base_model,
                                           "checkpoint_dir", None),
    }
    with open(os.path.join(out_dir, ADAPTER_CONFIG), "w") as f:
        json.dump(cfg, f, indent=2)


@torch.no_grad()
def load_adapters(model: LoRAModel, adapter_dir: str) -> LoRAModel:
    """Fill ``model``'s adapters from :func:`save_adapters`' files (or the
    JAX package's), cast to each adapter's dtype; a missing tensor or a
    shape mismatch raises."""
    want = list(_hf_module_keys(model))
    names = [f"base_model.model.{k}.{part}.weight"
             for _, _, k in want for part in ("lora_A", "lora_B")]
    got = read_safetensors(os.path.join(adapter_dir, ADAPTER_FILE), names)
    for mod_path, i, key in want:
        ad = model.adapter(mod_path)
        for part, p in (("lora_A", ad.A[i]), ("lora_B", ad.B[i])):
            t = got[f"base_model.model.{key}.{part}.weight"].t()
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{key}.{part}: shape {tuple(t.shape)} does "
                                 f"not fit {tuple(p.shape)}")
            p.copy_(t.to(p.dtype))
    return model
