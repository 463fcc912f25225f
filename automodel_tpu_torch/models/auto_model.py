"""YAML-friendly model construction (counterpart:
``automodel_tpu/models/auto_model.py``).

``AutoModelForCausalLM.from_pretrained`` resolves a local directory or an
HF-cache snapshot (``$HF_HOME/hub/models--<org>--<name>/snapshots/<rev>``,
the revision ``refs/main`` names), reads its ``config.json`` and builds
the matching family; with ``load_weights`` it fills the model from the
directory's safetensors (``models/hf_io.py``).  Nothing is ever
downloaded: an id that resolves to no directory raises
``FileNotFoundError``, as in JAX.  ``build_model`` takes either a name or
path, or an inline config.

The families are the JAX registry's names (``automodel_tpu/models/
registry.py``): ``llama``, and on Llama's class ``mistral``, ``qwen2`` and
``qwen3``; ``mixtral``, ``qwen3_moe``, ``deepseek_v2`` and
``deepseek_v3``.  Other ``model_type`` values raise.  Every model is
built with random weights drawn from ``seed`` first, then loaded where
asked; ``device`` None is ``cuda`` (raises without a card).  The recipe
loads the weights of ``model.checkpoint_dir`` itself, after PEFT has
wrapped the model (``recipes/llm/train_ft.py``), as the JAX recipe does.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

from automodel_tpu_torch.models.deepseek_v2 import (
    DeepseekV2Config,
    DeepseekV2ForCausalLM,
)
from automodel_tpu_torch.models.deepseek_v3 import (
    DeepseekV3Config,
    DeepseekV3ForCausalLM,
)
from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from automodel_tpu_torch.models.mixtral import (
    MixtralConfig,
    MixtralForCausalLM,
)
from automodel_tpu_torch.models.qwen3_moe import (
    Qwen3MoeConfig,
    Qwen3MoeForCausalLM,
)

FAMILIES = {
    "llama": (LlamaConfig, LlamaForCausalLM),
    "mistral": (LlamaConfig, LlamaForCausalLM),
    "qwen2": (LlamaConfig, LlamaForCausalLM),
    "qwen3": (LlamaConfig, LlamaForCausalLM),
    "mixtral": (MixtralConfig, MixtralForCausalLM),
    "qwen3_moe": (Qwen3MoeConfig, Qwen3MoeForCausalLM),
    "deepseek_v2": (DeepseekV2Config, DeepseekV2ForCausalLM),
    "deepseek_v3": (DeepseekV3Config, DeepseekV3ForCausalLM),
}


def resolve_checkpoint_dir(name_or_path: str) -> Optional[str]:
    """A model id or path -> a local directory, or None: the path itself
    when it is a directory, else the HF-cache snapshot of the id under
    ``$HF_HOME/hub`` (``~/.cache/huggingface`` without ``HF_HOME``): the
    revision ``refs/main`` names, else the last snapshot by name."""
    if os.path.isdir(name_or_path):
        return name_or_path
    hf_home = os.environ.get("HF_HOME",
                             os.path.expanduser("~/.cache/huggingface"))
    repo_dir = os.path.join(hf_home, "hub",
                            "models--" + name_or_path.replace("/", "--"))
    snap_root = os.path.join(repo_dir, "snapshots")
    if not os.path.isdir(snap_root):
        return None
    ref_main = os.path.join(repo_dir, "refs", "main")
    if os.path.exists(ref_main):
        with open(ref_main) as f:
            cand = os.path.join(snap_root, f.read().strip())
        if os.path.isdir(cand):
            return cand
    snaps = sorted(os.listdir(snap_root))
    return os.path.join(snap_root, snaps[-1]) if snaps else None


class AutoModelForCausalLM:
    """``_target_: automodel_tpu.models.auto_model.AutoModelForCausalLM.
    from_pretrained`` (the loader maps the JAX name to this class)."""

    @staticmethod
    def from_config(config: Any, *, seed: int = 0, device=None,
                    **model_kwargs) -> LlamaForCausalLM:
        """Build from an HF-style config dict (or a config dataclass) with
        random weights drawn from ``seed``.  ``param_dtype`` defaults to
        the config's ``torch_dtype``, as in the JAX package."""
        if hasattr(config, "to_dict"):
            config = config.to_dict()
        if isinstance(config, dict):
            model_type = config.get("model_type", "llama")
            if model_type not in FAMILIES:
                raise NotImplementedError(
                    f"model_type {model_type!r} is not ported (ported: "
                    f"{sorted(FAMILIES)})")
            config = FAMILIES[model_type][0].from_hf_config(config)
        if config.torch_dtype:
            model_kwargs.setdefault("param_dtype", str(config.torch_dtype))
        model = FAMILIES[config.model_type][1](config, device=device,
                                               **model_kwargs)
        return model.init_weights(seed)

    @staticmethod
    def from_pretrained(pretrained_model_name_or_path: str,
                        load_weights: bool = False, *, seed: int = 0,
                        device=None, **model_kwargs) -> LlamaForCausalLM:
        """The model of a local HF directory or cache snapshot, its
        ``checkpoint_dir`` set; with ``load_weights`` its weights are the
        directory's (else drawn from ``seed``)."""
        ckpt_dir = resolve_checkpoint_dir(pretrained_model_name_or_path)
        if ckpt_dir is None:
            raise FileNotFoundError(
                f"Cannot resolve {pretrained_model_name_or_path!r} to a "
                "local checkpoint directory (no network egress; pre-populate "
                "the HF cache or pass a local path)")
        with open(os.path.join(ckpt_dir, "config.json")) as f:
            hf_cfg = json.load(f)
        model = AutoModelForCausalLM.from_config(
            hf_cfg, seed=seed, device=device, **model_kwargs)
        model.checkpoint_dir = ckpt_dir
        if load_weights:
            from automodel_tpu_torch.models.hf_io import load_hf_weights

            load_hf_weights(model, ckpt_dir)
        return model


def build_model(name_or_path: Optional[Any] = None,
                config: Optional[Any] = None, *, seed: int = 0, device=None,
                **kwargs) -> LlamaForCausalLM:
    """From a checkpoint name or path (``from_pretrained``) or an inline
    HF-style config (``from_config``).  A config given as the first
    argument is taken as ``config``."""
    if name_or_path is not None and not isinstance(name_or_path, str):
        name_or_path, config = None, name_or_path
    if name_or_path is not None:
        return AutoModelForCausalLM.from_pretrained(
            name_or_path, seed=seed, device=device, **kwargs)
    if config is not None:
        return AutoModelForCausalLM.from_config(config, seed=seed,
                                                device=device, **kwargs)
    raise ValueError("build_model needs name_or_path or config")
