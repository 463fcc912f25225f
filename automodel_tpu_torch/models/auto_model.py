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
registry.py``): ``llama``, and on Llama's class ``mistral``, ``qwen2``,
``qwen3``, ``granite``, ``olmo2``, ``starcoder2`` and ``phi3``; ``gpt2``;
``mixtral``, ``qwen3_moe``, ``deepseek_v2`` and ``deepseek_v3``;
``gemma3_text`` and ``gemma2``; ``gemma3n_text`` (Gemma-3n's AltUp /
Laurel / per-layer-embedding decoder alone); ``qwen2_5_vl_text``
(Qwen2.5-VL's M-RoPE decoder alone); and the image-text models
``gemma3`` (Gemma-3 multimodal), ``gemma3n`` (Gemma-3n with its native
conv tower), ``llava``, ``qwen2_5_vl`` and ``phi4_multimodal``
(Phi-4-multimodal's audio and text), which
:class:`AutoModelForImageTextToText` builds the same way (Qwen2.5-VL's
``image_grid`` / ``video_grid`` pass through as model keywords): all 22
of the JAX registry's types.  Any other ``model_type`` raises.
:class:`AutoModelForSequenceClassification` (and
``build_sequence_classifier``) wraps any of the text families in
``models/sequence_classification.py``'s ``score`` head.  Every model is
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
from automodel_tpu_torch.models.gemma2 import Gemma2Config, Gemma2ForCausalLM
from automodel_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from automodel_tpu_torch.models.granite import (
    GraniteConfig,
    GraniteForCausalLM,
)
from automodel_tpu_torch.models.gemma3 import (
    Gemma3Config,
    Gemma3ForCausalLM,
    Gemma3ForConditionalGeneration,
    Gemma3VLConfig,
)
from automodel_tpu_torch.models.gemma3n import (
    Gemma3nForCausalLM,
    Gemma3nForConditionalGeneration,
    Gemma3nTextConfig,
    Gemma3nVLConfig,
)
from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from automodel_tpu_torch.models.mixtral import (
    MixtralConfig,
    MixtralForCausalLM,
)
from automodel_tpu_torch.models.olmo2 import Olmo2Config, Olmo2ForCausalLM
from automodel_tpu_torch.models.phi3 import Phi3Config, Phi3ForCausalLM
from automodel_tpu_torch.models.phi4_mm import (
    Phi4MMConfig,
    Phi4MMForCausalLM,
)
from automodel_tpu_torch.models.qwen2_5_vl import (
    Qwen25VLConfig,
    Qwen25VLForConditionalGeneration,
    Qwen25VLTextConfig,
    Qwen25VLTextModel,
)
from automodel_tpu_torch.models.qwen3_moe import (
    Qwen3MoeConfig,
    Qwen3MoeForCausalLM,
)
from automodel_tpu_torch.models.sequence_classification import (
    ForSequenceClassification,
)
from automodel_tpu_torch.models.starcoder2 import (
    Starcoder2Config,
    Starcoder2ForCausalLM,
)
from automodel_tpu_torch.models.vlm import (
    VLMConfig,
    VLMForConditionalGeneration,
)

FAMILIES = {
    "llama": (LlamaConfig, LlamaForCausalLM),
    "mistral": (LlamaConfig, LlamaForCausalLM),
    "qwen2": (LlamaConfig, LlamaForCausalLM),
    "qwen3": (LlamaConfig, LlamaForCausalLM),
    "granite": (GraniteConfig, GraniteForCausalLM),
    "olmo2": (Olmo2Config, Olmo2ForCausalLM),
    "starcoder2": (Starcoder2Config, Starcoder2ForCausalLM),
    "phi3": (Phi3Config, Phi3ForCausalLM),
    "gpt2": (GPT2Config, GPT2LMHeadModel),
    "mixtral": (MixtralConfig, MixtralForCausalLM),
    "qwen3_moe": (Qwen3MoeConfig, Qwen3MoeForCausalLM),
    "deepseek_v2": (DeepseekV2Config, DeepseekV2ForCausalLM),
    "deepseek_v3": (DeepseekV3Config, DeepseekV3ForCausalLM),
    "gemma3_text": (Gemma3Config, Gemma3ForCausalLM),
    "gemma2": (Gemma2Config, Gemma2ForCausalLM),
    # HF's "gemma3" is the multimodal config (text and vision nested)
    "gemma3": (Gemma3VLConfig, Gemma3ForConditionalGeneration),
    "gemma3n_text": (Gemma3nTextConfig, Gemma3nForCausalLM),
    "gemma3n": (Gemma3nVLConfig, Gemma3nForConditionalGeneration),
    "llava": (VLMConfig, VLMForConditionalGeneration),
    "qwen2_5_vl": (Qwen25VLConfig, Qwen25VLForConditionalGeneration),
    "qwen2_5_vl_text": (Qwen25VLTextConfig, Qwen25VLTextModel),
    "phi4_multimodal": (Phi4MMConfig, Phi4MMForCausalLM),
}


def _read_config(pretrained_model_name_or_path: str):
    """``(checkpoint directory, its config.json)``; an id that resolves to
    no directory raises ``FileNotFoundError``."""
    ckpt_dir = resolve_checkpoint_dir(pretrained_model_name_or_path)
    if ckpt_dir is None:
        raise FileNotFoundError(
            f"Cannot resolve {pretrained_model_name_or_path!r} to a "
            "local checkpoint directory (no network egress; pre-populate "
            "the HF cache or pass a local path)")
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        return ckpt_dir, json.load(f)


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
        the config's ``torch_dtype``, as in the JAX package; the other
        keywords reach the family's constructor (``weight_only_quant:
        int8`` builds the int8 base, as a serve YAML's ``model`` node may
        ask)."""
        if hasattr(config, "to_dict"):
            config = config.to_dict()
        if isinstance(config, dict):
            model_type = config.get("model_type", "llama")
            if model_type not in FAMILIES:
                raise NotImplementedError(
                    f"model_type {model_type!r} is not ported (ported: "
                    f"{sorted(FAMILIES)})")
            config = FAMILIES[model_type][0].from_hf_config(config)
        if getattr(config, "torch_dtype", None):
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
        ckpt_dir, hf_cfg = _read_config(pretrained_model_name_or_path)
        model = AutoModelForCausalLM.from_config(
            hf_cfg, seed=seed, device=device, **model_kwargs)
        model.checkpoint_dir = ckpt_dir
        if load_weights:
            if getattr(model, "weight_only_quant", None) == "int8":
                from automodel_tpu_torch.quantization.weight_only import (
                    load_quantized_hf_base,
                )

                # the HF weights quantized on the host as they stream in
                load_quantized_hf_base(model, ckpt_dir)
            else:
                from automodel_tpu_torch.models.hf_io import load_hf_weights

                load_hf_weights(model, ckpt_dir)
        return model


class AutoModelForImageTextToText:
    """The VLM facade (``_target_: automodel_tpu.models.auto_model.
    AutoModelForImageTextToText.from_pretrained``): the same construction,
    since ``model_type`` routes to the family, as in JAX."""

    from_config = AutoModelForCausalLM.from_config
    from_pretrained = AutoModelForCausalLM.from_pretrained


class AutoModelForSequenceClassification:
    """The classification facade (``_target_: automodel_tpu.models.
    auto_model.AutoModelForSequenceClassification.from_pretrained``): a
    text family's backbone without its head, plus a ``score`` head pooled
    at the last non-pad token (``models/sequence_classification.py``)."""

    @staticmethod
    def from_config(config: Any, num_labels: Optional[int] = None,
                    pad_token_id: Optional[int] = None, *, seed: int = 0,
                    device=None, **model_kwargs) -> ForSequenceClassification:
        """``num_labels`` / ``pad_token_id`` default to the config dict's
        (``num_labels``, else the length of ``id2label``, else 2), as in
        JAX; weights drawn from ``seed``."""
        if hasattr(config, "to_dict"):
            config = config.to_dict()
        if isinstance(config, dict):
            if num_labels is None:
                n = config.get("num_labels") or len(
                    config.get("id2label") or ())
                num_labels = int(n) if n else 2
            if pad_token_id is None:
                pad_token_id = config.get("pad_token_id")
        backbone = AutoModelForCausalLM.from_config(
            config, seed=seed, device=device, **model_kwargs)
        model = ForSequenceClassification(backbone, num_labels or 2,
                                          pad_token_id)
        return model.init_score(seed)        # the backbone is drawn

    @staticmethod
    def from_pretrained(pretrained_model_name_or_path: str,
                        load_weights: bool = False,
                        num_labels: Optional[int] = None, *, seed: int = 0,
                        device=None, **model_kwargs
                        ) -> ForSequenceClassification:
        """The classifier of a local HF directory or cache snapshot, its
        ``checkpoint_dir`` set; with ``load_weights`` its weights are the
        directory's (a causal-LM directory gives a fresh ``score``)."""
        ckpt_dir, hf_cfg = _read_config(pretrained_model_name_or_path)
        model = AutoModelForSequenceClassification.from_config(
            hf_cfg, num_labels=num_labels, seed=seed, device=device,
            **model_kwargs)
        model.checkpoint_dir = ckpt_dir
        if load_weights:
            from automodel_tpu_torch.models.hf_io import load_hf_weights

            load_hf_weights(model, ckpt_dir)
        return model


def build_sequence_classifier(name_or_path: Optional[Any] = None,
                              config: Optional[Any] = None, *, seed: int = 0,
                              device=None, **kwargs
                              ) -> ForSequenceClassification:
    """The classification builder (the JAX ``build_sequence_classifier``):
    from a checkpoint name or path, or an inline HF-style config."""
    if name_or_path is not None and not isinstance(name_or_path, str):
        name_or_path, config = None, name_or_path
    if name_or_path is not None:
        return AutoModelForSequenceClassification.from_pretrained(
            name_or_path, seed=seed, device=device, **kwargs)
    if config is not None:
        return AutoModelForSequenceClassification.from_config(
            config, seed=seed, device=device, **kwargs)
    raise ValueError("build_sequence_classifier needs name_or_path or config")


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
