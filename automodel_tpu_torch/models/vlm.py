"""Image-text-to-text model, llava style (counterpart:
``automodel_tpu/models/vlm.py``): the SigLIP tower of
``models/vision.py``, a two-layer projector (``fc1``, tanh GELU, ``fc2``,
with biases) and the port's Llama decoder.  Image features are scattered
into the token stream wherever ``input_ids == image_token_id``
(:func:`merge_image_embeds`, shared with ``models/gemma3.py``), the
placeholder expansion the VLM collators produce
(``datasets/vlm/collate_fns.py``).  The token embeddings are not scaled.
``init_kv_cache`` is the decoder's: ``generate()`` decodes these models
over the dense cache, the images on the prefill only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from automodel_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    as_dtype,
)
from automodel_tpu_torch.models.vision import (
    VisionConfig,
    VisionTower,
    vision_flops_per_image,
)
from automodel_tpu_torch.models.weights import jax_leaves
from automodel_tpu_torch.utils.device import resolve_device


def merge_image_embeds(embeds: torch.Tensor, input_ids: torch.Tensor,
                       pixel_values: torch.Tensor,
                       encode: Callable[[torch.Tensor], torch.Tensor],
                       token_id: int) -> torch.Tensor:
    """Scatter image features into the placeholder positions.

    ``pixel_values [B, I, H, W, C]`` (each row's image slots): row ``b``'s
    ``j``-th placeholder takes the ``j``-th feature row of its own images
    (a cumulative count per row), so rows are independent.  The flat
    ``[B_img, H, W, C]`` layout takes the features in one row-major order
    over the whole batch."""
    B, S = input_ids.shape
    is_img = input_ids == token_id
    if pixel_values.dim() == 5:
        I = pixel_values.shape[1]
        img = encode(pixel_values.reshape((B * I,) + pixel_values.shape[2:]))
        rows = img.reshape(B, I * img.shape[1], img.shape[-1])
        idx = (torch.cumsum(is_img.long(), dim=-1) - 1).clamp(
            0, rows.shape[1] - 1)
        gathered = torch.gather(
            rows, 1, idx[..., None].expand(B, S, rows.shape[-1]))
    else:
        img = encode(pixel_values)
        flat = img.reshape(-1, img.shape[-1])
        idx = (torch.cumsum(is_img.reshape(-1).long(), dim=0) - 1).clamp(
            0, flat.shape[0] - 1)
        gathered = flat[idx].reshape(B, S, -1)
    return torch.where(is_img[..., None], gathered.to(embeds.dtype), embeds)


@dataclasses.dataclass
class VLMConfig:
    """llava config (HF field names; ``image_token_index`` is read as
    ``image_token_id``)."""

    text_config: Any = None
    vision_config: Any = None
    image_token_id: int = 257152
    projector_hidden_act: str = "gelu"
    model_type: str = "llava"
    tie_word_embeddings: bool = True

    def __post_init__(self):
        if isinstance(self.text_config, dict):
            self.text_config = LlamaConfig.from_hf_config(self.text_config)
        if isinstance(self.vision_config, dict):
            self.vision_config = VisionConfig.from_hf_config(
                self.vision_config)
        self.text_config = self.text_config or LlamaConfig()
        self.vision_config = self.vision_config or VisionConfig()

    @classmethod
    def from_hf_config(cls, hf: Dict[str, Any]) -> "VLMConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in hf.items() if k in known}
        if "image_token_index" in hf:
            kwargs["image_token_id"] = hf["image_token_index"]
        return cls(**kwargs)


class ImageTextModel(nn.Module):
    """What the image-text families share: the decoder
    ``language_model`` (``lm_cls``), the ``vision_tower`` and, built by
    each family, the ``multi_modal_projector`` behind ``encode_images``.
    ``forward(input_ids, pixel_values=None, ...)`` takes the decoder's
    arguments and overwrites the token embeddings at ``image_token_id``
    with the projected image features; ``pixel_values`` is ``[B, I, H, W,
    C]`` (each row's image slots) or ``[B_img, H, W, C]``."""

    image_token_id: int

    def __init__(self, config, lm_cls, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, remat: bool = True,
                 remat_policy: Optional[str] = "nothing_saveable",
                 scan_unroll: int = 1, scan_block: int = 1, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.param_dtype = as_dtype(param_dtype)
        self.compute_dtype = as_dtype(compute_dtype)
        self.language_model = lm_cls(
            config.text_config, param_dtype=param_dtype,
            compute_dtype=compute_dtype, remat=remat,
            remat_policy=remat_policy, scan_unroll=scan_unroll,
            scan_block=scan_block, device=device)
        self.vision_tower = VisionTower(
            config.vision_config, param_dtype=self.param_dtype,
            compute_dtype=self.compute_dtype, remat=remat, device=device)

    # the decoder's knobs, as the first-step checks set them
    remat_policy = property(
        lambda self: self.language_model.remat_policy,
        lambda self, v: setattr(self.language_model, "remat_policy", v))
    qdot_impl = property(
        lambda self: self.language_model.qdot_impl,
        lambda self, v: setattr(self.language_model, "qdot_impl", v))

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "ImageTextModel":
        """The decoder's weights from ``seed``, the tower's and the
        projector's from ``seed + 1``."""
        self.language_model.init_weights(seed)
        dev = self.language_model.inv_freq.device
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        self.vision_tower.init_weights(gen)
        self._init_projector(gen)
        return self

    def jax_tree_leaves(self) -> Iterator[Tuple[Tuple[str, ...], Any, bool]]:
        for path, t, tr in jax_leaves(self.language_model):
            yield ("language_model",) + path, t, tr
        for path, t, tr in self.vision_tower.jax_tree_leaves():
            yield ("vision_tower",) + path, t, tr
        yield from self._projector_leaves()

    def forward(self, input_ids: torch.Tensor,
                pixel_values: Optional[torch.Tensor] = None,
                **kwargs) -> Dict[str, torch.Tensor]:
        lm = self.language_model
        embeds = lm._embed(input_ids)
        if pixel_values is not None:
            embeds = merge_image_embeds(embeds, input_ids, pixel_values,
                                        self.encode_images,
                                        self.image_token_id)
        return lm(input_ids, inputs_embeds=embeds, **kwargs)

    def init_kv_cache(self, batch: int, max_len: int, dtype=None):
        """The decoder's dense decode cache (``generate()``); ``forward``
        hands ``kv_cache`` / ``cache_index`` to the decoder."""
        return self.language_model.init_kv_cache(batch, max_len, dtype)

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self) -> float:
        return self.language_model.flops_per_token()

    def attention_flops_per_token(self, seq_len: int,
                                  causal: bool = True) -> float:
        return self.language_model.attention_flops_per_token(seq_len, causal)

    def flops_per_image(self) -> float:
        """Vision-tower FLOPs per image (step FLOPs = text tokens x
        ``flops_per_token`` + images x ``flops_per_image``)."""
        return vision_flops_per_image(self.config.vision_config)


class LlavaProjector(nn.Module):
    def __init__(self, Hv: int, Ht: int, dtype, device):
        super().__init__()
        self.fc1 = nn.Linear(Hv, Ht, bias=True, dtype=dtype, device=device)
        self.fc2 = nn.Linear(Ht, Ht, bias=True, dtype=dtype, device=device)


class VLMForConditionalGeneration(ImageTextModel):
    """SigLIP tower -> ``fc1`` / GELU / ``fc2`` -> Llama decoder."""

    def __init__(self, config: VLMConfig, **kwargs):
        super().__init__(config, LlamaForCausalLM, **kwargs)
        self.image_token_id = config.image_token_id
        self.multi_modal_projector = LlavaProjector(
            config.vision_config.hidden_size, config.text_config.hidden_size,
            self.param_dtype, self.language_model.inv_freq.device)

    def _init_projector(self, gen: torch.Generator) -> None:
        for lin in (self.multi_modal_projector.fc1,
                    self.multi_modal_projector.fc2):
            lin.weight.normal_(0.0, 0.02, generator=gen)
            lin.bias.zero_()

    def _projector_leaves(self):
        for fc in ("fc1", "fc2"):
            lin = getattr(self.multi_modal_projector, fc)
            yield ("multi_modal_projector", fc, "kernel"), lin.weight, True
            yield ("multi_modal_projector", fc, "bias"), lin.bias, False

    def encode_images(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """``[B_img, H, W, C]`` -> ``[B_img, n_patches, text_hidden]``."""
        cd = self.compute_dtype
        x = self.vision_tower(pixel_values)
        p = self.multi_modal_projector
        x = F.linear(x, p.fc1.weight.to(cd)) + p.fc1.bias.to(cd)
        x = F.gelu(x, approximate="tanh")
        return F.linear(x, p.fc2.weight.to(cd)) + p.fc2.bias.to(cd)
