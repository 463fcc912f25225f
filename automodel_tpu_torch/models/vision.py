"""SigLIP-style vision tower as an ``nn.Module`` (counterpart:
``automodel_tpu/models/vision.py``), the tower of the VLM families
(``models/gemma3.py``'s ``Gemma3ForConditionalGeneration``,
``models/vlm.py``'s llava).

The patch embedding is one matmul over patches flattened in ``(row, col,
channel)`` order (:meth:`VisionTower.patchify`; HF's Conv2d weight ``[H,
C, p, p]`` is permuted into it by ``models/hf_io.py``), plus learned
position embeddings; then pre-LN blocks (LayerNorm in fp32, separate q /
k / v / out projections with biases, non-causal SDPA through
``ops/attention.py::dot_product_attention``, a tanh-GELU MLP) and a final
LayerNorm.  Each block is recomputed in the backward pass when ``remat``
and gradients are recorded (the JAX tower's ``jax.checkpoint`` per
block).  As in JAX, weights live in ``param_dtype`` and every product
casts them to ``compute_dtype``; a frozen tower fed pixels without
gradients records nothing for autograd.  The attention is XLA code in the
JAX package, not a Pallas kernel, so no hand-written kernel stands here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from automodel_tpu_torch.ops.attention import dot_product_attention
from automodel_tpu_torch.ops.norms import layer_norm
from automodel_tpu_torch.ops.remat import (
    checkpoint_layer,
    resolve_remat_policy,
)


@dataclasses.dataclass
class VisionConfig:
    """HF ``SiglipVisionConfig`` field names."""

    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 224
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-6
    model_type: str = "siglip_vision_model"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def from_hf_config(cls, hf: Dict[str, Any]) -> "VisionConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in hf.items() if k in known})


def vision_flops_per_image(vc: VisionConfig) -> float:
    """Training FLOPs per image through the tower (fwd + bwd = 6x the
    matmul MACs of the projections and the patch embedding; the JAX
    convention)."""
    per_layer = (4 * vc.hidden_size ** 2
                 + 2 * vc.hidden_size * vc.intermediate_size)
    embed = vc.patch_size ** 2 * vc.num_channels * vc.hidden_size
    return 3.0 * 2.0 * vc.num_patches * (
        vc.num_hidden_layers * per_layer + embed)


class LayerNorm(nn.Module):
    def __init__(self, size: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size, dtype=dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(size, dtype=dtype,
                                             device=device))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class VisionLayer(nn.Module):
    """One pre-LN block (the JAX names: ``ln_1``, ``attn.{q,k,v,out}_proj``,
    ``ln_2``, ``mlp.fc1`` / ``fc2``)."""

    def __init__(self, cfg: VisionConfig, dtype, device):
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size

        def lin(i, o):
            return nn.Linear(i, o, bias=True, dtype=dtype, device=device)

        self.ln_1 = LayerNorm(H, cfg.layer_norm_eps, dtype, device)
        self.q_proj, self.k_proj = lin(H, H), lin(H, H)
        self.v_proj, self.out_proj = lin(H, H), lin(H, H)
        self.ln_2 = LayerNorm(H, cfg.layer_norm_eps, dtype, device)
        self.fc1, self.fc2 = lin(H, I), lin(I, H)


class VisionTower(nn.Module):
    """``[B, H, W, C]`` images -> ``[B, n_patches, hidden]`` features."""

    def __init__(self, config: VisionConfig, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, remat: bool = True,
                 device=None):
        super().__init__()
        self.config = config
        self.param_dtype, self.compute_dtype = param_dtype, compute_dtype
        self.remat = bool(remat)
        cfg, dt = config, param_dtype
        H = cfg.hidden_size
        P = cfg.patch_size * cfg.patch_size * cfg.num_channels
        self.patch_embed = nn.Linear(P, H, bias=True, dtype=dt, device=device)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.num_patches, H,
                                                  dtype=dt, device=device))
        self.layers = nn.ModuleList([VisionLayer(cfg, dt, device)
                                     for _ in range(cfg.num_hidden_layers)])
        self.post_ln = LayerNorm(H, cfg.layer_norm_eps, dt, device)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """N(0, 0.02) for the matmuls and position embeddings, ones and
        zeros for the LayerNorms, zeros for the biases (the JAX ``init``'s
        distribution)."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif name.endswith(("ln_1.weight", "ln_2.weight",
                                "post_ln.weight")):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)

    def jax_tree_leaves(self) -> Iterator[Tuple[Tuple[str, ...], Any, bool]]:
        """``(JAX path, target, transposed)`` of every leaf of the JAX
        tower's tree (``models/weights.py::jax_leaves``)."""
        layers = self.layers
        yield ("patch_embed", "kernel"), self.patch_embed.weight, True
        yield ("patch_embed", "bias"), self.patch_embed.bias, False
        yield ("pos_embed", "embedding"), self.pos_embed, False
        for ln in ("ln_1", "ln_2"):
            for wb in ("weight", "bias"):
                yield (("layers", ln, wb),
                       [getattr(getattr(l, ln), wb) for l in layers], False)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            yield (("layers", "attn", proj, "kernel"),
                   [getattr(l, proj).weight for l in layers], True)
            yield (("layers", "attn", proj, "bias"),
                   [getattr(l, proj).bias for l in layers], False)
        for fc in ("fc1", "fc2"):
            yield (("layers", "mlp", fc, "kernel"),
                   [getattr(l, fc).weight for l in layers], True)
            yield (("layers", "mlp", fc, "bias"),
                   [getattr(l, fc).bias for l in layers], False)
        yield ("post_ln", "weight"), self.post_ln.weight, False
        yield ("post_ln", "bias"), self.post_ln.bias, False

    def patchify(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, C]`` -> ``[B, n_patches, p * p * C]``, patches in row
        order, each flattened ``(row, col, channel)``."""
        B, H, W, C = pixel_values.shape
        p = self.config.patch_size
        x = pixel_values.reshape(B, H // p, p, W // p, p, C)
        x = x.permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, (H // p) * (W // p), p * p * C)

    def _lin(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """``x @ W^T + b`` in the compute dtype (the product rounded, then
        the bias added, as the JAX tower's)."""
        cd = self.compute_dtype
        return F.linear(x, lin.weight.to(cd)) + lin.bias.to(cd)

    def _block(self, layer: VisionLayer, hidden: torch.Tensor
               ) -> torch.Tensor:
        B, S, H = hidden.shape
        nh = self.config.num_attention_heads
        x = layer.ln_1(hidden)
        shape = (B, S, nh, H // nh)
        q = self._lin(layer.q_proj, x).view(shape)
        k = self._lin(layer.k_proj, x).view(shape)
        v = self._lin(layer.v_proj, x).view(shape)
        attn = dot_product_attention(q, k, v).reshape(B, S, H)
        hidden = hidden + self._lin(layer.out_proj, attn)
        x = layer.ln_2(hidden)
        x = F.gelu(self._lin(layer.fc1, x), approximate="tanh")
        return hidden + self._lin(layer.fc2, x)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        patches = self.patchify(pixel_values).to(cd)
        hidden = self._lin(self.patch_embed, patches)
        hidden = hidden + self.pos_embed.to(cd)[None]
        remat = self.remat and torch.is_grad_enabled()
        policy = resolve_remat_policy("nothing_saveable")
        for layer in self.layers:
            if remat:
                hidden = checkpoint_layer(
                    lambda h, layer=layer: self._block(layer, h), hidden,
                    policy=policy)
            else:
                hidden = self._block(layer, hidden)
        return self.post_ln(hidden)
