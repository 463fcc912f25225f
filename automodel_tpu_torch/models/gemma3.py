"""Gemma-3 text decoder and Gemma-3 multimodal model as ``nn.Module``s
(counterpart: ``automodel_tpu/models/gemma3.py``).

:class:`Gemma3ForCausalLM` is the Llama decoder of ``models/llama.py`` (its
projections, LoRA / quantized-compute seam, remat units and loop) with the
Gemma-3 body:

* token embeddings scaled by ``sqrt(hidden_size)`` rounded to the compute
  dtype first (the JAX ``jnp.asarray(H ** 0.5, compute_dtype)``);
* zero-centred RMSNorm applied as ``(1 + w)`` in fp32
  (``ops/norms.py::rms_norm(offset=1.0)``), four norms a layer (input,
  post-attention, pre-feedforward, post-feedforward) and per-head q / k
  norms;
* attention scale ``query_pre_attn_scalar ** -0.5``; a tanh-GELU gated
  MLP; a tied head;
* alternating sliding / full layers (``layer_types``, by default every
  sixth layer full): a sliding layer rotates by ``rope_local_base_freq``
  and attends through kernel 9 with its static window
  (``sliding_window``), a full layer rotates by ``rope_theta`` with
  ``rope_scaling`` and attends causally.  Where JAX scans the layers and
  branches with ``lax.cond`` on a per-layer flag, the port's Python loop
  hands each layer its window as a constant.

Gemma-2 (``models/gemma2.py``) is this class with the q / k norms off,
``attn_logit_softcapping`` on kernel 9 and ``final_logit_softcapping`` on
the logits, which a hidden-state loss (``FusedLinearCrossEntropy``)
refuses, as in JAX.

:class:`Gemma3ForConditionalGeneration` is the SigLIP tower of
``models/vision.py``, the projector (an average pool of the patch grid
down to ``mm_tokens_per_image`` tokens as a reshape-mean, ``(1 + w)``
RMSNorm ``mm_soft_emb_norm``, then ``x @ mm_input_projection_weight [Hv,
Ht]``) and the decoder; image features overwrite the placeholder tokens'
embeddings after the ``sqrt(H)`` scale (``models/vlm.py::
merge_image_embeds``).  Both decode through ``generate()`` over the
dense cache (the VLM's ``init_kv_cache`` is its decoder's); the paged
serving engine does not take them, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from automodel_tpu_torch.models.llama import DenseKVView, LlamaForCausalLM
from automodel_tpu_torch.models.vision import VisionConfig
from automodel_tpu_torch.models.vlm import ImageTextModel
from automodel_tpu_torch.ops.attention import attention
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.ops.rotary import apply_rope, rope_tables


@dataclasses.dataclass
class Gemma3Config:
    """HF ``Gemma3TextConfig`` field names (the JAX package's defaults:
    ``vocab_size`` 262,144 where HF's is 262,208)."""

    vocab_size: int = 262144
    hidden_size: int = 2304
    intermediate_size: int = 9216
    num_hidden_layers: int = 26
    num_attention_heads: int = 8
    num_key_value_heads: int = 4
    head_dim: int = 256
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    rope_local_base_freq: float = 10_000.0
    rope_scaling: Optional[dict] = None
    query_pre_attn_scalar: float = 256.0
    sliding_window: int = 4096
    layer_types: Optional[List[str]] = None
    max_position_embeddings: int = 131072
    tie_word_embeddings: bool = True
    attention_bias: bool = False
    model_type: str = "gemma3_text"
    torch_dtype: str = "bfloat16"
    # the Gemma-2 deltas, branches of the one body
    qk_norm: bool = True
    attn_logit_softcapping: Optional[float] = None
    final_logit_softcapping: Optional[float] = None

    def __post_init__(self):
        if self.layer_types is None:
            # HF default: every 6th layer is full attention
            self.layer_types = [
                "full_attention" if (i + 1) % 6 == 0 else "sliding_attention"
                for i in range(self.num_hidden_layers)]

    @classmethod
    def from_hf_config(cls, hf: Dict[str, Any]) -> "Gemma3Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in hf.items() if k in known})


class GemmaRMSNorm(nn.Module):
    """RMSNorm scaled by ``(1 + w)``; ``w`` starts at zero."""

    def __init__(self, size: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(size, dtype=dtype,
                                               device=device))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps, offset=1.0)


_NORMS = ("input_layernorm", "post_attention_layernorm",
          "pre_feedforward_layernorm", "post_feedforward_layernorm")


class Gemma3DecoderLayer(nn.Module):
    """Four norms, q / k / v / o, q / k norms (``qk_norm``) and the gated
    MLP; ``full`` says whether the layer attends causally over the whole
    row (else within ``sliding_window``)."""

    def __init__(self, cfg: Gemma3Config, dtype, device, full: bool):
        super().__init__()
        H, D, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
        Hq, Hk = cfg.num_attention_heads, cfg.num_key_value_heads
        self.full = full

        def lin(i, o):
            return nn.Linear(i, o, bias=False, dtype=dtype, device=device)

        for norm in _NORMS:
            setattr(self, norm, GemmaRMSNorm(H, cfg.rms_norm_eps, dtype,
                                             device))
        self.q_proj, self.k_proj = lin(H, Hq * D), lin(H, Hk * D)
        self.v_proj, self.o_proj = lin(H, Hk * D), lin(Hq * D, H)
        if cfg.qk_norm:
            self.q_norm = GemmaRMSNorm(D, cfg.rms_norm_eps, dtype, device)
            self.k_norm = GemmaRMSNorm(D, cfg.rms_norm_eps, dtype, device)
        self.gate_proj, self.up_proj = lin(H, I), lin(H, I)
        self.down_proj = lin(I, H)


class Gemma3ForCausalLM(LlamaForCausalLM):
    """``device`` None is ``cuda`` (raises without a card).  ``remat``,
    ``remat_policy`` and ``scan_block`` as the Llama class's.  With the
    dense cache of ``init_kv_cache`` (``generate()``) each layer writes
    k / v at ``cache_index``; a prefill attends its own keys through
    kernel 9, a decode step the cache through the plain
    ``cached_attention``, both at the layer's window, scale and soft cap
    (the JAX cached layer; Gemma-2 inherits it, as in JAX)."""

    def __init__(self, config: Gemma3Config, **kwargs):
        super().__init__(config, **kwargs)
        cfg = config
        self.norm = GemmaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                 self.param_dtype, self.inv_freq.device)
        inv_local, _ = rope_tables(cfg.head_dim, cfg.rope_local_base_freq)
        self.register_buffer(
            "inv_freq_local",
            torch.from_numpy(inv_local).to(self.inv_freq.device),
            persistent=False)

    def _uniform_window(self, cfg) -> Optional[int]:
        return None                     # per layer: Gemma3DecoderLayer.full

    def _build_layers(self, cfg: Gemma3Config, dtype, device) -> None:
        self.layers = nn.ModuleList([
            Gemma3DecoderLayer(cfg, dtype, device, t == "full_attention")
            for t in cfg.layer_types])

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "Gemma3ForCausalLM":
        """N(0, 0.02) for embeddings and projections, zeros for the
        zero-centred norms (the JAX ``init``'s distribution)."""
        gen = torch.Generator(device=self.inv_freq.device).manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=gen)
        return self

    def jax_tree_leaves(self) -> Iterator[Tuple[Tuple[str, ...], Any, bool]]:
        """``(JAX path, target, transposed)`` of every leaf of the JAX
        Gemma tree (``models/weights.py::jax_leaves``)."""
        layers = self.layers
        yield ("embed_tokens", "embedding"), self.embed_tokens.weight, False
        for norm in _NORMS:
            yield (("layers", norm, "weight"),
                   [getattr(l, norm).weight for l in layers], False)
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            yield (("layers", "self_attn", proj, "kernel"),
                   [getattr(l, proj).weight for l in layers], True)
        if self.config.qk_norm:
            for norm in ("q_norm", "k_norm"):
                yield (("layers", "self_attn", norm, "weight"),
                       [getattr(l, norm).weight for l in layers], False)
        for proj in ("gate_proj", "up_proj", "down_proj"):
            yield (("layers", "mlp", proj, "kernel"),
                   [getattr(l, proj).weight for l in layers], True)
        yield ("norm", "weight"), self.norm.weight, False
        if self.lm_head is not None:
            yield ("lm_head", "kernel"), self.lm_head.weight, True

    def _embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        scale = torch.tensor(float(self.config.hidden_size) ** 0.5, dtype=cd)
        return self.embed_tokens.weight[input_ids].to(cd) * scale.to(
            input_ids.device)

    def _attention_block(self, layer: Gemma3DecoderLayer, hidden,
                         position_ids, segment_ids, kv_cache, attn_impl):
        cfg = self.config
        if kv_cache is not None and not isinstance(kv_cache, DenseKVView):
            raise NotImplementedError(
                "the Gemma families decode over the dense cache of "
                "init_kv_cache (generate()); the paged serving engine does "
                "not take them, as in JAX")
        B, S, _ = hidden.shape
        D, Hq, Hk = cfg.head_dim, cfg.num_attention_heads, \
            cfg.num_key_value_heads
        x = layer.input_layernorm(hidden)
        q = self._proj(layer.q_proj, x, "self_attn.q_proj").view(B, S, Hq, D)
        k = self._proj(layer.k_proj, x, "self_attn.k_proj").view(B, S, Hk, D)
        v = self._proj(layer.v_proj, x, "self_attn.v_proj").view(B, S, Hk, D)
        if cfg.qk_norm:
            q, k = layer.q_norm(q), layer.k_norm(k)
        q, k = apply_rope(q, k, position_ids,
                          self.inv_freq if layer.full else self.inv_freq_local)
        kw = dict(scale=float(cfg.query_pre_attn_scalar) ** -0.5,
                  logits_soft_cap=cfg.attn_logit_softcapping,
                  local_window_size=(None if layer.full
                                     else int(cfg.sliding_window)),
                  impl=attn_impl)
        if kv_cache is not None:
            kv_cache.write(k, v)
            attn = kv_cache.attend(q, k, v, **kw)
        else:
            attn = attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=True, segment_ids=segment_ids, **kw)
        out = self._proj(layer.o_proj, attn.reshape(B, S, Hq * D),
                         "self_attn.o_proj")
        return hidden + layer.post_attention_layernorm(out)

    def _mlp_block(self, x: torch.Tensor, layer: Gemma3DecoderLayer):
        act = (F.gelu(self._proj(layer.gate_proj, x, "mlp.gate_proj"),
                      approximate="tanh")
               * self._proj(layer.up_proj, x, "mlp.up_proj"))
        return self._proj(layer.down_proj, act, "mlp.down_proj"), None

    def _layer(self, layer: Gemma3DecoderLayer, hidden, position_ids,
               segment_ids, kv_cache, attn_impl, adapters=None):
        self._adapters = adapters
        try:
            hidden = self._attention_block(layer, hidden, position_ids,
                                           segment_ids, kv_cache, attn_impl)
            out, _ = self._mlp_block(layer.pre_feedforward_layernorm(hidden),
                                     layer)
        finally:
            self._adapters = None
        return hidden + layer.post_feedforward_layernorm(out), None

    def _head(self, hidden: torch.Tensor, return_hidden: bool
              ) -> Dict[str, torch.Tensor]:
        cap = self.config.final_logit_softcapping
        if return_hidden and cap is not None:
            # the fused hidden @ head loss cannot apply the tanh cap
            raise NotImplementedError(
                "final_logit_softcapping (Gemma-2) is incompatible with "
                "hidden-state losses (FusedLinearCrossEntropy): the cap "
                "must apply to the full logits; use a logits loss "
                "(e.g. MaskedCrossEntropy) for this family")
        out = super()._head(hidden, return_hidden)
        if cap is not None:
            logits = out["logits"]
            out["logits"] = (torch.tanh(logits.float() / cap) * cap).to(
                logits.dtype)
        return out


@dataclasses.dataclass
class Gemma3VLConfig:
    """HF multimodal ``Gemma3Config`` (``model_type`` "gemma3")."""

    text_config: Any = None
    vision_config: Any = None
    mm_tokens_per_image: int = 256
    image_token_index: int = 262144
    boi_token_index: int = 255999
    eoi_token_index: int = 256000
    model_type: str = "gemma3"
    tie_word_embeddings: bool = True
    torch_dtype: str = "bfloat16"

    def __post_init__(self):
        if isinstance(self.text_config, dict):
            self.text_config = Gemma3Config.from_hf_config(self.text_config)
        if isinstance(self.vision_config, dict):
            self.vision_config = VisionConfig.from_hf_config(
                self.vision_config)
        self.text_config = self.text_config or Gemma3Config()
        self.vision_config = self.vision_config or VisionConfig()

    @classmethod
    def from_hf_config(cls, hf: Dict[str, Any]) -> "Gemma3VLConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in hf.items() if k in known})


class Gemma3Projector(nn.Module):
    """``mm_soft_emb_norm`` ``[Hv]`` and ``mm_input_projection_weight`` ``[Hv,
    Ht]`` (applied as ``x @ W``: the HF and JAX layout)."""

    def __init__(self, Hv: int, Ht: int, eps: float, dtype, device):
        super().__init__()
        self.mm_soft_emb_norm = GemmaRMSNorm(Hv, eps, dtype, device)
        self.mm_input_projection_weight = nn.Parameter(
            torch.zeros(Hv, Ht, dtype=dtype, device=device))


class Gemma3ForConditionalGeneration(ImageTextModel):
    """SigLIP tower -> average-pool + soft-embedding-norm projector ->
    Gemma-3 decoder; the decoder scales its token embeddings before the
    image features overwrite theirs (HF's order)."""

    def __init__(self, config: Gemma3VLConfig, **kwargs):
        super().__init__(config, Gemma3ForCausalLM, **kwargs)
        self.image_token_id = config.image_token_index
        self.multi_modal_projector = Gemma3Projector(
            config.vision_config.hidden_size, config.text_config.hidden_size,
            config.text_config.rms_norm_eps, self.param_dtype,
            self.language_model.inv_freq.device)

    def _init_projector(self, gen: torch.Generator) -> None:
        p = self.multi_modal_projector
        p.mm_input_projection_weight.normal_(0.0, 0.02, generator=gen)
        p.mm_soft_emb_norm.weight.zero_()

    def _projector_leaves(self):
        p = self.multi_modal_projector
        yield (("multi_modal_projector", "mm_input_projection_weight"),
               p.mm_input_projection_weight, False)
        yield (("multi_modal_projector", "mm_soft_emb_norm", "weight"),
               p.mm_soft_emb_norm.weight, False)

    def encode_images(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """``[B_img, H, W, C]`` -> ``[B_img, mm_tokens_per_image,
        text_hidden]`` in the compute dtype."""
        cfg, cd = self.config, self.compute_dtype
        feats = self.vision_tower(pixel_values)
        B, _, Hv = feats.shape
        side = cfg.vision_config.image_size // cfg.vision_config.patch_size
        tokens_side = int(round(cfg.mm_tokens_per_image ** 0.5))
        pool = side // tokens_side
        x = feats.reshape(B, tokens_side, pool, tokens_side, pool, Hv)
        x = x.mean(dim=(2, 4)).reshape(B, tokens_side * tokens_side, Hv)
        x = self.multi_modal_projector.mm_soft_emb_norm(x)
        w = self.multi_modal_projector.mm_input_projection_weight.to(cd)
        return x.to(cd) @ w
