"""Gemma-3n, text and multimodal, as ``nn.Module``s (counterpart:
``automodel_tpu/models/gemma3n.py``).

:class:`Gemma3nForCausalLM` is the Llama decoder of ``models/llama.py``
(its ``_proj`` seam for LoRA, its remat units and layer loop, its
``forward`` entry) with the Gemma-3n body:

* **AltUp**: ``altup_num_inputs`` parallel hidden streams ``[A, B, S, H]``.
  The token embeddings become stream 0; the others are magnitude-matched
  projections of it (``altup_projections``).  Each layer predicts every
  stream from a router-modulated ``[A, A]`` mix, runs the transformer body
  on the active prediction (stream 0) and corrects every stream with the
  innovation; the streams are merged back by the unembed projections and
  averaged before the final norm.
* **Laurel**: a low-rank ``left @ right`` bypass around attention,
  rms-normed, averaged with the attention residual by ``1/sqrt(2)``.
* **Per-layer embeddings (PLE)**: a second table ``[vocab_per_layer, L *
  H_pl]`` (rows zero for ids past it) plus a projection of the embeddings;
  each layer's slice gates the corrected streams ``1:`` (never stream 0).
* **Activation sparsity**: on layers whose ``activation_sparsity_pattern``
  is above 0 the gate activations pass ``relu(g - (mean + std *
  std_mult))``, the population std, ``std_mult`` the normal ppf of the
  pattern computed on the host by :func:`_ppf` (the JAX constants, not
  ``torch.erfinv``: a cutoff that differs in its last bits moves which
  activations survive).
* Attention with q / k rms-norms and a weightless v norm, **softmax scale
  1.0**, sliding layers (``layer_types``; every fifth layer full by
  default) rotating by ``rope_local_base_freq`` and attending within
  ``sliding_window``, full layers by ``rope_theta``.  Attention goes
  through ``ops/attention.py::attention``, i.e. kernel 9
  (``csrc/flash_attn_{fwd,bwd}.cu``) on CUDA tensors.  Where JAX scans the
  layers and branches with ``lax.cond`` on per-layer flags, the Python
  loop hands each layer its window and sparsity as constants.
* Plain RMSNorm, ``x / sqrt(mean(x^2) + eps) * w`` in fp32 (:func:`_rms_norm`,
  weights starting at one): not Gemma-3's ``(1 + w)``.  A tied head with
  ``final_logit_softcapping``, which a hidden-state loss
  (``FusedLinearCrossEntropy``) refuses, as in JAX.

KV sharing: HF shares the last ``num_kv_shared_layers`` layers' k / v only
when a cache object is present; its uncached forward, which training runs,
computes every layer's own k / v.  As the JAX model, the port reads the
field and computes every layer's k / v; decoding with a cache is refused.
Heterogeneous MatFormer widths (a per-layer ``intermediate_size`` list with
more than one value) raise, as in JAX.

:class:`Gemma3nVisionTower` is the JAX package's native conv tower (HF's
is a timm MobileNetV5): a 3x3 stride-2 stem, ``depth`` inverted-residual
blocks (1x1 expand, GELU, 3x3 depthwise, GELU, 1x1 project, plain RMSNorm,
residual), a 1x1 head and an average pool to the soft-token grid.  Its
kernels are kept as the JAX tree holds them, HWIO and stacked over the
blocks, so that both packages read each other's checkpoints; the 3x3
convolutions run ``F.conv2d`` on permuted views, the 1x1 ones as products
over the channel axis.  XLA's ``SAME`` padding at stride 2 pads an even
side by (0, 1), not (1, 1): the stem pads explicitly.

:class:`Gemma3nForConditionalGeneration` embeds multimodal ids (at or past
``vision_config.vocab_offset``) through the embedder's hard path, the
tower's soft tokens (times ``sqrt(vision hidden)``) through its soft path,
and scatters the soft tokens onto ``image_token_id`` positions with one
cumulative count over the whole flattened batch, as JAX does
(``models/vlm.py::merge_image_embeds`` counts per row; the two differ when
rows carry different numbers of images).  The per-layer embeddings stay
keyed by the raw ids.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from automodel_tpu_torch.models.llama import LlamaForCausalLM, as_dtype
from automodel_tpu_torch.ops.attention import attention
from automodel_tpu_torch.ops.remat import checkpoint_layer
from automodel_tpu_torch.ops.rotary import apply_rope, rope_tables
from automodel_tpu_torch.utils.device import resolve_device

_NO_CACHE = ("gemma3n decode uses the cacheless forward (see the KV sharing "
             "note in the module docstring); generation runs full-prefix "
             "forwards")


def _rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
              eps: float = 1e-6) -> torch.Tensor:
    """Gemma-3n RMSNorm: plain ``x / sqrt(mean(x^2) + eps) * w`` in fp32,
    cast back to ``x``'s dtype; no weight for the v norm and the
    embedder's output norm."""
    x32 = x.float()
    y = x32 / torch.sqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


class Gemma3nRMSNorm(nn.Module):
    """:func:`_rms_norm` with a weight that starts at one."""

    def __init__(self, size: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size, dtype=dtype,
                                              device=device))

    def forward(self, x):
        return _rms_norm(x, self.weight, self.eps)


@dataclasses.dataclass
class Gemma3nTextConfig:
    """HF ``Gemma3nTextConfig`` field names (speech fields omitted)."""

    vocab_size: int = 262400
    vocab_size_per_layer_input: int = 262144
    hidden_size: int = 2048
    hidden_size_per_layer_input: int = 256
    intermediate_size: Union[int, List[int]] = 16384
    num_hidden_layers: int = 35
    num_attention_heads: int = 8
    num_key_value_heads: int = 2
    head_dim: int = 256
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    rope_scaling: Optional[dict] = None
    rope_local_base_freq: float = 10_000.0
    sliding_window: int = 512
    layer_types: Optional[List[str]] = None
    max_position_embeddings: int = 32768
    final_logit_softcapping: Optional[float] = 30.0
    altup_active_idx: int = 0
    altup_coef_clip: Optional[float] = 120.0
    altup_correct_scale: bool = True
    altup_num_inputs: int = 4
    num_kv_shared_layers: int = 15
    laurel_rank: int = 64
    activation_sparsity_pattern: Optional[List[float]] = None
    tie_word_embeddings: bool = True
    attention_bias: bool = False
    model_type: str = "gemma3n_text"
    torch_dtype: str = "bfloat16"

    def __post_init__(self):
        L = self.num_hidden_layers
        if self.layer_types is None:
            # HF default: every 5th layer full attention
            self.layer_types = [
                "full_attention" if (i + 1) % 5 == 0 else "sliding_attention"
                for i in range(L)]
        if isinstance(self.intermediate_size, (list, tuple)):
            widths = set(int(x) for x in self.intermediate_size)
            if len(widths) != 1:
                raise NotImplementedError(
                    "gemma3n: heterogeneous per-layer intermediate_size "
                    f"(MatFormer widths {sorted(widths)}) cannot ride one "
                    "scanned layer body; released e2b/e4b configs are "
                    "uniform")
            self.intermediate_size = widths.pop()
        if self.activation_sparsity_pattern is None:
            self.activation_sparsity_pattern = [0.0] * L
        self.activation_sparsity_pattern = [
            float(x) for x in self.activation_sparsity_pattern]

    @classmethod
    def from_hf_config(cls, hf: Dict[str, Any]) -> "Gemma3nTextConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in hf.items() if k in known})


def _ppf(p: float) -> float:
    """Standard-normal inverse CDF (host-side, for the sparsity cutoff)."""
    if p <= 0.0:
        return -math.inf
    return float(math.sqrt(2.0) * float(_erfinv(2.0 * p - 1.0)))


def _erfinv(x: float) -> float:
    # Winitzki's approximation refined by two Newton steps -- plenty for the
    # one constant per layer this feeds (HF uses torch's erfinv).
    a = 0.147
    ln1mx2 = math.log(max(1.0 - x * x, 1e-300))
    t = 2.0 / (math.pi * a) + ln1mx2 / 2.0
    y = math.copysign(math.sqrt(math.sqrt(t * t - ln1mx2 / a) - t), x)
    for _ in range(2):
        err = math.erf(y) - x
        y -= err / (2.0 / math.sqrt(math.pi) * math.exp(-y * y))
    return y


def _linear(i: int, o: int, dtype, device) -> nn.Linear:
    return nn.Linear(i, o, bias=False, dtype=dtype, device=device)


_NORMS = ("input_layernorm", "post_attention_layernorm",
          "pre_feedforward_layernorm", "post_feedforward_layernorm")


class Gemma3nAltUp(nn.Module):
    """One layer's AltUp: ``correct_output_scale [H]`` (zeros at init), the
    ``[A, A]`` correction and ``[A, A * A]`` prediction coefficients, the
    ``[H, A]`` modality router and its norm."""

    def __init__(self, cfg: Gemma3nTextConfig, dtype, device):
        super().__init__()
        H, A = cfg.hidden_size, cfg.altup_num_inputs
        self.correct_output_scale = nn.Parameter(
            torch.zeros(H, dtype=dtype, device=device))
        self.correction_coefs = _linear(A, A, dtype, device)
        self.prediction_coefs = _linear(A, A * A, dtype, device)
        self.modality_router = _linear(H, A, dtype, device)
        self.router_norm = Gemma3nRMSNorm(H, cfg.rms_norm_eps, dtype, device)


class Gemma3nLaurel(nn.Module):
    def __init__(self, cfg: Gemma3nTextConfig, dtype, device):
        super().__init__()
        H, R = cfg.hidden_size, cfg.laurel_rank
        self.linear_left = _linear(H, R, dtype, device)
        self.linear_right = _linear(R, H, dtype, device)
        self.post_laurel_norm = Gemma3nRMSNorm(H, cfg.rms_norm_eps, dtype,
                                               device)


class Gemma3nDecoderLayer(nn.Module):
    """Four block norms, q / k / v / o with q / k norms, the gated MLP,
    AltUp, Laurel and the per-layer input gate.  ``full``: the layer
    attends causally over the whole row (else within ``sliding_window``);
    ``std_mult``: the sparsity cutoff's multiplier (None: a dense gate)."""

    def __init__(self, cfg: Gemma3nTextConfig, dtype, device, full: bool,
                 std_mult: Optional[float]):
        super().__init__()
        H, D, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
        Hq, Hk = cfg.num_attention_heads, cfg.num_key_value_heads
        Hpl, eps = cfg.hidden_size_per_layer_input, cfg.rms_norm_eps
        self.full = full
        self.std_mult = std_mult
        for norm in _NORMS:
            setattr(self, norm, Gemma3nRMSNorm(H, eps, dtype, device))
        self.q_proj, self.k_proj = _linear(H, Hq * D, dtype, device), \
            _linear(H, Hk * D, dtype, device)
        self.v_proj, self.o_proj = _linear(H, Hk * D, dtype, device), \
            _linear(Hq * D, H, dtype, device)
        self.q_norm = Gemma3nRMSNorm(D, eps, dtype, device)
        self.k_norm = Gemma3nRMSNorm(D, eps, dtype, device)
        self.gate_proj, self.up_proj = _linear(H, I, dtype, device), \
            _linear(H, I, dtype, device)
        self.down_proj = _linear(I, H, dtype, device)
        self.altup = Gemma3nAltUp(cfg, dtype, device)
        self.laurel = Gemma3nLaurel(cfg, dtype, device)
        self.per_layer_input_gate = _linear(H, Hpl, dtype, device)
        self.per_layer_projection = _linear(Hpl, H, dtype, device)
        self.post_per_layer_input_norm = Gemma3nRMSNorm(H, eps, dtype,
                                                        device)


class Gemma3nForCausalLM(LlamaForCausalLM):
    """``model_type: gemma3n_text``.  ``device`` None is ``cuda`` (raises
    without a card).  ``remat``, ``remat_policy`` and ``scan_block`` as
    the Llama class's; the head is always tied, as in JAX."""

    def __init__(self, config: Gemma3nTextConfig, **kwargs):
        super().__init__(config, **kwargs)
        cfg, dt = config, self.param_dtype
        dev = self.inv_freq.device
        L, H = cfg.num_hidden_layers, cfg.hidden_size
        Hpl, A = cfg.hidden_size_per_layer_input, cfg.altup_num_inputs
        self.lm_head = None
        self.norm = Gemma3nRMSNorm(H, cfg.rms_norm_eps, dt, dev)
        self.embed_tokens_per_layer = nn.Embedding(
            cfg.vocab_size_per_layer_input, L * Hpl, dtype=dt, device=dev)
        self.per_layer_model_projection = _linear(H, L * Hpl, dt, dev)
        self.per_layer_projection_norm = Gemma3nRMSNorm(
            Hpl, cfg.rms_norm_eps, dt, dev)
        self.altup_projections = nn.ModuleList(
            [_linear(H, H, dt, dev) for _ in range(A - 1)])
        self.altup_unembed_projections = nn.ModuleList(
            [_linear(H, H, dt, dev) for _ in range(A - 1)])
        inv_local, _ = rope_tables(cfg.head_dim, cfg.rope_local_base_freq)
        self.register_buffer("inv_freq_local",
                             torch.from_numpy(inv_local).to(dev),
                             persistent=False)

    def _uniform_window(self, cfg) -> Optional[int]:
        return None                  # per layer: Gemma3nDecoderLayer.full

    def _build_layers(self, cfg: Gemma3nTextConfig, dtype, device) -> None:
        # the sparsity multipliers rounded to fp32 on the host, as JAX's
        # np.float32 array of them
        self.layers = nn.ModuleList([
            Gemma3nDecoderLayer(
                cfg, dtype, device, t == "full_attention",
                float(np.float32(_ppf(p))) if p > 0.0 else None)
            for t, p in zip(cfg.layer_types,
                            cfg.activation_sparsity_pattern)])

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "Gemma3nForCausalLM":
        """N(0, 0.02) for embeddings and kernels, ones for the norms,
        zeros for ``correct_output_scale`` (the JAX ``init``'s
        distribution, not its numbers)."""
        gen = torch.Generator(device=self.inv_freq.device).manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith("correct_output_scale"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=gen)
        return self

    def jax_tree_leaves(self) -> Iterator[Tuple[Tuple[str, ...], Any, bool]]:
        """``(JAX path, target, transposed)`` of every leaf of the JAX
        Gemma-3n tree (``models/weights.py::jax_leaves``); the AltUp
        projections stack over ``A - 1`` as the layers do over ``L``."""
        layers = self.layers
        yield ("embed_tokens", "embedding"), self.embed_tokens.weight, False
        yield (("embed_tokens_per_layer", "embedding"),
               self.embed_tokens_per_layer.weight, False)
        yield (("per_layer_model_projection", "kernel"),
               self.per_layer_model_projection.weight, True)
        yield (("per_layer_projection_norm", "weight"),
               self.per_layer_projection_norm.weight, False)
        for name in ("altup_projections", "altup_unembed_projections"):
            yield ((name, "kernel"), [l.weight for l in getattr(self, name)],
                   True)

        def each(get):
            return [get(l) for l in layers]

        for norm in _NORMS:
            yield (("layers", norm, "weight"),
                   each(lambda l: getattr(l, norm).weight), False)
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            yield (("layers", "self_attn", proj, "kernel"),
                   each(lambda l: getattr(l, proj).weight), True)
        for norm in ("q_norm", "k_norm"):
            yield (("layers", "self_attn", norm, "weight"),
                   each(lambda l: getattr(l, norm).weight), False)
        for proj in ("gate_proj", "up_proj", "down_proj"):
            yield (("layers", "mlp", proj, "kernel"),
                   each(lambda l: getattr(l, proj).weight), True)
        yield (("layers", "altup", "correct_output_scale"),
               each(lambda l: l.altup.correct_output_scale), False)
        for lin in ("correction_coefs", "prediction_coefs",
                    "modality_router"):
            yield (("layers", "altup", lin, "kernel"),
                   each(lambda l: getattr(l.altup, lin).weight), True)
        yield (("layers", "altup", "router_norm", "weight"),
               each(lambda l: l.altup.router_norm.weight), False)
        for lin in ("linear_left", "linear_right"):
            yield (("layers", "laurel", lin, "kernel"),
                   each(lambda l: getattr(l.laurel, lin).weight), True)
        yield (("layers", "laurel", "post_laurel_norm", "weight"),
               each(lambda l: l.laurel.post_laurel_norm.weight), False)
        for lin in ("per_layer_input_gate", "per_layer_projection"):
            yield (("layers", lin, "kernel"),
                   each(lambda l: getattr(l, lin).weight), True)
        yield (("layers", "post_per_layer_input_norm", "weight"),
               each(lambda l: l.post_per_layer_input_norm.weight), False)
        yield ("norm", "weight"), self.norm.weight, False

    # -- pieces ------------------------------------------------------------
    def _embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        scale = torch.tensor(float(self.config.hidden_size) ** 0.5, dtype=cd)
        return self.embed_tokens.weight[input_ids].to(cd) * scale.to(
            input_ids.device)

    def _const(self, value: float, dtype, ref: torch.Tensor) -> torch.Tensor:
        """``value`` rounded to ``dtype`` first (JAX's ``jnp.asarray(v,
        dtype)``), on ``ref``'s device."""
        return torch.tensor(value, dtype=dtype, device=ref.device)

    def _per_layer_inputs(self, input_ids: torch.Tensor,
                          embeds: torch.Tensor) -> torch.Tensor:
        """``[B, S, L, H_pl]``: the PLE rows of ``input_ids`` (zero past
        ``vocab_size_per_layer_input``) and the normed projection of the
        embeddings, averaged by ``1/sqrt(2)``."""
        cfg, cd = self.config, self.compute_dtype
        B, S = input_ids.shape
        L, Hpl = cfg.num_hidden_layers, cfg.hidden_size_per_layer_input
        in_range = input_ids < cfg.vocab_size_per_layer_input
        safe = torch.where(in_range, input_ids, torch.zeros_like(input_ids))
        ple = self.embed_tokens_per_layer.weight[safe].to(cd) * self._const(
            float(Hpl) ** 0.5, cd, embeds)
        ple = torch.where(in_range[..., None], ple,
                          torch.zeros((), dtype=cd, device=ple.device))
        ple = ple.reshape(B, S, L, Hpl)
        proj = F.linear(embeds, self.per_layer_model_projection.weight.to(
            cd)) * self._const(float(cfg.hidden_size) ** -0.5, cd, embeds)
        proj = self.per_layer_projection_norm(proj.reshape(B, S, L, Hpl))
        return (proj + ple) * self._const(1.0 / math.sqrt(2.0), cd, embeds)

    @staticmethod
    def _matched(x: torch.Tensor, w: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
        """``x @ w^T`` rescaled to the root-mean-square ``target`` (the
        projection's own at least ``sqrt(1e-5)``), in ``x``'s dtype."""
        proj = F.linear(x, w.to(x.dtype)).float()
        mag = torch.sqrt(torch.clamp_min(
            proj.square().mean(dim=-1, keepdim=True), 1e-5))
        return (proj * target / mag).to(x.dtype)

    def _expand_streams(self, h0: torch.Tensor) -> torch.Tensor:
        """``[B, S, H]`` -> ``[A, B, S, H]``: ``h0`` and its
        magnitude-matched projections."""
        target = torch.sqrt(h0.float().square().mean(dim=-1, keepdim=True))
        return torch.stack([h0] + [self._matched(h0, lin.weight, target)
                                   for lin in self.altup_projections])

    def _merge_streams(self, h: torch.Tensor) -> torch.Tensor:
        target = torch.sqrt(h[0].float().square().mean(dim=-1, keepdim=True))
        streams = [h[0]] + [
            self._matched(h[i + 1], lin.weight, target)
            for i, lin in enumerate(self.altup_unembed_projections)]
        return torch.stack(streams).mean(dim=0)

    def _router_modalities(self, x: torch.Tensor, altup: Gemma3nAltUp
                           ) -> torch.Tensor:
        r = altup.router_norm(x)
        r = r * self._const(1.0 / self.config.hidden_size, r.dtype, r)
        routed = F.linear(r, altup.modality_router.weight.to(r.dtype))
        return torch.tanh(routed.float()).to(x.dtype)

    def _altup_predict(self, h: torch.Tensor, altup: Gemma3nAltUp
                       ) -> torch.Tensor:
        """``h [A, B, S, H]`` -> the predictions ``[A, B, S, H]``."""
        A = self.config.altup_num_inputs
        mods = self._router_modalities(h[self.config.altup_active_idx], altup)
        pc = F.linear(mods, altup.prediction_coefs.weight.to(mods.dtype))
        pcr = pc.reshape(*mods.shape[:-1], A, A)             # [B, S, j, a]
        pred = torch.einsum("bsja,absh->jbsh", pcr.float(), h.float())
        return pred.to(h.dtype) + h

    def _altup_correct(self, predictions: torch.Tensor,
                       activated: torch.Tensor, altup: Gemma3nAltUp
                       ) -> torch.Tensor:
        mods = self._router_modalities(activated, altup)
        innovation = activated - predictions[self.config.altup_active_idx]
        coefs = F.linear(mods, altup.correction_coefs.weight.to(
            mods.dtype)) + 1.0                               # [B, S, A]
        coefs = coefs.permute(2, 0, 1)[..., None]            # [A, B, S, 1]
        return predictions + coefs * innovation[None]

    def _sparse_gate(self, g: torch.Tensor, std_mult: float) -> torch.Tensor:
        """``relu(g - (mean + std * std_mult))`` over the features, the
        population std, in fp32."""
        g32 = g.float()
        mean = g32.mean(dim=-1, keepdim=True)
        std = g32.std(dim=-1, keepdim=True, unbiased=False)
        return F.relu(g32 - (mean + std * std_mult)).to(g.dtype)

    # -- layers --------------------------------------------------------------
    def _layer(self, layer: Gemma3nDecoderLayer, h, per_layer_in,
               position_ids, segment_ids, attn_impl, adapters=None):
        """One decoder layer over the streams ``h [A, B, S, H]`` with its
        per-layer input ``[B, S, H_pl]``; ``adapters`` reach ``_proj`` for
        the length of the call."""
        self._adapters = adapters
        try:
            return self._layer_body(layer, h, per_layer_in, position_ids,
                                    segment_ids, attn_impl)
        finally:
            self._adapters = None

    def _layer_body(self, layer, h, per_layer_in, position_ids, segment_ids,
                    attn_impl):
        cfg, cd = self.config, self.compute_dtype
        _, B, S, _ = h.shape
        D, Hq, Hk = cfg.head_dim, cfg.num_attention_heads, \
            cfg.num_key_value_heads
        eps = cfg.rms_norm_eps
        predictions = self._altup_predict(h, layer.altup)
        active = predictions[cfg.altup_active_idx]
        x = layer.input_layernorm(active)

        lo = F.linear(x, layer.laurel.linear_left.weight.to(cd))
        lo = F.linear(lo, layer.laurel.linear_right.weight.to(cd))
        laurel_out = x + layer.laurel.post_laurel_norm(lo)

        q = self._proj(layer.q_proj, x, "self_attn.q_proj").view(B, S, Hq, D)
        k = self._proj(layer.k_proj, x, "self_attn.k_proj").view(B, S, Hk, D)
        v = self._proj(layer.v_proj, x, "self_attn.v_proj").view(B, S, Hk, D)
        q, k, v = layer.q_norm(q), layer.k_norm(k), _rms_norm(v, None, eps)
        q, k = apply_rope(q, k, position_ids,
                          self.inv_freq if layer.full else self.inv_freq_local)
        attn = attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
            segment_ids=segment_ids, scale=1.0,
            local_window_size=None if layer.full else int(cfg.sliding_window),
            impl=attn_impl)
        attn = self._proj(layer.o_proj, attn.reshape(B, S, Hq * D),
                          "self_attn.o_proj")
        attn = layer.post_attention_layernorm(attn)
        attn_laurel = ((active + attn + laurel_out)
                       * self._const(1.0 / math.sqrt(2.0), cd, attn))

        x = layer.pre_feedforward_layernorm(attn_laurel)
        gate = self._proj(layer.gate_proj, x, "mlp.gate_proj")
        if layer.std_mult is not None:
            gate = self._sparse_gate(gate, layer.std_mult)
        up = self._proj(layer.up_proj, x, "mlp.up_proj")
        down = self._proj(layer.down_proj,
                          F.gelu(gate, approximate="tanh") * up,
                          "mlp.down_proj")
        activated = attn_laurel + layer.post_feedforward_layernorm(down)

        corrected = self._altup_correct(predictions, activated, layer.altup)
        first = corrected[cfg.altup_active_idx]
        if cfg.altup_correct_scale:
            first = first * layer.altup.correct_output_scale.to(first.dtype)
        g = F.gelu(F.linear(first, layer.per_layer_input_gate.weight.to(cd)),
                   approximate="tanh")
        g = F.linear(g * per_layer_in, layer.per_layer_projection.weight.to(
            cd))
        g = layer.post_per_layer_input_norm(g)
        # the per-layer gate joins streams 1: only, never the active one
        return torch.cat([corrected[:1],
                          corrected[1:] + g[None].to(corrected.dtype)])

    def _unit(self, h, per_layer, position_ids, segment_ids, *, first: int,
              attn_impl, adapters):
        """Layers ``first .. first + scan_block - 1`` (one checkpointed
        unit) with their slices ``per_layer [B, S, scan_block, H_pl]``."""
        for j in range(self.scan_block):
            h = self._layer(self.layers[first + j], h, per_layer[:, :, j],
                            position_ids, segment_ids, attn_impl,
                            adapters[j] if adapters else None)
        return h

    # -- forward -------------------------------------------------------------
    def forward(self, input_ids: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                kv_cache=None, return_hidden: bool = False,
                attn_impl: Optional[str] = None, adapters=None,
                cache_index: Optional[int] = None,
                adapter_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """The Llama entry's arguments; a cache raises (the cacheless
        forward only, as in JAX).  ``inputs_embeds`` (the multimodal
        model's merged embeddings) replaces the scaled token embeddings
        while the per-layer embeddings stay keyed by ``input_ids``."""
        if kv_cache is not None:
            raise NotImplementedError(_NO_CACHE)
        return super().forward(
            input_ids, position_ids, segment_ids, attention_mask, None,
            return_hidden, attn_impl, adapters, cache_index, adapter_ids,
            inputs_embeds)

    def _forward(self, input_ids, position_ids, segment_ids, kv_cache,
                 return_hidden, attn_impl, adapters, inputs_embeds=None):
        cd = self.compute_dtype
        embeds = (self._embed(input_ids) if inputs_embeds is None
                  else inputs_embeds.to(cd))
        per_layer = self._per_layer_inputs(input_ids, embeds)
        h = self._expand_streams(embeds)
        remat = self.remat and torch.is_grad_enabled()
        k = self.scan_block
        for first in range(0, len(self.layers), k):
            # the unit's adapters ride the closure (see the Llama loop)
            unit = functools.partial(
                self._unit, first=first, attn_impl=attn_impl,
                adapters=adapters[first:first + k] if adapters else None)
            args = (h, per_layer[:, :, first:first + k], position_ids,
                    segment_ids)
            h = (checkpoint_layer(unit, *args, policy=self.remat_policy)
                 if remat else unit(*args))
        hidden = self.norm(self._merge_streams(h))
        return self._head(hidden, return_hidden)

    def _head(self, hidden: torch.Tensor, return_hidden: bool
              ) -> Dict[str, torch.Tensor]:
        cap = self.config.final_logit_softcapping
        if return_hidden and cap is not None:
            # the fused hidden @ head loss cannot apply the tanh cap
            raise NotImplementedError(
                "final_logit_softcapping is incompatible with hidden-state "
                "losses (FusedLinearCrossEntropy): use a logits loss (e.g. "
                "MaskedCrossEntropy) for gemma3n")
        out = super()._head(hidden, return_hidden)
        if cap is not None:
            logits = out["logits"]
            out["logits"] = (torch.tanh(logits.float() / cap) * cap).to(
                logits.dtype)
        return out

    def init_kv_cache(self, *args, **kwargs):
        raise NotImplementedError(_NO_CACHE)

    def flops_per_token(self) -> float:
        """The JAX model's count: attention and MLP projections, Laurel,
        the AltUp router and coefficients, the per-layer gate and
        projection, and the head (fwd + bwd = 3 x 2 MACs)."""
        cfg = self.config
        H, D = cfg.hidden_size, cfg.head_dim
        Hpl = cfg.hidden_size_per_layer_input
        A, R = cfg.altup_num_inputs, cfg.laurel_rank
        attn = (2 * H * (cfg.num_attention_heads
                         + 2 * cfg.num_key_value_heads) * D
                + 2 * cfg.num_attention_heads * D * H)
        ffn = 6 * H * cfg.intermediate_size
        extras = (2 * H * R * 2            # laurel
                  + 2 * H * A * (1 + A)    # altup router + coefs
                  + 2 * H * Hpl * 2)       # per-layer gate + projection
        embed = 2 * cfg.vocab_size * H
        return 3.0 * (cfg.num_hidden_layers * (attn + ffn + extras) + embed)


# ---------------------------------------------------------------------------
# Multimodal: the native conv tower and the multimodal embedder
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Gemma3nVisionConfig:
    """HF ``Gemma3nVisionConfig``'s interface fields plus the native
    tower's knobs (not HF fields)."""

    hidden_size: int = 2048
    vocab_size: int = 128
    vocab_offset: int = 262144
    rms_norm_eps: float = 1e-6
    in_channels: int = 3
    stem_channels: int = 64
    depth: int = 4
    expand_ratio: int = 2
    model_type: str = "gemma3n_vision"

    @classmethod
    def from_hf_config(cls, hf: Dict[str, Any]) -> "Gemma3nVisionConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in hf.items() if k in known})


@dataclasses.dataclass
class Gemma3nVLConfig:
    """HF multimodal ``Gemma3nConfig`` (``model_type`` "gemma3n").  It has
    no ``torch_dtype`` field, as in JAX, so the model's parameter dtype is
    the caller's ``param_dtype`` (fp32 by default)."""

    text_config: Any = None
    vision_config: Any = None
    image_token_id: int = 262145
    vision_soft_tokens_per_image: int = 256
    model_type: str = "gemma3n"
    tie_word_embeddings: bool = True

    def __post_init__(self):
        if isinstance(self.text_config, dict):
            self.text_config = Gemma3nTextConfig.from_hf_config(
                self.text_config)
        if isinstance(self.vision_config, dict):
            self.vision_config = Gemma3nVisionConfig.from_hf_config(
                self.vision_config)
        self.text_config = self.text_config or Gemma3nTextConfig()
        self.vision_config = self.vision_config or Gemma3nVisionConfig()
        g = int(math.isqrt(self.vision_soft_tokens_per_image))
        if g * g != self.vision_soft_tokens_per_image:
            raise ValueError(
                "vision_soft_tokens_per_image must be a square grid; got "
                f"{self.vision_soft_tokens_per_image}")

    @classmethod
    def from_hf_config(cls, hf: Dict[str, Any]) -> "Gemma3nVLConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in hf.items() if k in known})


class _Kernel(nn.Module):
    """A convolution kernel in the JAX layout (HWIO, blocks stacked
    first)."""

    def __init__(self, shape, dtype, device):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(shape, dtype=dtype,
                                               device=device))


class _Blocks(nn.Module):
    """The inverted-residual blocks' kernels and norms, stacked over
    ``depth``: ``expand [D, 1, 1, C, E C]``, ``depthwise [D, 3, 3, 1,
    E C]``, ``project [D, 1, 1, E C, C]``, ``norm.weight [D, C]``."""

    def __init__(self, cfg: Gemma3nVisionConfig, dtype, device):
        super().__init__()
        D, C = cfg.depth, cfg.stem_channels
        EC = cfg.expand_ratio * C
        self.expand = _Kernel((D, 1, 1, C, EC), dtype, device)
        self.depthwise = _Kernel((D, 3, 3, 1, EC), dtype, device)
        self.project = _Kernel((D, 1, 1, EC, C), dtype, device)
        self.norm = nn.Module()
        self.norm.weight = nn.Parameter(torch.ones(D, C, dtype=dtype,
                                                   device=device))


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one side: ``ceil(size / stride)`` outputs,
    the odd pixel of the total at the end (an even side at stride 2 pads
    (0, 1) for a 3x3 kernel)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
          groups: int = 1) -> torch.Tensor:
    """``SAME`` convolution of NHWC ``x`` by an HWIO ``kernel`` through
    ``F.conv2d`` on the NCHW views (channels-last memory: no copies)."""
    kh, kw = kernel.shape[:2]
    ph, pw = (_same_pads(x.shape[1], kh, stride),
              _same_pads(x.shape[2], kw, stride))
    xs = F.pad(x.permute(0, 3, 1, 2), (*pw, *ph))
    y = F.conv2d(xs, kernel.permute(3, 2, 0, 1), stride=stride,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


class Gemma3nVisionTower(nn.Module):
    """NHWC images ``[N, H, W, C]`` -> soft tokens ``[N, soft_tokens,
    vision_hidden]`` (the JAX native tower)."""

    def __init__(self, config: Gemma3nVisionConfig, soft_tokens: int,
                 param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        cfg = config
        self.config = config
        self.soft_tokens = int(soft_tokens)
        self.grid = int(math.isqrt(self.soft_tokens))
        self.param_dtype = as_dtype(param_dtype)
        self.compute_dtype = as_dtype(compute_dtype)
        device = resolve_device(device)
        dt, C = self.param_dtype, cfg.stem_channels
        self.stem = _Kernel((3, 3, cfg.in_channels, C), dt, device)
        self.blocks = _Blocks(cfg, dt, device)
        self.head = _Kernel((1, 1, C, cfg.hidden_size), dt, device)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX ``init``'s distribution: He-normal stem and head, N(0,
        0.05) expand / project, N(0, 0.1) depthwise, norms at one."""
        for mod, std in ((self.stem, None), (self.blocks.expand, 0.05),
                         (self.blocks.depthwise, 0.1),
                         (self.blocks.project, 0.05), (self.head, None)):
            k = mod.kernel
            if std is None:
                std = (2.0 / float(np.prod(k.shape[:-1]))) ** 0.5
            k.normal_(0.0, std, generator=gen)
        self.blocks.norm.weight.fill_(1.0)

    def jax_tree_leaves(self) -> Iterator[Tuple[Tuple[str, ...], Any, bool]]:
        yield ("stem", "kernel"), self.stem.kernel, False
        for name in ("expand", "depthwise", "project"):
            yield (("blocks", name, "kernel"),
                   getattr(self.blocks, name).kernel, False)
        yield ("blocks", "norm", "weight"), self.blocks.norm.weight, False
        yield ("head", "kernel"), self.head.kernel, False

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg, cd = self.config, self.compute_dtype
        x = F.gelu(_conv(images.to(cd), self.stem.kernel.to(cd), stride=2),
                   approximate="tanh")
        b = self.blocks
        for d in range(cfg.depth):
            y = F.gelu(x @ b.expand.kernel[d, 0, 0].to(cd),
                       approximate="tanh")
            y = F.gelu(_conv(y, b.depthwise.kernel[d].to(cd),
                             groups=y.shape[-1]), approximate="tanh")
            y = y @ b.project.kernel[d, 0, 0].to(cd)
            x = x + _rms_norm(y, b.norm.weight[d], cfg.rms_norm_eps)
        x = x @ self.head.kernel[0, 0].to(cd)
        # average pool to the soft-token grid
        N, H, W, D = x.shape
        g = self.grid
        if H % g or W % g:
            raise ValueError(
                f"vision input {H}x{W} must be divisible by the soft-token "
                f"grid {g}x{g} after the stride-2 stem")
        x = x.reshape(N, g, H // g, g, W // g, D).mean(dim=(2, 4))
        return x.reshape(N, g * g, D)

    def flops_per_image(self, image_size: int) -> float:
        """Training FLOPs of one square image of side ``image_size`` (fwd
        + bwd = 3 x 2 MACs): the stem at half the side, the blocks'
        expand / depthwise / project and the head at that resolution."""
        cfg = self.config
        C, EC = cfg.stem_channels, cfg.expand_ratio * cfg.stem_channels
        pixels = (-(-image_size // 2)) ** 2
        per_pixel = (9 * cfg.in_channels * C
                     + cfg.depth * (C * EC + 9 * EC + EC * C)
                     + C * cfg.hidden_size)
        return 3.0 * 2.0 * pixels * per_pixel


class Gemma3nMultimodalEmbedder(nn.Module):
    """``embed_vision``: the hard path's table ``[vision vocab, Hv]`` and
    norm, the soft path's norm, and the shared ``[Hv, H]`` projection."""

    def __init__(self, vc: Gemma3nVisionConfig, text_hidden: int, dtype,
                 device):
        super().__init__()
        Hv, eps = vc.hidden_size, vc.rms_norm_eps
        self.embedding = nn.Embedding(vc.vocab_size, Hv, dtype=dtype,
                                      device=device)
        self.hard_embedding_norm = Gemma3nRMSNorm(Hv, eps, dtype, device)
        self.soft_embedding_norm = Gemma3nRMSNorm(Hv, eps, dtype, device)
        self.embedding_projection = _linear(Hv, text_hidden, dtype, device)


class Gemma3nForConditionalGeneration(nn.Module):
    """``model_type: gemma3n``: the native tower, the multimodal embedder
    and the Gemma-3n decoder (``language_model``).  ``forward(input_ids,
    pixel_values=None, ...)`` takes the decoder's arguments;
    ``pixel_values`` is the collator's NHWC slots ``[B, I, H, W, C]`` or
    flat ``[N, H, W, C]``.  Audio is out of scope: it declares no
    ``extra_batch_keys``, so audio batch keys fail at the train step."""

    def __init__(self, config: Gemma3nVLConfig, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, remat: bool = True,
                 remat_policy: Optional[str] = "nothing_saveable",
                 scan_unroll: int = 1, scan_block: int = 1, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.param_dtype = as_dtype(param_dtype)
        self.compute_dtype = as_dtype(compute_dtype)
        self.language_model = Gemma3nForCausalLM(
            config.text_config, param_dtype=param_dtype,
            compute_dtype=compute_dtype, remat=remat,
            remat_policy=remat_policy, scan_unroll=scan_unroll,
            scan_block=scan_block, device=device)
        self.vision_tower = Gemma3nVisionTower(
            config.vision_config, config.vision_soft_tokens_per_image,
            param_dtype=self.param_dtype, compute_dtype=self.compute_dtype,
            device=device)
        self.embed_vision = Gemma3nMultimodalEmbedder(
            config.vision_config, config.text_config.hidden_size,
            self.param_dtype, device)

    # the decoder's knobs, as the first-step checks set them
    remat_policy = property(
        lambda self: self.language_model.remat_policy,
        lambda self, v: setattr(self.language_model, "remat_policy", v))
    qdot_impl = property(
        lambda self: self.language_model.qdot_impl,
        lambda self, v: setattr(self.language_model, "qdot_impl", v))

    @torch.no_grad()
    def init_weights(self, seed: int = 0
                     ) -> "Gemma3nForConditionalGeneration":
        """The decoder's weights from ``seed``, the tower's and the
        embedder's from ``seed + 1``."""
        self.language_model.init_weights(seed)
        dev = self.language_model.inv_freq.device
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        self.vision_tower.init_weights(gen)
        ev = self.embed_vision
        ev.embedding.weight.normal_(0.0, 0.02, generator=gen)
        ev.embedding_projection.weight.normal_(0.0, 0.02, generator=gen)
        ev.hard_embedding_norm.weight.fill_(1.0)
        ev.soft_embedding_norm.weight.fill_(1.0)
        return self

    def jax_tree_leaves(self) -> Iterator[Tuple[Tuple[str, ...], Any, bool]]:
        for path, t, tr in self.language_model.jax_tree_leaves():
            yield ("language_model",) + path, t, tr
        for path, t, tr in self.vision_tower.jax_tree_leaves():
            yield ("vision_tower",) + path, t, tr
        ev = self.embed_vision
        yield (("embed_vision", "embedding", "embedding"),
               ev.embedding.weight, False)
        for norm in ("hard_embedding_norm", "soft_embedding_norm"):
            yield (("embed_vision", norm, "weight"),
                   getattr(ev, norm).weight, False)
        yield (("embed_vision", "embedding_projection", "kernel"),
               ev.embedding_projection.weight, True)

    def _project(self, y: torch.Tensor) -> torch.Tensor:
        """The embedder's shared projection and weightless output norm."""
        vc = self.config.vision_config
        y = F.linear(y, self.embed_vision.embedding_projection.weight.to(
            y.dtype))
        return _rms_norm(y, None, vc.rms_norm_eps)

    def _embed_hard(self, ids: torch.Tensor) -> torch.Tensor:
        vc = self.config.vision_config
        local = torch.clamp(ids - vc.vocab_offset, 0, vc.vocab_size - 1)
        y = self.embed_vision.embedding.weight[local].to(self.compute_dtype)
        return self._project(self.embed_vision.hard_embedding_norm(y))

    def encode_images(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """``[N, H, W, C]`` images -> flat soft-token embeddings ``[N *
        soft_tokens, text_hidden]`` in the language model's space."""
        vc = self.config.vision_config
        soft = self.vision_tower(pixel_values)
        soft = soft * torch.tensor(float(vc.hidden_size) ** 0.5,
                                   dtype=soft.dtype, device=soft.device)
        emb = self._project(self.embed_vision.soft_embedding_norm(soft))
        return emb.reshape(-1, emb.shape[-1])

    def forward(self, input_ids: torch.Tensor,
                pixel_values: Optional[torch.Tensor] = None,
                kv_cache=None, cache_index: Optional[int] = None,
                **kwargs) -> Dict[str, torch.Tensor]:
        """Text embeddings (scaled, ids clipped to the vocabulary), the
        hard path's at multimodal ids, the soft tokens scattered onto
        ``image_token_id`` in the flattened batch's order; the other
        keywords are the decoder's (``adapters`` included)."""
        if kv_cache is not None or cache_index is not None:
            raise NotImplementedError(_NO_CACHE)
        cfg, cd = self.config, self.compute_dtype
        lm = self.language_model
        B, S = input_ids.shape
        safe = torch.clamp(input_ids, 0, cfg.text_config.vocab_size - 1)
        embeds = lm._embed(safe)
        is_mm = input_ids >= cfg.vision_config.vocab_offset
        embeds = torch.where(is_mm[..., None],
                             self._embed_hard(input_ids).to(cd), embeds)
        if pixel_values is not None:
            flat = (pixel_values.reshape(-1, *pixel_values.shape[2:])
                    if pixel_values.dim() == 5 else pixel_values)
            feats = self.encode_images(flat)
            is_img = (input_ids == cfg.image_token_id).reshape(-1)
            idx = torch.clamp(torch.cumsum(is_img.long(), dim=0) - 1, 0,
                              feats.shape[0] - 1)
            gathered = feats[idx].reshape(B, S, -1)
            embeds = torch.where(is_img.reshape(B, S)[..., None],
                                 gathered.to(cd), embeds)
        return lm(input_ids, inputs_embeds=embeds, **kwargs)

    def init_kv_cache(self, *args, **kwargs):
        raise NotImplementedError(_NO_CACHE)

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self) -> float:
        return self.language_model.flops_per_token()

    def attention_flops_per_token(self, seq_len: int,
                                  causal: bool = True) -> float:
        return self.language_model.attention_flops_per_token(seq_len, causal)

    def flops_per_image(self, image_size: int) -> float:
        """The tower's training FLOPs per image of side ``image_size`` plus
        the embedder's soft path (the JAX model counts neither in
        ``flops_per_token``)."""
        vc = self.config.vision_config
        soft = (3.0 * 2.0 * self.config.vision_soft_tokens_per_image
                * vc.hidden_size * self.config.text_config.hidden_size)
        return self.vision_tower.flops_per_image(image_size) + soft


def build_gemma3n_vl(config: Optional[dict] = None, *, seed: int = 0,
                     device=None, **kwargs) -> Gemma3nForConditionalGeneration:
    """The YAML entry (``model._target_``): an HF-style config dict (or
    none: the published defaults), weights drawn from ``seed``."""
    if config is not None:
        if hasattr(config, "to_dict"):
            config = config.to_dict()
        cfg = Gemma3nVLConfig.from_hf_config(config)
    else:
        cfg = Gemma3nVLConfig()
    return Gemma3nForConditionalGeneration(
        cfg, device=device, **kwargs).init_weights(seed)


def build_gemma3n_text(config: Optional[dict] = None, *, seed: int = 0,
                       device=None, **kwargs) -> Gemma3nForCausalLM:
    """The YAML entry for the text-only family."""
    if config is not None:
        if hasattr(config, "to_dict"):
            config = config.to_dict()
        cfg = Gemma3nTextConfig.from_hf_config(config)
    else:
        cfg = Gemma3nTextConfig()
    return Gemma3nForCausalLM(cfg, device=device, **kwargs).init_weights(
        seed)
