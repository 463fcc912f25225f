"""Phi-4-multimodal, the audio and text scope, as ``nn.Module``s
(counterpart: ``automodel_tpu/models/phi4_mm.py``).

* :class:`Phi4MMAudioEncoder`: HF's conformer speech encoder.  Features
  ``[N, T, input_size]`` are normalised by ``global_mean`` /
  ``global_invstd`` in fp32, subsampled by ``time_reduction`` through the
  nemo conv stack (a 3x3 stride-2 conv, then per further stage a depthwise
  3x3 stride-2 conv and a 1x1 conv, each followed by relu; NCHW with one
  input channel), projected by ``out`` and run through ``num_blocks``
  conformer blocks: ``x + FFN_in / 2``, self-attention with fp32 logits,
  a relative-position bias table and HF's additive mask (the bool
  availability mask is ADDED to the logits, +1 on visible frames, 0 on
  padded ones: padded frames are not masked to -inf), the convolution
  module (GLU pointwise with its ``glu_b1`` / ``glu_b2`` channel biases,
  a causal depthwise conv over time, ``pw_conv``, silu, ``ext_pw_conv``),
  ``x + FFN_out / 2`` and the block's LayerNorm.  The audio MLPs split
  their ``gate_up_proj`` as (up, gate), the decoder's as (gate, up).  The
  blocks are a Python loop, each recomputed in the backward pass when
  ``remat`` (the JAX scan's ``jax.checkpoint``).  The attention and the
  convolutions are plain PyTorch (``torch.einsum`` / ``F.conv1d`` /
  ``F.conv2d``), as the JAX encoder runs them in XLA outside any Pallas
  kernel; kernel 9 takes no additive bias.  After subsampling an input
  longer than 500 frames and a streaming ``chunk_size`` are refused, as
  in JAX.
* :class:`Phi4MMTextModel`: the Phi decoder of ``models/phi3.py`` (fused
  ``qkv_proj`` / ``gate_up_proj``, partial rotary, longrope) under the
  JAX text config, attention on kernel 9 at the config's window.
* :class:`Phi4MMForCausalLM`: the encoder, the speech projector (``up``,
  exact GELU, ``down``) and the decoder.  The audio features overwrite the
  audio placeholders' embeddings in one flat order over the whole batch:
  a stable argsort over the per-clip frame validity (``arange(T) <
  audio_embed_sizes``) puts every clip's valid frames first, in order, and
  the ``k``-th placeholder of the batch takes the ``k``-th of them (the
  JAX static-shape scatter of HF's concat + ``index_put``).  The
  ``*_for_vision_speech`` projectors are parameters (in the tree and the
  HF map) that the forward does not use; no vision tower is built.

Weights live in ``param_dtype`` and every product runs in
``compute_dtype``; ``device`` None is ``cuda`` (raises without a card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from automodel_tpu_torch.models.llama import LayerNorm, LlamaForCausalLM, \
    as_dtype
from automodel_tpu_torch.models.phi3 import Phi3Config, Phi3ForCausalLM
from automodel_tpu_torch.ops.remat import checkpoint_layer, \
    resolve_remat_policy
from automodel_tpu_torch.utils.device import resolve_device

MAX_AUDIO_FRAMES = 500           # post-subsampling (HF's absolute window)
_LORA_BYPASS = ("rank-r LoRA bypass is not wired for the fused Phi "
                "projections; use peft merge mode (dropout=0)")


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Phi4MMAudioConfig:
    """HF ``Phi4MultimodalAudioConfig`` field names (the speech set).
    Unknown keys are dropped, as in JAX: HF's remote-code spelling
    ``depthwise_seperable_out_channel`` falls back to the default."""

    hidden_size: int = 1024
    intermediate_size: int = 1536
    num_blocks: int = 24
    num_attention_heads: int = 16
    chunk_size: int = -1
    left_chunk: int = 18
    ext_pw_out_channel: int = 1024
    depthwise_separable_out_channel: int = 1024
    depthwise_multiplier: int = 1
    kernel_size: int = 3
    input_size: int = 80
    time_reduction: int = 8
    bias_max_distance: int = 1000
    bias_symmetric: bool = False
    nemo_conv_channels: int = 1024
    downsample_rate: int = 1
    audio_token_id: int = 200011

    @classmethod
    def from_hf_config(cls, hf: Dict[str, Any]) -> "Phi4MMAudioConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in hf.items() if k in known})

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def n_stages(self) -> int:
        """Stride-2 stages of the subsampling stack."""
        return int(math.log2(self.time_reduction))

    @property
    def nemo_final_size(self) -> int:
        """The feature axis after the stride-2 stages."""
        length = self.input_size
        for _ in range(self.n_stages):
            length = math.floor((length - 1) / 2 + 1)
        return length

    @property
    def num_buckets(self) -> int:
        return (self.bias_max_distance if self.bias_symmetric
                else 2 * self.bias_max_distance)


@dataclasses.dataclass
class Phi4MMTextConfig(Phi3Config):
    """The Phi decoder's config (``model_type`` ``phi4_multimodal_text``)."""

    def __post_init__(self):
        super().__post_init__()
        self.model_type = "phi4_multimodal_text"


@dataclasses.dataclass
class Phi4MMConfig:
    """HF ``Phi4MultimodalConfig``: the text fields at the top level,
    ``audio_config`` nested, ``vision_config`` dropped."""

    text_config: Any = None
    audio_config: Any = None
    model_type: str = "phi4_multimodal"

    def __post_init__(self):
        if isinstance(self.text_config, dict):
            self.text_config = Phi4MMTextConfig.from_hf_config(
                self.text_config)
        if isinstance(self.audio_config, dict):
            self.audio_config = Phi4MMAudioConfig.from_hf_config(
                self.audio_config)
        self.text_config = self.text_config or Phi4MMTextConfig()
        self.audio_config = self.audio_config or Phi4MMAudioConfig()

    @classmethod
    def from_hf_config(cls, hf: Dict[str, Any]) -> "Phi4MMConfig":
        return cls(text_config={k: v for k, v in hf.items()
                                if k not in ("audio_config", "vision_config")},
                   audio_config=hf.get("audio_config") or {})


# ---------------------------------------------------------------------------
# Audio encoder (conformer)
# ---------------------------------------------------------------------------
def _lin(i: int, o: int, dtype, device) -> nn.Linear:
    return nn.Linear(i, o, bias=True, dtype=dtype, device=device)


class _Conv(nn.Module):
    """A convolution's ``weight`` (PyTorch's layout) and ``bias``."""

    def __init__(self, shape, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(shape, dtype=dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(shape[0], dtype=dtype,
                                             device=device))


class _AudioMLP(nn.Module):
    def __init__(self, D: int, I: int, dtype, device):
        super().__init__()
        self.layer_norm = LayerNorm(D, 1e-5, dtype, device)
        self.gate_up_proj = _lin(D, 2 * I, dtype, device)
        self.down_proj = _lin(I, D, dtype, device)


class _AudioAttention(nn.Module):
    def __init__(self, D: int, dtype, device):
        super().__init__()
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            setattr(self, proj, _lin(D, D, dtype, device))


class _ConvModule(nn.Module):
    """``dw_conv.weight`` is ``[C, k]`` (the JAX leaf; HF's ``(C, 1, k)``
    is a view of it)."""

    def __init__(self, cfg: Phi4MMAudioConfig, dtype, device):
        super().__init__()
        D, E = cfg.hidden_size, cfg.ext_pw_out_channel
        C = cfg.depthwise_separable_out_channel
        self.layer_norm = LayerNorm(D, 1e-5, dtype, device)
        self.glu = _lin(D, 2 * E, dtype, device)
        self.glu_b1 = nn.Parameter(torch.zeros(E, dtype=dtype, device=device))
        self.glu_b2 = nn.Parameter(torch.zeros(E, dtype=dtype, device=device))
        self.dw_conv = _Conv((C, cfg.kernel_size), dtype, device)
        self.pw_conv = _lin(C, D, dtype, device)
        self.ext_pw_conv = _lin(D, E, dtype, device)


class Phi4MMAudioBlock(nn.Module):
    def __init__(self, cfg: Phi4MMAudioConfig, dtype, device):
        super().__init__()
        D = cfg.hidden_size
        self.feed_forward_in = _AudioMLP(D, cfg.intermediate_size, dtype,
                                         device)
        self.layer_norm_att = LayerNorm(D, 1e-5, dtype, device)
        self.self_attn = _AudioAttention(D, dtype, device)
        self.conv = _ConvModule(cfg, dtype, device)
        self.feed_forward_out = _AudioMLP(D, cfg.intermediate_size, dtype,
                                          device)
        self.layer_norm = LayerNorm(D, 1e-5, dtype, device)


class _Subsample(nn.Module):
    """The nemo conv stack: ``conv0``, then ``dw{s}`` / ``pw{s}`` per
    further stage, and the ``out`` projection."""

    def __init__(self, cfg: Phi4MMAudioConfig, dtype, device):
        super().__init__()
        C = cfg.nemo_conv_channels
        self.conv0 = _Conv((C, 1, 3, 3), dtype, device)
        for s in range(1, cfg.n_stages):
            setattr(self, f"dw{s}", _Conv((C, 1, 3, 3), dtype, device))
            setattr(self, f"pw{s}", _Conv((C, C, 1, 1), dtype, device))
        self.out = _lin(C * cfg.nemo_final_size, cfg.hidden_size, dtype,
                        device)


class Phi4MMAudioEncoder(nn.Module):
    """Mean-var norm -> nemo conv subsampling -> conformer blocks."""

    def __init__(self, config: Phi4MMAudioConfig, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, remat: bool = True,
                 device=None):
        super().__init__()
        cfg = self.config = config
        dt = self.param_dtype = as_dtype(param_dtype)
        self.compute_dtype = as_dtype(compute_dtype)
        self.remat = bool(remat)
        self.global_mean = nn.Parameter(torch.zeros(
            cfg.input_size, dtype=dt, device=device))
        self.global_invstd = nn.Parameter(torch.ones(
            cfg.input_size, dtype=dt, device=device))
        self.embed = _Subsample(cfg, dt, device)
        self.relative_attention_bias = nn.Parameter(torch.zeros(
            cfg.num_buckets, cfg.num_attention_heads, dtype=dt,
            device=device))
        self.blocks = nn.ModuleList([Phi4MMAudioBlock(cfg, dt, device)
                                     for _ in range(cfg.num_blocks)])
        self._bias_index: Dict[int, torch.Tensor] = {}

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """N(0, 0.02) for the kernels and the bias table, zeros for the
        biases, ones for the LayerNorm weights, the identity
        normalisation (the JAX ``init``'s distribution)."""
        for name, p in self.named_parameters():
            if name.endswith("norm.weight") or name == "global_invstd":
                p.fill_(1.0)
            elif (name.endswith(".bias") or name in ("global_mean",)
                  or name.endswith(("glu_b1", "glu_b2"))):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=gen)

    def jax_tree_leaves(self) -> Iterator[Tuple[Tuple[str, ...], Any, bool]]:
        """``(JAX path, target, transposed)`` of the JAX encoder tree."""
        yield ("encoder_embedding", "global_mean"), self.global_mean, False
        yield ("encoder_embedding", "global_invstd"), self.global_invstd, \
            False
        sub = self.embed
        convs = ["conv0"] + [f"{k}{s}" for s in range(1, self.config.n_stages)
                             for k in ("dw", "pw")]
        for name in convs:
            conv = getattr(sub, name)
            yield ("embed", name, "kernel"), conv.weight, False
            yield ("embed", name, "bias"), conv.bias, False
        yield ("embed", "out", "kernel"), sub.out.weight, True
        yield ("embed", "out", "bias"), sub.out.bias, False
        yield (("relative_attention_bias", "weight"),
               self.relative_attention_bias, False)
        blocks = self.blocks

        def each(get):
            return [get(b) for b in blocks]

        def lin(path, get):
            yield ("encoders",) + path + ("kernel",), each(
                lambda b: get(b).weight), True
            yield ("encoders",) + path + ("bias",), each(
                lambda b: get(b).bias), False

        def ln(path, get):
            for wb in ("weight", "bias"):
                yield ("encoders",) + path + (wb,), each(
                    lambda b: getattr(get(b), wb)), False

        for mod in ("feed_forward_in", "feed_forward_out"):
            yield from ln((mod, "layer_norm"),
                          lambda b, m=mod: getattr(b, m).layer_norm)
            for proj in ("gate_up_proj", "down_proj"):
                yield from lin((mod, proj), lambda b, m=mod, p=proj:
                               getattr(getattr(b, m), p))
        yield from ln(("layer_norm_att",), lambda b: b.layer_norm_att)
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            yield from lin(("self_attn", proj),
                           lambda b, p=proj: getattr(b.self_attn, p))
        yield from ln(("conv", "layer_norm"), lambda b: b.conv.layer_norm)
        yield from lin(("conv", "glu"), lambda b: b.conv.glu)
        for bias in ("glu_b1", "glu_b2"):
            yield (("encoders", "conv", bias),
                   each(lambda b, n=bias: getattr(b.conv, n)), False)
        yield (("encoders", "conv", "dw_conv", "kernel"),
               each(lambda b: b.conv.dw_conv.weight), False)
        yield (("encoders", "conv", "dw_conv", "bias"),
               each(lambda b: b.conv.dw_conv.bias), False)
        for proj in ("pw_conv", "ext_pw_conv"):
            yield from lin(("conv", proj),
                           lambda b, p=proj: getattr(b.conv, p))
        yield from ln(("layer_norm",), lambda b: b.layer_norm)

    def _linear(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.linear(x, lin.weight.to(cd)) + lin.bias.to(cd)

    def _conv2d(self, h, conv: _Conv, stride: int, padding: int,
                groups: int = 1) -> torch.Tensor:
        cd = self.compute_dtype
        return (F.conv2d(h, conv.weight.to(cd), stride=stride,
                         padding=padding, groups=groups)
                + conv.bias.to(cd)[None, :, None, None])

    def subsample(self, x: torch.Tensor) -> torch.Tensor:
        """``[N, T, input_size]`` -> ``[N, T', hidden]`` (``T'`` about ``T
        / time_reduction``)."""
        h = x.to(self.compute_dtype)[:, None]          # NCHW, C = 1
        sub = self.embed
        h = F.relu(self._conv2d(h, sub.conv0, 2, 1))
        for s in range(1, self.config.n_stages):
            h = self._conv2d(h, getattr(sub, f"dw{s}"), 2, 1,
                             groups=h.shape[1])
            h = F.relu(self._conv2d(h, getattr(sub, f"pw{s}"), 1, 0))
        n, c, t, f = h.shape
        return self._linear(sub.out, h.permute(0, 2, 1, 3).reshape(n, t,
                                                                   c * f))

    def rel_bias(self, t: int) -> torch.Tensor:
        """``[1, heads, T, T]``: the bias table at the clipped offsets (the
        index built on the host once per ``T``)."""
        idx = self._bias_index.get(t)
        table = self.relative_attention_bias
        if idx is None or idx.device != table.device:
            cfg = self.config
            rel = np.arange(t)[None, :] - np.arange(t)[:, None]
            rel = np.clip(rel, -cfg.bias_max_distance,
                          cfg.bias_max_distance - 1)
            rel = (np.abs(rel) if cfg.bias_symmetric
                   else rel + cfg.num_buckets // 2)
            # a symmetric table has ``max`` rows and |-max| = max: the row
            # past the end reads the last one (JAX's clamping gather)
            rel = np.minimum(rel, cfg.num_buckets - 1)
            idx = torch.from_numpy(rel).to(table.device)
            self._bias_index[t] = idx
        return table[idx].permute(2, 0, 1)[None]

    def _mlp(self, mlp: _AudioMLP, x: torch.Tensor) -> torch.Tensor:
        up, gate = self._linear(mlp.gate_up_proj, mlp.layer_norm(x)).chunk(
            2, dim=-1)                  # (up, gate): HF's audio order
        return self._linear(mlp.down_proj, up * F.silu(gate))

    def _conv_module(self, conv: _ConvModule, x: torch.Tensor
                     ) -> torch.Tensor:
        cd, E = self.compute_dtype, self.config.ext_pw_out_channel
        h = self._linear(conv.glu, conv.layer_norm(x))    # [N, T, 2E]
        h = ((h[..., :E] + conv.glu_b1.to(cd))
             * F.silu(h[..., E:] + conv.glu_b2.to(cd)))
        k = self.config.kernel_size
        hp = F.pad(h.transpose(1, 2), (k - 1, 0))          # causal: left pad
        w = conv.dw_conv.weight.to(cd)[:, None, :]         # (C, 1, k)
        h = (F.conv1d(hp, w, groups=h.shape[-1]).transpose(1, 2)
             + conv.dw_conv.bias.to(cd))
        h = F.silu(self._linear(conv.pw_conv, h))
        return self._linear(conv.ext_pw_conv, h)

    def _block(self, block: Phi4MMAudioBlock, x: torch.Tensor,
               add_mask: torch.Tensor) -> torch.Tensor:
        cfg, cd = self.config, self.compute_dtype
        N, T, D = x.shape
        H, Dh = cfg.num_attention_heads, cfg.head_dim
        r = x + 0.5 * self._mlp(block.feed_forward_in, x)
        y = block.layer_norm_att(r)
        at = block.self_attn
        q, k, v = (self._linear(getattr(at, p), y).view(N, T, H, Dh)
                   for p in ("q_proj", "k_proj", "v_proj"))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
        logits = logits * Dh ** -0.5 + add_mask
        w = torch.softmax(logits, dim=-1).to(cd)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(N, T, D)
        x = r + self._linear(at.o_proj, o)
        x = x + self._conv_module(block.conv, x)
        x = x + 0.5 * self._mlp(block.feed_forward_out, x)
        return block.layer_norm(x)

    def forward(self, features: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``features [N, T, input_size]`` (and the frame mask ``[N, T]``)
        -> ``[N, T', hidden]`` in the compute dtype."""
        cfg = self.config
        x = ((features.float() - self.global_mean.float())
             * self.global_invstd.float())
        x = self.subsample(x)
        N, T, _ = x.shape
        if T > MAX_AUDIO_FRAMES:
            raise ValueError(
                f"audio sequence {T} frames post-subsampling exceeds the "
                "absolute-position window (500); the HF unfold path is not "
                "implemented: chunk the audio at the collator")
        if cfg.chunk_size > 0:
            raise NotImplementedError(
                "streaming chunk masks: only the full-attention default "
                "(chunk_size=-1) is implemented")
        if mask is not None:
            lens = mask.to(torch.int32).sum(dim=1)
            sub = torch.ceil(lens.float() / cfg.time_reduction).int()
            visible = (torch.arange(T, device=x.device)[None, :]
                       < sub[:, None])
        else:
            visible = torch.ones(N, T, dtype=torch.bool, device=x.device)
        # HF's quirk, kept: the availability mask is ADDED to the logits
        add_mask = (visible[:, None, None, :].float()
                    + self.rel_bias(T).float())
        remat = self.remat and torch.is_grad_enabled()
        policy = resolve_remat_policy("nothing_saveable")
        for block in self.blocks:
            if remat:
                x = checkpoint_layer(
                    lambda h, m, b=block: self._block(b, h, m), x, add_mask,
                    policy=policy)
            else:
                x = self._block(block, x, add_mask)
        return x

    def flops(self, clips: int, frames: int) -> float:
        """Training FLOPs (forward and backward, 3x the forward's; the
        remat re-forward not counted) of ``clips`` clips of ``frames``
        input frames: the subsampling convs, the blocks' products, the
        attention's score and value products and the depthwise conv."""
        cfg = self.config
        C, D, I = cfg.nemo_conv_channels, cfg.hidden_size, \
            cfg.intermediate_size
        E, Cdw = cfg.ext_pw_out_channel, cfg.depthwise_separable_out_channel
        t, f = frames, cfg.input_size
        fwd = 0.0
        for s in range(cfg.n_stages):
            t, f = (t - 1) // 2 + 1, (f - 1) // 2 + 1
            fwd += 2 * 9 * C * t * f            # conv0 / a depthwise conv
            if s:
                fwd += 2 * C * C * t * f        # the stage's 1x1 conv
        T = t
        fwd += 2 * C * cfg.nemo_final_size * D * T
        per_frame = (2 * 2 * (D * 2 * I + I * D)       # the two FFNs
                     + 2 * 4 * D * D                    # q, k, v, o
                     + 2 * (D * 2 * E + Cdw * D + D * E)  # conv products
                     + 2 * cfg.kernel_size * Cdw        # depthwise
                     + 2 * 2 * T * D)                   # scores, values
        fwd += cfg.num_blocks * per_frame * T
        return 3.0 * clips * fwd

    def out_frames(self, frames: int) -> int:
        """Frames after subsampling of an input of ``frames``."""
        for _ in range(self.config.n_stages):
            frames = (frames - 1) // 2 + 1
        return frames


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------
class Phi4MMTextModel(Phi3ForCausalLM):
    """The Phi decoder under the JAX text config; a LoRA bypass is
    refused with the JAX message (a merged adapter weight passes)."""

    def _layer(self, layer, hidden, position_ids, segment_ids, kv_cache,
               attn_impl, adapters=None):
        if adapters and any(a.A is not None for a in adapters.values()):
            raise NotImplementedError(_LORA_BYPASS)
        return LlamaForCausalLM._layer(self, layer, hidden, position_ids,
                                       segment_ids, kv_cache, attn_impl,
                                       adapters)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------
class Phi4MMAudioEmbed(nn.Module):
    """``model.embed_tokens_extend.audio_embed``: the encoder and the four
    projectors."""

    def __init__(self, config: Phi4MMConfig, dtype, compute_dtype, remat,
                 device):
        super().__init__()
        ac = config.audio_config
        D, H = ac.hidden_size, config.text_config.hidden_size
        self.encoder = Phi4MMAudioEncoder(ac, dtype, compute_dtype, remat,
                                          device)
        for mode in ("speech", "vision_speech"):
            setattr(self, f"up_proj_for_{mode}",
                    _lin(D * ac.downsample_rate, H, dtype, device))
            setattr(self, f"down_proj_for_{mode}", _lin(H, H, dtype, device))


class Phi4MMForCausalLM(nn.Module):
    """``model._target_: automodel_tpu.models.phi4_mm.build_phi4_mm`` (or
    an HF directory through ``AutoModelForImageTextToText``).
    ``forward(input_ids, input_audio_embeds=None, audio_embed_sizes=None,
    audio_attention_mask=None, ...)`` takes the decoder's other
    arguments; ``init_kv_cache`` is the decoder's."""

    extra_batch_keys = ("input_audio_embeds", "audio_embed_sizes",
                        "audio_attention_mask")

    def __init__(self, config: Phi4MMConfig, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, remat: bool = True,
                 remat_policy: Optional[str] = "nothing_saveable",
                 scan_unroll: int = 1, scan_block: int = 1, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.param_dtype = as_dtype(param_dtype)
        self.compute_dtype = as_dtype(compute_dtype)
        self.language_model = Phi4MMTextModel(
            config.text_config, param_dtype=param_dtype,
            compute_dtype=compute_dtype, remat=remat,
            remat_policy=remat_policy, scan_unroll=scan_unroll,
            scan_block=scan_block, device=device)
        self.audio_embed = Phi4MMAudioEmbed(
            config, self.param_dtype, self.compute_dtype, remat, device)

    # the decoder's knobs, as the first-step checks set them
    remat_policy = property(
        lambda self: self.language_model.remat_policy,
        lambda self, v: setattr(self.language_model, "remat_policy", v))
    qdot_impl = property(
        lambda self: self.language_model.qdot_impl,
        lambda self, v: setattr(self.language_model, "qdot_impl", v))

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "Phi4MMForCausalLM":
        """The decoder's weights from ``seed``, the encoder's and the
        projectors' from ``seed + 1``."""
        self.language_model.init_weights(seed)
        dev = self.language_model.inv_freq.device
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        self.audio_embed.encoder.init_weights(gen)
        for mode in ("speech", "vision_speech"):
            for kind in ("up", "down"):
                lin = getattr(self.audio_embed, f"{kind}_proj_for_{mode}")
                lin.weight.normal_(0.0, 0.02, generator=gen)
                lin.bias.zero_()
        return self

    def jax_tree_leaves(self) -> Iterator[Tuple[Tuple[str, ...], Any, bool]]:
        for path, t, tr in self.language_model.jax_tree_leaves():
            yield ("language_model",) + path, t, tr
        ae = self.audio_embed
        for path, t, tr in ae.encoder.jax_tree_leaves():
            yield ("audio_embed", "encoder") + path, t, tr
        for mode in ("speech", "vision_speech"):
            for kind in ("up", "down"):
                name = f"{kind}_proj_for_{mode}"
                lin = getattr(ae, name)
                yield ("audio_embed", name, "kernel"), lin.weight, True
                yield ("audio_embed", name, "bias"), lin.bias, False

    def init_kv_cache(self, batch: int, max_len: int, dtype=None):
        """The decoder's dense decode cache (``generate()``)."""
        return self.language_model.init_kv_cache(batch, max_len, dtype)

    def encode_audio(self, features: torch.Tensor,
                     audio_attention_mask: Optional[torch.Tensor] = None,
                     mode: str = "speech") -> torch.Tensor:
        """``[N, T, input_size]`` -> ``[N, T', text_hidden]``: the encoder,
        then ``up``, exact GELU, ``down``."""
        cd = self.compute_dtype
        ae = self.audio_embed
        h = ae.encoder(features, audio_attention_mask)
        up, down = (getattr(ae, f"{k}_proj_for_{mode}") for k in ("up",
                                                                  "down"))
        h = F.gelu(F.linear(h, up.weight.to(cd)) + up.bias.to(cd))
        return F.linear(h, down.weight.to(cd)) + down.bias.to(cd)

    def forward(self, input_ids: torch.Tensor,
                input_audio_embeds: Optional[torch.Tensor] = None,
                audio_embed_sizes: Optional[torch.Tensor] = None,
                audio_attention_mask: Optional[torch.Tensor] = None,
                **kwargs) -> Dict[str, torch.Tensor]:
        lm = self.language_model
        B, S = input_ids.shape
        embeds = lm._embed(input_ids)
        if input_audio_embeds is not None:
            feats = self.encode_audio(input_audio_embeds,
                                      audio_attention_mask)
            N, T, H = feats.shape
            dev = feats.device
            if audio_embed_sizes is None:
                audio_embed_sizes = torch.full((N,), T, dtype=torch.int32,
                                               device=dev)
            valid = (torch.arange(T, device=dev)[None, :]
                     < audio_embed_sizes[:, None]).reshape(-1)
            order = torch.argsort((~valid).to(torch.int8), stable=True)
            merged = feats.reshape(N * T, H)[order]
            is_audio = (input_ids
                        == self.config.audio_config.audio_token_id).reshape(-1)
            idx = (torch.cumsum(is_audio.long(), 0) - 1).clamp(0, N * T - 1)
            gathered = merged[idx].reshape(B, S, H)
            embeds = torch.where(is_audio.reshape(B, S)[..., None],
                                 gathered.to(embeds.dtype), embeds)
        return lm(input_ids, inputs_embeds=embeds, **kwargs)

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self) -> float:
        """The decoder's (the JAX model's count: no encoder)."""
        return self.language_model.flops_per_token()

    def attention_flops_per_token(self, seq_len: int,
                                  causal: bool = True) -> float:
        return self.language_model.attention_flops_per_token(seq_len, causal)

    def audio_flops(self, clips: int, frames: int) -> float:
        """Training FLOPs of the encoder and the speech projector on
        ``clips`` clips of ``frames`` input frames."""
        ac, H = self.config.audio_config, self.config.text_config.hidden_size
        enc = self.audio_embed.encoder
        t = enc.out_frames(frames)
        proj = 3.0 * 2 * t * (ac.hidden_size * ac.downsample_rate * H + H * H)
        return enc.flops(clips, frames) + clips * proj

    def hf_config_dict(self) -> Dict[str, Any]:
        """``config.json`` in HF's layout: the text fields at the top
        level, ``audio_config`` nested."""
        d = dataclasses.asdict(self.config.text_config)
        d["model_type"] = self.config.model_type
        d["audio_config"] = dataclasses.asdict(self.config.audio_config)
        return d


def build_phi4_mm(config: Optional[dict] = None, *, seed: int = 0,
                  device=None, **kwargs) -> Phi4MMForCausalLM:
    """The YAML entry (``model._target_``): an HF-style config dict (or
    none: the published defaults), weights drawn from ``seed``."""
    if config is not None:
        if hasattr(config, "to_dict"):
            config = config.to_dict()
        cfg = Phi4MMConfig.from_hf_config(config)
    else:
        cfg = Phi4MMConfig()
    return Phi4MMForCausalLM(cfg, device=device, **kwargs).init_weights(seed)
