"""Llama decoder as an ``nn.Module`` (counterpart:
``automodel_tpu/models/llama.py``).

The JAX model keeps its parameters as one pytree with every layer stacked
along a leading axis and runs a ``lax.scan`` over them; here each layer is
its own module and the forward is a Python loop (PyTorch runs eagerly).
Projections are ``nn.Linear`` weights ``[out, in]`` (the JAX kernels are
``[in, out]``; ``models/weights.py`` transposes on load).  As in JAX, the
weights live in ``param_dtype`` and each projection casts its weight to
``compute_dtype``.

Two forwards: without a cache (training and scoring: packed ``segment_ids``,
a padding mask and per-sample ``position_ids``, attention through
``ops/attention.py`` -- the hand-written CUDA kernels on the card -- and
each layer rematerialized under ``torch.utils.checkpoint`` when gradients
are recorded, as the JAX model's ``nothing_saveable`` default does), and
with a :class:`~automodel_tpu_torch.serving.kv_cache.PagedKVView` (the
serving path: each layer writes its k/v into the paged pools, then attends
through ``ops/paged_attention.py``).  LoRA, quantized compute and sharding
constraints wait for later port slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from automodel_tpu_torch.ops.attention import (
    attention,
    fold_padding_into_segments,
)
from automodel_tpu_torch.ops.norms import rms_norm
from automodel_tpu_torch.ops.remat import checkpoint_layer, resolve_remat_policy
from automodel_tpu_torch.ops.rotary import apply_rope, rope_parameters
from automodel_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class LlamaConfig:
    """Llama config (HF field names)."""

    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 16
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling: Optional[dict] = None
    max_position_embeddings: int = 131072
    tie_word_embeddings: bool = True
    attention_bias: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    use_sliding_window: bool = True
    max_window_layers: Optional[int] = None
    attention_dropout: float = 0.0     # accepted, unused
    model_type: str = "llama"
    torch_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf_config(cls, hf: Dict[str, Any]) -> "LlamaConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in hf.items() if k in known})


def llama3_2_1b_config() -> LlamaConfig:
    """The Llama-3.2-1B shape (the JAX package's ``llama3_2_1b_config``)."""
    return LlamaConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192,
        num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
        head_dim=64, rope_theta=500000.0, tie_word_embeddings=True,
        rope_scaling={
            "rope_type": "llama3", "factor": 32.0,
            "low_freq_factor": 1.0, "high_freq_factor": 4.0,
            "original_max_position_embeddings": 8192,
        })


def as_dtype(d) -> torch.dtype:
    """``torch.bfloat16`` or its name (``"bfloat16"``) -> a torch dtype."""
    if isinstance(d, torch.dtype):
        return d
    dtype = getattr(torch, str(d), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"not a torch dtype: {d!r}")
    return dtype


def _sliding_window(cfg: LlamaConfig) -> Optional[int]:
    """HF semantics: layer i slides when i >= max_window_layers, so None/0
    slides every layer, >= L slides none; a mixed stack is refused."""
    if not cfg.sliding_window or not cfg.use_sliding_window:
        return None
    mwl = cfg.max_window_layers
    if mwl is None or mwl == 0:
        return int(cfg.sliding_window)
    if mwl >= cfg.num_hidden_layers:
        return None
    raise NotImplementedError(
        f"max_window_layers={mwl} inside (0, {cfg.num_hidden_layers}): "
        "mixed sliding/full layer stacks are not supported")


class RMSNorm(nn.Module):
    def __init__(self, size: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size, dtype=dtype, device=device))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype, device):
        super().__init__()
        H, I, D = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
        Hq, Hk = cfg.num_attention_heads, cfg.num_key_value_heads

        def linear(i, o):
            return nn.Linear(i, o, bias=False, dtype=dtype, device=device)

        self.input_layernorm = RMSNorm(H, cfg.rms_norm_eps, dtype, device)
        self.q_proj = linear(H, Hq * D)
        self.k_proj = linear(H, Hk * D)
        self.v_proj = linear(H, Hk * D)
        self.o_proj = linear(Hq * D, H)
        self.post_attention_layernorm = RMSNorm(H, cfg.rms_norm_eps, dtype,
                                                device)
        self.gate_proj = linear(H, I)
        self.up_proj = linear(H, I)
        self.down_proj = linear(I, H)


class LlamaForCausalLM(nn.Module):
    """``device`` None is ``cuda`` (raises without a card); tests pass
    ``device="cpu"``.  ``remat`` recomputes each layer in the backward
    pass (policy ``nothing_saveable``, the JAX model's default)."""

    def __init__(self, config: LlamaConfig,
                 param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                 remat: bool = True,
                 remat_policy: Optional[str] = "nothing_saveable",
                 device=None):
        super().__init__()
        if config.attention_bias or config.qk_norm:
            raise NotImplementedError(
                "attention_bias / qk_norm (Qwen families) are not ported")
        device = resolve_device(device)
        self.config = config
        self.param_dtype = as_dtype(param_dtype)
        self.compute_dtype = as_dtype(compute_dtype)
        self.remat = bool(remat)
        self.remat_policy = resolve_remat_policy(remat_policy)
        self.sliding_window = _sliding_window(config)
        cfg, dt = config, self.param_dtype
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         dtype=dt, device=device)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(cfg, dt, device)
             for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dt, device)
        self.lm_head = None
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias=False, dtype=dt, device=device)
        inv_freq = rope_parameters(cfg.head_dim, cfg.rope_theta,
                                   cfg.rope_scaling)
        self.register_buffer("inv_freq", torch.from_numpy(inv_freq).to(device),
                             persistent=False)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "LlamaForCausalLM":
        """Random weights drawn from ``seed``: N(0, 0.02) for embeddings and
        projections, ones for the norms (the JAX ``init``'s distribution;
        not its numbers)."""
        gen = torch.Generator(device=self.inv_freq.device).manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("layernorm.weight") or name == "norm.weight":
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)
        return self

    def _proj(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, lin.weight.to(self.compute_dtype))

    def _layer(self, layer: LlamaDecoderLayer, hidden, position_ids,
               segment_ids, kv_cache, attn_impl):
        cfg = self.config
        B, S, _ = hidden.shape
        D, Hq, Hk = cfg.head_dim, cfg.num_attention_heads, \
            cfg.num_key_value_heads
        x = layer.input_layernorm(hidden)
        q = self._proj(layer.q_proj, x).view(B, S, Hq, D)
        k = self._proj(layer.k_proj, x).view(B, S, Hk, D)
        v = self._proj(layer.v_proj, x).view(B, S, Hk, D)
        q, k = apply_rope(q, k, position_ids, self.inv_freq)
        if kv_cache is not None:
            kv_cache.write(k, v)
            attn = kv_cache.attend(q, local_window_size=self.sliding_window)
        else:
            attn = attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=True, segment_ids=segment_ids,
                             local_window_size=self.sliding_window,
                             impl=attn_impl)
        hidden = hidden + self._proj(layer.o_proj, attn.reshape(B, S, Hq * D))
        x = layer.post_attention_layernorm(hidden)
        act = F.silu(self._proj(layer.gate_proj, x)) \
            * self._proj(layer.up_proj, x)
        return hidden + self._proj(layer.down_proj, act)

    def flops_per_token(self) -> float:
        """Training FLOPs per token of the matmul parameters (fwd + bwd =
        6N; the JAX model's convention)."""
        cfg = self.config
        per_layer = (
            2 * cfg.hidden_size * (cfg.num_attention_heads
                                   + 2 * cfg.num_key_value_heads)
            * cfg.head_dim
            + 2 * cfg.num_attention_heads * cfg.head_dim * cfg.hidden_size
            + 6 * cfg.hidden_size * cfg.intermediate_size)
        embed = 2 * cfg.vocab_size * cfg.hidden_size
        return 3.0 * (cfg.num_hidden_layers * per_layer + embed)

    def attention_flops_per_token(self, seq_len: int,
                                  causal: bool = True) -> float:
        """Training FLOPs per token of the attention score and value
        products at a row length (causal rows average S/2 keys; fwd + bwd =
        3 x fwd, the remat re-forward not counted; the JAX model's
        convention)."""
        cfg = self.config
        s_avg = seq_len / 2 if causal else seq_len
        fwd = 2 * 2 * cfg.num_attention_heads * cfg.head_dim * s_avg
        return 3.0 * cfg.num_hidden_layers * fwd

    def forward(self, input_ids: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                kv_cache=None, return_hidden: bool = False,
                attn_impl: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """``input_ids [B, S]`` -> ``{"logits": [B, S, V]}`` in the compute
        dtype, or with ``return_hidden`` ``{"hidden_states": [B, S, H],
        "lm_head_kernel": [H, V]}`` (the JAX layout) for a loss that applies
        the head itself.

        Without a cache: ``segment_ids [B, S]`` (packed samples, 0 = pad),
        ``attention_mask [B, S]`` (folded into the segments) and
        ``position_ids [B, S]`` (restarting per packed sample) reach the
        attention; ``attn_impl`` is passed to ``ops.attention.attention``
        (None: the kernels on CUDA tensors, the plain versions on CPU).
        ``kv_cache`` is a ``PagedKVView`` (pools updated in place) or
        None."""
        B, S = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(S, device=input_ids.device).expand(
                B, S)
        if kv_cache is None:
            segment_ids = fold_padding_into_segments((B, S), segment_ids,
                                                     attention_mask)
        remat = (self.remat and kv_cache is None
                 and torch.is_grad_enabled())
        hidden = self.embed_tokens.weight[input_ids].to(self.compute_dtype)
        for i, layer in enumerate(self.layers):
            view = kv_cache.layer_view(i) if kv_cache is not None else None
            args = (layer, hidden, position_ids, segment_ids, view,
                    attn_impl)
            hidden = (checkpoint_layer(self._layer, *args) if remat
                      else self._layer(*args))
        hidden = self.norm(hidden)
        # tied: the head is the embedding, whose gradient sums both uses
        head = (self.embed_tokens.weight if self.lm_head is None
                else self.lm_head.weight)
        if return_hidden:
            return {"hidden_states": hidden, "lm_head_kernel": head.t()}
        return {"logits": F.linear(hidden, head.to(self.compute_dtype))}
