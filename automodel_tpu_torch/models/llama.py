"""Llama decoder as an ``nn.Module`` (counterpart:
``automodel_tpu/models/llama.py``).

The JAX model keeps its parameters as one pytree with every layer stacked
along a leading axis and runs a ``lax.scan`` over them; here each layer is
its own module and the forward is a Python loop (PyTorch runs eagerly).
Projections are ``nn.Linear`` weights ``[out, in]`` (the JAX kernels are
``[in, out]``; ``models/weights.py`` transposes on load).  As in JAX, the
weights live in ``param_dtype`` and each projection casts its weight to
``compute_dtype``.  The Qwen2, Qwen3 dense and Mistral families are this
class too, as in the JAX registry: ``attention_bias`` (Qwen2's q / k / v
biases, added after any adapter delta), ``qk_norm`` (Qwen3) and a
uniform ``sliding_window`` (Mistral).

Two forwards: without a cache (training and scoring: packed ``segment_ids``,
a padding mask and per-sample ``position_ids``, attention through
``ops/attention.py`` -- the hand-written CUDA kernels on the card -- and,
when gradients are recorded, each unit of ``scan_block`` layers
rematerialized under the ``remat_policy`` (``ops/remat.py``; the JAX
model's default ``nothing_saveable`` keeps only the unit's input; the
attention output is tagged ``attn_core`` and ``silu(gate) * up``
``mlp_silu``, as in JAX)), and
with a cache: a :class:`~automodel_tpu_torch.serving.kv_cache.PagedKVView`
(the serving path: each layer writes its k/v into the paged pools, then
attends through ``ops/paged_attention.py``) or the dense decode cache of
:meth:`LlamaForCausalLM.init_kv_cache` (``generation/generate.py``: k/v
written at ``cache_index``; a prefill attends its own keys through
``ops/attention.py::attention``, kernel 9 on the card, each decode step
the cache through the plain ``cached_attention``, as JAX's cached
layer).  The
feed-forward block is a hook
(``_mlp_block``) that the MoE families (``models/mixtral.py``) replace with
routed experts; their per-layer routing statistics come back through remat
and fold into ``out["aux_loss"]``.  Quantized compute
(``quantization/fp8.py::apply_fp8_to_model`` sets ``quant``) sends every
projection through ``ops/quant.py::maybe_qdot`` under the JAX names
(``self_attn.q_proj`` ... ``mlp.down_proj``), so ``filter_fqns`` matches
the same products; the head never does.

``_proj`` is also the seam of LoRA (``peft/lora.py``) and of a weight-only
int8 base (``quantization/weight_only.py``), as the JAX layer's
``_make_proj``: the forward takes ``adapters``, one ``{name:
LayerAdapter}`` per layer, and a projection that has one either uses the
adapter's merged weight (``W + s A B``, made by the wrapper each step)
or adds the rank-r bypass ``s ((x m?) A) B`` to its base product, with
inverted dropout before (``pre``) or after (``post``) the adapter while
training.  An int8 base is dequantized in the compute dtype before the
product; the base product goes through ``maybe_qdot`` either way, the
adapter's delta stays in the compute dtype.  ``weight_only_quant="int8"``
builds that base at construction (the JAX init's transform), and quantized
compute runs with or without a cache (the serving engine's decode rows and
prefill chunks included), as in JAX.  Multi-tenant serving hands
``_proj`` per-layer slabs ``A [E, in, r]`` / ``B [E, r, out]`` and the
forward ``adapter_ids [B]`` (0 = base, a zero slab): each row's delta
then runs through ``ops/lora_gmm.py`` (the gmm kernel on the card), with
the rows' sort by adapter computed once per forward.  Sharding
constraints wait for later port slices.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import zlib
from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from automodel_tpu_torch.ops.attention import (
    attention,
    cached_attention,
    fold_padding_into_segments,
)
from automodel_tpu_torch.ops.lora_gmm import lora_routing, multi_lora_delta
from automodel_tpu_torch.ops.norms import layer_norm, rms_norm
from automodel_tpu_torch.ops.quant import maybe_qdot
from automodel_tpu_torch.ops.remat import (
    checkpoint_layer,
    checkpoint_name,
    resolve_remat_policy,
)
from automodel_tpu_torch.ops.rotary import (
    apply_rope,
    longrope_tables,
    rope_tables,
)
from automodel_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

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
    original_max_position_embeddings: Optional[int] = None
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
        """The known keys of an HF ``config.json``, with the Qwen families'
        defaults that HF's own config classes supply when a file omits
        them: ``attention_bias`` for ``qwen2``, ``use_sliding_window``
        False for ``qwen2*`` / ``qwen3*``, and ``qk_norm`` always on for
        ``qwen3`` (HF ``Qwen3Config`` has no such key)."""
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in hf.items() if k in known}
        model_type = str(hf.get("model_type", ""))
        if model_type == "qwen2":
            kwargs.setdefault("attention_bias", True)
        if model_type.startswith(("qwen2", "qwen3")):
            kwargs.setdefault("use_sliding_window", False)
        if model_type == "qwen3":
            kwargs["qk_norm"] = True
        return cls(**kwargs)


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


class LayerAdapter(NamedTuple):
    """One projection's LoRA in one layer: ``merged`` (``[out, in]``, the
    merge path) or ``A [in, r]`` / ``B [r, out]`` (the bypass), the scale
    ``alpha / r``, and the dropout rate, position and this step's seed
    (None: no dropout, as outside training).  Multi-tenant slabs are
    ``A [E, in, r]`` / ``B [E, r, out]`` (scales folded into ``B``)."""

    merged: Optional[torch.Tensor] = None
    A: Optional[torch.Tensor] = None
    B: Optional[torch.Tensor] = None
    scale: float = 1.0
    dropout: float = 0.0
    position: str = "post"
    seed: Optional[int] = None


def _dropout(t: torch.Tensor, rate: float, seed: int, name: str
             ) -> torch.Tensor:
    """Inverted dropout of ``t`` with a mask drawn from ``seed`` and the
    projection's name (the same mask when the layer is recomputed)."""
    keep = 1.0 - rate
    gen = torch.Generator(device=t.device)
    gen.manual_seed((seed ^ zlib.crc32(name.encode())) & (2 ** 63 - 1))
    m = torch.rand(t.shape, generator=gen, device=t.device) < keep
    return torch.where(m, t / keep, torch.zeros((), dtype=t.dtype,
                                                 device=t.device)).to(t.dtype)


def _linear(i: int, o: int, dtype, device, bias: bool = False
            ) -> nn.Linear:
    return nn.Linear(i, o, bias=bias, dtype=dtype, device=device)


class DenseKVView:
    """The dense decode cache as one forward sees it: ``{"k"|"v": [L, B, T,
    Hk, D]}`` (the JAX ``init_kv_cache`` layout), this step's tokens
    written at positions ``cache_index ..`` of every row, and the padding
    mask ``[B, T]`` (True = a key to attend).  ``layer_view`` narrows to
    one layer (views: writes land in the cache)."""

    def __init__(self, cache: Dict[str, torch.Tensor], cache_index: int,
                 attention_mask: Optional[torch.Tensor]):
        self.cache = cache
        self.cache_index = int(cache_index)
        self.attention_mask = attention_mask

    def layer_view(self, layer: int) -> "DenseKVView":
        return DenseKVView({n: t[layer] for n, t in self.cache.items()},
                           self.cache_index, self.attention_mask)

    def write(self, k: torch.Tensor, v: torch.Tensor) -> None:
        i, S = self.cache_index, k.shape[1]
        for name, x in (("k", k), ("v", v)):
            t = self.cache[name]
            t[:, i:i + S] = x.to(t.dtype)

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               scale=None, logits_soft_cap=None, local_window_size=None,
               impl: Optional[str] = None) -> torch.Tensor:
        """This step's attention after :meth:`write`, as the JAX cached
        layer's: a prefill (S > 1) attends its own S keys through the
        attention dispatcher (kernel 9 on the card; ``impl`` as
        ``ops.attention.attention``'s), the padding mask's first S columns
        folded into segments; a decode step (S = 1) attends the cache
        through the plain ``cached_attention``."""
        S = q.shape[1]
        if S > 1:
            mask = self.attention_mask
            out = attention(
                q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                attention_mask=None if mask is None else mask[:, :S],
                scale=scale, logits_soft_cap=logits_soft_cap,
                local_window_size=local_window_size, impl=impl)
            if mask is None:
                return out
            return _masked_rows_as_jax(out, v, mask[:, :S])
        return cached_attention(
            q, self.cache["k"], self.cache["v"], cache_index=self.cache_index,
            attention_mask=self.attention_mask, scale=scale,
            logits_soft_cap=logits_soft_cap,
            local_window_size=local_window_size)


def _masked_rows_as_jax(out: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """A left-padded prefill's pad queries (``mask`` False: every key they
    may see is a pad) as the JAX cached layer computes them: its softmax
    over an all-masked row is uniform over the S keys, so such a row is
    the mean of ``v`` (weights ``1 / S`` in v's dtype).  Real rows never
    read them, but a tensorwise quantized projection takes its scale from
    every row of its input, pads included."""
    B, S, Hq, D = out.shape
    w = torch.tensor(1.0 / S, dtype=v.dtype, device=v.device)
    mean = (v * w).float().sum(dim=1).to(out.dtype)        # [B, Hk, D]
    mean = mean.repeat_interleave(Hq // v.shape[2], dim=1)  # [B, Hq, D]
    pad = ~mask.bool()
    return torch.where(pad[:, :, None, None], mean[:, None], out)


class RMSNorm(nn.Module):
    def __init__(self, size: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size, dtype=dtype, device=device))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class LayerNorm(nn.Module):
    """LayerNorm with weight (ones) and bias (zeros), statistics in fp32
    (``ops/norms.py::layer_norm``, the JAX one): StarCoder-2's and
    GPT-2's."""

    def __init__(self, size: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size, dtype=dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(size, dtype=dtype,
                                             device=device))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class LlamaDecoderLayer(nn.Module):
    """Attention projections (with Qwen3's per-head ``q_norm`` / ``k_norm``
    when ``cfg.qk_norm``) and the feed-forward block that ``init_mlp``
    builds: the dense SwiGLU here, routed experts in the MoE families.
    ``norm_cls`` builds the block norms (and the model's final norm):
    RMSNorm here, a biased LayerNorm in StarCoder-2 (the JAX ``_norm``
    hook)."""

    norm_cls = RMSNorm

    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype, device):
        super().__init__()
        H, D = cfg.hidden_size, cfg.head_dim
        self.input_layernorm = self.norm_cls(H, cfg.rms_norm_eps, dtype,
                                             device)
        self.init_attention(cfg, dtype, device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(D, cfg.rms_norm_eps, dtype, device)
            self.k_norm = RMSNorm(D, cfg.rms_norm_eps, dtype, device)
        self.post_attention_layernorm = self.norm_cls(H, cfg.rms_norm_eps,
                                                      dtype, device)
        self.init_mlp(cfg, dtype, device)

    def init_attention(self, cfg: LlamaConfig, dtype: torch.dtype,
                       device) -> None:
        H, D = cfg.hidden_size, cfg.head_dim
        Hq, Hk = cfg.num_attention_heads, cfg.num_key_value_heads
        bias = bool(cfg.attention_bias)
        self.q_proj = _linear(H, Hq * D, dtype, device, bias)
        self.k_proj = _linear(H, Hk * D, dtype, device, bias)
        self.v_proj = _linear(H, Hk * D, dtype, device, bias)
        self.o_proj = _linear(Hq * D, H, dtype, device)

    def init_mlp(self, cfg: LlamaConfig, dtype: torch.dtype, device) -> None:
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _linear(H, I, dtype, device)
        self.up_proj = _linear(H, I, dtype, device)
        self.down_proj = _linear(I, H, dtype, device)


class LlamaForCausalLM(nn.Module):
    """``device`` None is ``cuda`` (raises without a card); tests pass
    ``device="cpu"``.  ``remat`` recomputes each unit of ``scan_block``
    layers in the backward pass, keeping what ``remat_policy`` names
    (``ops/remat.py``; default ``nothing_saveable``, the JAX model's).
    ``scan_block`` must be >= 1 and divide the layer count, as in JAX;
    ``scan_unroll`` (the JAX ``lax.scan`` unroll) is accepted and has no
    effect on an eager model."""

    layer_cls = LlamaDecoderLayer

    def __init__(self, config: LlamaConfig,
                 param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                 remat: bool = True,
                 remat_policy: Optional[str] = "nothing_saveable",
                 weight_only_quant: Optional[str] = None,
                 scan_unroll: int = 1, scan_block: int = 1, device=None):
        super().__init__()
        device = resolve_device(device)
        if isinstance(weight_only_quant, str) and \
                weight_only_quant.lower() in ("none", "null", ""):
            weight_only_quant = None
        if weight_only_quant not in (None, "int8"):
            raise ValueError(
                f"model.weight_only_quant must be 'int8' or null, got "
                f"{weight_only_quant!r}")
        # "int8": the seven decoder projections are int8 codes and fp32
        # scales (quantization/weight_only.py), the JAX init's QLoRA base
        self.weight_only_quant = weight_only_quant
        self.quant = None        # set by quantization.fp8.apply_fp8_to_model
        self._adapters = None    # the running layer's LoRA (see _layer)
        self._lora_routing = None   # a multi-tenant forward's row sort
        self.qdot_impl: Optional[str] = None   # "plain" forces qdot's plain
        self.config = config
        self.param_dtype = as_dtype(param_dtype)
        self.compute_dtype = as_dtype(compute_dtype)
        self.remat = bool(remat)
        self.remat_policy = resolve_remat_policy(remat_policy)
        L = config.num_hidden_layers
        if scan_block < 1:
            raise ValueError(f"model.scan_block must be >= 1, got "
                             f"{scan_block}")
        if scan_block > 1 and L % scan_block:
            raise ValueError(
                f"model.scan_block={scan_block} must divide "
                f"num_hidden_layers={L}")
        self.scan_block = int(scan_block)
        # The families' scalar hooks (Granite's multipliers; the JAX
        # decoder's): token embeddings times ``_embedding_scale``, both
        # block outputs times ``_residual_scale`` before the residual add,
        # ``_attn_softmax_scale`` in place of ``head_dim ** -0.5`` (None:
        # the default), logits divided by ``_logits_divisor`` (folded into
        # the head for a hidden-state loss).
        self._embedding_scale = 1.0
        self._residual_scale = 1.0
        self._attn_softmax_scale: Optional[float] = None
        self._logits_divisor = 1.0
        if scan_unroll != 1:
            logger.info("model.scan_unroll=%s: the port runs its layers in "
                        "an eager loop, which has nothing to unroll; the "
                        "knob does nothing here", scan_unroll)
        self.sliding_window = self._uniform_window(config)
        cfg, dt = config, self.param_dtype
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         dtype=dt, device=device)
        self._build_layers(cfg, dt, device)
        self.norm = self.layer_cls.norm_cls(cfg.hidden_size,
                                            cfg.rms_norm_eps, dt, device)
        self.lm_head = None
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias=False, dtype=dt, device=device)
        rope_kw = dict(
            max_position_embeddings=cfg.max_position_embeddings,
            original_max_position_embeddings=getattr(
                cfg, "original_max_position_embeddings", None))
        inv_freq, self.rope_attention_scaling = rope_tables(
            self._rotary_dim(), cfg.rope_theta, cfg.rope_scaling, **rope_kw)
        self.register_buffer("inv_freq", torch.from_numpy(inv_freq).to(device),
                             persistent=False)
        # longrope: the long table and the original length it starts past
        long = longrope_tables(self._rotary_dim(), cfg.rope_theta,
                               cfg.rope_scaling, **rope_kw)
        self.rope_original_max = None if long is None else long[1]
        if long is not None:
            self.register_buffer(
                "inv_freq_long", torch.from_numpy(long[0]).to(device),
                persistent=False)
        if self.weight_only_quant == "int8":
            self._quantize_base()

    def _quantize_base(self) -> None:
        """The int8 base of ``weight_only_quant``: every layer's seven
        projections become ``Int8Linear`` codes of their weights (the JAX
        ``quantize_base_params``, which needs all seven: a family without
        them raises, as the JAX transform's lookup does)."""
        from automodel_tpu_torch.quantization.weight_only import (
            QUANTIZED_MODULES,
            quantize_base_params,
        )

        for layer in getattr(self, "layers", ()):
            missing = [p for _, p in QUANTIZED_MODULES
                       if getattr(layer, p, None) is None]
            if missing:
                raise ValueError(
                    f"weight_only_quant='int8' quantizes the seven dense "
                    f"decoder projections; {type(self).__name__}'s layers "
                    f"lack {missing}")
        quantize_base_params(self)

    def _uniform_window(self, cfg) -> Optional[int]:
        """The one window every layer attends under (None: causal); the
        Gemma families, whose window is per layer, override."""
        return _sliding_window(cfg)

    def _build_layers(self, cfg: LlamaConfig, dtype, device) -> None:
        """The decoder stack, ``self.layers`` (the families with a split
        stack override)."""
        self.layers = nn.ModuleList(
            [self.layer_cls(cfg, dtype, device)
             for _ in range(cfg.num_hidden_layers)])

    def _rotary_dim(self) -> int:
        """The channels rope rotates: ``head_dim`` times the config's
        ``partial_rotary_factor`` (1 but for Phi)."""
        cfg = self.config
        return int(cfg.head_dim * getattr(cfg, "partial_rotary_factor", 1.0))

    def _rope_inv_freq(self, position_ids: torch.Tensor) -> torch.Tensor:
        """This forward's inverse frequencies: longrope's long table when
        ``max(position_ids) + 1`` passes the original length, else the
        (short) table, chosen on the device (no host sync)."""
        if self.rope_original_max is None:
            return self.inv_freq
        use_long = position_ids.max() + 1 > self.rope_original_max
        return torch.where(use_long, self.inv_freq_long, self.inv_freq)

    def _apply_rope(self, q: torch.Tensor, k: torch.Tensor,
                    position_ids: torch.Tensor):
        """Rotate q and k; with partial rotary only the first
        ``_rotary_dim()`` channels (scaled), the rest pass through."""
        inv = self._rope_inv_freq(position_ids)
        scaling = self.rope_attention_scaling
        rd = self._rotary_dim()
        if rd == q.shape[-1]:
            return apply_rope(q, k, position_ids, inv, scaling)
        q_rot, k_rot = apply_rope(q[..., :rd], k[..., :rd], position_ids,
                                  inv, scaling)
        return (torch.cat([q_rot, q[..., rd:]], dim=-1),
                torch.cat([k_rot, k[..., rd:]], dim=-1))

    def _attend(self, q, k, v, segment_ids, kv_cache, attn_impl):
        """Attention of rotated ``q`` over ``k`` / ``v`` (written into the
        cache first when there is one), at the family's softmax scale and
        window; tagged ``attn_core`` for the remat policy."""
        scale = self._attn_softmax_scale
        if kv_cache is not None:
            kv_cache.write(k, v)
            return kv_cache.attend(q, k, v, scale=scale,
                                   local_window_size=self.sliding_window,
                                   impl=attn_impl)
        attn = attention(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal=True, segment_ids=segment_ids, scale=scale,
                         local_window_size=self.sliding_window,
                         impl=attn_impl)
        return self._tag(attn, "attn_core")

    def _scale_residual(self, out: torch.Tensor) -> torch.Tensor:
        """A block's output times ``_residual_scale`` (when not 1)."""
        return out if self._residual_scale == 1.0 else \
            out * self._residual_scale

    def _stack(self) -> List[nn.Module]:
        """Every decoder layer in order."""
        return list(self.layers)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "LlamaForCausalLM":
        """Random weights drawn from ``seed``: N(0, 0.02) for embeddings,
        projections, routers and experts, ones for the norms, zeros for
        the biases (the JAX ``init``'s distribution; not its numbers)."""
        from automodel_tpu_torch.quantization.weight_only import (
            dequantize_base_params,
            is_quantized,
        )

        # an int8 base draws its dense weights as the dense model would
        # (same order, same numbers), then quantizes them, as JAX's init
        int8 = self.weight_only_quant == "int8" and is_quantized(self)
        if int8:
            dequantize_base_params(self, self.param_dtype)
        gen = torch.Generator(device=self.inv_freq.device).manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=gen)
        if int8:
            self._quantize_base()
        return self

    def _proj(self, lin: nn.Module, x: torch.Tensor, name: str
              ) -> torch.Tensor:
        """``x @ W^T`` in the compute dtype; with quantized compute on,
        through ``maybe_qdot`` on the ``[in, out]`` view of the weight
        (the JAX kernel's layout, read in place).  ``W`` is the layer's
        merged LoRA weight when it has one, else the int8 base
        dequantized, else the weight; a bypass adapter adds its delta."""
        cd = self.compute_dtype
        ad = self._adapters.get(name) if self._adapters else None
        if ad is not None and ad.merged is not None:
            w = ad.merged.to(cd)
        elif lin.weight.dtype == torch.int8:
            w = lin.dequantize(cd)
        else:
            w = lin.weight.to(cd)
        if self.quant is None:
            y = F.linear(x, w)
        else:
            y = maybe_qdot(x, w.t(), self.quant, name, impl=self.qdot_impl)
        if ad is not None and ad.A is not None and ad.A.dim() == 3:
            # multi-tenant slabs: each row's delta through its slot's A/B
            # (the tenants' scales are folded into B)
            return self._bias(lin, y + multi_lora_delta(
                x, ad.A.to(cd), ad.B.to(cd), None,
                routing=self._lora_routing))
        if ad is None or ad.A is None:
            return self._bias(lin, y)
        drop = ad.dropout > 0.0 and ad.seed is not None
        xa = x
        if drop and ad.position == "pre":
            xa = _dropout(x, ad.dropout, ad.seed, name)
        delta = (xa @ ad.A.to(cd)) @ ad.B.to(cd)
        if drop and ad.position == "post":
            delta = _dropout(delta, ad.dropout, ad.seed, name)
        # the scale rounded to the compute dtype first, as the JAX layer's
        return self._bias(
            lin, y + float(torch.tensor(ad.scale, dtype=cd)) * delta)

    def _bias(self, lin: nn.Module, y: torch.Tensor) -> torch.Tensor:
        """``y`` plus the projection's bias in the compute dtype, after any
        adapter delta (the JAX layer's order); a frozen base tensor under
        LoRA (``"bias": "none"``)."""
        bias = getattr(lin, "bias", None)
        return y if bias is None else y + bias.to(self.compute_dtype)

    def _attention_block(self, layer: LlamaDecoderLayer, hidden,
                         position_ids, segment_ids, kv_cache, attn_impl):
        """``hidden`` plus the layer's attention output."""
        cfg = self.config
        B, S, _ = hidden.shape
        D, Hq, Hk = cfg.head_dim, cfg.num_attention_heads, \
            cfg.num_key_value_heads
        x = layer.input_layernorm(hidden)
        q = self._proj(layer.q_proj, x, "self_attn.q_proj").view(B, S, Hq, D)
        k = self._proj(layer.k_proj, x, "self_attn.k_proj").view(B, S, Hk, D)
        v = self._proj(layer.v_proj, x, "self_attn.v_proj").view(B, S, Hk, D)
        if cfg.qk_norm:
            q, k = layer.q_norm(q), layer.k_norm(k)
        q, k = self._apply_rope(q, k, position_ids)
        attn = self._attend(q, k, v, segment_ids, kv_cache, attn_impl)
        return hidden + self._scale_residual(self._proj(
            layer.o_proj, attn.reshape(B, S, Hq * D), "self_attn.o_proj"))

    def _mlp_block(self, x: torch.Tensor, layer: LlamaDecoderLayer):
        """Post-norm feed-forward of one layer -> ``(out, aux | None)``: the
        seam the MoE families replace (routed experts return the layer's
        routing statistics for the load-balancing loss; dense gives
        None)."""
        act = self._tag(
            F.silu(self._proj(layer.gate_proj, x, "mlp.gate_proj"))
            * self._proj(layer.up_proj, x, "mlp.up_proj"), "mlp_silu")
        return self._proj(layer.down_proj, act, "mlp.down_proj"), None

    def _tag(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """``x`` tagged ``name`` for the remat policy (a copy) when the
        policy keeps that tag and gradients are recorded, else ``x`` (the
        same answer in the forward and its recomputation)."""
        if (self.remat and name in self.remat_policy.names
                and torch.is_grad_enabled()):
            return checkpoint_name(x, name)
        return x

    def _block(self, hidden, position_ids, segment_ids, *, first: int,
               attn_impl, adapters):
        """Layers ``first .. first + scan_block - 1`` (one checkpointed
        unit; ``adapters`` holds theirs, or is None) -> ``(hidden, [aux |
        None per layer])``."""
        auxes = []
        stack = self._stack()
        for j in range(self.scan_block):
            hidden, aux = self._layer(
                stack[first + j], hidden, position_ids, segment_ids,
                None, attn_impl, adapters[j] if adapters else None)
            auxes.append(aux)
        return hidden, auxes

    def _layer(self, layer: LlamaDecoderLayer, hidden, position_ids,
               segment_ids, kv_cache, attn_impl, adapters=None):
        """One decoder layer -> ``(hidden, aux | None)``; ``adapters`` (the
        layer's ``{name: LayerAdapter}``) reach ``_proj`` for the length of
        the call, its recomputation under remat included."""
        self._adapters = adapters
        try:
            hidden = self._attention_block(layer, hidden, position_ids,
                                           segment_ids, kv_cache, attn_impl)
            out, aux = self._mlp_block(
                layer.post_attention_layernorm(hidden), layer)
        finally:
            self._adapters = None
        return hidden + self._scale_residual(out), aux

    def _head(self, hidden: torch.Tensor, return_hidden: bool
              ) -> Dict[str, torch.Tensor]:
        """The normed hidden states -> ``{"logits"}``, or with
        ``return_hidden`` ``{"hidden_states", "lm_head_kernel"}``."""
        # tied: the head is the embedding, whose gradient sums both uses
        head = (self.embed_tokens.weight if self.lm_head is None
                else self.lm_head.weight)
        div = self._logits_divisor
        if return_hidden:
            if div != 1.0:
                # folded into the head, so a fused loss sees the scaled
                # logits and the head's gradient carries the factor
                head = head / torch.tensor(div, dtype=head.dtype,
                                           device=head.device)
            return {"hidden_states": hidden, "lm_head_kernel": head.t()}
        logits = F.linear(hidden, head.to(self.compute_dtype))
        if div != 1.0:
            logits = logits / torch.tensor(div, dtype=logits.dtype,
                                           device=logits.device)
        return {"logits": logits}

    def _combine_aux(self, aux_losses: List[Any]) -> torch.Tensor:
        """Fold the layers' aux values into the scalar ``aux_loss`` output
        (the JAX model's mean); the MoE families override."""
        return torch.stack(aux_losses).mean()

    @property
    def num_params(self) -> int:
        """Elements of every parameter and weight buffer (an int8 base's
        codes and scales), the JAX ``num_params`` over its tree."""
        return (sum(p.numel() for p in self.parameters())
                + sum(b.numel() for n, b in self.named_buffers()
                      if not n.rsplit(".", 1)[-1].startswith("inv_freq")))

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

    def init_kv_cache(self, batch: int, max_len: int, dtype=None
                      ) -> Dict[str, torch.Tensor]:
        """The dense decode cache ``{"k"|"v": [L, B, max_len, Hk, D]}``,
        zeros in ``dtype`` (default the compute dtype) on the model's
        device (the JAX ``init_kv_cache``)."""
        cfg = self.config
        shape = (cfg.num_hidden_layers, batch, max_len,
                 cfg.num_key_value_heads, cfg.head_dim)
        dt = as_dtype(dtype) if dtype is not None else self.compute_dtype
        dev = self.inv_freq.device
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}

    def forward(self, input_ids: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                kv_cache=None, return_hidden: bool = False,
                attn_impl: Optional[str] = None,
                adapters: Optional[List[Dict[str, LayerAdapter]]] = None,
                cache_index: Optional[int] = None,
                adapter_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """``input_ids [B, S]`` -> ``{"logits": [B, S, V]}`` in the compute
        dtype, or with ``return_hidden`` ``{"hidden_states": [B, S, H],
        "lm_head_kernel": [H, V]}`` (the JAX layout) for a loss that applies
        the head itself; models whose layers return aux values (MoE) add
        ``"aux_loss"``.

        Without a cache: ``segment_ids [B, S]`` (packed samples, 0 = pad),
        ``attention_mask [B, S]`` (folded into the segments) and
        ``position_ids [B, S]`` (restarting per packed sample) reach the
        attention; ``attn_impl`` is passed to ``ops.attention.attention``
        (None: the kernels on CUDA tensors, the plain versions on CPU).
        ``kv_cache`` is a ``PagedKVView`` (pools updated in place), the
        dense cache of :meth:`init_kv_cache` with ``cache_index`` (this
        step's first cache position) and ``attention_mask [B, max_len]``
        over the cache (returned updated in place as ``out["kv_cache"]``),
        or None.  ``adapters`` (from ``peft/lora.py::LoRAModel``, or the
        serving slabs of ``serving/adapters.py`` with ``adapter_ids
        [B]``) holds one ``{name: LayerAdapter}`` per layer.
        ``inputs_embeds [B, S, H]`` (the VLM families' merged text and
        image embeddings) replaces the token embedding of ``input_ids``."""
        B, S = input_ids.shape
        dense = isinstance(kv_cache, dict)
        if dense:
            if cache_index is None:
                raise ValueError("a dense kv_cache needs cache_index")
            kv_cache = DenseKVView(kv_cache, cache_index, attention_mask)
        if position_ids is None:
            start = 0 if cache_index is None else int(cache_index)
            position_ids = start + torch.arange(
                S, device=input_ids.device).expand(B, S)
        if kv_cache is None:
            segment_ids = fold_padding_into_segments((B, S), segment_ids,
                                                     attention_mask)
        if adapter_ids is not None:
            if not adapters:
                raise ValueError("adapter_ids route rows through adapter "
                                 "slabs: pass adapters too")
            slabs = next(a for layer in adapters for a in layer.values())
            self._lora_routing = lora_routing(adapter_ids, S,
                                              slabs.A.shape[0])
        try:
            out = self._forward(input_ids, position_ids, segment_ids,
                                kv_cache, return_hidden, attn_impl, adapters,
                                inputs_embeds)
        finally:
            self._lora_routing = None
        if dense:
            out["kv_cache"] = kv_cache.cache
        return out

    def _embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The token embeddings of ``input_ids`` in the compute dtype,
        times ``_embedding_scale`` in that dtype when it is not 1."""
        cd = self.compute_dtype
        hidden = self.embed_tokens.weight[input_ids].to(cd)
        if self._embedding_scale != 1.0:
            hidden = hidden * torch.tensor(self._embedding_scale, dtype=cd,
                                           device=hidden.device)
        return hidden

    def _forward(self, input_ids, position_ids, segment_ids, kv_cache,
                 return_hidden, attn_impl, adapters, inputs_embeds=None):
        remat = (self.remat and kv_cache is None
                 and torch.is_grad_enabled())
        hidden = (self._embed(input_ids) if inputs_embeds is None
                  else inputs_embeds.to(self.compute_dtype))
        aux_losses = []
        if remat:
            k = self.scan_block
            for first in range(0, len(self._stack()), k):
                # the unit's adapters ride the closure: the checkpoint
                # saves an RNG state per CUDA tensor among its arguments
                unit = functools.partial(
                    self._block, first=first, attn_impl=attn_impl,
                    adapters=adapters[first:first + k] if adapters else None)
                hidden, auxes = checkpoint_layer(
                    unit, hidden, position_ids, segment_ids,
                    policy=self.remat_policy)
                aux_losses += [a for a in auxes if a is not None]
        else:
            for i, layer in enumerate(self._stack()):
                view = (kv_cache.layer_view(i) if kv_cache is not None
                        else None)
                hidden, aux = self._layer(
                    layer, hidden, position_ids, segment_ids, view,
                    attn_impl, adapters[i] if adapters else None)
                if aux is not None:
                    aux_losses.append(aux)
        out = self._head(self.norm(hidden), return_hidden)
        if aux_losses:
            out["aux_loss"] = self._combine_aux(aux_losses)
        return out
