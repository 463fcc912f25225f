"""DeepSeek-V3 family: Multi-head Latent Attention and the aux-loss-free
MoE (counterpart: ``automodel_tpu/models/deepseek_v3.py``; HF
``modeling_deepseek_v3.py``).  DeepSeek-V2's softmax gate is
``models/deepseek_v2.py``, a subclass that replaces :meth:`_route`.

MLA (:meth:`DeepseekV3ForCausalLM._attention_block`): queries through
``q_proj`` or the low-rank ``q_a_proj -> rms_norm -> q_b_proj``; keys and
values decompressed from one latent (``kv_a_proj_with_mqa -> rms_norm ->
kv_b_proj``) that carries a single rope head beside it, broadcast to every
query head; the nope / rope split per head, the rope channels
de-interleaved (``rope_interleave``) before the half-split rotation, with
yarn's tables at the rope width.  The attention runs through
``ops/attention.py::attention`` (kernel 9, the splash rung, on the card)
at ``qk_head_dim`` = nope + rope (192 in the released models), v padded
with zeros to that width and the output sliced back to ``v_head_dim``,
as the JAX model does; the softmax scale is ``qk_head_dim ** -0.5`` times
yarn's ``mscale(factor, mscale_all_dim) ** 2``.

The stack is two sub-stacks, as the JAX tree: ``dense_layers`` (the first
``first_k_dense_replace``, a SwiGLU MLP) and ``layers`` (the routed
experts of ``ops/moe.py``'s core plus the dense ``shared_experts``).  HF
layer ``i`` is ``dense_layers[i]`` for ``i < k`` and ``layers[i - k]``
after (``models/hf_io.py``'s ``layer_offset``).  The V3 router
(:func:`~automodel_tpu_torch.ops.moe.noaux_topk_routing`) carries
``e_score_correction_bias`` as an fp32 parameter with no gradient path
(selection only; ``optim/builder.py`` keeps it out of weight decay, so
AdamW leaves it as it is).  The routing statistics are not computed: the
family folds no load-balancing loss, as in JAX.

Projections are plain products in the compute dtype (the JAX family's
``proj``): quantized compute reaches the routed experts only
(``mlp.experts``), and LoRA on the MLA projections is refused, as JAX
refuses its rank-r bypass there.  Decoding uses the dense cache of
:meth:`init_kv_cache` (expanded per-head keys and padded values per
sub-stack; MLA's latent cache is not wired, in JAX either): a prefill
(more than one token) attends its own keys through the dispatcher, the
padding mask folded into segments, and a single-token step attends the
cache through the plain ``cached_attention`` (XLA in JAX).
``DecodeEngine`` refuses these models (their ``serving_refusal``, read
as ``peft/lora.py`` reads ``peft_refusal``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from automodel_tpu_torch.models.llama import (
    DenseKVView,
    LlamaConfig,
    LlamaForCausalLM,
    RMSNorm,
)
from automodel_tpu_torch.ops import moe
from automodel_tpu_torch.ops.attention import attention, cached_attention
from automodel_tpu_torch.ops.quant import quant_for
from automodel_tpu_torch.ops.rotary import apply_rope, get_mscale

_LORA_REFUSAL = (
    "LoRA is not wired for the MLA projections of the DeepSeek families "
    "(the JAX family refuses its rank-r bypass there too)")
_SERVING_REFUSAL = (
    "DecodeEngine does not serve MLA attention: the paged KV pools hold one "
    "head_dim per kv head and MLA's expanded cache is not paged -- the JAX "
    "engine does not serve MLA either; generate() (generation/generate.py) "
    "runs these models over their dense decode cache")


@dataclasses.dataclass
class DeepseekV3Config(LlamaConfig):
    """HF ``DeepseekV3Config`` field names on the Llama config."""

    q_lora_rank: Optional[int] = None       # None: a plain q_proj (V2-Lite)
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    rope_interleave: bool = True
    n_routed_experts: int = 8
    num_experts_per_tok: int = 2
    n_shared_experts: int = 1
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    moe_intermediate_size: int = 512
    first_k_dense_replace: int = 1
    # not HF fields: GShard capacity (None = dropless), tokens per routing
    # group, the expert dispatch path (None = sorted)
    moe_capacity_factor: Optional[float] = 2.0
    moe_group_size: int = 512
    moe_dispatch: Optional[str] = None

    def __post_init__(self):
        # HF's head_dim is the rope width (its rotary table's)
        if self.head_dim is None:
            self.head_dim = self.qk_rope_head_dim
        super().__post_init__()
        self.model_type = "deepseek_v3"
        self.moe_dispatch = moe.validate_moe_dispatch(
            moe.normalize_moe_dispatch(self.moe_dispatch))
        if not 0 <= self.first_k_dense_replace <= self.num_hidden_layers:
            raise ValueError(
                f"first_k_dense_replace={self.first_k_dense_replace} out of "
                f"range for {self.num_hidden_layers} layers")
        if self.n_routed_experts % self.n_group:
            raise ValueError("n_routed_experts must divide into n_group")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


def _linear(i: int, o: int, dtype, device) -> nn.Linear:
    return nn.Linear(i, o, bias=False, dtype=dtype, device=device)


class MLAAttention(nn.Module):
    """The MLA projections under their HF / JAX names."""

    def __init__(self, cfg: DeepseekV3Config, dtype, device):
        super().__init__()
        H, Hq = cfg.hidden_size, cfg.num_attention_heads
        if cfg.q_lora_rank is None:
            self.q_proj = _linear(H, Hq * cfg.qk_head_dim, dtype, device)
        else:
            self.q_a_proj = _linear(H, cfg.q_lora_rank, dtype, device)
            self.q_a_layernorm = RMSNorm(cfg.q_lora_rank, cfg.rms_norm_eps,
                                         dtype, device)
            self.q_b_proj = _linear(cfg.q_lora_rank, Hq * cfg.qk_head_dim,
                                    dtype, device)
        self.kv_a_proj_with_mqa = _linear(
            H, cfg.kv_lora_rank + cfg.qk_rope_head_dim, dtype, device)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps,
                                      dtype, device)
        self.kv_b_proj = _linear(
            cfg.kv_lora_rank, Hq * (cfg.qk_nope_head_dim + cfg.v_head_dim),
            dtype, device)
        self.o_proj = _linear(Hq * cfg.v_head_dim, H, dtype, device)


class DenseMLP(nn.Module):
    """SwiGLU ``gate_proj`` / ``up_proj`` / ``down_proj``."""

    def __init__(self, hidden: int, inter: int, dtype, device):
        super().__init__()
        self.gate_proj = _linear(hidden, inter, dtype, device)
        self.up_proj = _linear(hidden, inter, dtype, device)
        self.down_proj = _linear(inter, hidden, dtype, device)


class DeepseekMoE(nn.Module):
    """The router ``gate`` (an ``nn.Linear [E, H]``, with V3's fp32
    ``e_score_correction_bias [E]``), the routed experts stacked as
    ``experts.{gate,up,down}_proj`` (``[E, H, I]`` / ``[E, I, H]``, the
    JAX layout) and the dense ``shared_experts`` of width ``I *
    n_shared_experts``."""

    def __init__(self, cfg: DeepseekV3Config, dtype, device,
                 correction_bias: bool):
        super().__init__()
        H, E = cfg.hidden_size, cfg.n_routed_experts
        inter = cfg.moe_intermediate_size
        self.gate = _linear(H, E, dtype, device)
        if correction_bias:
            self.gate.register_parameter(
                "e_score_correction_bias", nn.Parameter(torch.zeros(
                    E, dtype=torch.float32, device=device)))
        self.experts = nn.Module()
        for name, shape in (("gate_proj", (E, H, inter)),
                            ("up_proj", (E, H, inter)),
                            ("down_proj", (E, inter, H))):
            self.experts.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device)))
        self.shared_experts = DenseMLP(H, inter * cfg.n_shared_experts,
                                       dtype, device)


class DeepseekDecoderLayer(nn.Module):
    """Norms, MLA, and a dense MLP (``moe`` False) or the MoE block."""

    def __init__(self, cfg: DeepseekV3Config, dtype, device, moe_layer: bool,
                 correction_bias: bool):
        super().__init__()
        self.moe = moe_layer
        H = cfg.hidden_size
        self.input_layernorm = RMSNorm(H, cfg.rms_norm_eps, dtype, device)
        self.self_attn = MLAAttention(cfg, dtype, device)
        self.post_attention_layernorm = RMSNorm(H, cfg.rms_norm_eps, dtype,
                                                device)
        self.mlp = (DeepseekMoE(cfg, dtype, device, correction_bias)
                    if moe_layer else
                    DenseMLP(H, cfg.intermediate_size, dtype, device))


class _SplitDenseCache:
    """The JAX dense cache of a split stack (``{"dense_layers" | "layers":
    {"k" | "v": [n, B, T, Hq, qk_head_dim]}}``) as the per-layer views of
    ``LlamaForCausalLM._forward``: layer ``i`` of the whole stack."""

    def __init__(self, cache, cache_index: int, attention_mask):
        self.views = [DenseKVView(cache[name], cache_index, attention_mask)
                      for name in ("dense_layers", "layers") if name in cache]
        self.sizes = [v.cache["k"].shape[0] for v in self.views]

    def layer_view(self, i: int) -> DenseKVView:
        for view, n in zip(self.views, self.sizes):
            if i < n:
                return view.layer_view(i)
            i -= n
        raise IndexError(i)


class DeepseekV3ForCausalLM(LlamaForCausalLM):
    """``model_type: deepseek_v3``: MLA x the aux-loss-free MoE.  The
    other families' constructor arguments (``device`` None is ``cuda``);
    ``gmm_impl`` reaches the routed experts' grouped matmuls."""

    correction_bias = True          # V3's router carries the bias
    peft_refusal = _LORA_REFUSAL
    serving_refusal = _SERVING_REFUSAL

    def __init__(self, config: DeepseekV3Config, **kwargs):
        super().__init__(config, **kwargs)
        self.gmm_impl: Optional[str] = None
        # HF DeepseekV3Attention.scaling: qk_head_dim^-0.5, times yarn's
        # mscale(factor, mscale_all_dim)^2 when the rope sets it
        scale = config.qk_head_dim ** -0.5
        rs = config.rope_scaling or {}
        if rs.get("mscale_all_dim"):
            m = get_mscale(rs["factor"], rs["mscale_all_dim"])
            scale = scale * m * m
        self.attn_scale = float(scale)

    # -- construction -------------------------------------------------------
    def _build_layers(self, cfg, dtype, device) -> None:
        kd = cfg.first_k_dense_replace
        self.dense_layers = nn.ModuleList(
            [DeepseekDecoderLayer(cfg, dtype, device, False, False)
             for _ in range(kd)])
        self.layers = nn.ModuleList(
            [DeepseekDecoderLayer(cfg, dtype, device, True,
                                  self.correction_bias)
             for _ in range(cfg.num_hidden_layers - kd)])

    def _rotary_dim(self) -> int:
        return self.config.qk_rope_head_dim

    def _stack(self) -> List[nn.Module]:
        return list(self.dense_layers) + list(self.layers)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "DeepseekV3ForCausalLM":
        """The other families' draw; the correction biases start at zero
        (the JAX ``init``)."""
        super().init_weights(seed)
        for name, p in self.named_parameters():
            if name.endswith("e_score_correction_bias"):
                p.zero_()
        return self

    def jax_tree_leaves(self) -> Iterator[Tuple[Tuple[str, ...], Any, bool]]:
        """``(JAX tree path, target, transposed)`` of every leaf (the
        ``models/weights.py::jax_leaves`` contract): the two sub-stacks'
        leaves are per-layer lists, ``nn.Linear`` weights transposed, the
        expert stacks and the correction bias as they are."""
        cfg = self.config
        yield ("embed_tokens", "embedding"), self.embed_tokens.weight, False
        for stack in ("dense_layers", "layers"):
            layers = getattr(self, stack)
            if not len(layers):
                continue
            for norm in ("input_layernorm", "post_attention_layernorm"):
                yield ((stack, norm, "weight"),
                       [getattr(l, norm).weight for l in layers], False)
            attn = [l.self_attn for l in layers]
            projs = (("q_proj",) if cfg.q_lora_rank is None
                     else ("q_a_proj", "q_b_proj"))
            for proj in projs + ("kv_a_proj_with_mqa", "kv_b_proj",
                                 "o_proj"):
                yield ((stack, "self_attn", proj, "kernel"),
                       [getattr(a, proj).weight for a in attn], True)
            norms = (("kv_a_layernorm",) if cfg.q_lora_rank is None
                     else ("q_a_layernorm", "kv_a_layernorm"))
            for norm in norms:
                yield ((stack, "self_attn", norm, "weight"),
                       [getattr(a, norm).weight for a in attn], False)
            mlps = [l.mlp for l in layers]
            if stack == "dense_layers":
                for proj in ("gate_proj", "up_proj", "down_proj"):
                    yield ((stack, "mlp", proj, "kernel"),
                           [getattr(m, proj).weight for m in mlps], True)
                continue
            yield ((stack, "mlp", "gate", "kernel"),
                   [m.gate.weight for m in mlps], True)
            if self.correction_bias:
                yield ((stack, "mlp", "gate", "e_score_correction_bias"),
                       [m.gate.e_score_correction_bias for m in mlps], False)
            for proj in ("gate_proj", "up_proj", "down_proj"):
                yield ((stack, "mlp", "experts", proj, "kernel"),
                       [getattr(m.experts, proj) for m in mlps], False)
            for proj in ("gate_proj", "up_proj", "down_proj"):
                yield ((stack, "mlp", "shared_experts", proj, "kernel"),
                       [getattr(m.shared_experts, proj).weight
                        for m in mlps], True)
        yield ("norm", "weight"), self.norm.weight, False
        if self.lm_head is not None:
            yield ("lm_head", "kernel"), self.lm_head.weight, True

    # -- forward ------------------------------------------------------------
    def _mm(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, lin.weight.to(self.compute_dtype))

    def _deinterleave(self, x: torch.Tensor) -> torch.Tensor:
        """Rope pairs (0, 1), (2, 3), .. -> halves [evens | odds] (HF's
        interleaved rotation; the permutation is shared by q and k, so
        their inner products are HF's)."""
        if not self.config.rope_interleave:
            return x
        return torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)

    def _attention_block(self, layer, hidden, position_ids, segment_ids,
                         kv_cache, attn_impl):
        cfg = self.config
        B, S, _ = hidden.shape
        Hq = cfg.num_attention_heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
            cfg.v_head_dim
        p = layer.self_attn
        x = layer.input_layernorm(hidden)
        if cfg.q_lora_rank is None:
            q = self._mm(p.q_proj, x)
        else:
            q = self._mm(p.q_b_proj, p.q_a_layernorm(self._mm(p.q_a_proj, x)))
        q = q.view(B, S, Hq, dn + dr)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        ckv = self._mm(p.kv_a_proj_with_mqa, x)
        k_lat = p.kv_a_layernorm(ckv[..., :cfg.kv_lora_rank])
        k_rope = ckv[..., cfg.kv_lora_rank:]
        kv = self._mm(p.kv_b_proj, k_lat).view(B, S, Hq, dn + dv)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        q_rope, k_rope = apply_rope(
            self._deinterleave(q_rope), self._deinterleave(k_rope)[:, :, None],
            position_ids, self.inv_freq, self.rope_attention_scaling)
        qh = torch.cat([q_nope, q_rope], dim=-1)
        kh = torch.cat([k_nope, k_rope.expand(B, S, Hq, dr)], dim=-1)
        # one head dim for the kernel: v padded with zeros to qk_head_dim,
        # which leaves the output's pad columns zero; sliced off below
        vh = F.pad(v, (0, dn + dr - dv)) if dv != dn + dr else v
        qh, kh, vh = qh.contiguous(), kh.contiguous(), vh.contiguous()
        if kv_cache is None:
            out = attention(qh, kh, vh, causal=True, segment_ids=segment_ids,
                            scale=self.attn_scale, impl=attn_impl)
        else:
            kv_cache.write(kh, vh)
            if S > 1:           # a prefill attends its own keys
                mask = kv_cache.attention_mask
                out = attention(
                    qh, kh, vh, causal=True,
                    attention_mask=None if mask is None else mask[:, :S],
                    scale=self.attn_scale, impl=attn_impl)
            else:
                out = cached_attention(
                    qh, kv_cache.cache["k"], kv_cache.cache["v"],
                    cache_index=kv_cache.cache_index,
                    attention_mask=kv_cache.attention_mask,
                    scale=self.attn_scale)
        out = out[..., :dv].reshape(B, S, Hq * dv)
        return hidden + self._mm(p.o_proj, out)

    def _dense_mlp(self, x: torch.Tensor, mlp: DenseMLP) -> torch.Tensor:
        return self._mm(mlp.down_proj, F.silu(self._mm(mlp.gate_proj, x))
                        * self._mm(mlp.up_proj, x))

    def _route(self, xg: torch.Tensor, gate: nn.Linear, k: int):
        """Router hook -> ``(weights, idx)``: V3's sigmoid scores with the
        correction bias (V2 overrides with its softmax gate)."""
        cfg = self.config
        scores = torch.sigmoid(moe.router_logits(xg, gate.weight.t()))
        return moe.noaux_topk_routing(
            scores, gate.e_score_correction_bias, k, n_group=cfg.n_group,
            topk_group=cfg.topk_group, norm_topk=bool(cfg.norm_topk_prob),
            routed_scaling_factor=float(cfg.routed_scaling_factor))

    def _mlp_block(self, x, layer):
        if not layer.moe:
            return self._dense_mlp(x, layer.mlp), None
        cfg = self.config
        m = layer.mlp
        B, S, H = x.shape
        E, k, T = cfg.n_routed_experts, cfg.num_experts_per_tok, B * S
        M, C = moe.group_and_capacity(T, cfg.moe_group_size, E, k,
                                      cfg.moe_capacity_factor)
        xg, pad = moe.group_tokens(x.reshape(T, H), M)
        weights, idx = self._route(xg, m.gate, k)
        weights, idx, _ = moe.mask_padded_tokens(weights, idx, pad, E)
        routed = moe.expert_ffn(
            xg, weights, idx, m.experts.gate_proj, m.experts.up_proj,
            m.experts.down_proj, capacity=C, dispatch=cfg.moe_dispatch,
            compute_dtype=self.compute_dtype,
            quant=quant_for(self.quant, "mlp.experts"), impl=self.gmm_impl)
        routed = routed.reshape(-1, H)[:T].reshape(B, S, H)
        return routed + self._dense_mlp(x, m.shared_experts), None

    def forward(self, input_ids: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                kv_cache=None, return_hidden: bool = False,
                attn_impl: Optional[str] = None, adapters=None,
                cache_index: Optional[int] = None,
                adapter_ids: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """The other families' forward (see ``LlamaForCausalLM.forward``)
        without adapters; ``kv_cache`` is the dense cache of
        :meth:`init_kv_cache` (a paged view raises: ``DecodeEngine`` does
        not serve MLA)."""
        if adapters is not None or adapter_ids is not None:
            raise NotImplementedError(_LORA_REFUSAL)
        if kv_cache is None:
            return super().forward(
                input_ids, position_ids=position_ids,
                segment_ids=segment_ids, attention_mask=attention_mask,
                return_hidden=return_hidden, attn_impl=attn_impl)
        if not isinstance(kv_cache, dict):
            raise NotImplementedError(
                "the DeepSeek families decode over their dense cache "
                "(init_kv_cache, generate()); the paged engine does not "
                "serve MLA")
        if getattr(self.quant, "enabled", False):
            raise NotImplementedError(
                "quantized compute while decoding is not ported yet: "
                "ROADMAP Queue 1 item 6")
        if cache_index is None:
            raise ValueError("a dense kv_cache needs cache_index")
        B, S = input_ids.shape
        if position_ids is None:
            position_ids = int(cache_index) + torch.arange(
                S, device=input_ids.device).expand(B, S)
        view = _SplitDenseCache(kv_cache, int(cache_index), attention_mask)
        out = self._forward(input_ids, position_ids, None, view,
                            return_hidden, attn_impl, None)
        out["kv_cache"] = kv_cache
        return out

    def init_kv_cache(self, batch: int, max_len: int, dtype=None
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
        """The JAX dense decode cache per sub-stack: expanded per-head
        keys ``[n, B, max_len, Hq, qk_head_dim]`` and values padded to the
        same width, zeros in ``dtype`` (default the compute dtype)."""
        from automodel_tpu_torch.models.llama import as_dtype

        cfg = self.config
        dt = as_dtype(dtype) if dtype is not None else self.compute_dtype
        dev = self.inv_freq.device
        out = {}
        for name, n in (("dense_layers", len(self.dense_layers)),
                        ("layers", len(self.layers))):
            if n:
                shape = (n, batch, max_len, cfg.num_attention_heads,
                         cfg.qk_head_dim)
                out[name] = {"k": torch.zeros(shape, dtype=dt, device=dev),
                             "v": torch.zeros(shape, dtype=dt, device=dev)}
        return out

    def flops_per_token(self) -> float:
        """Training FLOPs per token (fwd + bwd = 3 x fwd): the MLA
        projections, the dense FFN of the first ``k`` layers, ``k``
        routed experts plus the shared ones and the router after, and the
        head (the JAX model's convention)."""
        cfg = self.config
        H, Hq = cfg.hidden_size, cfg.num_attention_heads
        q = (2 * H * Hq * cfg.qk_head_dim if cfg.q_lora_rank is None
             else 2 * H * cfg.q_lora_rank
             + 2 * cfg.q_lora_rank * Hq * cfg.qk_head_dim)
        attn = (q + 2 * H * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
                + 2 * cfg.kv_lora_rank * Hq * (cfg.qk_nope_head_dim
                                               + cfg.v_head_dim)
                + 2 * Hq * cfg.v_head_dim * H)
        dense_ffn = 6 * H * cfg.intermediate_size
        moe_ffn = (cfg.num_experts_per_tok * 6 * H * cfg.moe_intermediate_size
                   + 6 * H * cfg.moe_intermediate_size * cfg.n_shared_experts
                   + 2 * H * cfg.n_routed_experts)
        kd = cfg.first_k_dense_replace
        total = (cfg.num_hidden_layers * attn + kd * dense_ffn
                 + (cfg.num_hidden_layers - kd) * moe_ffn
                 + 2 * cfg.vocab_size * H)
        return 3.0 * total

    def attention_flops_per_token(self, seq_len: int,
                                  causal: bool = True) -> float:
        """The attention products' training FLOPs per token at a row
        length: scores at ``qk_head_dim``, values at ``v_head_dim`` (the
        kernel multiplies the padded width; this counts the model's)."""
        cfg = self.config
        s_avg = seq_len / 2 if causal else seq_len
        fwd = 2 * cfg.num_attention_heads * (cfg.qk_head_dim
                                             + cfg.v_head_dim) * s_avg
        return 3.0 * cfg.num_hidden_layers * fwd

