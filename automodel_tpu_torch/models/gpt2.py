"""GPT-2 for YAML-driven pretraining as an ``nn.Module`` (counterpart:
``automodel_tpu/models/gpt2.py``).

The JAX model's architecture: learned token and position embeddings
(``wte``, ``wpe``), pre-LN blocks on ``ops/norms.py::layer_norm``, a fused
biased ``c_attn`` split q | k | v in that order, causal attention through
``ops/attention.py`` (kernel 9 on the card, its plain version on the CPU;
packed ``segment_ids`` and a padding mask as the Llama class takes them),
an MLP ``c_fc -> gelu(tanh) -> c_proj`` (``jax.nn.gelu``'s default is the
tanh approximation) and a tied head (``wte`` as ``[H, V]``) that
``return_hidden`` hands to the fused linear-CE loss.  ``remat`` recomputes
every whole block in the backward pass (the JAX ``jax.checkpoint`` of the
scan body, nothing saved), so kernel 9's forward runs twice per layer and
microbatch.

Projections are ``nn.Linear`` weights ``[out, in]``: the JAX kernels
(and HF's Conv1D weights) are ``[in, out]``, so ``models/weights.py`` and
``models/hf_io.py`` transpose.  Weights live in ``param_dtype`` and each
product casts them to ``compute_dtype``.  :meth:`GPT2LMHeadModel.
init_weights` draws GPT-2's init from an explicit generator: N(0, 0.02),
the position table N(0, 0.01), the residual projections (``attn.c_proj``,
``mlp.c_proj``) N(0, 0.02 / sqrt(2 L)), zero biases, unit norms.  GPT-2
has no decode cache, as in JAX: the serving engine refuses it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from automodel_tpu_torch.models.llama import LayerNorm, as_dtype
from automodel_tpu_torch.ops.attention import (
    attention,
    fold_padding_into_segments,
)
from automodel_tpu_torch.ops.remat import (
    checkpoint_layer,
    resolve_remat_policy,
)
from automodel_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class GPT2Config:
    vocab_size: int = 50304
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    model_type: str = "gpt2"

    @classmethod
    def from_hf_config(cls, hf: Dict[str, Any]) -> "GPT2Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in hf.items() if k in known})


def _linear(i: int, o: int, dtype, device) -> nn.Linear:
    return nn.Linear(i, o, bias=True, dtype=dtype, device=device)


class GPT2Attention(nn.Module):
    def __init__(self, H: int, dtype, device):
        super().__init__()
        self.c_attn = _linear(H, 3 * H, dtype, device)
        self.c_proj = _linear(H, H, dtype, device)


class GPT2MLP(nn.Module):
    def __init__(self, H: int, dtype, device):
        super().__init__()
        self.c_fc = _linear(H, 4 * H, dtype, device)
        self.c_proj = _linear(4 * H, H, dtype, device)


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config, dtype, device):
        super().__init__()
        H, eps = cfg.n_embd, cfg.layer_norm_epsilon
        self.ln_1 = LayerNorm(H, eps, dtype, device)
        self.attn = GPT2Attention(H, dtype, device)
        self.ln_2 = LayerNorm(H, eps, dtype, device)
        self.mlp = GPT2MLP(H, dtype, device)


_BLOCK_LINEARS = (("attn", "c_attn"), ("attn", "c_proj"), ("mlp", "c_fc"),
                  ("mlp", "c_proj"))


class GPT2LMHeadModel(nn.Module):
    """``device`` None is ``cuda`` (raises without a card); tests pass
    ``device="cpu"``."""

    serving_refusal = ("GPT-2 has no decode cache (as in the JAX package): "
                       "it trains through the recipe and does not serve")

    def __init__(self, config: GPT2Config, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, remat: bool = True,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.param_dtype = as_dtype(param_dtype)
        self.compute_dtype = as_dtype(compute_dtype)
        self.remat = bool(remat)
        self.remat_policy = resolve_remat_policy("nothing_saveable")
        cfg, dt = config, self.param_dtype
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd, dtype=dt,
                                device=device)
        self.wpe = nn.Embedding(cfg.n_positions, cfg.n_embd, dtype=dt,
                                device=device)
        self.h = nn.ModuleList([GPT2Block(cfg, dt, device)
                                for _ in range(cfg.n_layer)])
        self.ln_f = LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon, dt, device)
        self.lm_head = None
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.n_embd, cfg.vocab_size, bias=False,
                                     dtype=dt, device=device)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "GPT2LMHeadModel":
        """GPT-2's init (the JAX ``init``'s distribution, not its numbers)
        from a generator seeded with ``seed``."""
        gen = torch.Generator(device=self.wte.weight.device).manual_seed(seed)
        resid_std = 0.02 / (2 * self.config.n_layer) ** 0.5
        for name, p in self.named_parameters():
            if name.startswith("ln") or ".ln_" in name:
                p.fill_(1.0) if name.endswith("weight") else p.zero_()
            elif name.endswith(".bias"):
                p.zero_()
            elif name == "wpe.weight":
                p.normal_(0.0, 0.01, generator=gen)
            elif name.endswith("c_proj.weight"):
                p.normal_(0.0, resid_std, generator=gen)
            else:
                p.normal_(0.0, 0.02, generator=gen)
        return self

    def jax_tree_leaves(self) -> Iterator[Tuple[Tuple[str, ...], Any, bool]]:
        """``(JAX path, target, transposed)`` of every leaf of the JAX
        GPT-2 tree (``models/weights.py::jax_leaves``): ``wte``, ``wpe``,
        the stacked ``h`` and ``ln_f``."""
        yield ("wte", "embedding"), self.wte.weight, False
        yield ("wpe", "embedding"), self.wpe.weight, False
        for ln in ("ln_1", "ln_2"):
            for wb in ("weight", "bias"):
                yield (("h", ln, wb),
                       [getattr(getattr(b, ln), wb) for b in self.h], False)
        for mod, sub in _BLOCK_LINEARS:
            lins = [getattr(getattr(b, mod), sub) for b in self.h]
            yield ("h", mod, sub, "kernel"), [l.weight for l in lins], True
            yield ("h", mod, sub, "bias"), [l.bias for l in lins], False
        yield ("ln_f", "weight"), self.ln_f.weight, False
        yield ("ln_f", "bias"), self.ln_f.bias, False
        if self.lm_head is not None:
            yield ("lm_head", "kernel"), self.lm_head.weight, True

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self) -> float:
        """Training FLOPs per token of the matmul parameters (fwd + bwd =
        6N, the Llama class's convention: ``c_attn``, ``c_proj``, ``c_fc``
        and ``c_proj`` per layer, and the head)."""
        cfg = self.config
        H = cfg.n_embd
        per_layer = 2 * H * 3 * H + 2 * H * H + 2 * 2 * H * 4 * H
        return 3.0 * (cfg.n_layer * per_layer + 2 * cfg.vocab_size * H)

    def attention_flops_per_token(self, seq_len: int,
                                  causal: bool = True) -> float:
        """The attention score and value products' training FLOPs per token
        at a row length (the Llama class's convention)."""
        cfg = self.config
        s_avg = seq_len / 2 if causal else seq_len
        return 3.0 * cfg.n_layer * 2 * 2 * cfg.n_embd * s_avg

    def _lin(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.linear(x, lin.weight.to(cd), lin.bias.to(cd))

    def _block(self, block: GPT2Block, hidden, segment_ids, attn_impl):
        cfg = self.config
        B, S, H = hidden.shape
        nh = cfg.n_head
        x = block.ln_1(hidden)
        q, k, v = self._lin(block.attn.c_attn, x).split(H, dim=-1)
        shape = (B, S, nh, H // nh)
        attn = attention(q.reshape(shape).contiguous(),
                         k.reshape(shape).contiguous(),
                         v.reshape(shape).contiguous(), causal=True,
                         segment_ids=segment_ids, impl=attn_impl)
        hidden = hidden + self._lin(block.attn.c_proj, attn.reshape(B, S, H))
        x = F.gelu(self._lin(block.mlp.c_fc, block.ln_2(hidden)),
                   approximate="tanh")
        return hidden + self._lin(block.mlp.c_proj, x)

    def forward(self, input_ids: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                return_hidden: bool = False,
                attn_impl: Optional[str] = None,
                kv_cache=None) -> Dict[str, torch.Tensor]:
        """``input_ids [B, S]`` -> ``{"logits": [B, S, V]}`` in the compute
        dtype, or with ``return_hidden`` ``{"hidden_states", "lm_head_kernel"
        [H, V]}``; ``segment_ids`` / ``attention_mask`` / ``position_ids``
        as the Llama class takes them (positions past ``n_positions - 1``
        read the table's last row, as JAX's clamping gather does)."""
        if kv_cache is not None:
            raise NotImplementedError(self.serving_refusal)
        B, S = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(S, device=input_ids.device).expand(
                B, S)
        segment_ids = fold_padding_into_segments((B, S), segment_ids,
                                                 attention_mask)
        # positions past the table read its last row, as JAX's gather
        # clamps: the recipe pads a 1,024-token row to 1,152 (its labels
        # -100, after every real token), as in the JAX recipe
        pos = position_ids.clamp(0, self.config.n_positions - 1)
        hidden = (self.wte.weight[input_ids]
                  + self.wpe.weight[pos]).to(self.compute_dtype)
        remat = self.remat and torch.is_grad_enabled()
        for block in self.h:
            if remat:
                hidden = checkpoint_layer(
                    functools.partial(self._block, block,
                                      attn_impl=attn_impl),
                    hidden, segment_ids, policy=self.remat_policy)
            else:
                hidden = self._block(block, hidden, segment_ids, attn_impl)
        hidden = self.ln_f(hidden)
        head = self.wte.weight if self.lm_head is None else self.lm_head.weight
        if return_hidden:
            return {"hidden_states": hidden, "lm_head_kernel": head.t()}
        return {"logits": F.linear(hidden, head.to(self.compute_dtype))}


def build_gpt2_model(*, seed: int = 0, device=None,
                     **kwargs) -> GPT2LMHeadModel:
    """YAML builder (the JAX ``build_gpt2_model``): config fields, then the
    model's own arguments; weights drawn from ``seed``."""
    cfg_fields = {f.name for f in dataclasses.fields(GPT2Config)}
    cfg = GPT2Config(**{k: v for k, v in kwargs.items() if k in cfg_fields})
    extra = {k: v for k, v in kwargs.items() if k not in cfg_fields}
    return GPT2LMHeadModel(cfg, device=device, **extra).init_weights(seed)
