"""Sampling and the dense generation loop (counterpart:
``automodel_tpu/generation/generate.py``).

:func:`generate` is the JAX eval path: one lockstep batch over the dense
decode cache (``model.init_kv_cache``).  Prompts are left-aligned so every
row's last prompt token sits at the same position, pads are excluded by a
padding mask over the cache, rope positions count from 0 per row; one
prefill forward writes the cache and gives each row's first token, then
``max_new_tokens - 1`` single-token forwards follow.  Finished rows emit
``pad_token_id`` after their eos.  Serving workloads go through the
paged decode engine (``serving/engine.py``), whose greedy output is
token-identical to this loop.  Every family's prefill attends its own
keys through the attention dispatcher (kernel 9 on the card; the
prefill's ``attn_impl="plain"`` forces the plain version), each
single-token step the cache through the plain ``cached_attention``, as
the JAX cached layers do.  The DeepSeek families, which the engine does
not serve, run here over their split dense cache; the VLMs (Gemma-3,
llava, Qwen2.5-VL, Phi-4-multimodal) take their images, videos or audio
as prefill keywords (``pixel_values``, ``pixel_values_videos``,
``input_audio_embeds`` ...; numpy arrays are moved to the model's
device).  Their features follow the placeholders wherever the
left-alignment puts them (each row's, or the batch's, placeholders keep
their order), so right-padded prompts with ``prompt_lens`` serve as
well as left-padded ones with ``prompt_lens=None``.  Positions are 1-D
text positions, as in JAX: Qwen2.5-VL decodes without M-RoPE ids.

Randomness comes from an explicit ``torch.Generator``; it will not draw
the numbers ``jax.random`` draws from the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 64
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    do_sample: bool = False           # False -> greedy
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0


def sample_logits(logits: torch.Tensor, cfg: GenerationConfig,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """``[B, V]`` logits -> ``[B]`` int64 token ids under ``cfg``."""
    if not cfg.do_sample:
        return logits.argmax(dim=-1)
    logits = logits.float() / max(cfg.temperature, 1e-6)
    if cfg.top_k is not None:
        kth = torch.sort(logits, dim=-1).values[:, -cfg.top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if cfg.top_p is not None:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        cumulative = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
        # smallest prefix whose mass exceeds top_p; top-1 always survives
        cutoff_idx = (cumulative < cfg.top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_desc, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def left_align(input_ids: torch.Tensor, prompt_lens: torch.Tensor,
               pad_token_id: int) -> torch.Tensor:
    """Right-padded ``[B, S]`` prompts -> left-padded (right-aligned)."""
    B, S = input_ids.shape
    shift = S - prompt_lens                                  # [B]
    idx = torch.arange(S, device=input_ids.device)[None, :] - shift[:, None]
    rolled = torch.gather(input_ids, 1, idx.clamp(0, S - 1))
    return torch.where(idx < 0, torch.full_like(rolled, pad_token_id),
                       rolled)


@torch.inference_mode()
def generate(model, input_ids, prompt_lens=None,
             config: Optional[GenerationConfig] = None,
             generator: Optional[torch.Generator] = None,
             **prefill_kwargs) -> np.ndarray:
    """Continuations of right-padded ``input_ids [B, S]`` (``prompt_lens
    [B]`` the true lengths, default S) on the model's device ->
    ``[B, max_new_tokens]`` int32 numpy, ``pad_token_id`` after eos.
    ``prefill_kwargs`` go to the prefill forward only, as in JAX (e.g.
    ``attn_impl="plain"``, or a VLM's ``pixel_values``).  The decode
    steps are plain PyTorch ops: the JAX loop runs no Pallas kernel there
    either."""
    cfg = config or GenerationConfig()
    dev = next(model.parameters()).device
    prefill_kwargs = {k: torch.from_numpy(np.asarray(v)).to(dev)
                      if isinstance(v, np.ndarray) else v
                      for k, v in prefill_kwargs.items()}
    ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                          device=dev)
    B, S = ids.shape
    lens = (torch.full((B,), S, dtype=torch.long, device=dev)
            if prompt_lens is None else torch.as_tensor(
                np.asarray(prompt_lens), dtype=torch.long, device=dev))
    left = left_align(ids, lens, cfg.pad_token_id)
    max_len = S + cfg.max_new_tokens
    shift = S - lens                                         # pads per row
    # padding mask over the whole cache: prompt pads out, generated in
    kv_mask = torch.arange(max_len, device=dev)[None, :] >= shift[:, None]
    prefill_pos = (torch.arange(S, device=dev)[None, :]
                   - shift[:, None]).clamp(min=0)
    cache = model.init_kv_cache(B, max_len)
    out = model(left, position_ids=prefill_pos, attention_mask=kv_mask,
                kv_cache=cache, cache_index=0, **prefill_kwargs)
    tok = sample_logits(out["logits"][:, -1].float(), cfg, generator)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    emitted = []
    # N tokens need N - 1 decode forwards: each emits its carried token and
    # samples the next; the last carry is emitted without a forward
    for t in range(cfg.max_new_tokens - 1):
        out = model(tok[:, None], position_ids=(lens + t)[:, None],
                    attention_mask=kv_mask, kv_cache=cache,
                    cache_index=S + t)
        nxt = sample_logits(out["logits"][:, 0].float(), cfg, generator)
        emitted.append(torch.where(done, cfg.pad_token_id, tok))
        if cfg.eos_token_id is not None:
            done = done | (tok == cfg.eos_token_id)
        tok = nxt
    emitted.append(torch.where(done, cfg.pad_token_id, tok))
    return torch.stack(emitted, dim=1).to(torch.int32).cpu().numpy()
