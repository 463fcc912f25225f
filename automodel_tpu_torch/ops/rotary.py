"""Rotary position embeddings (counterpart: ``automodel_tpu/ops/rotary.py``).

The frequency tables are computed in numpy float64 exactly as the JAX
package does, so both sides rotate by the same float32 frequencies.  The
default, linear, llama3, yarn and longrope rope types are ported (yarn
and longrope with their amplitude factor, ``attention_scaling``).
Longrope (Phi-3's 128k variants) rescales each frequency by a per-dim
factor list, ``short_factor`` or, once the sequence passes the original
context length, ``long_factor``: the model holds both tables
(:func:`longrope_tables`) and picks one from the positions at run time,
as HF's ``dynamic_rope_update`` and the JAX ``_rope_tables`` do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def rope_type_of(scaling: Optional[dict]) -> str:
    """``scaling["rope_type"]``, else its older spelling ``"type"``, else
    ``"default"`` (HF ``modeling_rope_utils.py``)."""
    if not scaling:
        return "default"
    return scaling.get("rope_type", scaling.get("type", "default"))


def rope_tables(head_dim: int, theta: float = 10000.0,
                scaling: Optional[dict] = None, *,
                max_position_embeddings: Optional[int] = None,
                original_max_position_embeddings: Optional[int] = None,
                seq_len: Optional[int] = None
                ) -> Tuple[np.ndarray, float]:
    """``(inverse frequencies [D/2] float32 numpy, attention_scaling)``:
    the JAX ``rope_parameters``.  ``attention_scaling`` multiplies the cos
    and sin amplitudes; it is 1.0 but for yarn (its ``mscale``).

    yarn (HF ``_compute_yarn_parameters``) blends the interpolated and the
    original frequencies over a linear ramp between the correction dims of
    ``beta_fast`` and ``beta_slow``; its context length is the scaling
    dict's ``original_max_position_embeddings``, else
    ``max_position_embeddings`` (HF reads no config-level original length
    for yarn, and neither does JAX).

    longrope (HF ``_compute_longrope_parameters``) divides each frequency
    by ``long_factor`` when ``seq_len`` exceeds the original context
    length, else by ``short_factor``; its amplitude is ``sqrt(1 + ln(f) /
    ln(original))``.  A config-level ``original_max_position_embeddings``
    sets the original length and ``f = max_position_embeddings /
    original``; without it the original length is
    ``max_position_embeddings`` and ``f`` the dict's ``factor``."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                                / head_dim))
    attention_scaling = 1.0
    rope_type = rope_type_of(scaling)
    if rope_type == "llama3":
        factor = scaling["factor"]
        low_factor = scaling["low_freq_factor"]
        high_factor = scaling["high_freq_factor"]
        old_len = scaling["original_max_position_embeddings"]
        wavelen = 2 * np.pi / inv_freq
        low_wavelen = old_len / low_factor
        high_wavelen = old_len / high_factor
        scaled = np.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
        smooth = (old_len / wavelen - low_factor) / (high_factor - low_factor)
        smoothed = (1 - smooth) / factor * inv_freq + smooth * inv_freq
        is_medium = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
        inv_freq = np.where(is_medium, smoothed, scaled)
    elif rope_type == "linear":
        inv_freq = inv_freq / scaling["factor"]
    elif rope_type == "yarn":
        factor = scaling["factor"]
        old_len = (scaling.get("original_max_position_embeddings")
                   or max_position_embeddings)
        beta_fast = scaling.get("beta_fast") or 32.0
        beta_slow = scaling.get("beta_slow") or 1.0
        mscale = scaling.get("mscale")
        mscale_all_dim = scaling.get("mscale_all_dim")
        attention_scaling = scaling.get("attention_factor")
        if attention_scaling is None:
            if mscale and mscale_all_dim:
                attention_scaling = float(
                    get_mscale(factor, mscale)
                    / get_mscale(factor, mscale_all_dim))
            else:
                attention_scaling = float(get_mscale(factor))

        def correction_dim(num_rotations):
            return (head_dim * np.log(old_len / (num_rotations * 2 * np.pi))
                    ) / (2 * np.log(theta))

        low, high = correction_dim(beta_fast), correction_dim(beta_slow)
        if scaling.get("truncate", True):
            low, high = np.floor(low), np.ceil(high)
        low = max(float(low), 0.0)
        high = min(float(high), head_dim - 1)
        rmin, rmax = low, max(high, low + 0.001)
        ramp = np.clip((np.arange(head_dim // 2, dtype=np.float64) - rmin)
                       / (rmax - rmin), 0, 1)
        extrapolation = 1.0 - ramp
        inv_freq = (inv_freq / factor * (1 - extrapolation)
                    + inv_freq * extrapolation)
    elif rope_type == "longrope":
        if original_max_position_embeddings:
            old_len = original_max_position_embeddings
            factor = (max_position_embeddings / old_len
                      if max_position_embeddings else None)
        else:
            old_len = max_position_embeddings
            factor = scaling.get("factor")
        use_long = seq_len is not None and old_len and seq_len > old_len
        ext = np.asarray(scaling["long_factor" if use_long
                                 else "short_factor"], dtype=np.float64)
        inv_freq = inv_freq / ext
        attention_scaling = scaling.get("attention_factor")
        if attention_scaling is None:
            attention_scaling = (
                1.0 if factor is None or factor <= 1.0
                else float(np.sqrt(1 + np.log(factor) / np.log(old_len))))
    elif rope_type not in ("default", "dynamic"):
        raise NotImplementedError(
            f"rope_type {rope_type!r} is not ported (default, linear, "
            "llama3, yarn and longrope are)")
    return inv_freq.astype(np.float32), float(attention_scaling)


def longrope_tables(head_dim: int, theta: float, scaling: Optional[dict], *,
                    max_position_embeddings: Optional[int] = None,
                    original_max_position_embeddings: Optional[int] = None
                    ) -> Optional[Tuple[np.ndarray, int]]:
    """``(long inverse frequencies, original length)`` for a longrope
    config, else None: the table a forward switches to once
    ``max(position_ids) + 1`` passes the original length (the
    config-level ``original_max_position_embeddings``, else
    ``max_position_embeddings``, as in HF and JAX)."""
    original = original_max_position_embeddings or max_position_embeddings
    if rope_type_of(scaling) != "longrope" or not original:
        return None
    inv_long, _ = rope_tables(
        head_dim, theta, scaling,
        max_position_embeddings=max_position_embeddings,
        original_max_position_embeddings=original_max_position_embeddings,
        seq_len=original + 1)
    return inv_long, int(original)


def get_mscale(scale: float, m: float = 1.0) -> float:
    """yarn's magnitude factor ``0.1 m ln(scale) + 1`` (1 for scale <= 1)."""
    return 0.1 * m * np.log(scale) + 1.0 if scale > 1 else 1.0


def rope_parameters(head_dim: int, theta: float = 10000.0,
                    scaling: Optional[dict] = None, **kwargs) -> np.ndarray:
    """The inverse frequencies of :func:`rope_tables` alone."""
    return rope_tables(head_dim, theta, scaling, **kwargs)[0]


def apply_rope(q: torch.Tensor, k: torch.Tensor, position_ids: torch.Tensor,
               inv_freq: torch.Tensor, attention_scaling: float = 1.0):
    """Rotate ``q [B, S, Hq, D]`` and ``k [B, S, Hk, D]`` by position
    (HF half-split convention: element i pairs with i + D/2), cos and sin
    times ``attention_scaling`` when it is not 1.  The rotation runs in
    fp32 and each half is cast back to the input dtype, as in the JAX
    package."""
    angles = position_ids[..., None].float() * inv_freq        # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    if attention_scaling != 1.0:
        cos = cos * attention_scaling
        sin = sin * attention_scaling

    def rot(x):
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([(x1 * cos - x2 * sin).to(x.dtype),
                          (x2 * cos + x1 * sin).to(x.dtype)], dim=-1)

    return rot(q), rot(k)
