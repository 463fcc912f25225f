"""Qwen2.5-VL: the windowed ViT and the M-RoPE decoder as ``nn.Module`` s
(counterpart: ``automodel_tpu/models/qwen2_5_vl.py``).

The design is the JAX model's, in eager PyTorch:

* **A fixed patch grid per call.**  The tower is run for one ``(t, h, w)``
  grid (``image_grid`` / ``video_grid``); everything derived from the grid
  -- the window partition's gather indices, their inverse, the pad-slot
  mask and the 2-D rotary tables -- is host numpy, computed once per grid
  (:func:`_grid_layout`, cached) and copied to the tower's device.
* **Windows as a batch axis.**  A window block gathers the patch stream
  ``[N, L, H, Dh]`` into ``[N * nW, wlen, H, Dh]`` (pad slots masked out of
  the keys), runs one non-causal attention and scatters the valid slots
  back; a full-attention block (``fullatt_block_indexes``) attends over
  each temporal frame.  Both go through ``ops/attention.py::attention``,
  the dispatcher the JAX tower calls: on CUDA tensors kernel 9
  (``csrc/flash_attn_{fwd,bwd}.cu``) non-causal, head_dim 80 zero-padded
  to 128 by its wrappers.  The block's routing is a Python ``if`` on the
  block index (JAX: ``lax.cond`` on a flag riding the layer scan).
* **Canonical patch order.**  The processor's merge-unit-grouped order is
  kept end to end: the rotary tables attach per patch, the merger is
  pointwise per merge unit, and the window permutation lives inside the
  gather and the scatter.  A pad query slot gets 0 from the kernel (the
  JAX SDPA rung gives it the mean of the v rows); the scatter reads valid
  slots only, so neither reaches the output nor a gradient.
* **M-RoPE**: ``position_ids [B, S, 3]`` (temporal, height, width; the
  collator computes them, ``datasets/vlm/qwen_rope.py``) pick, per rotary
  channel, the angle of its section's axis; ``[B, S]`` ids take the plain
  rope.

Parameters keep the JAX tree's names (``language_model``, ``visual.
patch_embed`` / ``blocks[i].{norm1, attn.qkv, attn.proj, norm2, mlp.*}`` /
``merger.{ln_q, fc1, fc2}``); projections are ``nn.Linear`` weights
``[out, in]``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from automodel_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    RMSNorm,
    as_dtype,
)
from automodel_tpu_torch.models.weights import jax_leaves
from automodel_tpu_torch.ops.attention import attention
from automodel_tpu_torch.ops.remat import (
    checkpoint_layer,
    resolve_remat_policy,
)
from automodel_tpu_torch.utils.device import resolve_device

_EPS = 1e-6


@dataclasses.dataclass
class Qwen25VisionConfig:
    """HF ``Qwen2_5_VLVisionConfig`` field names."""

    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    out_hidden_size: int = 3584
    tokens_per_second: int = 2
    model_type: str = "qwen2_5_vl"

    @classmethod
    def from_hf_config(cls, hf: Dict[str, Any]) -> "Qwen25VisionConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in hf.items() if k in known})

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return (self.in_channels * self.temporal_patch_size
                * self.patch_size ** 2)


@dataclasses.dataclass
class Qwen25VLTextConfig(LlamaConfig):
    """The text config (HF ``Qwen2_5_VLTextConfig``): Qwen2's decoder, q /
    k / v biases on, the M-RoPE sections in ``rope_scaling``."""

    def __post_init__(self):
        super().__post_init__()
        self.model_type = "qwen2_5_vl_text"

    @classmethod
    def from_hf_config(cls, hf: Dict[str, Any]) -> "Qwen25VLTextConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in hf.items() if k in known}
        kwargs.setdefault("attention_bias", True)
        return cls(**kwargs)


def _mrope_section_of(config: LlamaConfig) -> Tuple[int, ...]:
    rs = config.rope_scaling or {}
    return tuple(rs.get("mrope_section", (16, 24, 24)))


@dataclasses.dataclass
class Qwen25VLConfig:
    """HF ``Qwen2_5_VLConfig``: nested text and vision configs.  As in
    JAX, only the nested ``text_config`` layout is read: the text fields
    of the older flat layout are not."""

    text_config: Any = None
    vision_config: Any = None
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    model_type: str = "qwen2_5_vl"
    tie_word_embeddings: bool = False

    def __post_init__(self):
        if isinstance(self.text_config, dict):
            self.text_config = Qwen25VLTextConfig.from_hf_config(
                self.text_config)
        if isinstance(self.vision_config, dict):
            self.vision_config = Qwen25VisionConfig.from_hf_config(
                self.vision_config)
        self.text_config = self.text_config or Qwen25VLTextConfig(
            attention_bias=True)
        self.vision_config = self.vision_config or Qwen25VisionConfig()
        self.text_config.tie_word_embeddings = self.tie_word_embeddings

    @classmethod
    def from_hf_config(cls, hf: Dict[str, Any]) -> "Qwen25VLConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in hf.items() if k in known})

    @property
    def mrope_section(self) -> Tuple[int, ...]:
        return _mrope_section_of(self.text_config)


# ---------------------------------------------------------------------------
# the grid's geometry (host numpy, cached per grid)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=16)
def _grid_layout(grid: Tuple[int, int, int], spatial_merge_size: int,
                 window_size: int, patch_size: int, head_dim: int):
    """Everything derived from the grid, in canonical (merge-unit grouped)
    order: ``gather [nW, wlen_p]`` patch indices of each window's slots
    (pads -> 0), ``valid [nW, wlen_p]``, ``scatter [L]`` (each patch's
    slot in the flat window stream) and the 2-D rotary tables ``cos`` /
    ``sin [L, head_dim]`` (HF ``get_window_index`` / ``rot_pos_emb``; a
    grid that is a multiple of the window gets no pad)."""
    t, h, w = grid
    m = spatial_merge_size
    llm_h, llm_w = h // m, w // m
    unit = m * m
    n_units = t * llm_h * llm_w
    L = n_units * unit

    wlen = window_size // m // patch_size
    pad_h, pad_w = (-llm_h) % wlen, (-llm_w) % wlen
    nwh, nww = (llm_h + pad_h) // wlen, (llm_w + pad_w) // wlen
    idx = np.arange(n_units).reshape(t, llm_h, llm_w)
    idx = np.pad(idx, ((0, 0), (0, pad_h), (0, pad_w)), constant_values=-1)
    idx = idx.reshape(t, nwh, wlen, nww, wlen).transpose(0, 1, 3, 2, 4)
    win_units = idx.reshape(-1, wlen * wlen)                 # [nW, wu]
    n_win = win_units.shape[0]
    valid_u = win_units >= 0
    gather = (np.where(valid_u, win_units, 0)[..., None] * unit
              + np.arange(unit)[None, None, :]).reshape(n_win, -1)
    valid = np.repeat(valid_u, unit, axis=1)                 # [nW, wlen_p]
    scatter = np.zeros(L, np.int64)
    flat_gather, flat_valid = gather.reshape(-1), valid.reshape(-1)
    scatter[flat_gather[flat_valid]] = np.nonzero(flat_valid)[0]

    hpos = np.arange(h)[:, None] * np.ones((1, w), np.int64)
    wpos = np.ones((h, 1), np.int64) * np.arange(w)[None, :]

    def to_units(x):
        x = x.reshape(llm_h, m, llm_w, m).transpose(0, 2, 1, 3).reshape(-1)
        return np.tile(x, t)

    hpos, wpos = to_units(hpos), to_units(wpos)              # [L]
    inv_freq = 1.0 / (10000.0 ** (
        np.arange(0, head_dim // 2, 2, np.float64) / (head_dim // 2)))
    freqs = np.concatenate([hpos[:, None] * inv_freq[None, :],
                            wpos[:, None] * inv_freq[None, :]], axis=-1)
    emb = np.concatenate([freqs, freqs], axis=-1)            # [L, hd]
    return {
        "gather": gather.astype(np.int32),
        "valid": valid,
        "scatter": scatter.astype(np.int32),
        "cos": np.cos(emb).astype(np.float32),
        "sin": np.sin(emb).astype(np.float32),
        "n_units": n_units, "unit": unit,
    }


def _rot_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
              ) -> torch.Tensor:
    """``x cos + rotate_half(x) sin`` in fp32, cast back to ``x``'s dtype
    (the tower's 2-D rope)."""
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    return (x32 * cos + rotated * sin).to(x.dtype)


def _linear(i: int, o: int, dtype, device) -> nn.Linear:
    return nn.Linear(i, o, bias=True, dtype=dtype, device=device)


class _VisionAttention(nn.Module):
    def __init__(self, D: int, dtype, device):
        super().__init__()
        self.qkv = _linear(D, 3 * D, dtype, device)
        self.proj = _linear(D, D, dtype, device)


class _VisionMLP(nn.Module):
    def __init__(self, D: int, I: int, dtype, device):
        super().__init__()
        self.gate_proj = _linear(D, I, dtype, device)
        self.up_proj = _linear(D, I, dtype, device)
        self.down_proj = _linear(I, D, dtype, device)


class Qwen25VisionBlock(nn.Module):
    """One block (the JAX names ``norm1``, ``attn.qkv`` / ``attn.proj``,
    ``norm2``, ``mlp.{gate,up,down}_proj``)."""

    def __init__(self, cfg: Qwen25VisionConfig, dtype, device):
        super().__init__()
        D = cfg.hidden_size
        self.norm1 = RMSNorm(D, _EPS, dtype, device)
        self.attn = _VisionAttention(D, dtype, device)
        self.norm2 = RMSNorm(D, _EPS, dtype, device)
        self.mlp = _VisionMLP(D, cfg.intermediate_size, dtype, device)


class _Merger(nn.Module):
    def __init__(self, cfg: Qwen25VisionConfig, dtype, device):
        super().__init__()
        unit_d = cfg.spatial_merge_size ** 2 * cfg.hidden_size
        self.ln_q = RMSNorm(cfg.hidden_size, _EPS, dtype, device)
        self.fc1 = _linear(unit_d, unit_d, dtype, device)
        self.fc2 = _linear(unit_d, cfg.out_hidden_size, dtype, device)


class Qwen25VisionTower(nn.Module):
    """Flat patches ``[N, L, patch_dim]`` of one grid -> merged features
    ``[N, n_units, out_hidden_size]``.  Each block is recomputed in the
    backward pass when ``remat`` and gradients are recorded (the JAX
    tower's ``jax.checkpoint`` per block, ``nothing_saveable``)."""

    def __init__(self, config: Qwen25VisionConfig,
                 param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                 remat: bool = True, device=None):
        super().__init__()
        self.config = config
        self.param_dtype = as_dtype(param_dtype)
        self.compute_dtype = as_dtype(compute_dtype)
        self.remat = bool(remat)
        cfg, dt = config, self.param_dtype
        self.patch_embed = nn.Linear(cfg.patch_dim, cfg.hidden_size,
                                     bias=False, dtype=dt, device=device)
        self.blocks = nn.ModuleList([Qwen25VisionBlock(cfg, dt, device)
                                     for _ in range(cfg.depth)])
        self.merger = _Merger(cfg, dt, device)
        self._tables: Dict[Tuple, Dict[str, torch.Tensor]] = {}

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """N(0, 0.02) for the matmuls, ones for the norms, zeros for the
        biases (the JAX ``init``'s distribution)."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif name.endswith(("norm1.weight", "norm2.weight",
                                "ln_q.weight")):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)

    def jax_tree_leaves(self) -> Iterator[Tuple[Tuple[str, ...], Any, bool]]:
        """``(JAX path, target, transposed)`` of every leaf of the JAX
        tower's tree (``models/weights.py::jax_leaves``)."""
        blocks = self.blocks
        yield ("patch_embed", "kernel"), self.patch_embed.weight, True
        for norm in ("norm1", "norm2"):
            yield (("blocks", norm, "weight"),
                   [getattr(b, norm).weight for b in blocks], False)
        for part, names in (("attn", ("qkv", "proj")),
                            ("mlp", ("gate_proj", "up_proj", "down_proj"))):
            for name in names:
                lins = [getattr(getattr(b, part), name) for b in blocks]
                yield (("blocks", part, name, "kernel"),
                       [m.weight for m in lins], True)
                yield (("blocks", part, name, "bias"),
                       [m.bias for m in lins], False)
        mg = self.merger
        yield ("merger", "ln_q", "weight"), mg.ln_q.weight, False
        for fc in ("fc1", "fc2"):
            lin = getattr(mg, fc)
            yield ("merger", fc, "kernel"), lin.weight, True
            yield ("merger", fc, "bias"), lin.bias, False

    def layout(self, grid: Tuple[int, int, int]) -> Dict[str, Any]:
        """The grid's :func:`_grid_layout` as tensors on the tower's
        device, copied once per grid (the rotary tables shaped ``[1, L, 1,
        head_dim]`` to broadcast over the images and heads)."""
        grid = tuple(int(g) for g in grid)
        tables = self._tables.get(grid)
        if tables is None:
            cfg = self.config
            lay = _grid_layout(grid, cfg.spatial_merge_size, cfg.window_size,
                               cfg.patch_size, cfg.head_dim)
            dev = self.patch_embed.weight.device
            tables = {k: (torch.from_numpy(v).to(dev)
                          if isinstance(v, np.ndarray) else v)
                      for k, v in lay.items()}
            tables["gather"] = tables["gather"].long()
            tables["scatter"] = tables["scatter"].long()
            for k in ("cos", "sin"):
                tables[k] = tables[k][None, :, None, :]
            self._tables[grid] = tables
        return tables

    def _lin(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """``x @ W^T + b`` in the compute dtype (the product rounded, then
        the bias added, as the JAX tower's)."""
        cd = self.compute_dtype
        return F.linear(x, lin.weight.to(cd)) + lin.bias.to(cd)

    def _attend(self, q, k, v, lay, full: bool, t_frames: int, attn_impl):
        """One block's attention over ``[N, L, H, Dh]``: per temporal frame
        (full), else per window with the pad slots masked."""
        N, L, Hh, Dh = q.shape
        if full:
            # HF's cu_seqlens = repeat_interleave(h * w, t): canonical
            # order is t-major, so the frames are contiguous
            def per_frame(z):
                return z.reshape(N * t_frames, L // t_frames, Hh, Dh)

            out = attention(per_frame(q), per_frame(k), per_frame(v),
                            causal=False, impl=attn_impl)
            return out.reshape(N, L, Hh, Dh)
        gather, valid = lay["gather"], lay["valid"]
        nW, wlen_p = gather.shape

        def to_win(z):
            return z.index_select(1, gather.reshape(-1)).reshape(
                N * nW, wlen_p, Hh, Dh)

        mask = valid[None].expand(N, nW, wlen_p).reshape(N * nW, wlen_p)
        out = attention(to_win(q), to_win(k), to_win(v), causal=False,
                        attention_mask=mask, impl=attn_impl)
        return out.reshape(N, nW * wlen_p, Hh, Dh).index_select(
            1, lay["scatter"])

    def _block(self, block: Qwen25VisionBlock, x: torch.Tensor, lay,
               full: bool, t_frames: int, attn_impl) -> torch.Tensor:
        cfg = self.config
        N, L, _ = x.shape
        Hh, Dh = cfg.num_heads, cfg.head_dim
        y = block.norm1(x)
        qkv = self._lin(block.attn.qkv, y).reshape(N, L, 3, Hh, Dh)
        q, k, v = qkv.unbind(2)
        q = _rot_half(q, lay["cos"], lay["sin"]).contiguous()
        k = _rot_half(k, lay["cos"], lay["sin"]).contiguous()
        out = self._attend(q, k, v.contiguous(), lay, full, t_frames,
                           attn_impl)
        x = x + self._lin(block.attn.proj, out.reshape(N, L, Hh * Dh))
        y = block.norm2(x)
        act = F.silu(self._lin(block.mlp.gate_proj, y)) * self._lin(
            block.mlp.up_proj, y)
        return x + self._lin(block.mlp.down_proj, act)

    def forward(self, patches: torch.Tensor, grid: Tuple[int, int, int],
                attn_impl: Optional[str] = None) -> torch.Tensor:
        """``patches [N, L, patch_dim]`` (canonical processor order; ``L``
        must be ``t * h * w`` of ``grid``) -> ``[N, n_units,
        out_hidden_size]``; ``attn_impl`` reaches
        ``ops/attention.py::attention``."""
        cfg, cd = self.config, self.compute_dtype
        N, L, _ = patches.shape
        if L != grid[0] * grid[1] * grid[2]:
            raise ValueError(f"patch count {L} != grid {tuple(grid)}")
        lay = self.layout(grid)
        t_frames = int(grid[0])
        x = F.linear(patches.to(cd), self.patch_embed.weight.to(cd))
        full_blocks = set(cfg.fullatt_block_indexes)
        remat = self.remat and torch.is_grad_enabled()
        policy = resolve_remat_policy("nothing_saveable")
        for i, block in enumerate(self.blocks):
            fn = functools.partial(self._block, block, lay=lay,
                                   full=i in full_blocks, t_frames=t_frames,
                                   attn_impl=attn_impl)
            x = checkpoint_layer(fn, x, policy=policy) if remat else fn(x)
        mg = self.merger
        y = mg.ln_q(x).reshape(N, lay["n_units"],
                               lay["unit"] * cfg.hidden_size)
        y = F.gelu(self._lin(mg.fc1, y), approximate="none")
        return self._lin(mg.fc2, y)


class Qwen25VLTextModel(LlamaForCausalLM):
    """Qwen2's decoder with the 3-section rope: ``position_ids [B, S]``
    take the plain rope (text only: the three sections then share
    positions), ``[B, S, 3]`` (temporal, height, width) the M-RoPE."""

    def __init__(self, config: LlamaConfig, mrope_section=None, **kwargs):
        super().__init__(config, **kwargs)
        if mrope_section is None:
            mrope_section = _mrope_section_of(config)
        half = config.head_dim // 2
        if sum(mrope_section) != half:
            raise ValueError(f"mrope_section {tuple(mrope_section)} does not "
                             f"sum to head_dim / 2 = {half}")
        # each rotary channel's axis (t, h or w): the row of the JAX
        # one-hot section selector that is 1 in its column (not a buffer:
        # ``num_params`` counts weight buffers)
        self.mrope_axis = torch.from_numpy(np.repeat(
            np.arange(3), np.asarray(mrope_section))).to(
                self.inv_freq.device)

    def _apply_rope(self, q: torch.Tensor, k: torch.Tensor,
                    position_ids: torch.Tensor):
        if position_ids.dim() == 2:
            return super()._apply_rope(q, k, position_ids)
        # HF apply_multimodal_rotary_pos_emb: the first half's channels
        # split into t / h / w blocks, the second half mirrors them
        B, S, _ = position_ids.shape
        angles3 = (position_ids.float()[..., None]
                   * self.inv_freq[None, None, None, :])     # [B, S, 3, half]
        axis = self.mrope_axis.view(1, 1, 1, -1).expand(B, S, 1, -1)
        angles = angles3.gather(2, axis).squeeze(2)          # [B, S, half]
        scale = self.rope_attention_scaling
        cos = torch.cos(angles)[:, :, None, :] * scale
        sin = torch.sin(angles)[:, :, None, :] * scale

        def rot(x):
            x1, x2 = x.float().chunk(2, dim=-1)
            return torch.cat([(x1 * cos - x2 * sin).to(x.dtype),
                              (x2 * cos + x1 * sin).to(x.dtype)], dim=-1)

        return rot(q), rot(k)


class Qwen25VLForConditionalGeneration(nn.Module):
    """``model._target_: automodel_tpu.models.qwen2_5_vl.build_qwen25_vl``
    (or an HF directory through ``AutoModelForImageTextToText``).

    ``image_grid`` / ``video_grid``: the ``(t, h, w)`` patch grid the tower
    runs each image / video at.  ``image_grid_thw`` / ``video_grid_thw``
    are accepted as batch data; the VLM recipe holds them against the
    grids on the host (``recipes/vlm/finetune.py``), and
    :meth:`encode_images` refuses a patch count the grid does not
    divide."""

    extra_batch_keys = ("image_grid_thw", "pixel_values_videos",
                        "video_grid_thw")

    def __init__(self, config: Qwen25VLConfig, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, remat: bool = True,
                 image_grid: Optional[Tuple] = None,
                 video_grid: Optional[Tuple] = None, device=None, **kwargs):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.param_dtype = as_dtype(param_dtype)
        self.compute_dtype = as_dtype(compute_dtype)
        self.image_grid = tuple(image_grid) if image_grid else None
        self.video_grid = tuple(video_grid) if video_grid else None
        self.language_model = Qwen25VLTextModel(
            config.text_config, mrope_section=config.mrope_section,
            param_dtype=param_dtype, compute_dtype=compute_dtype,
            remat=remat, device=device, **kwargs)
        self.visual = Qwen25VisionTower(
            config.vision_config, param_dtype=self.param_dtype,
            compute_dtype=self.compute_dtype, remat=remat, device=device)

    # the decoder's knobs, as the first-step checks set them
    remat_policy = property(
        lambda self: self.language_model.remat_policy,
        lambda self, v: setattr(self.language_model, "remat_policy", v))
    qdot_impl = property(
        lambda self: self.language_model.qdot_impl,
        lambda self, v: setattr(self.language_model, "qdot_impl", v))

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "Qwen25VLForConditionalGeneration":
        """The decoder's weights from ``seed``, the tower's from ``seed +
        1``."""
        self.language_model.init_weights(seed)
        dev = self.language_model.inv_freq.device
        self.visual.init_weights(
            torch.Generator(device=dev).manual_seed(seed + 1))
        return self

    def jax_tree_leaves(self) -> Iterator[Tuple[Tuple[str, ...], Any, bool]]:
        for path, t, tr in jax_leaves(self.language_model):
            yield ("language_model",) + path, t, tr
        for path, t, tr in self.visual.jax_tree_leaves():
            yield ("visual",) + path, t, tr

    def init_kv_cache(self, batch: int, max_len: int, dtype=None):
        """The decoder's dense decode cache (``generate()``, whose 1-D
        positions take the plain rope, as in JAX)."""
        return self.language_model.init_kv_cache(batch, max_len, dtype)

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self) -> float:
        return self.language_model.flops_per_token()

    def attention_flops_per_token(self, seq_len: int,
                                  causal: bool = True) -> float:
        return self.language_model.attention_flops_per_token(seq_len, causal)

    def encode_images(self, pixel_values: torch.Tensor,
                      grid: Tuple[int, int, int],
                      attn_impl: Optional[str] = None) -> torch.Tensor:
        """Flat HF patches ``[n_patches, patch_dim]`` -> merged features
        ``[n_items * n_units, out_hidden_size]`` (the placeholders'
        order)."""
        t, h, w = grid
        L = t * h * w
        if pixel_values.shape[0] % L != 0:
            raise ValueError(
                f"pixel patch count {pixel_values.shape[0]} does not divide "
                f"the grid {tuple(grid)} ({L} patches per item): the batch "
                "was produced for a different resolution; group batches by "
                "grid at the collator or set model.image_grid/video_grid to "
                "match the processor's output")
        n = pixel_values.shape[0] // L
        feats = self.visual(pixel_values.reshape(n, L, -1), grid,
                            attn_impl=attn_impl)
        return feats.reshape(n * feats.shape[1], feats.shape[2])

    @staticmethod
    def _scatter_modality(embeds, input_ids, feats, token_id):
        """The merged vision features onto their placeholder tokens, in
        order over the whole batch."""
        B, S = input_ids.shape
        is_tok = (input_ids == token_id).reshape(-1)
        idx = (torch.cumsum(is_tok.long(), 0) - 1).clamp(0, feats.shape[0]
                                                         - 1)
        gathered = feats[idx].reshape(B, S, -1)
        return torch.where(is_tok.reshape(B, S)[..., None],
                           gathered.to(embeds.dtype), embeds)

    def forward(self, input_ids: torch.Tensor,
                pixel_values: Optional[torch.Tensor] = None,
                image_grid_thw: Optional[torch.Tensor] = None,
                pixel_values_videos: Optional[torch.Tensor] = None,
                video_grid_thw: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                attn_impl: Optional[str] = None,
                **kwargs) -> Dict[str, torch.Tensor]:
        """The decoder's forward with the image and video features over
        their placeholders; ``position_ids`` ``[B, S, 3]`` (M-RoPE) or
        ``[B, S]``; the other arguments are the decoder's."""
        lm = self.language_model
        embeds = lm._embed(input_ids)
        for pixels, grid, token, name in (
                (pixel_values, self.image_grid, self.config.image_token_id,
                 "image"),
                (pixel_values_videos, self.video_grid,
                 self.config.video_token_id, "video")):
            if pixels is None:
                continue
            if grid is None:
                raise ValueError(
                    f"Qwen2.5-VL needs a fixed {name}_grid=(t, h, w) to "
                    f"consume its {name} patches: set model.{name}_grid "
                    f"({name}_grid_thw rows are data, not shapes)")
            feats = self.encode_images(pixels, grid, attn_impl=attn_impl)
            embeds = self._scatter_modality(embeds, input_ids, feats, token)
        if (position_ids is not None and position_ids.dim() == 3
                and position_ids.shape[-1] != 3):
            raise ValueError("M-RoPE position_ids must be [B, S, 3]")
        return lm(input_ids, position_ids=position_ids, attn_impl=attn_impl,
                  inputs_embeds=embeds, **kwargs)


def build_qwen25_vl(config: Optional[dict] = None, *, seed: int = 0,
                    device=None, **kwargs) -> Qwen25VLForConditionalGeneration:
    """The YAML entry (``model._target_``): an HF-style config dict (or
    none: the published defaults), weights drawn from ``seed``."""
    if config is not None:
        if hasattr(config, "to_dict"):
            config = config.to_dict()
        cfg = Qwen25VLConfig.from_hf_config(config)
    else:
        cfg = Qwen25VLConfig()
    return Qwen25VLForConditionalGeneration(
        cfg, device=device, **kwargs).init_weights(seed)
