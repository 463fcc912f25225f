"""Paged-decode attention kernel: the ctypes wrapper of
``csrc/paged_decode.cu`` (counterpart: ``automodel_tpu/ops/
paged_attention_kernel.py``, whose Pallas ``_decode_kernel`` it replaces).

The kernel splits each row's keys across CTAs (split-KV): :func:`split_plan`
fixes the span of keys per CTA, the number of splits and the grid from the
operands' shapes alone, so the wrapper never reads the context lengths on
the host.  Each split writes an fp32 partial (m, l, unnormalised acc) into
scratch the wrapper allocates with ``torch.empty``, and a second launch
merges them (a row whose keys all lie in one split is written by that
split, and the merge passes it by).

The wrapper checks every operand (device, dtype, shape, contiguity,
alignment) and raises on anything the kernel does not take; it allocates
the output with ``torch.empty``, launches on the current stream, raises
if a launch failed, and adds one to :data:`launches` per call (the split
and merge launches of one call count once).  It never falls back to the
plain version: :func:`~automodel_tpu_torch.ops.paged_attention.
paged_attention` picks the plain version only for CPU tensors (or when the
caller asks for it by name).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

# Chunked-q bound: decode (S=1), a verify step and chunked prefill
# (prefill_chunk <= 64) take the kernel; longer queries take the gather
# path, by the same rule as the JAX package's ``paged_decode_available``.
MAX_CHUNKED_Q = 64
BLOCK_SIZE = 16
HEAD_DIMS = (64, 128)

# Split-KV plan.  Rows fold as R = S * Hq / Hk.  bf16 q runs on the tensor
# cores: with R <= KEY_SPLIT_ROWS[1], or at a speculative verify width (S <=
# VERIFY_S), the 4 warps of a CTA split the span's pages over a tile of 16
# rows (mode 3), else they split the rows of a 64-row tile and share the
# pages (mode 2).  fp32 q runs fp32 FMAs: the warps split the pages over 4
# rows (R <= KEY_SPLIT_ROWS[0], mode 0) or a tile of 16 rows (mode 1).  A
# CTA takes SPAN_PAGES pages (256 keys) of one row and kv head, halved down
# to MIN_SPAN_PAGES while the grid would hold fewer CTAs than the card has
# SMs (PERF.md: the spans measured on the H100); in mode 3 the grid counted
# is one query token's.  So a verify step's rows take a decode step's
# mode and span: each row sums its keys in the same order (a row's sums do
# not depend on the other rows of its tile, and pages masked for it add
# exact zeros), and greedy tokens do not move when speculation is on --
# without a sliding window, whose start (the tile's earliest token's)
# moves the warps' split of the pages.
SPAN_PAGES = 16
MIN_SPAN_PAGES = 4
MAX_SPAN = 1024
KEY_SPLIT_ROWS = (8, 16)          # (fp32 q, bf16 q)
VERIFY_S = 8
ROW_TILE = (4, 16, 64, 16)        # by mode

# wrapper calls in this process (reset by callers that count a window)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_fn = None
_sm_counts = {}


class SplitPlan(NamedTuple):
    span: int                    # keys per split, whole pages
    splits: int                  # ceil(MB * BLOCK_SIZE / span)
    mode: int                    # 0, 3: warps split the keys; 1, 2: rows
    row_tile: int                # folded query rows per CTA
    tiles: int                   # row tiles: ceil(R / row_tile)
    grid: Tuple[int, int, int]   # (splits, Hk * tiles, B)


@functools.lru_cache(maxsize=256)
def split_plan(B: int, S: int, Hq: int, Hk: int, MB: int, sms: int = 132,
               span: Optional[int] = None, bf16: bool = True) -> SplitPlan:
    """The kernel's launch plan for ``q [B, S, Hq, D]`` (``bf16``: q is
    bfloat16, else float32) over tables ``[B, MB]`` on a card of ``sms``
    SMs, from shapes alone.  ``span`` (keys, a multiple of 16 up to 1024)
    overrides the choice of the span."""
    if Hk <= 0 or Hq % Hk or min(B, S, MB) <= 0:
        raise ValueError(f"split_plan: bad shapes B={B} S={S} Hq={Hq} "
                         f"Hk={Hk} MB={MB}")
    G = Hq // Hk
    R = S * G
    if bf16:
        mode = 3 if R <= KEY_SPLIT_ROWS[1] or S <= VERIFY_S else 2
    else:
        mode = 0 if R <= KEY_SPLIT_ROWS[0] else 1
    row_tile = ROW_TILE[mode]
    tiles = -(-R // row_tile)
    if span is None:
        # mode 3 sizes the grid of one query token, so S does not move it
        grid_tiles = -(-G // row_tile) if mode == 3 else tiles
        pages = min(SPAN_PAGES, MB)
        while (pages > MIN_SPAN_PAGES
               and B * Hk * grid_tiles * -(-MB // pages) < sms):
            pages //= 2
        span = pages * BLOCK_SIZE
    if span <= 0 or span % BLOCK_SIZE or span > MAX_SPAN:
        raise ValueError(f"split_plan: span {span} is not a multiple of "
                         f"{BLOCK_SIZE} in 16..{MAX_SPAN}")
    splits = -(-MB * BLOCK_SIZE // span)
    return SplitPlan(span, splits, mode, row_tile, tiles,
                     (splits, Hk * tiles, B))


def _sms(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    n = _sm_counts.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_counts[device.index] = n
    return n


def paged_decode_available(q_seq: int) -> bool:
    """True for query lengths the kernel serves (1 <= S <= 64)."""
    return 1 <= q_seq <= MAX_CHUNKED_Q


def _kernel():
    global _fn
    if _fn is None:
        from automodel_tpu_torch.ops.kernel_lib import build

        fn = build.load("paged_decode").paged_decode
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p,  # tensors, scratch
                       i, i, i, i, i, i, i, i,          # B S Hq Hk D MB dtypes
                       f, f, i,                         # scale cap window
                       i, i, i, i, p]                   # span splits mode tiles stream
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_decode_cuda: {msg}")


def paged_decode_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, k_scale: Optional[torch.Tensor],
                      v_scale: Optional[torch.Tensor],
                      block_tables: torch.Tensor, context_lens: torch.Tensor,
                      positions: torch.Tensor, *, scale: Optional[float] = None,
                      logits_soft_cap: Optional[float] = None,
                      local_window_size: Optional[int] = None,
                      span: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel: ``q [B, S, Hq, D]`` over pools ``[NB, 16,
    Hk, D]`` (+ int8 scale planes ``[NB, 16, Hk]``) -> ``[B, S, Hq, D]``
    in q's dtype.  Operand contract: ``ops/paged_attention.py``.  ``span``
    overrides :func:`split_plan`'s keys per split (a tuning knob)."""
    global launches
    _check(q.is_cuda, f"q must be a CUDA tensor, got {q.device}")
    dev = q.device
    _check(q.dim() == 4, f"q must be [B, S, Hq, D], got {tuple(q.shape)}")
    B, S, Hq, D = q.shape
    _check(paged_decode_available(S), f"q_seq {S} outside 1..{MAX_CHUNKED_Q}")
    _check(D in HEAD_DIMS, f"head_dim {D} not in {HEAD_DIMS}: the decode "
           "kernel has no tile config for it (a head_dim-96 decode, "
           "Phi-3-mini's, is ROADMAP Queue 2 C)")
    _check(q.dtype in (torch.float32, torch.bfloat16),
           f"q dtype {q.dtype} not float32/bfloat16")
    _check(k_pool.dim() == 4 and k_pool.shape == v_pool.shape,
           "pools must share one [NB, BS, Hk, D] shape")
    NB, BS, Hk, Dk = k_pool.shape
    _check(BS == BLOCK_SIZE, f"block size {BS} != {BLOCK_SIZE}")
    _check(Dk == D, f"pool head_dim {Dk} != q head_dim {D}")
    _check(Hq % Hk == 0, f"query heads {Hq} not a multiple of kv heads {Hk}")
    quantized = k_scale is not None
    _check(quantized == (v_scale is not None), "pass both scales or neither")
    kv_dtype = torch.int8 if quantized else q.dtype
    _check(k_pool.dtype == kv_dtype and v_pool.dtype == kv_dtype,
           f"pools are {k_pool.dtype}/{v_pool.dtype}, expected {kv_dtype}")
    MB = block_tables.shape[-1]
    tensors = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
               ("block_tables", block_tables),
               ("context_lens", context_lens), ("positions", positions)]
    if quantized:
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check(t.dtype == torch.float32 and tuple(t.shape) == (NB, BS, Hk),
                   f"{name} must be float32 [NB, BS, Hk]")
    for name, t, shape in (("block_tables", block_tables, (B, MB)),
                           ("context_lens", context_lens, (B,)),
                           ("positions", positions, (B, S))):
        _check(t.dtype == torch.int32 and tuple(t.shape) == shape,
               f"{name} must be int32 {shape}, got {t.dtype} "
               f"{tuple(t.shape)}")
    for name, t in tensors:
        _check(t.device == dev, f"{name} on {t.device}, q on {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    if local_window_size is not None:
        _check(local_window_size >= 1, "local_window_size must be >= 1")
    if logits_soft_cap is not None:
        _check(logits_soft_cap > 0, "logits_soft_cap must be > 0")

    plan = split_plan(B, S, Hq, Hk, MB, _sms(dev), span,
                      q.dtype == torch.bfloat16)
    out = torch.empty_like(q)
    part_ml = part_acc = None
    if plan.splits > 1:
        rows = B * Hk * plan.splits * S * (Hq // Hk)
        part = torch.empty(rows * (D + 2), dtype=torch.float32, device=dev)
        part_ml = part.data_ptr()
        part_acc = part_ml + rows * 2 * part.element_size()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel()(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            block_tables.data_ptr(), context_lens.data_ptr(),
            positions.data_ptr(), out.data_ptr(), part_ml, part_acc,
            B, S, Hq, Hk, D, MB, _DTYPE_CODE[q.dtype], _DTYPE_CODE[kv_dtype],
            D ** -0.5 if scale is None else float(scale),
            float(logits_soft_cap or 0.0), int(local_window_size or 0),
            plan.span, plan.splits, plan.mode, plan.tiles, stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed (code {rc})")
    launches += 1
    return out
