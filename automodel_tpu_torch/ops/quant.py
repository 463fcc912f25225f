"""Quantized matmul with dynamic scaling: fp8/int8 training compute
(counterpart: ``automodel_tpu/ops/quant.py``).

:func:`qdot` is a drop-in for ``x @ w`` (``w`` in the JAX layout ``[K,
N]``; the models pass the ``[K, N]`` view of an ``nn.Linear`` weight
``[N, K]``) whose forward and both backward products are quantized:

* forward: e4m3 (or int8) x e4m3, accumulated in fp32 (int32 for int8),
  rescaled;
* backward: the incoming gradient in e5m2 (wider range), weights and
  activations in e4m3; int8 throughout for the int8 recipe.

Scales are dynamic per call: ``tensorwise`` (one per operand) or
``rowwise`` (per output row of ``a`` and output column of ``b``; never
along the contraction).  Every product is ``a [m, k] @ b [k, n]`` with
broadcast scales ``sa [m|1, 1]`` / ``sb [1, n|1]``; :func:`quantized_matmul`
computes the scales and hands the operands to ``ops/qdot_kernel.py``
(the hand-written ``csrc/qdot.cu`` on the card; the plain version on the
CPU).

Quantization is bit-for-bit the JAX package's: ``x / scale`` in fp32 (a
true division: scales are divided by a tensor, never multiplied by a
reciprocal, which torch does for a Python-number divisor on the card),
then int8: round half to even and clip to +-127; fp8: clip to +-qmax and
round to nearest even into ``float8_e4m3fn`` / ``float8_e5m2``.  The int8
KV-cache write (``serving/kv_cache.py``) uses the int8 branch of
:func:`quant_cast`.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0
INT8_MAX = 127.0

Recipe = Literal["tensorwise", "rowwise"]

# ``fp8.dtype`` / ``fp8.recipe_name`` config domains (enum-checked at
# config load, ``config/loader.py::validate_config_enums``)
QUANT_DTYPES = ("float8", "int8")
QUANT_RECIPES = ("tensorwise", "rowwise")
DEFAULT_QUANT_DTYPE = "float8"
DEFAULT_QUANT_RECIPE = "tensorwise"


def _normalize_null(v):
    """YAML null spellings ("none", "null", "") mean the default."""
    if isinstance(v, str) and v.lower() in ("none", "null", ""):
        return None
    return v


def normalize_quant_dtype(v):
    return _normalize_null(v)


def validate_quant_dtype(v: Optional[str]) -> Optional[str]:
    if v is None:
        return None
    if v not in QUANT_DTYPES:
        raise ValueError(
            f"fp8.dtype must be one of {list(QUANT_DTYPES)}, got {v!r}")
    return v


def normalize_quant_recipe(v):
    return _normalize_null(v)


def validate_quant_recipe(v: Optional[str]) -> Optional[str]:
    if v is None:
        return None
    if v not in QUANT_RECIPES:
        raise ValueError(
            f"fp8.recipe_name must be one of {list(QUANT_RECIPES)}, "
            f"got {v!r}")
    return v


@dataclasses.dataclass
class QuantConfig:
    """Knobs of fp8/int8 compute (YAML: the ``fp8:`` section)."""

    enabled: bool = False
    recipe_name: Recipe = DEFAULT_QUANT_RECIPE
    dtype: str = DEFAULT_QUANT_DTYPE   # "float8" | "int8"
    filter_fqns: list = dataclasses.field(default_factory=list)
    emulate: bool = False      # accepted for the reference's schema

    def __post_init__(self):
        self.recipe_name = (validate_quant_recipe(
            normalize_quant_recipe(self.recipe_name))
            or DEFAULT_QUANT_RECIPE)
        self.dtype = (validate_quant_dtype(normalize_quant_dtype(self.dtype))
                      or DEFAULT_QUANT_DTYPE)


def quant_for(cfg: Optional[QuantConfig], name: str
              ) -> Optional[QuantConfig]:
    """``cfg`` unless quantized compute is off or ``name`` contains one of
    ``filter_fqns``: the one filtering rule of the dense projections
    (:func:`maybe_qdot`) and the MoE grouped matmuls (``ops/moe.py``)."""
    if cfg is None or not cfg.enabled:
        return None
    if any(f in name for f in cfg.filter_fqns):
        return None
    return cfg


# ---------------------------------------------------------------------------
# quantization helpers (shared by qdot and the MoE grouped matmuls)
# ---------------------------------------------------------------------------
def qmax_for(qdtype: torch.dtype) -> float:
    if qdtype == torch.int8:
        return INT8_MAX
    if qdtype == torch.float8_e5m2:
        return E5M2_MAX
    return E4M3_MAX


def amax(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """``max |x|`` over ``dim`` (None: all) as fp32: one abs-max reduction
    over ``x`` in its own dtype (exact: the max is one of the values), no
    fp32 copy of ``x``."""
    return torch.linalg.vector_norm(x, ord=float("inf"), dim=dim,
                                    keepdim=keepdim).float()


def _amax(x: torch.Tensor, dim, keepdim: bool) -> torch.Tensor:
    """``max |x|`` in fp32 over ``dim`` (None: all), floored at 1e-12."""
    return amax(x, dim, keepdim).clamp(min=1e-12)


def scale_from_amax(a: torch.Tensor, qdtype: torch.dtype) -> torch.Tensor:
    """``a / qmax`` as a true fp32 division (a tensor divisor)."""
    return a / torch.full((), qmax_for(qdtype), dtype=torch.float32,
                          device=a.device)


def quant_cast(x: torch.Tensor, scale: torch.Tensor,
               qdtype: torch.dtype = torch.int8) -> torch.Tensor:
    """``x / scale`` in fp32 rounded/clipped into ``qdtype`` (int8: round
    half to even, then clip to +-127; fp8: clip to +-qmax, then round to
    nearest even)."""
    # bf16 / fp32 x over an fp32 scale divides in fp32 (no fp32 copy of x)
    xs = torch.div(x, scale.float())
    if qdtype == torch.int8:
        return torch.clamp(torch.round(xs), -INT8_MAX, INT8_MAX).to(
            torch.int8)
    qmax = qmax_for(qdtype)
    return torch.clamp(xs, -qmax, qmax).to(qdtype)


def _operand_scales(a: torch.Tensor, b: torch.Tensor, a_qdtype, b_qdtype,
                    rowwise: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Broadcast-ready dynamic scales for ``a [m, k] @ b [k, n]``: ``sa
    [m, 1] | [1, 1]`` and ``sb [1, n] | [1, 1]``.  Rowwise scales live on
    the output dimensions, never on the contraction, so the rescale is
    ``out * sa * sb``."""
    if rowwise:
        sa = scale_from_amax(_amax(a, 1, True), a_qdtype)       # [m, 1]
        sb = scale_from_amax(_amax(b, 0, True), b_qdtype)       # [1, n]
    else:
        sa = scale_from_amax(_amax(a, None, False), a_qdtype).reshape(1, 1)
        sb = scale_from_amax(_amax(b, None, False), b_qdtype).reshape(1, 1)
    return sa, sb


def accum_dtype(a_qdtype, b_qdtype) -> torch.dtype:
    """int32 for int8 x int8 (exact), fp32 when an operand is fp8."""
    if a_qdtype == torch.int8 and b_qdtype == torch.int8:
        return torch.int32
    return torch.float32


def quantized_matmul(a: torch.Tensor, b: torch.Tensor, *, a_qdtype,
                     b_qdtype, rowwise: bool,
                     out: Optional[torch.Tensor] = None,
                     out_dtype: torch.dtype = torch.float32,
                     impl: Optional[str] = None) -> torch.Tensor:
    """One dynamically scaled quantized product ``a [m, k] @ b [k, n]``
    (each operand row-major or the transpose view of a row-major tensor,
    read in place by the kernel) -> ``[m, n]`` in ``out_dtype`` (into
    ``out`` when given).  The scales are computed here, so the kernel and
    the plain version quantize the same numbers."""
    from automodel_tpu_torch.ops import qdot_kernel

    sa, sb = _operand_scales(a, b, a_qdtype, b_qdtype, rowwise)
    return qdot_kernel.qdot(a, b, sa, sb, a_qdtype, b_qdtype, out=out,
                            out_dtype=out_dtype, impl=impl)


def _gemm_dtypes(dtype: str, grad_operand: Optional[str]):
    """(a_qdtype, b_qdtype) of one of the three products; ``grad_operand``
    names the side that carries the incoming gradient ("a" | "b" | None):
    gradients in e5m2, weights and activations in e4m3; int8 throughout for
    the int8 recipe."""
    if dtype == "int8":
        return torch.int8, torch.int8
    g, o = torch.float8_e5m2, torch.float8_e4m3fn
    if grad_operand == "a":
        return g, o
    if grad_operand == "b":
        return o, g
    return o, o


# ---------------------------------------------------------------------------
# qdot: the quantized drop-in for ``x @ w`` with the three-product backward
# ---------------------------------------------------------------------------
class QDot(torch.autograd.Function):
    """``x [..., K] @ w [K, N]`` quantized, with JAX's custom VJP
    (``automodel_tpu/ops/quant.py:220-253``): ``x`` and ``w`` are saved
    unquantized and re-quantized in the backward, ``dx = g @ w^T`` and
    ``dw = x^T @ g``, each with its own rowwise axes.  On the card every
    product reads its operands in place (``w^T`` is the ``[N, K]`` weight
    storage, ``x^T`` and ``g`` the activations' row-major storage) and
    ``dw`` is written straight into the ``[N, K]`` layout of ``w``'s
    storage when ``w`` is the transpose view of a row-major tensor."""

    @staticmethod
    def forward(ctx, x, w, recipe, dtype, impl):
        ctx.save_for_backward(x, w)
        ctx.cfg = (recipe, dtype, impl)
        rowwise = recipe == "rowwise"
        a_q, b_q = _gemm_dtypes(dtype, None)
        x2 = x.reshape(-1, x.shape[-1])
        out = quantized_matmul(x2, w, a_qdtype=a_q, b_qdtype=b_q,
                               rowwise=rowwise, out_dtype=x.dtype, impl=impl)
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        recipe, dtype, impl = ctx.cfg
        rowwise = recipe == "rowwise"
        g2 = g.to(x.dtype).reshape(-1, g.shape[-1]).contiguous()
        x2 = x.reshape(-1, x.shape[-1])
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dx = g @ w^T (contract over N; g is operand a)
            a_q, b_q = _gemm_dtypes(dtype, "a")
            dx = quantized_matmul(g2, w.t(), a_qdtype=a_q, b_qdtype=b_q,
                                  rowwise=rowwise, out_dtype=x.dtype,
                                  impl=impl).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            # dw = x^T @ g (contract over the rows; g is operand b), written
            # in w's storage order
            a_q, b_q = _gemm_dtypes(dtype, "b")
            store = (torch.empty_like(w.t()).t()
                     if w.stride(0) == 1 and not w.is_contiguous()
                     else torch.empty(w.shape, dtype=w.dtype,
                                      device=w.device))
            dw = quantized_matmul(x2.t(), g2, a_qdtype=a_q, b_qdtype=b_q,
                                  rowwise=rowwise, out=store, impl=impl)
        return dx, dw, None, None, None


def qdot(x: torch.Tensor, w: torch.Tensor, recipe: Recipe = "tensorwise",
         dtype: str = "float8", impl: Optional[str] = None) -> torch.Tensor:
    """Quantized ``x @ w`` (``[..., K] @ [K, N]``) in ``x``'s dtype, with
    the three-product backward.  ``impl`` None takes the kernel for CUDA
    tensors and the plain version for CPU tensors; ``"kernel"`` /
    ``"plain"`` force one."""
    return QDot.apply(x, w, recipe, dtype, impl)


def maybe_qdot(x: torch.Tensor, w: torch.Tensor,
               cfg: Optional[QuantConfig], name: str = "",
               impl: Optional[str] = None) -> torch.Tensor:
    """``x @ w`` unless quantization is on for this product: a name that
    matches ``filter_fqns``, or a K or N that is no multiple of 16 (the
    torchao rule the JAX package keeps), stays in ``x``'s dtype."""
    cfg = quant_for(cfg, name)
    if cfg is None:
        return x @ w
    K, N = w.shape[-2], w.shape[-1]
    if K % 16 or N % 16:
        return x @ w
    return qdot(x, w, cfg.recipe_name, cfg.dtype, impl=impl)
