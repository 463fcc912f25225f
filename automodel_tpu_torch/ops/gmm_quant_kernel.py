"""Quantized grouped matmul of the sorted mixture-of-experts path: the
ctypes wrapper of ``csrc/gmm_quant.cu``, its plain PyTorch version and the
``torch.autograd.Function`` around them (counterpart:
``automodel_tpu/ops/gmm_quant_kernel.py``).

With quantized compute on (``fp8.enabled``), ``ops/moe.py``'s sorted path
runs its three SwiGLU grouped matmuls through :func:`gmm_quant`: the rows
of ``lhs [m, k]`` are per-group segments sized by ``group_sizes [E]``,
each multiplying ``rhs [E, k, n]`` on 8-bit operands with per-group
dynamic scales:

* ``rowwise``: each token row its own scale (amax over the contraction);
  the experts per (expert, output column);
* ``tensorwise``: one scale per group on both sides (a scatter-max over
  the group's row amaxes; rows past the groups form a slot of their own).

Scales never ride the contraction, so the result is ``(raw[r] *
s_lhs[r]) * s_rhs[group(r)]``.  The backward: ``dlhs = gmm_quant(dout,
rhs^T)`` with the gradient in e5m2 (int8 for the int8 recipe) against the
weights in e4m3, its scales taken on the swapped operand; ``drhs =
tgmm(lhs, dout)`` in the compute dtype through the bf16 ``tgmm`` kernel
(``ops/gmm_kernel.py``).

The scales are computed here (eager torch reductions, no host sync); the
operands' quantization, the grouped product and the rescale are the
kernel's.  It reads ``lhs`` and the experts in place -- the forward's
``rhs [E, k, n]`` and the backward's ``rhs^T``, the transpose view of the
experts' own storage -- and writes the 8-bit codes once, K-major, into
scratch copies allocated here.

TPU kernel replaced: ``_gmm_quant_pallas_impl``
(``automodel_tpu/ops/gmm_quant_kernel.py:182``, the gmm Pallas body
``gmm_kernel.py:187`` with an int32 / fp32 accumulator), with the
``quant_cast`` of its operands and the caller's ``_rescale``, which the JAX
package runs around it in XLA, in the same kernel launch.
``gmm_quant_launches`` counts its launches (forward and dlhs).  There is
no fallback: on CUDA tensors the kernel is launched or the call raises;
the plain version runs for CPU tensors or with ``impl="plain"``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from automodel_tpu_torch.ops import gmm_kernel
from automodel_tpu_torch.ops.qdot_kernel import PAIRS, QCODES
from automodel_tpu_torch.ops.quant import (
    _gemm_dtypes,
    amax,
    quant_cast,
    scale_from_amax,
)

# kernel launches in this process (reset by callers that count a window)
gmm_quant_launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from automodel_tpu_torch.ops.kernel_lib import build

        fn = build.load("gmm_quant").gmm_quant
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # lhs rhs rhs_e rhs_ld rhs_kmajor ends s_lhs s_rhs srhs_e srhs_n
        # lhs_q rhs_q out m K N E out_bf16 qa qb stream
        fn.argtypes = [p, p, ll, ll, i, p, p, p, i, i, p, p, p, i, i, i, i, i,
                       i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"gmm_quant: {msg}")


# ---------------------------------------------------------------------------
# per-group dynamic scales
# ---------------------------------------------------------------------------
def _row_group_ids(group_sizes: torch.Tensor, m: int) -> torch.Tensor:
    """Group id of every buffer row; rows past ``sum(group_sizes)`` get
    E."""
    ends = torch.cumsum(group_sizes.long(), 0)
    rows = torch.arange(m, device=group_sizes.device)
    return torch.searchsorted(ends, rows, right=True)


def lhs_scales(lhs: torch.Tensor, group_sizes: torch.Tensor, qdtype,
               recipe: str) -> torch.Tensor:
    """Per-row scale column ``[m, 1]``: each row's own amax (``rowwise``)
    or its group's amax by a scatter-max (``tensorwise``; no host sync)."""
    m = lhs.shape[0]
    row_amax = amax(lhs, 1)                                       # [m]
    if recipe == "rowwise":
        return scale_from_amax(row_amax.clamp(min=1e-12), qdtype)[:, None]
    E = group_sizes.shape[0]
    gid = _row_group_ids(group_sizes, m)
    group_amax = torch.zeros(E + 1, dtype=torch.float32,
                             device=lhs.device).scatter_reduce_(
        0, gid, row_amax, reduce="amax")
    per_row = group_amax.clamp(min=1e-12)[gid]
    return scale_from_amax(per_row, qdtype)[:, None]


def rhs_scales(rhs: torch.Tensor, qdtype, recipe: str) -> torch.Tensor:
    """Expert scales ``[E, 1, n]`` (``rowwise``: per output column) or
    ``[E, 1, 1]`` (``tensorwise``: per expert)."""
    a = amax(rhs, 1 if recipe == "rowwise" else (1, 2), keepdim=True)
    return scale_from_amax(a.clamp(min=1e-12), qdtype)


def _rescale(raw: torch.Tensor, s_lhs: torch.Tensor, s_rhs: torch.Tensor,
             group_sizes: torch.Tensor) -> torch.Tensor:
    """``raw [m, n] * s_lhs [m, 1] * s_rhs[group(row)]`` in fp32 (rows past
    the groups are 0 in ``raw``)."""
    E = group_sizes.shape[0]
    gid = _row_group_ids(group_sizes, raw.shape[0]).clamp(max=E - 1)
    return raw.float() * s_lhs * s_rhs[:, 0, :][gid]


# ---------------------------------------------------------------------------
# the kernel and its plain version: operands, scales -> rescaled product
# ---------------------------------------------------------------------------
def gmm_quant_cuda(lhs: torch.Tensor, rhs: torch.Tensor,
                   group_sizes: torch.Tensor, s_lhs: torch.Tensor,
                   s_rhs: torch.Tensor, a_qdtype: torch.dtype,
                   b_qdtype: torch.dtype,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch ``gmm_quant``: bf16 ``lhs [m, K]`` (row-major) against the
    experts ``rhs [E, K, N]`` (row-major, or the transpose view of a
    row-major ``[E, N, K]``: the backward's ``rhs^T``), quantized to
    ``a_qdtype`` / ``b_qdtype`` with ``s_lhs [m, 1]`` and ``s_rhs [E, 1,
    N|1]`` -> ``[m, N]`` fp32 or bf16."""
    global gmm_quant_launches
    _check(lhs.is_cuda, f"lhs must be a CUDA tensor, got {lhs.device}")
    _check(lhs.dim() == 2 and rhs.dim() == 3 and rhs.shape[1] == lhs.shape[1],
           f"lhs [m, K] and rhs [E, K, N], got {tuple(lhs.shape)} and "
           f"{tuple(rhs.shape)}")
    _check((a_qdtype, b_qdtype) in PAIRS,
           f"operand types ({a_qdtype}, {b_qdtype}) are not a pair "
           f"_gemm_dtypes makes: {PAIRS}")
    m, K = lhs.shape
    E, _, N = rhs.shape
    _check(K % 16 == 0 and N % 16 == 0 and K > 0 and N > 0,
           f"k={K} and n={N} must be positive multiples of 16")
    dev = lhs.device
    for name, t in (("lhs", lhs), ("rhs", rhs)):
        _check(t.device == dev and t.dtype == torch.bfloat16
               and t.data_ptr() % 16 == 0,
               f"{name} must be 16-byte aligned bfloat16 on {dev}, got "
               f"{t.dtype} on {t.device} (run impl='plain' for other dtypes)")
    _check(lhs.is_contiguous(), "lhs must be row-major")
    if rhs.stride(2) == 1:          # [E, K, N] storage: N-major experts
        rhs_kmajor, rhs_ld = 0, rhs.stride(1)
    else:                           # the transpose view of [E, N, K]
        _check(rhs.stride(1) == 1, f"rhs strides {rhs.stride()}: neither "
               "[E, K, N] nor the transpose of [E, N, K] is row-major")
        rhs_kmajor, rhs_ld = 1, rhs.stride(2)
    _check(rhs_ld % 8 == 0 and rhs.stride(0) % 8 == 0,
           f"rhs strides {rhs.stride()} must be multiples of 8")
    _check(tuple(s_lhs.shape) == (m, 1) and s_lhs.dtype == torch.float32
           and s_lhs.is_contiguous() and s_lhs.device == dev,
           f"s_lhs must be contiguous fp32 [{m}, 1], got "
           f"{tuple(s_lhs.shape)} {s_lhs.dtype}")
    _check(s_rhs.dim() == 3 and tuple(s_rhs.shape[:2]) == (E, 1)
           and s_rhs.shape[2] in (1, N) and s_rhs.dtype == torch.float32
           and s_rhs.is_contiguous() and s_rhs.device == dev,
           f"s_rhs must be contiguous fp32 [{E}, 1, {N}|1], got "
           f"{tuple(s_rhs.shape)} {s_rhs.dtype}")
    _check(tuple(group_sizes.shape) == (E,) and group_sizes.device == dev,
           f"group_sizes must be [{E}] on {dev}")
    out = torch.empty(m, N, dtype=out_dtype, device=dev)
    if m == 0:
        return out
    # the quantized copies, K-major (scratch)
    lhs_q = torch.empty(m, K, dtype=torch.uint8, device=dev)
    rhs_q = torch.empty(E, N, K, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        ends = torch.cumsum(group_sizes, 0, dtype=torch.int32)
        rc = _kernel()(
            lhs.data_ptr(), rhs.data_ptr(), rhs.stride(0), rhs_ld, rhs_kmajor,
            ends.data_ptr(), s_lhs.data_ptr(), s_rhs.data_ptr(),
            s_rhs.stride(0), int(s_rhs.shape[2] != 1), lhs_q.data_ptr(),
            rhs_q.data_ptr(), out.data_ptr(), m, K, N, E,
            int(out_dtype == torch.bfloat16), QCODES[a_qdtype],
            QCODES[b_qdtype], torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gmm_quant launch failed (code {rc})")
    gmm_quant_launches += 1
    return out


def gmm_quant_plain(lhs: torch.Tensor, rhs: torch.Tensor,
                    group_sizes: torch.Tensor, s_lhs: torch.Tensor,
                    s_rhs: torch.Tensor, a_qdtype: torch.dtype,
                    b_qdtype: torch.dtype,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The JAX package's arithmetic: ``quant_cast`` of both operands, per
    group ``lhs_q[rows of g] @ rhs_q[g]`` summed in float64 (exact for
    int8; fp8 products are exact too), rows past the groups 0, then
    :func:`_rescale` in fp32."""
    lhs_q = quant_cast(lhs, s_lhs, a_qdtype)
    rhs_q = quant_cast(rhs, s_rhs, b_qdtype)
    m = lhs_q.shape[0]
    raw = torch.zeros(m, rhs_q.shape[2], dtype=torch.float64,
                      device=lhs_q.device)
    for g, lo, hi in gmm_kernel._segments(group_sizes, m):
        if hi > lo:
            raw[lo:hi] = lhs_q[lo:hi].double() @ rhs_q[g].double()
    return _rescale(raw, s_lhs, s_rhs, group_sizes).to(out_dtype)


def _quantized_gmm(lhs, rhs, group_sizes, *, a_qdtype, b_qdtype, recipe,
                   out_dtype, impl):
    """One quantized grouped product ``lhs [m, k] x rhs [E, k, n]`` (rhs
    may be the transpose view of ``[E, n, k]``): the per-group scales, then
    the kernel or the plain version on the same scales."""
    s_lhs = lhs_scales(lhs, group_sizes, a_qdtype, recipe)
    s_rhs = rhs_scales(rhs, b_qdtype, recipe)
    run = gmm_quant_cuda if impl == "kernel" else gmm_quant_plain
    return run(lhs, rhs, group_sizes, s_lhs.contiguous(), s_rhs.contiguous(),
               a_qdtype, b_qdtype, out_dtype)


class GroupedMatmulQuant(torch.autograd.Function):
    """``gmm_quant`` with JAX's custom VJP
    (``automodel_tpu/ops/gmm_quant_kernel.py:150-169``): ``dlhs`` quantized
    against ``rhs^T``, ``drhs`` the bf16 ``tgmm``, each computed only when
    its input needs it."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, dtype, recipe, impl):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        ctx.cfg = (dtype, recipe, impl)
        a_q, b_q = _gemm_dtypes(dtype, None)
        return _quantized_gmm(lhs, rhs, group_sizes, a_qdtype=a_q,
                              b_qdtype=b_q, recipe=recipe,
                              out_dtype=lhs.dtype, impl=impl)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, group_sizes = ctx.saved_tensors
        dtype, recipe, impl = ctx.cfg
        dout = dout.to(lhs.dtype).contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            a_q, b_q = _gemm_dtypes(dtype, "a")   # the gradient is operand a
            dlhs = _quantized_gmm(dout, rhs.transpose(1, 2), group_sizes,
                                  a_qdtype=a_q, b_qdtype=b_q, recipe=recipe,
                                  out_dtype=lhs.dtype, impl=impl)
        if ctx.needs_input_grad[1]:
            drhs = gmm_kernel.tgmm(lhs, dout, group_sizes,
                                   impl=impl).to(rhs.dtype)
        return dlhs, drhs, None, None, None, None


def gmm_quant(lhs: torch.Tensor, rhs: torch.Tensor,
              group_sizes: torch.Tensor, dtype: str = "float8",
              recipe: str = "tensorwise", block_aligned: bool = False,
              block_rows: int = 128,
              impl: Optional[str] = None) -> torch.Tensor:
    """Quantized ``ops.gmm_kernel.gmm``: ``lhs [m, k]`` rows in per-group
    segments sized by ``group_sizes [E]``, each times ``rhs [E, k, n]`` on
    8-bit operands with per-group dynamic scales -> ``[m, n]`` in lhs's
    dtype; rows past the groups give 0.  Differentiable (dlhs quantized,
    drhs in the compute dtype).  ``block_aligned`` / ``block_rows`` are
    the JAX signature's promise, accepted and not needed.  ``impl`` None
    takes the kernels for CUDA tensors and the plain versions for CPU
    tensors; ``"kernel"`` / ``"plain"`` force one (``tgmm`` included)."""
    gmm_kernel._check_block_rows(block_rows)
    if rhs.dtype != lhs.dtype:
        rhs = rhs.to(lhs.dtype)
    return GroupedMatmulQuant.apply(lhs, rhs, group_sizes, dtype, recipe,
                                    gmm_kernel._impl(lhs, impl))
