"""Grouped matmuls of the sorted mixture-of-experts path: the ctypes
wrappers of ``csrc/gmm.cu``, their plain PyTorch versions and the
``torch.autograd.Function`` that joins them (counterpart:
``automodel_tpu/ops/gmm_kernel.py``).

The rows of ``lhs [m, k]`` are contiguous per-group segments sized by
``group_sizes [E]`` (int, on the operands' device):

* ``gmm(lhs, rhs [E, k, n], group_sizes) -> [m, n]``: ``out[rows of g] =
  lhs[rows of g] @ rhs[g]``; rows past ``sum(group_sizes)`` give 0 and get
  a zero gradient;
* ``tgmm(lhs, dout [m, n], group_sizes) -> [E, k, n]``: ``lhs[rows of
  g]^T @ dout[rows of g]``, the grouped weight gradient; an empty group's
  block is exactly 0.

TPU kernels replaced, and what bounds the replacements on the H100:

* ``_gmm_kernel`` (``automodel_tpu/ops/gmm_kernel.py:187``, launched at
  ``:225``) by ``gmm_fwd`` (kernel 5), which also serves the backward's
  ``dlhs = gmm(dout, rhs^T)`` reading ``rhs`` transposed in place;
* ``_tgmm_kernel`` (``:256``, launched at ``:290``) by ``tgmm`` (kernel 6).

Both are bound by their ``2 (sum of group sizes) k n`` operations on the
bf16 tensor cores.  ``csrc/gmm.cu`` says how each CTA finds its groups on
the device; the wrapper only hands it the prefix sum of ``group_sizes``
(one ``torch.cumsum``, no host sync per call).

``gmm_launches`` and ``tgmm_launches`` count the kernels' launches.  There
is no fallback: :func:`gmm` and :func:`tgmm` take the plain versions only
for CPU tensors or when asked by ``impl="plain"``; on CUDA tensors they
launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

# kernel launches in this process (reset by callers that count a window)
gmm_launches = 0
tgmm_launches = 0

_fns = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from automodel_tpu_torch.ops.kernel_lib import build

        fn = getattr(build.load("gmm"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {
            "gmm_fwd": [p, p, p, p, i, i, i, i, i, p],  # lhs rhs ends out m K N E trans stream
            "tgmm": [p, p, p, p, i, i, i, i, p],        # lhs dout ends out m K N E stream
        }[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"gmm: {msg}")


def _operand(t: torch.Tensor, name: str, dev: torch.device) -> None:
    _check(t.device == dev, f"{name} on {t.device}, lhs on {dev}")
    _check(t.dtype == torch.bfloat16,
           f"{name} is {t.dtype}; the kernels take bfloat16 (run "
           "impl='plain' for other dtypes)")
    _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def _ends(group_sizes: torch.Tensor, E: int, dev: torch.device
          ) -> torch.Tensor:
    _check(tuple(group_sizes.shape) == (E,) and group_sizes.device == dev,
           f"group_sizes must be [{E}] on {dev}, got "
           f"{tuple(group_sizes.shape)} on {group_sizes.device}")
    return torch.cumsum(group_sizes, 0, dtype=torch.int32)


def _launch(name: str, *args) -> None:
    rc = _kernel(name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed (code {rc})")


def gmm_cuda(lhs: torch.Tensor, rhs: torch.Tensor,
             group_sizes: torch.Tensor, trans_rhs: bool = False
             ) -> torch.Tensor:
    """Launch ``gmm_fwd``: ``lhs [m, K]`` bf16 against ``rhs [E, K, N]``,
    or with ``trans_rhs`` against ``rhs [E, N, K]`` read as ``rhs[g]^T``
    -> ``[m, N]`` bf16."""
    global gmm_launches
    _check(lhs.is_cuda, f"lhs must be a CUDA tensor, got {lhs.device}")
    _check(lhs.dim() == 2 and rhs.dim() == 3,
           f"lhs [m, k] and rhs [E, k, n], got {tuple(lhs.shape)} and "
           f"{tuple(rhs.shape)}")
    m, K = lhs.shape
    E = rhs.shape[0]
    N, rk = (rhs.shape[1], rhs.shape[2]) if trans_rhs else (rhs.shape[2],
                                                            rhs.shape[1])
    _check(rk == K, f"rhs {tuple(rhs.shape)} does not fit lhs "
                    f"{tuple(lhs.shape)} (trans_rhs={trans_rhs})")
    _check(K % 8 == 0 and N % 8 == 0 and K > 0 and N > 0,
           f"k={K} and n={N} must be positive multiples of 8")
    for name, t in (("lhs", lhs), ("rhs", rhs)):
        _operand(t, name, lhs.device)
    out = torch.empty(m, N, dtype=lhs.dtype, device=lhs.device)
    if m == 0:
        return out
    with torch.cuda.device(lhs.device):
        ends = _ends(group_sizes, E, lhs.device)
        _launch("gmm_fwd", lhs.data_ptr(), rhs.data_ptr(), ends.data_ptr(),
                out.data_ptr(), m, K, N, E, int(bool(trans_rhs)),
                torch.cuda.current_stream(lhs.device).cuda_stream)
    gmm_launches += 1
    return out


def tgmm_cuda(lhs: torch.Tensor, dout: torch.Tensor,
              group_sizes: torch.Tensor) -> torch.Tensor:
    """Launch ``tgmm``: ``lhs [m, K]``, ``dout [m, N]`` bf16 -> ``[E, K,
    N]`` bf16."""
    global tgmm_launches
    _check(lhs.is_cuda, f"lhs must be a CUDA tensor, got {lhs.device}")
    _check(lhs.dim() == 2 and dout.dim() == 2
           and dout.shape[0] == lhs.shape[0],
           f"lhs [m, k] and dout [m, n], got {tuple(lhs.shape)} and "
           f"{tuple(dout.shape)}")
    m, K = lhs.shape
    N = dout.shape[1]
    E = group_sizes.shape[0]
    _check(K % 8 == 0 and N % 8 == 0 and K > 0 and N > 0,
           f"k={K} and n={N} must be positive multiples of 8")
    for name, t in (("lhs", lhs), ("dout", dout)):
        _operand(t, name, lhs.device)
    if m == 0:
        return torch.zeros(E, K, N, dtype=lhs.dtype, device=lhs.device)
    out = torch.empty(E, K, N, dtype=lhs.dtype, device=lhs.device)
    with torch.cuda.device(lhs.device):
        ends = _ends(group_sizes, E, lhs.device)
        _launch("tgmm", lhs.data_ptr(), dout.data_ptr(), ends.data_ptr(),
                out.data_ptr(), m, K, N, E,
                torch.cuda.current_stream(lhs.device).cuda_stream)
    tgmm_launches += 1
    return out


# ---------------------------------------------------------------------------
# plain versions: fp32 torch, one product per group segment
# ---------------------------------------------------------------------------
def _segments(group_sizes: torch.Tensor, m: int):
    """``(g, lo, hi)`` of every group, rows clipped to ``[0, m)`` (reads
    the sizes on the host)."""
    lo = 0
    for g, size in enumerate(group_sizes.tolist()):
        hi = min(lo + int(size), m)
        yield g, min(lo, m), hi
        lo += int(size)


def gmm_plain(lhs: torch.Tensor, rhs: torch.Tensor,
              group_sizes: torch.Tensor, trans_rhs: bool = False
              ) -> torch.Tensor:
    """The per-group segment loop of ``_gmm_reference``
    (``automodel_tpu/ops/gmm_kernel.py:439``) in fp32, cast to lhs's
    dtype; ``trans_rhs`` multiplies by ``rhs[g]^T``."""
    m = lhs.shape[0]
    n = rhs.shape[1] if trans_rhs else rhs.shape[2]
    out = torch.zeros(m, n, dtype=torch.float32, device=lhs.device)
    for g, lo, hi in _segments(group_sizes, m):
        if hi > lo:
            w = rhs[g].float()
            out[lo:hi] = lhs[lo:hi].float() @ (w.t() if trans_rhs else w)
    return out.to(lhs.dtype)


def tgmm_plain(lhs: torch.Tensor, dout: torch.Tensor,
               group_sizes: torch.Tensor) -> torch.Tensor:
    """Per group ``lhs[rows of g]^T @ dout[rows of g]`` in fp32 (0 for an
    empty group), cast to lhs's dtype."""
    m, k = lhs.shape
    out = torch.zeros(group_sizes.shape[0], k, dout.shape[1],
                      dtype=torch.float32, device=lhs.device)
    for g, lo, hi in _segments(group_sizes, m):
        if hi > lo:
            out[g] = lhs[lo:hi].float().t() @ dout[lo:hi].float()
    return out.to(lhs.dtype)


def _run_gmm(lhs, rhs, group_sizes, impl, trans_rhs=False):
    if impl == "kernel":
        return gmm_cuda(lhs, rhs, group_sizes, trans_rhs)
    return gmm_plain(lhs, rhs, group_sizes, trans_rhs)


def _run_tgmm(lhs, dout, group_sizes, impl):
    if impl == "kernel":
        return tgmm_cuda(lhs, dout, group_sizes)
    return tgmm_plain(lhs, dout, group_sizes)


class GroupedMatmul(torch.autograd.Function):
    """``gmm`` with the backward of the TPU kernel's custom VJP
    (``_gmm_pallas_diff``, ``ops/gmm_kernel.py:317-335``): ``dlhs =
    gmm(dout, rhs^T)`` and ``drhs = tgmm(lhs, dout)``, each computed only
    when its input needs it."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, impl):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        ctx.impl = impl
        return _run_gmm(lhs, rhs, group_sizes, impl)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, group_sizes = ctx.saved_tensors
        dout = dout.to(lhs.dtype).contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = _run_gmm(dout, rhs, group_sizes, ctx.impl, trans_rhs=True)
        if ctx.needs_input_grad[1]:
            drhs = _run_tgmm(lhs, dout, group_sizes, ctx.impl).to(rhs.dtype)
        return dlhs, drhs, None, None


def _impl(t: torch.Tensor, impl: Optional[str]) -> str:
    impl = impl or ("kernel" if t.is_cuda else "plain")
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    return impl


def _check_block_rows(block_rows: int) -> None:
    # ``block_aligned`` / ``block_rows`` pick the JAX package's block-segment
    # XLA fallback; the kernels here are right without the promise
    _check(int(block_rows) > 0, f"block_rows must be > 0, got {block_rows}")


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, *,
        block_aligned: bool = False, block_rows: int = 128,
        impl: Optional[str] = None) -> torch.Tensor:
    """Differentiable grouped matmul: ``lhs [m, k]`` rows in contiguous
    per-group segments sized by ``group_sizes [E]``, each times ``rhs [E,
    k, n]`` -> ``[m, n]`` in lhs's dtype; rows past ``sum(group_sizes)``
    give 0.  ``block_aligned`` / ``block_rows`` are the JAX signature's
    promise (every group a multiple of ``block_rows`` rows); it is
    accepted and not needed.  ``impl`` None takes the kernels for CUDA
    tensors and the plain versions for CPU tensors; ``"kernel"`` /
    ``"plain"`` force one."""
    _check_block_rows(block_rows)
    if rhs.dtype != lhs.dtype:
        rhs = rhs.to(lhs.dtype)
    return GroupedMatmul.apply(lhs, rhs, group_sizes, _impl(lhs, impl))


def tgmm(lhs: torch.Tensor, dout: torch.Tensor, group_sizes: torch.Tensor,
         *, block_aligned: bool = False, block_rows: int = 128,
         impl: Optional[str] = None) -> torch.Tensor:
    """Per-group ``lhs[rows of g]^T @ dout[rows of g]`` -> ``[E, k, n]``
    in lhs's dtype (the grouped weight gradient; not differentiated)."""
    _check_block_rows(block_rows)
    if dout.dtype != lhs.dtype:
        dout = dout.to(lhs.dtype)
    return _run_tgmm(lhs, dout, group_sizes, _impl(lhs, impl))
