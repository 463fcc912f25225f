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
bf16 tensor cores.  Both run on the persistent ``wgmma`` + TMA mainloop
``csrc/wgmma_gemm.cuh`` over work items fixed by shapes alone;
``csrc/gmm_items.cuh`` (gmm's items, shared with ``csrc/gmm_quant.cu``)
and ``csrc/gmm.cu`` (tgmm's) say how each item finds its group on the
device.  The
wrapper hands the kernels the prefix sum of ``group_sizes`` (one
``torch.cumsum``, no host sync per call), past 1024 groups an int32
workspace for the group plan (:func:`plan_workspace`; any number of groups
is taken) and, for ``tgmm``, the row chunk of :func:`tgmm_chunk_rows` and
an fp32 workspace for groups that split.
:func:`gmm_work_items` and :func:`tgmm_work_items` mirror the kernels'
item plans in Python, for the CPU tests.

``gmm_launches`` and ``tgmm_launches`` count calls: one per call, whatever
launches the call makes (``tgmm`` adds the reduction of split groups when
a group could split).  There is no fallback: :func:`gmm` and :func:`tgmm`
take the plain versions only for CPU tensors or when asked by
``impl="plain"``; on CUDA tensors they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence

import torch

from automodel_tpu_torch.ops.kernel_lib.build import ptr
from automodel_tpu_torch.ops.qdot_kernel import _sms

# kernel launches in this process (reset by callers that count a window)
gmm_launches = 0
tgmm_launches = 0

# the kernels' tiles (csrc/gmm.cu on wgmma_gemm.cuh): 128 x 256 outputs,
# 64-deep stages; the group plan of a call lives in shared memory up to
# SHARED_PLAN_GROUPS groups, past that in a workspace (plan_workspace)
TILE_M, TILE_N, STAGE_K = 128, 256, 64
SHARED_PLAN_GROUPS = 1024

_fns = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tgmm_chunk_rows(m: int, k: int, n: int, sms: int) -> int:
    """``C``, the rows of a ``tgmm`` work item: the largest multiple of 64
    that still cuts ``m`` rows into enough chunks for two waves of items on
    ``sms`` SMs, should one group take every row (a group of more than
    ``C`` rows is cut into chunks of ``C``, whose fp32 partials a second
    launch adds).  From shapes alone."""
    tiles = _cdiv(k, TILE_M) * _cdiv(n, TILE_N)
    want = _cdiv(2 * sms, tiles)
    if want <= 1:
        return _cdiv(m, STAGE_K) * STAGE_K
    return max(STAGE_K, (m - 1) // (want - 1) // STAGE_K * STAGE_K)


def plan_workspace(E: int, kind: str, device) -> Optional[torch.Tensor]:
    """The int32 workspace that holds a call's group plan past
    ``SHARED_PLAN_GROUPS`` groups (None at or below: the kernels keep it in
    shared memory): ``gmm``'s clipped ends ``[E]``, or ``tgmm``'s ends,
    chunk prefix, slots, split groups, their count and the longest-first
    order (``5 E + 2``).  A plan pass in the launch fills it."""
    if E <= SHARED_PLAN_GROUPS:
        return None
    return torch.empty(E if kind == "gmm" else 5 * E + 2, dtype=torch.int32,
                       device=device)


def tgmm_workspace_slots(m: int, chunk_rows: int) -> int:
    """``[k, n]`` fp32 partials the workspace must hold: none when no group
    can split (``m <= C``), else ``2 m // C`` (a group of ``r > C`` rows
    has ``ceil(r / C) < 2 r / C`` chunks)."""
    return 0 if m <= chunk_rows else 2 * m // chunk_rows


class GmmItem(NamedTuple):
    """One ``gmm`` work item: the output tile at ``(m0, n0)`` times group
    ``group``'s weights (``-1`` idle, ``E`` a tile of zeros), ``nk`` K
    stages; rows ``[r_lo, r_hi)`` get its sums, ``[r_hi, z_hi)`` zeros."""
    m0: int
    n0: int
    group: int
    nk: int
    r_lo: int
    r_hi: int
    z_hi: int


class TgmmItem(NamedTuple):
    """One ``tgmm`` work item: rows ``[r0, r0 + rows)`` of group ``group``
    (chunk ``chunk``; ``-1`` idle) into the output tile ``(k0, n0)`` of
    ``out[group]``, directly in bf16 (``slot`` -1) or as the fp32 partial
    in workspace slot ``slot``; ``nk`` 64-row stages, 0 for an empty
    group's zeros."""
    group: int
    chunk: int
    k0: int
    n0: int
    r0: int
    rows: int
    nk: int
    slot: int


def _clipped_ends(group_sizes: Sequence[int], m: int) -> List[int]:
    ends, total = [], 0
    for size in group_sizes:
        total += int(size)
        ends.append(min(total, m))
    return ends


def gmm_work_items(group_sizes: Sequence[int], m: int, k: int, n: int,
                   tile_n: int = TILE_N, stage_k: int = STAGE_K
                   ) -> List[GmmItem]:
    """The items of ``gmm_fwd`` in order, as its ``tile`` and ``pre``
    compute them on the device (``csrc/gmm_items.cuh``, also the plan of
    ``csrc/gmm_quant.cu``'s product with its 8-bit ``tile_n`` and
    ``stage_k``): ``n_n`` primary items per 128-row tile (the group holding
    the tile's first row), then ``n_n`` per group for a group that starts
    strictly inside a tile (idle otherwise): ``n_n (n_m + E)`` in all."""
    E = len(group_sizes)
    ends = _clipped_ends(group_sizes, m)
    n_m, n_n, kt = _cdiv(m, TILE_M), _cdiv(n, tile_n), _cdiv(k, stage_k)
    items = []
    for i in range(n_n * (n_m + E)):
        if i < n_m * n_n:
            tm, tn = divmod(i, n_n)
            g = next((j for j in range(E) if ends[j] > tm * TILE_M), E)
        else:
            g, tn = divmod(i - n_m * n_n, n_n)
            lo = ends[g - 1] if g else 0
            tm = lo // TILE_M
            if ends[g] <= lo or lo % TILE_M == 0:
                g = -1
        m0, m1 = tm * TILE_M, min(tm * TILE_M + TILE_M, m)
        if g < 0:
            r_lo = r_hi = z_hi = m0
        elif g == E:
            r_lo, r_hi, z_hi = m0, m0, m1
        else:
            lo, hi = (ends[g - 1] if g else 0), ends[g]
            r_lo, r_hi = max(lo, m0), min(hi, m1)
            z_hi = m1 if hi == ends[E - 1] else r_hi
        items.append(GmmItem(m0, tn * tile_n, g,
                             kt if 0 <= g < E else 0, r_lo, r_hi, z_hi))
    return items


def tgmm_work_items(group_sizes: Sequence[int], m: int, k: int, n: int,
                    chunk_rows: int, grid: int) -> List[TgmmItem]:
    """The items of ``tgmm`` in the mainloop's order (item ``i`` runs on CTA
    ``i % grid``), as its ``tile`` and ``epi`` compute them
    (``csrc/gmm.cu``): a group has ``ceil(rows / C)`` chunks (one for an
    empty group).  The chunk slots run longest first: the full chunks of
    split groups (``C`` rows) in group order, then every group's last chunk
    by decreasing rows (ties by group), then the idle slots; the ``n_k
    n_n`` output tiles of a slot together.  Of those ``n_k n_n (E + m //
    C)`` items, item ``i`` is taken in snake order over bands of ``grid``
    (every other band reversed)."""
    E, C = len(group_sizes), chunk_rows
    ends = _clipped_ends(group_sizes, m)
    rows_of = [ends[g] - (ends[g - 1] if g else 0) for g in range(E)]
    chunks, slot0, slots = [], [], 0
    for g in range(E):
        nc = _cdiv(rows_of[g], C) if rows_of[g] > C else 1
        chunks.append(nc)
        slot0.append(slots if nc > 1 else -1)
        slots += nc if nc > 1 else 0
    last = [rows_of[g] - (chunks[g] - 1) * C for g in range(E)]
    by_slot = ([(g, c) for g in range(E) for c in range(chunks[g] - 1)]
               + [(g, chunks[g] - 1)
                  for g in sorted(range(E), key=lambda g: (-last[g], g))])
    n_k, n_n = _cdiv(k, TILE_M), _cdiv(n, TILE_N)
    tiles = n_k * n_n
    n_work = tiles * (E + m // C)
    items = []
    for i in range(n_work):
        band, pos = divmod(i, grid)
        span = min(grid, n_work - band * grid)
        j = band * grid + (span - 1 - pos if band % 2 else pos)
        slot, tt = divmod(j, tiles)
        k0, n0 = (tt % n_k) * TILE_M, (tt // n_k) * TILE_N
        if slot >= len(by_slot):
            items.append(TgmmItem(-1, -1, k0, n0, 0, 0, 0, -1))
            continue
        g, c = by_slot[slot]
        r0 = (ends[g - 1] if g else 0) + c * C
        rows = max(min(r0 + C, ends[g]) - r0, 0)
        items.append(TgmmItem(g, c, k0, n0, r0, rows, _cdiv(rows, STAGE_K),
                              slot0[g] + c if slot0[g] >= 0 else -1))
    return items


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from automodel_tpu_torch.ops.kernel_lib import build

        fn = getattr(build.load("gmm"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {
            # lhs rhs ends plan out m K N E trans stream
            "gmm_fwd": [p, p, p, p, p, i, i, i, i, i, p],
            # lhs dout ends plan out ws m K N E chunk_rows stream
            "tgmm": [p, p, p, p, p, p, i, i, i, i, i, p],
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
    _check(E > 0, "no groups")
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
        plan = plan_workspace(E, "gmm", lhs.device)
        _launch("gmm_fwd", lhs.data_ptr(), rhs.data_ptr(), ends.data_ptr(),
                ptr(plan), out.data_ptr(), m, K, N, E, int(bool(trans_rhs)),
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
        chunk = tgmm_chunk_rows(m, K, N, _sms(lhs.device))
        slots = tgmm_workspace_slots(m, chunk)
        ws = (torch.empty(slots, K, N, dtype=torch.float32,
                          device=lhs.device) if slots else None)
        plan = plan_workspace(E, "tgmm", lhs.device)
        _launch("tgmm", lhs.data_ptr(), dout.data_ptr(), ends.data_ptr(),
                ptr(plan), out.data_ptr(), ptr(ws),
                m, K, N, E, chunk,
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
