"""Fused linear + cross-entropy kernels: the ctypes wrappers of
``csrc/linear_ce_fwd.cu`` and ``csrc/linear_ce_bwd.cu``, their plain
PyTorch versions and the ``torch.autograd.Function`` that joins them
(counterpart: ``automodel_tpu/ops/linear_ce_kernel.py``).

The boundary is the JAX package's: ``lse_and_pick(h, w, labels) -> (lse,
pick)`` per row of ``h [T, H]`` against the LM head ``w [H, V]``, with
``lse = logsumexp(h @ w)`` and ``pick = (h @ w)[label]`` in fp32; a label
outside ``[0, V)`` (an ignored row, or another vocab shard's label) picks
0.  The cross-entropy is assembled outside (``loss/linear_ce.py``).

TPU kernels replaced, and what bounds the replacements on the H100:

* ``_fwd_kernel`` (``automodel_tpu/ops/linear_ce_kernel.py:132``) by
  ``linear_ce_fwd`` (kernel 2): the logits products, 2 T H V operations on
  the bf16 tensor cores, as a persistent ``wgmma`` + TMA product
  (``csrc/wgmma_gemm.cuh``) whose CTAs walk runs of vocab tiles of one row
  tile (:func:`linear_ce_fwd_plan`); the partial (max, sumexp, pick) of
  the vocabulary's splits are combined in a second small launch.
* ``_bwd_dh_kernel`` (``:222``) and ``_bwd_dw_kernel`` (``:248``) by
  ``linear_ce_dlogits`` + ``linear_ce_dh`` + ``linear_ce_dw`` (kernels 3
  and 4): per chunk of ``CHUNK_ROWS`` rows, one recompute of the logits
  writes bf16 ``dlogits`` for the chunk, then ``dh = dlogits W^T`` and
  ``dW += h^T dlogits`` (fp32 sum over chunks); 6 T H V operations in all,
  each of the three a persistent ``wgmma`` + TMA product
  (``csrc/wgmma_gemm.cuh``).

No ``[T, V]`` tensor exists on either route: the kernels keep logits tiles
in registers and a ``[Tc, V]`` chunk of ``dlogits``; the plain versions
walk rows in chunks of ``CHUNK_ROWS`` too.

The kernels read the head in the port's storage: ``w`` must be the ``[H,
V]`` transposed view of a row-major ``[V, H]`` tensor (the tied embedding
or ``lm_head.weight``), as ``models/llama.py`` hands it over; a copy into
another layout would move 525 MB per call, so any other layout raises.
``fwd_launches`` counts forward calls (two launches each: partials and
their combine), ``dlogits_launches`` / ``dh_launches`` / ``dw_launches``
count the backward's launches (one each per chunk; no dW when the head
needs no gradient, as a frozen PEFT head does).  There is no
fallback: :func:`lse_and_pick` takes the plain versions only for CPU
tensors or when asked by ``impl="plain"``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from automodel_tpu_torch.ops.qdot_kernel import _sms

# rows per chunk: the kernels' bf16 dlogits chunk is 2048 x 128256 x 2 B
# = 0.5 GB at Llama-3's vocabulary, the plain versions' fp32 logits 1 GB
CHUNK_ROWS = 2048
# the dlogits chunk's rows are V rounded up to this (256-byte aligned rows;
# the kernels write the pad columns as 0)
_VOCAB_ALIGN = 128

# kernel launches in this process (reset by callers that count a window)
fwd_launches = 0
dlogits_launches = 0
dh_launches = 0
dw_launches = 0

_fns = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from automodel_tpu_torch.ops.kernel_lib import build

        lib = build.load("linear_ce_fwd" if name.startswith("linear_ce_fwd")
                         else "linear_ce_bwd")
        fn = getattr(lib, name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {
            "linear_ce_fwd_splits": [i, i],
            "linear_ce_fwd": [p, p, p, p, p, p, i, p, p,   # h w lab parts n lse pick
                              i, i, i, i, p],               # T H V epi stream
            "linear_ce_dlogits": [p, p, p, p, p, p, p,      # h w lab lse dlse dpick dl
                                  i, i, i, i, i, i, p],     # r0 rows H V ldv epi stream
            "linear_ce_dh": [p, p, p, i, i, i, i, p],       # dl w dh rows H V ldv
            "linear_ce_dw": [p, p, p, p, i, i, i, i,        # dl h dw32 dw rows H V ldv
                             i, i, p],                      # mode has_prev stream
        }[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"linear_ce: {msg}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed (code {rc})")


def head_storage(w: torch.Tensor) -> torch.Tensor:
    """The row-major ``[V, H]`` storage behind the ``[H, V]`` head view the
    kernels take; raises on any other layout."""
    _check(w.dim() == 2, f"w must be [H, V], got {tuple(w.shape)}")
    ws = w.t()
    _check(ws.is_contiguous(),
           f"w {tuple(w.shape)} with strides {w.stride()} is not the [H, V] "
           "view of a row-major [V, H] tensor (the port's LM head layout); "
           "the kernels do not copy the head into another layout")
    return ws


def _check_operands(h: torch.Tensor, w: torch.Tensor,
                    labels: torch.Tensor) -> Tuple[int, int, int,
                                                   torch.Tensor]:
    _check(h.is_cuda, f"h must be a CUDA tensor, got {h.device}")
    _check(h.dim() == 2, f"h must be [T, H], got {tuple(h.shape)}")
    T, H = h.shape
    _check(w.dim() == 2 and w.shape[0] == H,
           f"w {tuple(w.shape)} does not fit h {tuple(h.shape)}")
    V = w.shape[1]
    _check(T > 0 and V > 0, "empty operands")
    _check(H % 8 == 0, f"hidden size {H} is not a multiple of 8")
    ws = head_storage(w)
    for name, t in (("h", h), ("w", ws)):
        _check(t.dtype == torch.bfloat16,
               f"{name} is {t.dtype}; the kernels take bfloat16 (run "
               "impl='plain' for other dtypes)")
        _check(t.device == h.device, f"{name} on {t.device}, h on {h.device}")
        _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    _check(h.is_contiguous(), "h must be contiguous")
    _check(labels.dtype == torch.int32 and tuple(labels.shape) == (T,)
           and labels.is_contiguous() and labels.device == h.device,
           f"labels must be contiguous int32 [{T}] on {h.device}")
    return T, H, V, ws


def _f32_row(t: torch.Tensor, T: int, name: str) -> torch.Tensor:
    _check(tuple(t.shape) == (T,), f"{name} must be [{T}]")
    return t.to(torch.float32).contiguous()


# the forward's tiles (csrc/linear_ce_fwd.cu on wgmma_gemm.cuh): 128 rows
# by 256 vocab columns; at most this many row tiles share the L2 at a time
FWD_TILE_M, FWD_TILE_V, FWD_ROW_TILES_MAX = 128, 256, 32


class FwdItem(NamedTuple):
    """One item of a forward CTA: the logits tile ``(row_tile,
    vocab_tile)`` folded into the running sums of split ``split``'s run
    (``vocab_tile`` -1: an idle item of the run, no product; ``row_tile``
    past the last: an idle run); ``run_end``: the run's partials are
    written after it."""
    row_tile: int
    vocab_tile: int
    split: int
    run_end: bool


class FwdPlan(NamedTuple):
    """The forward's plan (``csrc/linear_ce_fwd.cu``): row tiles in groups
    of ``row_tiles``, the vocabulary's ``n_v`` tiles in ``splits`` ranges
    (split ``q``: tiles ``[q n_v / Q, (q + 1) n_v / Q)``), ``grid`` =
    ``row_tiles * splits`` CTAs, CTA ``c`` taking the run (row ``c %
    row_tiles``, split ``c // row_tiles``) of every group, each run padded
    to ``run`` items."""
    row_tiles: int
    splits: int
    run: int
    groups: int
    n_m: int
    n_v: int

    @property
    def grid(self) -> int:
        return self.row_tiles * self.splits

    def items(self, cta: int) -> List[FwdItem]:
        """CTA ``cta``'s items in order, as the kernel's ``tile`` gives
        them: item ``k`` is the mainloop's round-robin item ``cta + k *
        grid``."""
        R, Q, L = self.row_tiles, self.splits, self.run
        q, out = cta // R, []
        lo, hi = q * self.n_v // Q, (q + 1) * self.n_v // Q
        for k in range(self.groups * L):
            tm, v = (k // L) * R + cta % R, lo + k % L
            out.append(FwdItem(tm, v if tm < self.n_m and v < hi else -1, q,
                               k % L == L - 1))
        return out


@functools.lru_cache(maxsize=64)
def linear_ce_fwd_plan(T: int, V: int, sms: int) -> FwdPlan:
    """The forward kernel's plan for ``T`` rows, ``V`` vocab entries on
    ``sms`` SMs, from shapes alone: ``(row_tiles R, splits Q)`` with ``R
    <= FWD_ROW_TILES_MAX`` and ``R Q <= sms``, the largest ``R`` (fewest
    passes over the head) whose longest run times the number of row groups
    (the CTAs' item count) is within an eighth of the least.  ``splits``
    sizes the partials; the kernel's ``linear_ce_fwd_splits`` gives the
    same."""
    n_m, n_v = -(-T // FWD_TILE_M), -(-V // FWD_TILE_V)
    plans = []
    for R in range(1, min(n_m, FWD_ROW_TILES_MAX, max(sms, 1)) + 1):
        Q = min(n_v, max(1, sms // R))
        plans.append(FwdPlan(R, Q, -(-n_v // Q), -(-n_m // R), n_m, n_v))
    least = min(p.run * p.groups for p in plans)
    return [p for p in plans if 8 * p.run * p.groups <= 9 * least][-1]


# timing run of the forward kernel: the product alone (no partials, no
# combine; lse and pick are left unwritten)
FWD_TIMING = {"product": 1}


def linear_ce_fwd_cuda(h: torch.Tensor, w: torch.Tensor,
                       labels: torch.Tensor, timing: Optional[str] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel -> ``(lse [T], pick [T])`` fp32.
    ``timing="product"`` runs the product alone, to time it."""
    global fwd_launches
    T, H, V, ws = _check_operands(h, w, labels)
    with torch.cuda.device(h.device):
        nsplit = linear_ce_fwd_plan(T, V, _sms(h.device)).splits
        part = torch.empty(3, nsplit, T, dtype=torch.float32, device=h.device)
        lse = torch.empty(T, dtype=torch.float32, device=h.device)
        pick = torch.empty(T, dtype=torch.float32, device=h.device)
        rc = _kernel("linear_ce_fwd")(
            h.data_ptr(), ws.data_ptr(), labels.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), part[2].data_ptr(), nsplit, lse.data_ptr(),
            pick.data_ptr(), T, H, V, FWD_TIMING[timing] if timing else 0,
            _stream(h))
    _raise_on(rc, "linear_ce_fwd")
    fwd_launches += 1
    return lse, pick


def padded_vocab(V: int) -> int:
    """Row length of a dlogits chunk: V rounded up to 128."""
    return -(-V // _VOCAB_ALIGN) * _VOCAB_ALIGN


# timing runs of the dlogits kernel's parts (``out`` is left as it was):
# its epilogue's arithmetic without the stores, or the product alone
DLOGITS_TIMING = {"no_store": 1, "product": 2}


def linear_ce_dlogits_cuda(h, ws, labels, lse, dlse, dpick, r0: int,
                           rows: int, out: torch.Tensor,
                           timing: Optional[str] = None) -> torch.Tensor:
    """dlogits of rows ``r0 .. r0 + rows`` into ``out [>= rows, ldv]``
    bf16 (``ws`` the ``[V, H]`` head storage; operands checked by the
    caller).  ``timing`` (a key of :data:`DLOGITS_TIMING`) runs only a
    part of the kernel, to time it."""
    global dlogits_launches
    H, V = h.shape[1], ws.shape[0]
    rc = _kernel("linear_ce_dlogits")(
        h.data_ptr(), ws.data_ptr(), labels.data_ptr(), lse.data_ptr(),
        dlse.data_ptr(), dpick.data_ptr(), out.data_ptr(), r0, rows, H, V,
        out.shape[1], DLOGITS_TIMING[timing] if timing else 0, _stream(h))
    _raise_on(rc, "linear_ce_dlogits")
    dlogits_launches += 1
    return out


def linear_ce_dh_cuda(dl: torch.Tensor, ws: torch.Tensor, rows: int,
                      out: torch.Tensor) -> torch.Tensor:
    """``out[:rows] = dl[:rows, :V] @ ws`` (bf16, fp32 accumulate)."""
    global dh_launches
    V, H = ws.shape
    rc = _kernel("linear_ce_dh")(dl.data_ptr(), ws.data_ptr(),
                                 out.data_ptr(), rows, H, V, dl.shape[1],
                                 _stream(dl))
    _raise_on(rc, "linear_ce_dh")
    dh_launches += 1
    return out


def linear_ce_dw_cuda(dl: torch.Tensor, h_rows: torch.Tensor, rows: int,
                      dw32: Optional[torch.Tensor], dw: torch.Tensor,
                      mode: int, has_prev: bool) -> None:
    """``dW [V, H] (+)= dl[:rows, :V]^T @ h_rows[:rows]``: mode 0 writes
    ``dw32``, 1 adds into it, 2 writes bf16 ``dw`` (adding ``dw32`` when
    ``has_prev``)."""
    global dw_launches
    V, H = dw.shape
    rc = _kernel("linear_ce_dw")(
        dl.data_ptr(), h_rows.data_ptr(),
        None if dw32 is None else dw32.data_ptr(), dw.data_ptr(), rows, H, V,
        dl.shape[1], mode, int(bool(has_prev)), _stream(dl))
    _raise_on(rc, "linear_ce_dw")
    dw_launches += 1


def bwd_launches_per_call(T: int, chunk_rows: int = CHUNK_ROWS) -> int:
    """Launches of each backward kernel in one backward call over T rows."""
    return -(-T // chunk_rows)


def bwd_launch_plan(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                    lse: torch.Tensor, dlse: torch.Tensor, dpick: torch.Tensor,
                    chunk_rows: int = CHUNK_ROWS, need_dw: bool = True):
    """The backward's outputs and its launches, not yet run: ``(dh [T, H],
    dw [V, H], plan)`` with ``plan`` a list of ``(kind, launch)`` in
    stream order, kind ``"dlogits"``, ``"dh"`` or ``"dw"`` -- one of each
    per chunk of ``chunk_rows`` rows.  Without ``need_dw`` (a frozen head)
    ``dw`` is None and the plan has no ``"dw"`` launch; dlogits and dh are
    the same launches."""
    T, H, V, ws = _check_operands(h, w, labels)
    lse = _f32_row(lse, T, "lse")
    dlse = _f32_row(dlse, T, "dlse")
    dpick = _f32_row(dpick, T, "dpick")
    _check(chunk_rows > 0, "chunk_rows must be > 0")
    n_chunks = bwd_launches_per_call(T, chunk_rows)
    dev = h.device
    dl = torch.empty(min(chunk_rows, T), padded_vocab(V), dtype=torch.bfloat16,
                     device=dev)
    dh = torch.empty(T, H, dtype=torch.bfloat16, device=dev)
    dw = (torch.empty(V, H, dtype=torch.bfloat16, device=dev) if need_dw
          else None)
    dw32 = (torch.empty(V, H, dtype=torch.float32, device=dev)
            if need_dw and n_chunks > 1 else None)
    plan = []
    for c in range(n_chunks):
        r0 = c * chunk_rows
        rows = min(chunk_rows, T - r0)
        mode = 2 if c == n_chunks - 1 else (0 if c == 0 else 1)
        plan += [
            ("dlogits", lambda r0=r0, rows=rows: linear_ce_dlogits_cuda(
                h, ws, labels, lse, dlse, dpick, r0, rows, dl)),
            ("dh", lambda r0=r0, rows=rows: linear_ce_dh_cuda(
                dl, ws, rows, dh[r0:])),
        ]
        if need_dw:
            plan.append(("dw", lambda r0=r0, rows=rows, mode=mode, c=c:
                         linear_ce_dw_cuda(dl, h[r0:], rows, dw32, dw, mode,
                                           c > 0)))
    return dh, dw, plan


def linear_ce_bwd_cuda(h: torch.Tensor, w: torch.Tensor,
                       labels: torch.Tensor, lse: torch.Tensor,
                       dlse: torch.Tensor, dpick: torch.Tensor,
                       chunk_rows: int = CHUNK_ROWS, need_dw: bool = True
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the backward kernels chunk by chunk -> ``(dh [T, H], dw [H,
    V])`` bf16; ``dw`` is the transposed view of a row-major ``[V, H]``
    result, like ``w``, or None without ``need_dw`` (no dW launch)."""
    with torch.cuda.device(h.device):
        dh, dw, plan = bwd_launch_plan(h, w, labels, lse, dlse, dpick,
                                       chunk_rows, need_dw)
        for _, launch in plan:
            launch()
    return dh, (dw.t() if need_dw else None)


# ---------------------------------------------------------------------------
# plain versions: fp32 torch, chunked over rows, the formulas of the kernels
# ---------------------------------------------------------------------------
def _pick(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    V = logits.shape[1]
    lab = labels.long()
    ok = (lab >= 0) & (lab < V)
    got = logits.gather(1, lab.clamp(0, V - 1)[:, None])[:, 0]
    return torch.where(ok, got, torch.zeros_like(got))


def lse_and_pick_plain(h: torch.Tensor, w: torch.Tensor,
                       labels: torch.Tensor, chunk_rows: int = CHUNK_ROWS
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dense_lse_pick_reference`` (``automodel_tpu/ops/kernel_lib/
    parity.py:87-99``) in fp32, one chunk of rows at a time as the JAX
    chunked rung (``loss/linear_ce.py:206-233``): ``(lse, pick)`` fp32."""
    wf = w.float()
    lse, pick = [], []
    for r0 in range(0, h.shape[0], chunk_rows):
        logits = h[r0:r0 + chunk_rows].float() @ wf
        lse.append(torch.logsumexp(logits, dim=-1))
        pick.append(_pick(logits, labels[r0:r0 + chunk_rows]))
        del logits
    return torch.cat(lse), torch.cat(pick)


def dlogits_plain(h_rows: torch.Tensor, w: torch.Tensor,
                  labels: torch.Tensor, lse: torch.Tensor,
                  dlse: torch.Tensor, dpick: torch.Tensor) -> torch.Tensor:
    """``exp(logits - lse) * dlse + onehot(label) * dpick`` of a chunk of
    rows (``_dlogits_tile``, ``ops/linear_ce_kernel.py:209-219``), in w's
    dtype: the TPU kernel rounds dlogits to the weight dtype before its
    products (``:231``, ``:258``)."""
    logits = h_rows.float() @ w.float()
    d = torch.exp(logits - lse.float()[:, None]) * dlse.float()[:, None]
    lab = labels.long()
    rows = torch.nonzero((lab >= 0) & (lab < logits.shape[1]))[:, 0]
    d[rows, lab[rows]] += dpick.float()[rows]
    return d.to(w.dtype)


def dh_plain(dlogits: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``dlogits w^T`` of a chunk, fp32."""
    return dlogits.float() @ w.float().t()


def dw_plain(h_rows: torch.Tensor, dlogits: torch.Tensor) -> torch.Tensor:
    """``h^T dlogits`` of a chunk, fp32 ``[H, V]``."""
    return h_rows.float().t() @ dlogits.float()


def lse_and_pick_bwd_plain(h: torch.Tensor, w: torch.Tensor,
                           labels: torch.Tensor, lse: torch.Tensor,
                           dlse: torch.Tensor, dpick: torch.Tensor,
                           chunk_rows: int = CHUNK_ROWS, need_dw: bool = True
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The backward written out as the kernels compute it (not autograd of
    logsumexp), chunked over rows like ``_bwd_xla`` (``:326-349``):
    ``dh = dlogits w^T`` per chunk, ``dw = sum_chunks h^T dlogits`` in
    fp32.  Returns ``(dh, dw)`` in h's and w's dtypes (``dw`` None without
    ``need_dw``)."""
    dh = torch.empty(h.shape, dtype=h.dtype, device=h.device)
    dw = (torch.zeros(w.shape, dtype=torch.float32, device=w.device)
          if need_dw else None)
    for r0 in range(0, h.shape[0], chunk_rows):
        sl = slice(r0, r0 + chunk_rows)
        d = dlogits_plain(h[sl], w, labels[sl], lse[sl], dlse[sl], dpick[sl])
        dh[sl] = dh_plain(d, w).to(h.dtype)
        if need_dw:
            dw += dw_plain(h[sl], d)
        del d
    return dh, (dw.to(w.dtype) if need_dw else None)


class LseAndPick(torch.autograd.Function):
    """``(lse, pick)`` with the backward of the TPU kernels' custom VJP
    (``ops/linear_ce_kernel.py:355-404``) for any ``(dlse, dpick)``
    cotangents: the kernels (``impl="kernel"``) or the plain versions
    (``impl="plain"``).  Saves ``(h, w, labels, lse)``."""

    @staticmethod
    def forward(ctx, h, w, labels, impl):
        if impl == "kernel":
            lse, pick = linear_ce_fwd_cuda(h, w, labels)
        else:
            lse, pick = lse_and_pick_plain(h, w, labels)
        ctx.save_for_backward(h, w, labels, lse)
        ctx.impl = impl
        return lse, pick

    @staticmethod
    def backward(ctx, dlse, dpick):
        h, w, labels, lse = ctx.saved_tensors
        # a frozen head (PEFT) needs no dW: neither route computes it
        need_dw = ctx.needs_input_grad[1]
        if ctx.impl == "kernel":
            dh, dw = linear_ce_bwd_cuda(h, w, labels, lse, dlse, dpick,
                                        need_dw=need_dw)
        else:
            dh, dw = lse_and_pick_bwd_plain(h, w, labels, lse, dlse, dpick,
                                            need_dw=need_dw)
        return dh, dw, None, None


def lse_and_pick(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                 bwd_mode: str = "pallas", impl: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable ``(logsumexp(h @ w, -1), (h @ w)[labels])`` per row,
    fp32.  ``h [T, H]``, ``w [H, V]`` (cast to h's dtype), ``labels [T]``
    int (outside ``[0, V)`` picks 0).  ``impl`` None takes the kernels for
    CUDA tensors and the plain versions for CPU tensors; ``"kernel"`` /
    ``"plain"`` force one."""
    if bwd_mode == "xla":
        raise NotImplementedError(
            "bwd_mode='xla' (the JAX chunk-scan backward kept as a "
            "comparison point) is not ported: ROADMAP Queue 2 lists it with "
            "the linear-CE kernels")
    if bwd_mode != "pallas":
        raise ValueError(f"bwd_mode must be 'pallas' or 'xla', got "
                         f"{bwd_mode!r}")
    impl = impl or ("kernel" if h.is_cuda else "plain")
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    if w.dtype != h.dtype:
        w = w.to(h.dtype)
    labels = labels.reshape(-1).to(torch.int32).contiguous()
    return LseAndPick.apply(h, w, labels, impl)
