"""Quantized matmul: the ctypes wrapper of ``csrc/qdot.cu`` and its plain
PyTorch version (counterpart: ``automodel_tpu/ops/qdot_kernel.py``).

``qdot(a [m, k], b [k, n], sa, sb, a_dtype, b_dtype) -> [m, n]``: both
operands quantized with the precomputed dynamic scales (``sa [m|1, 1]``,
``sb [1, n|1]``; ``ops/quant.py::quant_cast``'s rule), multiplied exactly
in 8 bits (int32 sums for int8 x int8, fp32 for fp8) and rescaled as
``(raw * sa) * sb``, the JAX rung's order.

TPU kernel replaced: ``_qdot_kernel`` (``automodel_tpu/ops/qdot_kernel.py:
89``, launched at ``:127``), which quantizes each bf16 tile pair in VMEM,
runs the int8/fp8 MXU dot and rescales into an f32 tile.  On the H100 the
product is bound by its ``2 m k n`` operations on the 8-bit tensor cores
(1,979 TOP/s) at the training shapes; ``csrc/qdot.cu`` says what the
kernel does about it and what it costs.

Each operand is row-major or the transpose view of a row-major tensor
(``W.t()`` of an ``nn.Linear`` weight, ``x.t()`` of the activations).  A
call is two launches on the caller's stream (:func:`qdot_launch_plan`):
``qdot_pack`` quantizes every element once into a K-major 8-bit scratch
copy of each operand (allocated here), and ``qdot_product`` multiplies the
two copies on the wgmma mainloop; the source note says why it does not
quantize per tile as the TPU kernel does.  When the output tiles would
not fill the card, :func:`split_plan` splits K and the product sums the
splits' partials (a workspace allocated here) in a fixed order.  The
output is written in ``out_dtype`` (the cast of the same fp32 value as the
JAX rung's ``astype``), or into ``out``, which may also be a transpose
view.

``qdot_launches`` counts the kernel's calls (one per call: the pack and the
product launched together).  There is no fallback: :func:`qdot` takes the
plain version only for CPU tensors or when asked by ``impl="plain"``; on
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

# kernel launches in this process (reset by callers that count a window)
qdot_launches = 0

# the operand codes of csrc/gemm8.cuh
QCODES = {torch.int8: 0, torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}
# the (a, b) pairs ops/quant.py::_gemm_dtypes makes; the kernel is built
# for these
PAIRS = ((torch.float8_e4m3fn, torch.float8_e4m3fn),
         (torch.float8_e5m2, torch.float8_e4m3fn),
         (torch.float8_e4m3fn, torch.float8_e5m2),
         (torch.int8, torch.int8))

# the product's tiles (csrc/qdot.cu): 128 rows, 128 (fp8) or 256 (int8)
# columns, K tiles of 128 codes
TILE_M = 128
TILE_K = 128

_fns = {}
_sm_counts = {}


def _sms(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    n = _sm_counts.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_counts[device.index] = n
    return n


def tile_n(a_dtype: torch.dtype) -> int:
    """Output columns per CTA tile of the product for operand type
    ``a_dtype`` (fp8: 128, for the fp32 promotion registers; int8: 256)."""
    return 256 if a_dtype == torch.int8 else 128


def split_plan(m: int, n: int, k: int, a_dtype: torch.dtype, sms: int
               ) -> Tuple[int, int]:
    """``(splits, kt_split)``: how the product splits K.  With fewer output
    tiles than ``sms`` SMs, K (in tiles of ``TILE_K`` codes over ``kp`` =
    k rounded up to 16) is cut into ranges of ``kt_split`` whole tiles so
    that tiles x splits >= sms (as far as K has tiles); the last range
    holds the remainder.  Otherwise one range: ``(1, all K tiles)``."""
    kp = -(-k // 16) * 16
    kt = -(-kp // TILE_K)
    tiles = -(-m // TILE_M) * -(-n // tile_n(a_dtype))
    if tiles >= sms:
        return 1, kt
    want = min(-(-sms // tiles), kt)
    kt_split = -(-kt // want)
    while kt_split > 1 and -(-kt // kt_split) < want:
        kt_split -= 1
    return -(-kt // kt_split), kt_split


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from automodel_tpu_torch.ops.kernel_lib import build

        fn = getattr(build.load("qdot"), name)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = {
            # a b sa sb aq bq m n k lda ldb a_kmajor b_kmajor sa_stride
            # sb_stride qa qb stream
            "qdot_pack": [p, p, p, p, p, p, i, i, i, ll, ll, i, i, i, i, i,
                          i, p],
            # aq bq sa sb out ws m n kp sa_stride sb_stride out_rs out_cs
            # out_bf16 qa qb splits kt_split promote stream
            "qdot_product": [p, p, p, p, p, p, i, i, i, i, i, ll, ll, i, i,
                             i, i, i, i, p],
        }[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"qdot: {msg}")


def _orientation(t: torch.Tensor, name: str, inner_major: bool
                 ) -> Tuple[bool, int]:
    """``(k_major, ld)`` of a 2-D operand: ``a [m, k]`` is K-major with
    unit column stride, M-major with unit row stride (``inner_major``
    False); ``b [k, n]`` the other way round."""
    s0, s1 = t.stride()
    if inner_major:                 # a: K-major when stride(1) == 1
        if s1 == 1 or t.shape[1] == 1:
            return True, s0
        _check(s0 == 1 or t.shape[0] == 1,
               f"{name} {tuple(t.shape)} strides {t.stride()}: neither it "
               "nor its transpose is row-major")
        return False, s1
    if s0 == 1 or t.shape[0] == 1:  # b: K-major when stride(0) == 1
        return True, s1
    _check(s1 == 1 or t.shape[1] == 1,
           f"{name} {tuple(t.shape)} strides {t.stride()}: neither it nor "
           "its transpose is row-major")
    return False, s0


def _scales(s: torch.Tensor, size: int, axis: int, name: str) -> int:
    """Stride of a scale vector along its output axis (0: one scale)."""
    _check(s.dtype == torch.float32 and s.dim() == 2
           and s.shape[1 - axis] == 1 and s.shape[axis] in (1, size),
           f"{name} must be fp32 {'[m|1, 1]' if axis == 0 else '[1, n|1]'}"
           f", got {tuple(s.shape)} {s.dtype}")
    return 0 if s.shape[axis] == 1 and size != 1 else s.stride(axis)


def qdot_launch_plan(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor,
                     sb: torch.Tensor, a_dtype: torch.dtype,
                     b_dtype: torch.dtype,
                     out: Optional[torch.Tensor] = None,
                     out_dtype: torch.dtype = torch.float32,
                     promote: bool = True):
    """Check the operands and allocate the output and scratch of ``qdot``
    (bf16 ``a [m, k]`` and ``b [k, n]``, each row-major or a transpose view
    of one, the vectorised dimension a multiple of 8; ``[m, n]`` fp32 or
    bf16 out), launching nothing: ``(out, plan)`` with ``plan`` the
    ``[("pack", launch), ("product", launch)]`` to run in order (empty when
    m or k is 0: ``out`` is then final), each on the current stream of the
    current device, which must be a's.  ``promote=False`` (e4m3 x e4m3
    only) runs the fp8 product without its per-stage fp32 promotion, for
    measuring what the promotion buys; no caller of the port sets it."""
    _check(a.is_cuda, f"a must be a CUDA tensor, got {a.device}")
    _check(a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[0],
           f"a [m, k] and b [k, n], got {tuple(a.shape)} and "
           f"{tuple(b.shape)}")
    _check((a_dtype, b_dtype) in PAIRS,
           f"operand types ({a_dtype}, {b_dtype}) are not a pair "
           f"_gemm_dtypes makes: {PAIRS}")
    _check(promote or a_dtype == b_dtype == torch.float8_e4m3fn,
           "promote=False is built for e4m3 x e4m3 only")
    m, k = a.shape
    n = b.shape[1]
    for name, t in (("a", a), ("b", b)):
        _check(t.device == a.device, f"{name} on {t.device}, a on {a.device}")
        _check(t.dtype == torch.bfloat16,
               f"{name} is {t.dtype}; the kernel takes bfloat16 (run "
               "impl='plain' for other dtypes)")
        _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    a_k, lda = _orientation(a, "a", True)
    b_k, ldb = _orientation(b, "b", False)
    _check(n % 8 == 0 and (k % 8 == 0 or not (a_k or b_k))
           and (m % 8 == 0 or a_k) and lda % 8 == 0 and ldb % 8 == 0,
           f"m={m} (M-major a), k={k} (K-major operands), n={n} and the "
           f"leading dimensions ({lda}, {ldb}) must be multiples of 8")
    for name, s in (("sa", sa), ("sb", sb)):
        _check(s.device == a.device, f"{name} on {s.device}")
    sa_stride = _scales(sa, m, 0, "sa")
    sb_stride = _scales(sb, n, 1, "sb")
    if out is None:
        out = torch.empty(m, n, dtype=out_dtype, device=a.device)
    _check(tuple(out.shape) == (m, n) and out.device == a.device
           and out.dtype in (torch.float32, torch.bfloat16),
           f"out must be fp32 or bf16 [{m}, {n}] on {a.device}, got "
           f"{tuple(out.shape)} {out.dtype} on {out.device}")
    ors, ocs = out.stride()
    _check((ocs == 1 and ors % 2 == 0) or ors == 1,
           f"out strides {out.stride()}: neither it nor its transpose is "
           "row-major with an even leading dimension")
    _check(out.data_ptr() % 16 == 0, "out must be 16-byte aligned")
    if m == 0:
        return out, []
    if k == 0:
        return out.zero_(), []

    # the quantized copies, K-major with k padded to 16 (scratch)
    kp = -(-k // 16) * 16
    aq = torch.empty(m, kp, dtype=torch.uint8, device=a.device)
    bq = torch.empty(n, kp, dtype=torch.uint8, device=a.device)
    splits, kt_split = split_plan(m, n, k, a_dtype, _sms(a.device))
    ws = (torch.empty(splits, m, n, device=a.device, dtype=torch.int32
                      if a_dtype == torch.int8 else torch.float32)
          if splits > 1 else None)
    qa, qb = QCODES[a_dtype], QCODES[b_dtype]

    stream = torch.cuda.current_stream(a.device).cuda_stream

    def launch(name, *args):
        rc = _kernel(name)(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed (code {rc})")

    def pack():
        launch("qdot_pack", a.data_ptr(), b.data_ptr(), sa.data_ptr(),
               sb.data_ptr(), aq.data_ptr(), bq.data_ptr(), m, n, k, lda,
               ldb, int(a_k), int(b_k), sa_stride, sb_stride, qa, qb)

    def product():
        launch("qdot_product", aq.data_ptr(), bq.data_ptr(), sa.data_ptr(),
               sb.data_ptr(), out.data_ptr(),
               None if ws is None else ws.data_ptr(), m, n, kp, sa_stride,
               sb_stride, ors, ocs, int(out.dtype == torch.bfloat16), qa,
               qb, splits, kt_split, int(promote))

    return out, [("pack", pack), ("product", product)]


def qdot_cuda(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor,
              sb: torch.Tensor, a_dtype: torch.dtype, b_dtype: torch.dtype,
              out: Optional[torch.Tensor] = None,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch ``qdot``: bf16 ``a [m, k]`` and ``b [k, n]`` (each row-major
    or a transpose view of one; the vectorised dimension a multiple of 8)
    -> ``[m, n]`` fp32 or bf16."""
    global qdot_launches
    _check(a.is_cuda, f"a must be a CUDA tensor, got {a.device}")
    with torch.cuda.device(a.device):
        out, plan = qdot_launch_plan(a, b, sa, sb, a_dtype, b_dtype, out,
                                     out_dtype)
        for _, launch in plan:
            launch()
    if plan:
        qdot_launches += 1
    return out


def qdot_plain(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor,
               sb: torch.Tensor, a_dtype: torch.dtype, b_dtype: torch.dtype,
               out: Optional[torch.Tensor] = None,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The JAX rung's arithmetic: ``quant_cast`` of both operands, their
    product summed in float64 (exact for int8; fp8 products are exact
    too), then ``(raw.float() * sa) * sb`` in fp32."""
    from automodel_tpu_torch.ops.quant import quant_cast

    aq = quant_cast(a, sa, a_dtype)
    bq = quant_cast(b, sb, b_dtype)
    raw = aq.double() @ bq.double()
    res = raw.float() * sa.float() * sb.float()
    if out is None:
        return res.to(out_dtype)
    return out.copy_(res)


def qdot(a, b, sa, sb, a_dtype, b_dtype, out=None,
         out_dtype: torch.dtype = torch.float32,
         impl: Optional[str] = None) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors;
    ``impl`` ``"kernel"`` / ``"plain"`` forces one."""
    impl = impl or ("kernel" if a.is_cuda else "plain")
    if impl == "kernel":
        return qdot_cuda(a, b, sa, sb, a_dtype, b_dtype, out, out_dtype)
    if impl == "plain":
        return qdot_plain(a, b, sa, sb, a_dtype, b_dtype, out, out_dtype)
    raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
