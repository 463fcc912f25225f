"""The flash rung: multi-head attention over ``[B, H, S, D]`` with segment
ids (counterpart: ``automodel_tpu/ops/flash_attention.py``, whose
``_flash`` runs the upstream Pallas MHA flash kernel,
``jax.experimental.pallas.ops.tpu.flash_attention``).

What is computed: ``softmax(scale * q k^T) v`` per head, causal or full,
with the upstream kernel's segment rule -- query ``i`` attends key ``j``
iff ``seg[i] == seg[j]`` (and ``j <= i`` when causal).  Segment 0
(padding) is a segment like any other: a padding row attends the padding
keys before it, so every row of self-attention has at least itself to
attend, and padding rows have real outputs and gradients.  (The splash
rung, ``ops/splash_attention.py``, forbids segment 0 instead; the two
agree on every row of segment >= 1.)

:func:`flash_attention_bshd` is the JAX function's counterpart on the
``[B, S, H, D]`` layout: it refuses a soft cap, folds a padding mask into
segment 0 (:func:`~automodel_tpu_torch.ops.attention.fold_padding_into_segments`)
and repeats the kv heads up to the query heads (``repeat_interleave`` on
the head axis, as ``jnp.repeat(..., axis=1)``), so the kernels see MHA; the
repeated heads' dk and dv sum over each group through autograd.

On CUDA tensors the wrapper launches ``csrc/flash_mha_fwd.cu`` (which also
returns the row log-sum-exp the backward reuses) and
``csrc/flash_mha_bwd.cu`` (delta, then separate dQ and dK/dV passes: no
atomics, deterministic), both built on the splash rung's ``wgmma`` + TMA
attention core ``csrc/attn_core.cuh`` with the equality rule compiled in;
``fwd_launches`` / ``bwd_launches`` count wrapper calls.  The wrapper
takes bf16, head_dim 64 or 128, self-attention and sequences a multiple of
128 (the JAX rung's shape rule) and raises on anything else.  The plain
versions (a dense fp32 softmax and its VJP written out) run for CPU
tensors or on ``impl="plain"``; there is no fallback on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from automodel_tpu_torch.ops.attention import fold_padding_into_segments
from automodel_tpu_torch.ops.attention_plan import tile_meta_workspace
from automodel_tpu_torch.ops.kernel_lib.build import ptr

BLOCK = 128          # the JAX rung's shape rule: sequences a multiple of this
HEAD_DIMS = (64, 128)

# kernel launches in this process (reset by callers that count a window)
fwd_launches = 0
bwd_launches = 0

_fns = {}


def flash_attention_available(q_seq: int, kv_seq: int, head_dim: int) -> bool:
    """The JAX shape rule (both sequences a multiple of 128) plus what the
    kernels take (self-attention, head_dim 64 or 128)."""
    return (q_seq % BLOCK == 0 and kv_seq % BLOCK == 0 and q_seq == kv_seq
            and head_dim in HEAD_DIMS)


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from automodel_tpu_torch.ops.kernel_lib import build

        fn = getattr(build.load(name), name)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "flash_mha_fwd":
            fn.argtypes = [p, p, p, p, p, p, p,         # q k v seg meta out lse
                           i, i, i, i, f, i, p]         # B S H D scale causal stream
        else:
            fn.argtypes = [p, p, p, p, p, p, p, p, p,   # q k v out dout lse delta seg meta
                           p, p, p,                     # dq dk dv
                           i, i, i, i, f, i, p]         # B S H D scale causal stream
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_mha: {msg}")


def _check_operands(q, k, v, segment_ids):
    _check(q.is_cuda, f"q must be a CUDA tensor, got {q.device}")
    _check(q.dim() == 4, "q, k, v must be [B, H, S, D]")
    B, H, S, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(tuple(t.shape) == (B, H, S, D),
               f"{name} {tuple(t.shape)}: the kernels take MHA self-attention "
               f"with q, k, v all [B, H, S, D] = {(B, H, S, D)}")
        _check(t.dtype == torch.bfloat16, f"{name} is {t.dtype}; the kernels "
               "take bfloat16 (run impl='plain' for other dtypes)")
        _check(t.device == q.device, f"{name} on {t.device}, q on {q.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
        _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    _check(D in HEAD_DIMS, f"head_dim {D} not in {HEAD_DIMS}")
    _check(S % BLOCK == 0, f"sequence length {S} is not a multiple of {BLOCK}")
    if segment_ids is not None:
        _check(segment_ids.dtype == torch.int32
               and tuple(segment_ids.shape) == (B, S)
               and segment_ids.is_contiguous()
               and segment_ids.device == q.device,
               f"segment_ids must be contiguous int32 [B, S] on {q.device}")
    return B, H, S, D


def flash_mha_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       segment_ids: Optional[torch.Tensor], causal: bool,
                       scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel -> ``(out [B, H, S, D] bf16, lse [B, H, S]
    fp32)``."""
    global fwd_launches
    B, H, S, D = _check_operands(q, k, v, segment_ids)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    meta = tile_meta_workspace(segment_ids, B, S)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel("flash_mha_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(segment_ids),
            ptr(meta), out.data_ptr(), lse.data_ptr(), B, S, H, D,
            float(scale), int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"flash_mha_fwd launch failed (code {rc})")
    fwd_launches += 1
    return out, lse


def flash_mha_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, lse: torch.Tensor,
                       dout: torch.Tensor,
                       segment_ids: Optional[torch.Tensor], causal: bool,
                       scale: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward (delta, dK/dV, dQ passes) -> ``(dq, dk, dv)`` in
    bf16; deterministic (no atomics)."""
    global bwd_launches
    B, H, S, D = _check_operands(q, k, v, segment_ids)
    for name, t in (("out", out), ("dout", dout)):
        _check(t.shape == q.shape and t.dtype == q.dtype
               and t.device == q.device and t.is_contiguous()
               and t.data_ptr() % 16 == 0,
               f"{name} must be a contiguous {q.dtype} {tuple(q.shape)}")
    _check(lse.dtype == torch.float32 and tuple(lse.shape) == (B, H, S)
           and lse.is_contiguous() and lse.device == q.device,
           "lse must be contiguous float32 [B, H, S]")
    delta = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    meta = tile_meta_workspace(segment_ids, B, S)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel("flash_mha_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            ptr(segment_ids), ptr(meta), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, S, H, D, float(scale), int(bool(causal)),
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_mha_bwd launch failed (code {rc})")
    bwd_launches += 1
    return dq, dk, dv


# ---------------------------------------------------------------------------
# plain versions: fp32 torch, the formulas the kernels compute
# ---------------------------------------------------------------------------
def mha_mask(S: int, causal: bool, segment_ids: Optional[torch.Tensor],
             device) -> Optional[torch.Tensor]:
    """Boolean ``[B or 1, 1, S, S]`` (True = attend): causal and segment
    equality, segment 0 included; None when neither applies."""
    mask = None
    if causal:
        pos = torch.arange(S, device=device)
        mask = (pos[:, None] >= pos[None, :])[None, None]
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        mask = seg if mask is None else mask & seg
    return mask


def _scores(q, k, segment_ids, causal, scale):
    x = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    return x, mha_mask(q.shape[2], causal, segment_ids, q.device)


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    segment_ids: Optional[torch.Tensor], causal: bool,
                    scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward in fp32 -> ``(out [B, H, S, D] in q's dtype, lse [B, H,
    S] fp32)``."""
    x, mask = _scores(q, k, segment_ids, causal, scale)
    if mask is not None:
        x = x.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(x, dim=-1)
    p = torch.exp(x - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype).contiguous(), lse.contiguous()


def flash_mha_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor,
                        segment_ids: Optional[torch.Tensor], causal: bool,
                        scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward written out as the kernels compute it: ``P = exp(x -
    lse)``, ``dV = P^T dO``, ``dP = dO V^T``, ``dS = P * (dP - rowsum(dO *
    O))``, ``dQ = scale dS K``, ``dK = scale dS^T Q``; fp32 inside, results
    in the operands' dtypes."""
    x, mask = _scores(q, k, segment_ids, causal, scale)
    p = torch.exp(x - lse[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    do = dout.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v.float())
    delta = (do * out.float()).sum(-1)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return (dq.to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous())


class FlashMHA(torch.autograd.Function):
    """One MHA call over ``[B, H, S, D]``: the kernels (``impl="kernel"``)
    or the plain versions (``impl="plain"``).  Saves ``(q, k, v, out, lse,
    segment_ids)``; under ``torch.utils.checkpoint`` the forward runs again
    in the backward pass and saves them anew."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, scale, impl):
        if impl == "kernel":
            out, lse = flash_mha_fwd_cuda(q, k, v, segment_ids, causal, scale)
        else:
            out, lse = flash_mha_plain(q, k, v, segment_ids, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.causal, ctx.scale, ctx.impl = causal, scale, impl
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        fn = flash_mha_bwd_cuda if ctx.impl == "kernel" else flash_mha_bwd_plain
        dq, dk, dv = fn(q, k, v, out, lse, dout.contiguous(), segment_ids,
                        ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention_bshd(
    q: torch.Tensor,                                # [B, S, Hq, D]
    k: torch.Tensor,                                # [B, Skv, Hk, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,     # [B, S]
    attention_mask: Optional[torch.Tensor] = None,  # [B, Skv] padding mask
    scale: Optional[float] = None,
    logits_soft_cap: Optional[float] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Flash attention in the ``[B, S, H, D]`` convention; differentiable.
    ``impl`` None picks the kernels for CUDA tensors and the plain
    versions for CPU tensors; ``"kernel"`` / ``"plain"`` force one."""
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    if Hq % Hk != 0:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads {Hk}")
    if D > max(HEAD_DIMS):
        raise NotImplementedError(
            f"the flash rung at head_dim {D} (MLA's width) is not built: "
            "ROADMAP Queue 2 C item 7; the splash rung (impl=None, the "
            "default) takes head_dim 192")
    if logits_soft_cap is not None:
        raise NotImplementedError("soft cap not supported by the flash path")
    if S % BLOCK or k.shape[1] % BLOCK:
        raise ValueError(f"the flash rung takes sequences that are a multiple "
                         f"of {BLOCK}, got q {S} / kv {k.shape[1]}")
    impl = impl or ("kernel" if q.is_cuda else "plain")
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    scale = D ** -0.5 if scale is None else float(scale)
    segment_ids = fold_padding_into_segments((B, S), segment_ids,
                                             attention_mask)
    if segment_ids is not None:
        segment_ids = segment_ids.contiguous()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if Hk != Hq:
        kt = kt.repeat_interleave(Hq // Hk, dim=1)
        vt = vt.repeat_interleave(Hq // Hk, dim=1)
    out = FlashMHA.apply(qt.contiguous(), kt.contiguous(), vt.contiguous(),
                         segment_ids, causal, scale, impl)
    return out.transpose(1, 2)
