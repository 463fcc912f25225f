"""Training attention kernels: the ctypes wrappers of
``csrc/flash_attn_fwd.cu`` and ``csrc/flash_attn_bwd.cu`` (both built on
the ``wgmma`` + TMA attention core ``csrc/attn_core.cuh``, shared with the
flash rung), their plain PyTorch versions and the
``torch.autograd.Function`` that joins them (counterpart:
``automodel_tpu/ops/splash_attention.py``, whose Pallas splash kernel,
forward and fused dq/dkv backward, they replace).  The kernels' tile plan
(skip / full / partial tiles, item order) is mirrored in Python by
``ops/attention_plan.py``.

What is computed, on the JAX package's ``[B, S, H, D]`` layout: causal (or
full) grouped-query attention with ``Hq`` a multiple of ``Hk`` and no kv
repeat; packed-sequence segment ids ``[B, S]`` (0 = padding); a static
sliding window (attend ``[q - window + 1, q]``); an optional logit soft cap
``cap * tanh(x / cap)``; a softmax scale (default ``D ** -0.5``), applied
in fp32.  The forward also returns the row log-sum-exp ``lse [B, Hq, S]``
(fp32) that the backward reuses.

A query row with no key to attend (segment 0, or an empty window) has a
stated value here: ``out = 0``, ``lse = 0`` and zero gradient, in the
kernels and the plain versions alike.  The JAX rungs disagree on such rows
(the XLA SDPA rung gives the mean of all v rows); their labels are -100,
so no loss depends on them.

The kernels read segment ids, lse and delta through 1-D TMA boxes that
start at row offsets ``b S`` (and ``(b Hq + h) S``), which TMA needs
16-byte aligned: for a sequence length that is not a multiple of 4 (a
prompt's length at ``generate()``'s prefill) the wrappers pad the rows to
the next multiple of 4 as segment 0 (never attending, never attended:
every real row's result is the unpadded one's) and slice the results
back.

The wrappers check every operand and raise on anything the kernels do not
take (the kernels take bf16, head_dim 64, 128, 192 -- MLA's
``qk_nope + qk_rope`` width, v padded to it by the model -- or 256 --
Gemma's --, self-attention, any sequence length); they allocate outputs and scratch (the per-tile segment
ranges, delta) with ``torch`` on the current stream and raise if a launch
failed.  ``fwd_launches`` / ``bwd_launches`` count the
launches, ``plain_fwd_calls`` the plain forwards.  A remat policy can
keep the forward's ``(out, lse)`` (``ops/remat.py``, tag
``splash_residuals``).  There is no fallback:
:func:`splash_attention_bshd` takes the plain versions only for CPU
tensors or when asked by ``impl="plain"``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from automodel_tpu_torch.ops.attention import (
    fold_padding_into_segments,
    make_attention_mask,
)
from automodel_tpu_torch.ops.attention_plan import tile_meta_workspace
from automodel_tpu_torch.ops.kernel_lib.build import ptr
from automodel_tpu_torch.ops.remat import kept

HEAD_DIMS = (64, 128, 192, 256)

# kernel launches in this process (reset by callers that count a window),
# and the plain forward's calls through the op
fwd_launches = 0
bwd_launches = 0
plain_fwd_calls = 0

_fns = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from automodel_tpu_torch.ops.kernel_lib import build

        fn = getattr(build.load(name), name)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "flash_attn_fwd":
            fn.argtypes = [p, p, p, p, p, p, p,         # q k v seg meta out lse
                           i, i, i, i, i,               # B S Hq Hk D
                           f, f, i, i, p]               # scale cap causal win stream
        else:
            fn.argtypes = [p, p, p, p, p, p, p, p, p,   # q k v out dout lse delta seg meta
                           p, p, p,                     # dq dk dv
                           i, i, i, i, i,               # B S Hq Hk D
                           f, f, i, i, p]               # scale cap causal win stream
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attn: {msg}")


def _check_operands(q, k, v, segment_ids, causal, scale, logits_soft_cap,
                    local_window_size):
    _check(q.is_cuda, f"q must be a CUDA tensor, got {q.device}")
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
           "q, k, v must be [B, S, H, D]")
    B, S, Hq, D = q.shape
    _check(k.shape == v.shape and k.shape[0] == B and k.shape[3] == D,
           f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q "
           f"{tuple(q.shape)}")
    _check(k.shape[1] == S, f"self-attention only: kv length {k.shape[1]} "
           f"!= q length {S}")
    Hk = k.shape[2]
    _check(Hk >= 1 and Hq % Hk == 0,
           f"query heads {Hq} not a multiple of kv heads {Hk}")
    _check(D in HEAD_DIMS, f"head_dim {D} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.dtype == torch.bfloat16, f"{name} is {t.dtype}; the kernels "
               "take bfloat16 (run impl='plain' for other dtypes)")
        _check(t.device == q.device, f"{name} on {t.device}, q on {q.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
        _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    if segment_ids is not None:
        _check(segment_ids.dtype == torch.int32
               and tuple(segment_ids.shape) == (B, S)
               and segment_ids.is_contiguous()
               and segment_ids.device == q.device,
               f"segment_ids must be contiguous int32 [B, S] on {q.device}")
    if local_window_size is not None:
        _check(causal, "a window needs causal attention")
        _check(local_window_size >= 1, "local_window_size must be >= 1")
    if logits_soft_cap is not None:
        _check(logits_soft_cap > 0, "logits_soft_cap must be > 0")
    scale = D ** -0.5 if scale is None else float(scale)
    return (B, S, Hq, Hk, D, scale, float(logits_soft_cap or 0.0),
            int(bool(causal)), int(local_window_size or 0))


ROW_ALIGN = 4       # rows: 4 x 4-byte ids / lse / delta = 16 bytes


def _aligned_rows(S: int, segment_ids, B: int, device, *tensors):
    """``(segment ids, tensors)`` padded along the rows to a multiple of
    :data:`ROW_ALIGN`: the pad rows hold segment 0 (the real rows keep
    theirs, or 1 without segment ids) and zeros."""
    pad = -S % ROW_ALIGN
    seg = (torch.ones(B, S, dtype=torch.int32, device=device)
           if segment_ids is None else segment_ids)
    seg = torch.nn.functional.pad(seg, (0, pad)).contiguous()
    out = [torch.nn.functional.pad(
        t, (0, pad) if t.dim() == 3 else (0, 0, 0, 0, 0, pad)).contiguous()
        for t in tensors]
    return seg, out


def flash_attn_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        segment_ids: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None,
                        logits_soft_cap: Optional[float] = None,
                        local_window_size: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel -> ``(out [B, S, Hq, D] bf16, lse [B, Hq,
    S] fp32)``."""
    global fwd_launches
    B, S, Hq, Hk, D, scale, cap, causal_i, window = _check_operands(
        q, k, v, segment_ids, causal, scale, logits_soft_cap,
        local_window_size)
    if S % ROW_ALIGN:
        seg, (qp, kp, vp) = _aligned_rows(S, segment_ids, B, q.device, q, k,
                                          v)
        out, lse = flash_attn_fwd_cuda(
            qp, kp, vp, causal=causal, segment_ids=seg, scale=scale,
            logits_soft_cap=logits_soft_cap,
            local_window_size=local_window_size)
        return out[:, :S].contiguous(), lse[..., :S].contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(B, Hq, S, dtype=torch.float32, device=q.device)
    meta = tile_meta_workspace(segment_ids, B, S)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel("flash_attn_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(segment_ids),
            ptr(meta), out.data_ptr(), lse.data_ptr(), B, S, Hq, Hk, D,
            scale, cap, causal_i, window, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed (code {rc})")
    fwd_launches += 1
    return out, lse


def flash_attn_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        segment_ids: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None,
                        logits_soft_cap: Optional[float] = None,
                        local_window_size: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels (delta, then the dQ pass, then the dK /
    dV pass) -> ``(dq, dk, dv)`` in the operands' dtype; deterministic (no
    atomics: every element is written once)."""
    global bwd_launches
    B, S, Hq, Hk, D, scale, cap, causal_i, window = _check_operands(
        q, k, v, segment_ids, causal, scale, logits_soft_cap,
        local_window_size)
    for name, t in (("out", out), ("dout", dout)):
        _check(t.shape == q.shape and t.dtype == q.dtype
               and t.device == q.device and t.is_contiguous()
               and t.data_ptr() % 16 == 0,
               f"{name} must be a contiguous {q.dtype} {tuple(q.shape)}")
    _check(lse.dtype == torch.float32 and tuple(lse.shape) == (B, Hq, S)
           and lse.is_contiguous() and lse.device == q.device,
           "lse must be contiguous float32 [B, Hq, S]")
    if S % ROW_ALIGN:
        seg, (qp, kp, vp, op, dop, lp) = _aligned_rows(
            S, segment_ids, B, q.device, q, k, v, out, dout, lse)
        dq, dk, dv = flash_attn_bwd_cuda(
            qp, kp, vp, op, lp, dop, causal=causal, segment_ids=seg,
            scale=scale, logits_soft_cap=logits_soft_cap,
            local_window_size=local_window_size)
        return (dq[:, :S].contiguous(), dk[:, :S].contiguous(),
                dv[:, :S].contiguous())
    delta = torch.empty(B, Hq, S, dtype=torch.float32, device=q.device)
    meta = tile_meta_workspace(segment_ids, B, S)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel("flash_attn_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            ptr(segment_ids), ptr(meta), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, S, Hq, Hk, D, scale, cap, causal_i, window,
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd launch failed (code {rc})")
    bwd_launches += 1
    return dq, dk, dv


# ---------------------------------------------------------------------------
# plain versions: fp32 torch, the formulas the kernels compute
# ---------------------------------------------------------------------------
def _scores(q, k, causal, segment_ids, scale, logits_soft_cap,
            local_window_size):
    """``(x, dx, mask, scale)``: the (soft-capped) scaled scores ``[B, Hk,
    G, S, Skv]`` in fp32, their derivative by the scaled scores (None
    without a cap) and the mask ``[B or 1, 1, 1, S, Skv]`` (or None)."""
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    scale = D ** -0.5 if scale is None else float(scale)
    qg = q.float().reshape(B, S, Hk, Hq // Hk, D)
    x = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    dx = None
    if logits_soft_cap is not None:
        th = torch.tanh(x / logits_soft_cap)
        x = logits_soft_cap * th
        dx = 1.0 - th * th
    mask = make_attention_mask(
        S, k.shape[1], causal=causal, segment_ids_q=segment_ids,
        segment_ids_kv=segment_ids, local_window_size=local_window_size,
        device=q.device)
    return x, dx, None if mask is None else mask[:, :, None], scale


def splash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True,
                           segment_ids: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None,
                           logits_soft_cap: Optional[float] = None,
                           local_window_size: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward in fp32 -> ``(out [B, S, Hq, D] in q's dtype, lse [B,
    Hq, S] fp32)``; rows with no key give 0 and 0."""
    B, S, Hq, D = q.shape
    x, _, mask, _ = _scores(q, k, causal, segment_ids, scale,
                            logits_soft_cap, local_window_size)
    if mask is not None:
        x = x.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(x, dim=-1)
    lse = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    p = torch.exp(x - lse[..., None])
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return (out.reshape(B, S, Hq, D).to(q.dtype).contiguous(),
            lse.reshape(B, Hq, S).contiguous())


def splash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, out: torch.Tensor,
                               lse: torch.Tensor, dout: torch.Tensor, *,
                               causal: bool = True,
                               segment_ids: Optional[torch.Tensor] = None,
                               scale: Optional[float] = None,
                               logits_soft_cap: Optional[float] = None,
                               local_window_size: Optional[int] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """The backward written out with the formulas the CUDA kernel uses
    (not autograd through the forward): ``P = exp(x - lse)``, ``dV = P^T
    dO``, ``dP = dO V^T``, ``dS = P * (dP - rowsum(dO * O)) * dx/dS``,
    ``dQ = dS K``, ``dK = dS^T Q``.  fp32 inside; the results take the
    operands' dtypes."""
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    G = Hq // Hk
    x, dx, mask, scale = _scores(q, k, causal, segment_ids, scale,
                                 logits_soft_cap, local_window_size)
    p = torch.exp(x - lse.reshape(B, Hk, G, S)[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    dog = dout.float().reshape(B, S, Hk, G, D)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    delta = (dout.float() * out.float()).sum(-1)              # [B, S, Hq]
    delta = delta.reshape(B, S, Hk, G).permute(0, 2, 3, 1)    # [B, Hk, G, S]
    ds = p * (dp - delta[..., None])
    if dx is not None:
        ds = ds * dx
    ds = ds * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()).reshape(
        B, S, Hq, D)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds,
                      q.float().reshape(B, S, Hk, G, D))
    return (dq.to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous())


class SplashAttention(torch.autograd.Function):
    """Forward and backward of one attention call: the kernels
    (``impl="kernel"``) or the plain versions (``impl="plain"``, counted
    in ``plain_fwd_calls``).  Saves ``(q, k, v, out, lse)``; under
    ``torch.utils.checkpoint`` the forward runs again in the backward pass
    and saves them anew, unless the remat policy keeps ``(out, lse)`` (tag
    ``splash_residuals``, ``ops/remat.py::kept``): then the recomputation
    hands back the forward's and no forward kernel launches."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, scale, logits_soft_cap,
                local_window_size, impl):
        kw = dict(causal=causal, segment_ids=segment_ids, scale=scale,
                  logits_soft_cap=logits_soft_cap,
                  local_window_size=local_window_size)

        def compute():
            global plain_fwd_calls
            if impl == "kernel":
                return flash_attn_fwd_cuda(q, k, v, **kw)
            plain_fwd_calls += 1
            return splash_attention_plain(q, k, v, **kw)

        out, lse = kept("splash_residuals", compute)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.kw = kw
        ctx.impl = impl
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        kw = dict(ctx.kw, segment_ids=segment_ids)
        if ctx.impl == "kernel":
            dq, dk, dv = flash_attn_bwd_cuda(q, k, v, out, lse,
                                             dout.contiguous(), **kw)
        else:
            dq, dk, dv = splash_attention_bwd_plain(q, k, v, out, lse, dout,
                                                    **kw)
        return dq, dk, dv, None, None, None, None, None, None


def splash_attention_bshd(
    q: torch.Tensor,                                # [B, S, Hq, D]
    k: torch.Tensor,                                # [B, S, Hk, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,     # [B, S]
    attention_mask: Optional[torch.Tensor] = None,  # [B, S] padding mask
    scale: Optional[float] = None,
    logits_soft_cap: Optional[float] = None,
    local_window_size: Optional[int] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Differentiable attention in the ``[B, S, H, D]`` convention.
    ``impl`` None picks the kernels for CUDA tensors and the plain
    versions for CPU tensors; ``"kernel"`` / ``"plain"`` force one."""
    impl = impl or ("kernel" if q.is_cuda else "plain")
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    B, S = q.shape[:2]
    segment_ids = fold_padding_into_segments((B, S), segment_ids,
                                             attention_mask)
    if segment_ids is not None:
        segment_ids = segment_ids.contiguous()
    return SplashAttention.apply(
        q, k, v, segment_ids, causal, scale, logits_soft_cap,
        None if local_window_size is None else int(local_window_size), impl)
