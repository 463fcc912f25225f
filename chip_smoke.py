#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``automodel_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final ``ok`` line):

1. the card: ``torch.cuda.get_device_name`` and nvidia-smi's name and
   power limit;
2. build: every CUDA kernel of the port, from ``csrc/``, one ``nvcc`` per
   source, all started together (set-up);
3. paged-decode kernel: its wrapper against its plain PyTorch version on
   the card, at the serving path's shapes (Llama-3.2-1B: 32/8 heads,
   head_dim 64, plus head_dim 128; block size 16; batch 8; contexts up to
   2048; S = 1, 5, 32; bf16 and int8 pools; soft-cap and window);
4. attention kernels (forward and backward): each against its plain
   version at the SFT path's shapes (batch 8, S 2048, 32/8 heads, head_dim
   64, the segment ids of a packed batch of the SFT YAML's mock data), plus
   pure causal, head_dim 128, window 256, soft cap 30, S 1000 and the
   MHA head_dim-128 case of the Pallas flash kernel;
   for every kernel case: the kernel's time, the plain version's, one
   PyTorch library call's where one computes the same function, and the
   least time the card could take (bound);
5. engine: Llama-3.2-1B at full width (bf16, weights drawn from a seed)
   through the port's ``DecodeEngine`` with
   ``automodel_tpu_torch/examples/llama3_2_1b_serve.yaml``: the first step's
   logits against the same engine run with the plain attention, then 16
   requests (prompts of 64-1024 tokens, 64 new tokens each) with the
   launch counts zeroed just before and read just after, then a shorter
   int8-KV run the same way, then two profiled windows;
6. sft: Llama-3.2-1B at full width and depth trained by the port's recipe
   on ``automodel_tpu_torch/examples/llama3_2_1b_sft.yaml``: the first
   step's loss and gradient (2 rows of the first batch) through the
   attention kernels against the plain attention, 2 warm-up steps, then
   the timed steps with the launch counts zeroed just before and read just
   after (step time, tokens/s, MFU, peak memory), then a profiled window.

The second-to-last line is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor-core peak
L2_FLUSH_BYTES = 64 << 20          # > the 50 MB L2: each timed launch is cold

# bf16 output: one ulp at |x| in [2, 4) is 1.6e-2, and the two versions
# round from fp32 sums taken in another order
KERNEL_ATOL = KERNEL_RTOL = 2e-2
# first-step logits, kernel vs plain attention: both round activations to
# bf16 at every projection of 16 layers and the attention outputs differ by
# about one bf16 ulp, which the layers carry; 5 % of the logit range holds
# that, while a wrong kernel moves logits by O(range)
LOGITS_REL_TOL = 5e-2
# attention gradients, kernel vs plain, as relative L2 error over the whole
# tensor: the kernel rounds P and dS to bf16 before its products (the
# plain version keeps fp32) and writes bf16, ~2^-9 relative per element; a
# wrong formula moves them by O(1)
GRAD_REL_L2 = 2e-2
# SFT first step, attention kernels vs the plain attention through the
# bf16 model: the loss within 1 % and the whole gradient (every parameter,
# relative L2) within 10 %.  Both versions round to bf16 at every
# projection of 16 layers and in the backward of each, which amplifies
# small differences: two kernel runs that differ only in the order of the
# dQ atomics already differ by ~1.3 %, kernel vs plain by ~3.8 % (an H100
# run of this script).  A wrong kernel moves both by O(1).
SFT_LOSS_REL_TOL = 1e-2
SFT_GRAD_REL_L2 = 1e-1
SFT_YAML = os.path.join(REPO, "automodel_tpu_torch", "examples",
                        "llama3_2_1b_sft.yaml")
SFT_WARMUP, SFT_STEPS, SFT_PROFILED = 2, 6, 2


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def time_ms(fn, iters, flush=None):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events),
    after a warm-up; ``flush`` (a large buffer) is rewritten before each
    launch so the L2 holds none of its inputs."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------
KERNEL_CASES = [
    # (name, S, D, kv dtype, soft_cap, window); the first is the decode
    # step of the engine phase and stands for the kernel in the JSON line
    ("decode_d64_bf16", 1, 64, "bf16", None, None),
    ("decode_d64_int8", 1, 64, "int8", None, None),
    ("verify_s5_d64_bf16", 5, 64, "bf16", None, None),
    ("chunk_s32_d64_bf16", 32, 64, "bf16", None, None),
    ("chunk_s32_d64_int8", 32, 64, "int8", None, None),
    ("decode_d64_bf16_cap_window", 1, 64, "bf16", 30.0, 256),
    ("chunk_s32_d64_bf16_window", 32, 64, "bf16", None, 256),
    ("decode_d128_bf16", 1, 128, "bf16", None, None),
    ("verify_s5_d128_int8_cap", 5, 128, "int8", 30.0, None),
    ("chunk_s32_d128_bf16_window", 32, 128, "bf16", None, 512),
]


def make_paged_case(S, D, kv, seed, B=8, Hq=32, Hk=8, BS=16, MB=128):
    """Operands at the engine's layout: scrambled per-row tables whose
    entries past the context point at the null page 0, ragged contexts up
    to MB * BS = 2048 (row 0 full), consecutive positions ending at ctx-1."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    NB = B * MB + 1
    q = torch.randn(B, S, Hq, D, device=dev, generator=g).bfloat16()
    if kv == "int8":
        k = torch.randint(-127, 128, (NB, BS, Hk, D), device=dev,
                          dtype=torch.int8, generator=g)
        v = torch.randint(-127, 128, (NB, BS, Hk, D), device=dev,
                          dtype=torch.int8, generator=g)
        ks = torch.rand(NB, BS, Hk, device=dev, generator=g) * 0.015 + 0.005
        vs = torch.rand(NB, BS, Hk, device=dev, generator=g) * 0.015 + 0.005
    else:
        k = torch.randn(NB, BS, Hk, D, device=dev, generator=g).bfloat16()
        v = torch.randn(NB, BS, Hk, D, device=dev, generator=g).bfloat16()
        ks = vs = None
    tables = (torch.randperm(NB - 1, device=dev, generator=g) + 1).view(
        B, MB).int()
    ctx = torch.randint(max(S, 64), MB * BS + 1, (B,), device=dev,
                        generator=g).int()
    ctx[0] = MB * BS
    pages = (ctx + BS - 1) // BS
    tables[torch.arange(MB, device=dev)[None, :] >= pages[:, None]] = 0
    pos = (ctx[:, None] - S + torch.arange(S, device=dev)[None, :]).int()
    return q, k, v, ks, vs, tables, ctx, pos


def paged_bound(q, k, ks, tables, ctx, pos, window):
    """(bound_ms, bound_by): the bytes the function must move -- q and the
    output once, and for each row the k/v (+ scales) of the positions its
    queries can attend, with their table entries -- over HBM bandwidth,
    against the score and p@v operations over the bf16 peak."""
    B, S, Hq, D = q.shape
    Hk, BS = k.shape[2], k.shape[1]
    kv_bytes = 2 * Hk * D * k.element_size() + (2 * Hk * 4 if ks is not None
                                                 else 0)
    nbytes = 2 * q.numel() * q.element_size() + ctx.numel() * 4 \
        + pos.numel() * 4
    ops = 0
    for b in range(B):
        lo = int(pos[b].min())
        hi = min(int(ctx[b]), int(pos[b].max()) + 1)
        first = max(0, lo - window + 1) if window else 0
        keys = hi - first
        nbytes += keys * kv_bytes + (-(-hi // BS) - first // BS) * 4
        ops += 4 * S * Hq * D * keys
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library_call(q, k, v, tables, ctx, pos, window):
    """One PyTorch call computing the same function (bf16 pools, no soft
    cap): ``scaled_dot_product_attention`` over the cache gathered by table
    (the gather is set-up, not timed).  A yardstick only; the port never
    calls it."""
    import torch
    import torch.nn.functional as F

    B, S, Hq, D = q.shape
    idx = tables.long()
    K = idx.shape[1] * k.shape[1]
    keys = k[idx].reshape(B, K, k.shape[2], D).transpose(1, 2).contiguous()
    vals = v[idx].reshape(B, K, k.shape[2], D).transpose(1, 2).contiguous()
    kv_pos = torch.arange(K, device=q.device)
    mask = (kv_pos[None, None, :] < ctx[:, None, None]) \
        & (kv_pos[None, None, :] <= pos[:, :, None])
    if window:
        mask &= kv_pos[None, None, :] > pos[:, :, None] - window
    mask = mask[:, None]                                  # [B, 1, S, K]
    qt = q.transpose(1, 2).contiguous()

    def run():
        return F.scaled_dot_product_attention(qt, keys, vals, attn_mask=mask,
                                              enable_gqa=True)

    return run, lambda out: out.transpose(1, 2)


def kernel_phase(flush):
    import torch

    from automodel_tpu_torch.ops import paged_attention as tpa
    from automodel_tpu_torch.ops import paged_attention_kernel as pak

    rows = []
    for i, (name, S, D, kv, cap, win) in enumerate(KERNEL_CASES):
        q, k, v, ks, vs, tables, ctx, pos = make_paged_case(S, D, kv, seed=i)
        kw = dict(logits_soft_cap=cap, local_window_size=win)
        args = (q, k, v, ks, vs, tables, ctx, pos)
        out = pak.paged_decode_cuda(*args, **kw)
        torch.cuda.synchronize()
        ref = tpa.paged_attention_plain(*args, **kw)
        check(out.shape == ref.shape and out.dtype == q.dtype,
              f"{name}: output {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        bad = diff > KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()
        check(not bool(bad.any()),
              f"{name}: kernel disagrees with the plain version "
              f"(max_abs_err {err:.3e}, {int(bad.sum())} elements)")
        kernel_ms = time_ms(lambda: pak.paged_decode_cuda(*args, **kw), 20,
                            flush)
        plain_ms = time_ms(lambda: tpa.paged_attention_plain(*args, **kw), 5,
                           flush)
        library_ms = None
        if kv == "bf16" and cap is None:
            run, back = library_call(q, k, v, tables, ctx, pos, win)
            lib_err = float((back(run()).float() - ref.float()).abs().max())
            check(lib_err <= KERNEL_ATOL * 4,
                  f"{name}: the library yardstick computes something else "
                  f"({lib_err:.3e})")
            library_ms = time_ms(run, 20, flush)
        bound_ms, bound_by = paged_bound(q, k, ks, tables, ctx, pos, win)
        row = dict(case=name, S=S, D=D, kv=kv, soft_cap=cap, window=win,
                   max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        print("kernel_case " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# attention kernel phase
# ---------------------------------------------------------------------------
ATTN_CASES = [
    # (name, B, S, Hq, Hk, D, packed segments, window, soft cap); the first
    # is the SFT path's case and stands for the kernels in the JSON line
    ("sft_packed_d64", 8, 2048, 32, 8, 64, True, None, None),
    ("causal_d64", 8, 2048, 32, 8, 64, False, None, None),
    ("packed_d128", 8, 2048, 32, 8, 128, True, None, None),
    ("window256_d64", 8, 2048, 32, 8, 64, False, 256, None),
    ("packed_cap30_d64", 8, 2048, 32, 8, 64, True, None, 30.0),
    ("ragged_s1000_d64", 8, 1000, 32, 8, 64, False, None, None),
    # the Pallas flash kernel's case (ops/flash_attention.py): MHA,
    # head_dim 128, segment ids
    ("mha_packed_d128", 8, 2048, 16, 16, 128, True, None, None),
]


def sft_segment_ids():
    """The segment ids [8, 2048] of the first batch the SFT recipe's loader
    yields for ``llama3_2_1b_sft.yaml`` (its mock data, packed)."""
    from automodel_tpu_torch.config.loader import parse_args_and_load_config
    from automodel_tpu_torch.recipes.llm import train_ft

    cfg = parse_args_and_load_config(["-c", SFT_YAML])
    loader = train_ft.build_dataloader(
        cfg, cfg.dataset.instantiate(), "dataloader",
        int(cfg.get("step_scheduler.local_batch_size")),
        int(cfg.get("rng.seed")))
    return next(iter(loader))["segment_ids"]


def attn_bound(q, k, seg, pairs, backward):
    """(bound_ms, bound_by): q, k, v, out and lse (plus dout, dq, dk, dv
    for the backward) and the segment ids moved once over HBM bandwidth,
    against 4 (forward) or 10 (backward) * D * Hq flops per attended
    (q, k) pair over the bf16 peak."""
    B, S, Hq, D = q.shape
    nq, nkv = q.numel() * 2, 2 * k.numel() * 2
    nbytes = 2 * nq + nkv + B * Hq * S * 4 + (seg.numel() * 4 if seg
                                               is not None else 0)
    if backward:
        nbytes += 2 * nq + nkv                # dout, dq; dk, dv
    ops = (10 if backward else 4) * D * Hq * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attn_library(q, k, v, dout, mask, causal_only, scale):
    """``scaled_dot_product_attention`` on the same operands ([B, H, S, D]
    copies made here, not timed; ``enable_gqa``; ``is_causal`` or the dense
    boolean mask): ``(run_fwd, run_bwd, to_bshd)``.  A yardstick only; the
    port never calls it."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    kw = dict(is_causal=True) if causal_only else dict(attn_mask=mask)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, scale=scale,
                                              enable_gqa=True, **kw)

    out = fwd()
    dt = dout.transpose(1, 2).contiguous()

    def bwd():
        return torch.autograd.grad(out, (qt, kt, vt), dt, retain_graph=True)

    return fwd, bwd, lambda o: o.transpose(1, 2)


def attention_phase(flush, seg_np):
    import torch

    from automodel_tpu_torch.ops import splash_attention as sa
    from automodel_tpu_torch.ops.attention import make_attention_mask

    dev = torch.device("cuda")
    rows = []
    for i, (name, B, S, Hq, Hk, D, packed, win, cap) in enumerate(ATTN_CASES):
        g = torch.Generator(device=dev).manual_seed(100 + i)
        q = torch.randn(B, S, Hq, D, device=dev, generator=g).bfloat16()
        k = torch.randn(B, S, Hk, D, device=dev, generator=g).bfloat16()
        v = torch.randn(B, S, Hk, D, device=dev, generator=g).bfloat16()
        dout = torch.randn(B, S, Hq, D, device=dev, generator=g).bfloat16()
        seg = (torch.from_numpy(seg_np[:B, :S]).to(dev).contiguous()
               if packed else None)
        kw = dict(causal=True, segment_ids=seg, logits_soft_cap=cap,
                  local_window_size=win)
        mask = make_attention_mask(S, S, causal=True, segment_ids_q=seg,
                                   segment_ids_kv=seg,
                                   local_window_size=win, device=dev)
        mask = mask.expand(B, 1, S, S)
        pairs = int(mask.sum())
        valid = mask.any(-1)[:, 0]                        # [B, S] rows

        out, lse = sa.flash_attn_fwd_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        ref, ref_lse = sa.splash_attention_plain(q, k, v, **kw)
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        diff = (out.float() - ref.float()).abs()[valid]
        fwd_err = float(diff.max())
        bad = diff > KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()[valid]
        check(not bool(bad.any()),
              f"{name}: forward kernel disagrees with the plain version "
              f"(max_abs_err {fwd_err:.3e}, {int(bad.sum())} elements)")
        lse_err = float((lse - ref_lse).abs().transpose(1, 2)[valid].max())
        check(lse_err <= 1e-2, f"{name}: lse max_abs_err {lse_err:.3e}")
        check(bool((out[~valid] == 0).all()),
              f"{name}: rows with no key are not 0")

        grads = sa.flash_attn_bwd_cuda(q, k, v, ref, ref_lse, dout, **kw)
        torch.cuda.synchronize()
        refs = sa.splash_attention_bwd_plain(q, k, v, ref, ref_lse, dout,
                                             **kw)
        bwd_err, rel = 0.0, {}
        for gname, got, want in zip(("dq", "dk", "dv"), grads, refs):
            check(bool(torch.isfinite(got).all()), f"{name}: non-finite {gname}")
            rel[gname] = float((got.float() - want.float()).norm()
                               / want.float().norm())
            bwd_err = max(bwd_err, float((got.float() - want.float())
                                         .abs().max()))
            check(rel[gname] <= GRAD_REL_L2,
                  f"{name}: backward kernel {gname} relative L2 error "
                  f"{rel[gname]:.3e} > {GRAD_REL_L2}")
        del grads, refs

        fwd_ms = time_ms(lambda: sa.flash_attn_fwd_cuda(q, k, v, **kw), 10,
                         flush)
        bwd_ms = time_ms(lambda: sa.flash_attn_bwd_cuda(
            q, k, v, ref, ref_lse, dout, **kw), 10, flush)
        fwd_plain = time_ms(lambda: sa.splash_attention_plain(q, k, v, **kw),
                            3, flush)
        bwd_plain = time_ms(lambda: sa.splash_attention_bwd_plain(
            q, k, v, ref, ref_lse, dout, **kw), 3, flush)
        fwd_lib = bwd_lib = None
        if cap is None:
            lib_fwd, lib_bwd, back = attn_library(
                q, k, v, dout, mask, not packed and win is None, D ** -0.5)
            lib_err = float((back(lib_fwd().detach()).float() - ref.float())
                            .abs()[valid].max())
            check(lib_err <= KERNEL_ATOL * 4,
                  f"{name}: the library yardstick computes something else "
                  f"({lib_err:.3e})")
            fwd_lib = time_ms(lib_fwd, 10, flush)
            bwd_lib = time_ms(lib_bwd, 10, flush)
            del lib_fwd, lib_bwd
        fb, fby = attn_bound(q, k, seg, pairs, backward=False)
        bb, bby = attn_bound(q, k, seg, pairs, backward=True)
        row = dict(case=name, B=B, S=S, Hq=Hq, Hk=Hk, D=D, packed=packed,
                   window=win, soft_cap=cap, attended_pairs=pairs,
                   fwd=dict(ms=fwd_ms, plain_ms=fwd_plain, library_ms=fwd_lib,
                            bound_ms=fb, bound_by=fby, max_abs_err=fwd_err,
                            lse_max_abs_err=lse_err),
                   bwd=dict(ms=bwd_ms, plain_ms=bwd_plain, library_ms=bwd_lib,
                            bound_ms=bb, bound_by=bby, max_abs_err=bwd_err,
                            rel_l2=rel))
        print("attention_case " + json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, dout, out, lse, ref, ref_lse, mask
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# engine phase
# ---------------------------------------------------------------------------
def engine_phase():
    import numpy as np
    import torch

    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.generation import GenerationConfig
    from automodel_tpu_torch.ops import paged_attention as tpa
    from automodel_tpu_torch.ops import paged_attention_kernel as pak
    from automodel_tpu_torch.serving import (
        DecodeEngine,
        RequestState,
        build_serving_config,
    )

    cfg = load_yaml_config(os.path.join(
        REPO, "automodel_tpu_torch", "examples", "llama3_2_1b_serve.yaml"))
    scfg = build_serving_config(cfg)
    gen = GenerationConfig(**cfg.generation.to_dict())
    t0 = time.perf_counter()
    model = cfg.model.instantiate(seed=0, device="cuda")
    torch.cuda.synchronize()
    mcfg = model.config
    print(f"engine: Llama-3.2-1B widths (vocab {mcfg.vocab_size}, hidden "
          f"{mcfg.hidden_size}, ffn {mcfg.intermediate_size}, layers "
          f"{mcfg.num_hidden_layers}, heads {mcfg.num_attention_heads}/"
          f"{mcfg.num_key_value_heads}, head_dim {mcfg.head_dim}), "
          f"{sum(p.numel() for p in model.parameters())} params "
          f"{model.param_dtype}, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, mcfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 1025, 16)]

    # first step: kernel vs the plain attention, chosen by argument
    firsts = {}
    for impl in ("plain", "kernel"):
        eng = DecodeEngine(model, scfg, generation=gen, attn_impl=impl)
        for p in prompts:
            eng.submit(p)
        eng.step()
        firsts[impl] = eng.last_logits.clone()
        del eng
    torch.cuda.empty_cache()
    ref, got = firsts["plain"], firsts["kernel"]
    check(bool(torch.isfinite(got).all()), "first-step logits not finite")
    span = float(ref.abs().max())
    err = float((got - ref).abs().max())
    check(err <= LOGITS_REL_TOL * span,
          f"first-step logits: kernel vs plain max_abs_err {err:.4f} > "
          f"{LOGITS_REL_TOL} * {span:.3f}")
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"engine first step: logits {tuple(got.shape)} max_abs_err {err:.4f}"
          f" (logit range {span:.3f}, tol {LOGITS_REL_TOL * span:.4f}), "
          f"argmax agreement {agree:.3f}", flush=True)

    # warm-up off the clock: first launches of every op at both widths
    warm = DecodeEngine(model, scfg, generation=gen)
    warm.submit(prompts[0][:40], max_new_tokens=4)
    warm.run()
    del warm

    def drive(serving, requests, max_new, label):
        eng = DecodeEngine(model, serving, generation=gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pak.launches = 0                  # counts zeroed just before the run
        tpa.long_q_gather_calls = 0
        t0 = time.perf_counter()
        for p in requests:
            eng.submit(p, max_new_tokens=max_new)
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, gathers = pak.launches, tpa.long_q_gather_calls
        st = eng.stats()
        states = {r.state for r in eng.requests.values()}
        check(states == {RequestState.FINISHED},
              f"{label}: not every request finished: {st['outcomes']}")
        check(st["kernel_launches"] == launches,
              f"{label}: engine counted {st['kernel_launches']} launches, "
              f"the wrapper {launches}")
        check(launches == mcfg.num_hidden_layers * st["steps"],
              f"{label}: {launches} kernel launches != "
              f"{mcfg.num_hidden_layers} layers x {st['steps']} steps")
        check(gathers == 0, f"{label}: {gathers} long-query gather calls")
        check(bool(torch.isfinite(eng.last_logits).all()),
              f"{label}: non-finite logits")
        report = dict(
            run=label, requests=len(requests), max_new_tokens=max_new,
            decode_tok_s=st["tokens_generated"] / wall, wall_s=wall,
            steps=st["steps"], decode_steps=st["decode_steps"],
            mixed_steps=st["mixed_steps"], kernel_launches=launches,
            launches_per_step=launches / st["steps"],
            tokens_generated=st["tokens_generated"],
            preemptions=st["preemptions"], kv_pool_bytes=st["kv_pool_bytes"],
            peak_mem_bytes=torch.cuda.max_memory_allocated())
        print("engine_run " + json.dumps(report), flush=True)
        return report

    main = drive(scfg, prompts, gen.max_new_tokens, "bf16_kv")
    int8 = build_serving_config(
        {**cfg.serving.to_dict(), "kv_cache_dtype": "int8"})
    drive(int8, prompts[:8], 32, "int8_kv")

    # where a step's time goes: a profiled window of prefill-carrying
    # steps, then one of pure decode steps, on a fresh engine
    eng = DecodeEngine(model, scfg, generation=gen)
    for p in prompts[:8]:
        eng.submit(p)

    def steps(n):
        return lambda: [eng.step() for _ in range(n)]

    profile_window(steps(6), 6, "mixed_w32", ("paged_decode",))
    while any(len(r.pending) > 1 for r in eng.scheduler.active):
        eng.step()
    profile_window(steps(10), 10, "decode_w1", ("paged_decode",))
    eng.run()
    return main


# device-time buckets of a profiled window, by kernel name (first match)
KERNEL_KINDS = [
    ("gemm", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("loss", ("softmax", "nll_loss", "cross_entropy")),    # lower case
    ("optimizer", ("multi_tensor_apply", "foreach", "adam")),
    ("reduce", ("reduce_kernel",)),
    ("elementwise_and_copy", ("elementwise", "copy", "index", "cat")),
]


def profile_window(run, steps, label, attn_names):
    """Run ``run()`` (``steps`` steps) under ``torch.profiler`` and print
    the host time per step, the device time per step (sum of the kernels'
    own times), the idle share, the attention kernels' time per step
    (kernel names containing one of ``attn_names``) and the kernels that
    take the most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if (dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            kernels.append((dev_us / 1e3 / steps, evt.count / steps,
                            evt.key[:80]))
    kernels.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels)
    attn_ms = sum(k[0] for k in kernels
                  if any(n in k[2] for n in attn_names))
    by_kind = {}
    for ms, _, name in kernels:
        kind = next((kind for kind, keys in KERNEL_KINDS
                     if any(key in name.lower() for key in keys)), "other")
        if any(n in name for n in attn_names):
            kind = "attention"
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    report = dict(
        window=label, steps=steps, host_ms_per_step=host_ms,
        device_ms_per_step=device_ms if kernels else "not measured",
        device_idle_share=(1 - device_ms / host_ms) if kernels else None,
        attention_ms_per_step=attn_ms, ms_per_step_by_kind=by_kind,
        kernels_per_step=sum(k[1] for k in kernels),
        top=[dict(ms_per_step=k[0], calls_per_step=k[1], name=k[2])
             for k in kernels[:12]])
    print("profile " + json.dumps(report), flush=True)
    return report


# ---------------------------------------------------------------------------
# sft phase
# ---------------------------------------------------------------------------
def sft_first_step_check(recipe):
    """Loss and whole gradient of the first step (2 rows of the first batch,
    the recipe's initial weights), attention kernels vs the plain
    attention; nothing is updated.  A second kernel pass measures the
    run-to-run floor (the dQ atomics sum in another order each run)."""
    import torch

    from automodel_tpu_torch.training.train_step import (
        microbatch_loss,
        to_device_batch,
    )

    model = recipe.model
    names = [n for n, _ in model.named_parameters()]
    first = next(iter(recipe.dataloader))
    mb = {k: v[0] for k, v in to_device_batch(
        [{k: v[:2] for k, v in first.items()}], recipe.device).items()}
    losses, grads = {}, {}
    for impl in ("plain", "kernel", "kernel_again"):
        model.zero_grad(set_to_none=True)
        loss = microbatch_loss(model, recipe.loss_fn, mb,
                               attn_impl=impl.split("_")[0])
        loss.backward()
        torch.cuda.synchronize()
        losses[impl] = float(loss.detach())
        grads[impl] = [p.grad for p in model.parameters()]
        check(all(bool(torch.isfinite(g).all()) for g in grads[impl]),
              f"first step ({impl}): non-finite gradient")
    model.zero_grad(set_to_none=True)

    def rel_l2(a, b):
        num = den = 0.0
        per = []
        for n, x, y in zip(names, grads[a], grads[b]):
            d = float((x.float() - y.float()).square().sum())
            w = float(y.float().square().sum())
            num, den = num + d, den + w
            per.append(((d / max(w, 1e-30)) ** 0.5, n))
        return (num / den) ** 0.5, sorted(per, reverse=True)[:3]

    rel_grad, worst = rel_l2("kernel", "plain")
    floor, _ = rel_l2("kernel_again", "kernel")
    del grads
    torch.cuda.empty_cache()
    rel_loss = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
    print("sft first step: " + json.dumps(dict(
        rows=2, loss_kernel=losses["kernel"], loss_plain=losses["plain"],
        loss_rel_err=rel_loss, grad_rel_l2=rel_grad,
        grad_rel_l2_kernel_vs_kernel=floor,
        worst_params=[dict(name=n, rel_l2=r) for r, n in worst],
        loss_tol=SFT_LOSS_REL_TOL, grad_tol=SFT_GRAD_REL_L2)), flush=True)
    check(rel_loss <= SFT_LOSS_REL_TOL,
          f"first-step loss kernel vs plain: relative error {rel_loss:.3e}")
    check(rel_grad <= SFT_GRAD_REL_L2,
          f"first-step gradient kernel vs plain: relative L2 {rel_grad:.3e}")


def sft_phase():
    import torch

    from automodel_tpu_torch.config.loader import parse_args_and_load_config
    from automodel_tpu_torch.ops import splash_attention as sa
    from automodel_tpu_torch.recipes.llm import train_ft

    cfg = parse_args_and_load_config(
        ["-c", SFT_YAML, "--step_scheduler.max_steps", str(SFT_WARMUP)])
    t0 = time.perf_counter()
    recipe = train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg).setup()
    torch.cuda.synchronize()
    mcfg = recipe.model.config
    L = mcfg.num_hidden_layers
    print(f"sft: Llama-3.2-1B widths (vocab {mcfg.vocab_size}, hidden "
          f"{mcfg.hidden_size}, ffn {mcfg.intermediate_size}, layers {L}, "
          f"heads {mcfg.num_attention_heads}/{mcfg.num_key_value_heads}, "
          f"head_dim {mcfg.head_dim}), "
          f"{sum(p.numel() for p in recipe.model.parameters())} params "
          f"{recipe.model.param_dtype}, remat {recipe.model.remat_policy}, "
          f"set up in {time.perf_counter() - t0:.1f} s", flush=True)
    sft_first_step_check(recipe)

    recipe.run_train_validation_loop()                   # warm-up steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sa.fwd_launches = sa.bwd_launches = 0   # counts zeroed just before
    recipe.step_scheduler.max_steps = SFT_WARMUP + SFT_STEPS
    t0 = time.perf_counter()
    recipe.run_train_validation_loop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = sa.fwd_launches, sa.bwd_launches
    peak = torch.cuda.max_memory_allocated()
    timed = recipe.history[SFT_WARMUP:]
    check(len(timed) == SFT_STEPS, f"sft ran {len(timed)} timed steps")
    check(fwd == 2 * L * SFT_STEPS,
          f"sft: {fwd} forward kernel launches != 2 x {L} layers x "
          f"{SFT_STEPS} steps (forward + remat recompute)")
    check(bwd == L * SFT_STEPS,
          f"sft: {bwd} backward kernel launches != {L} layers x "
          f"{SFT_STEPS} steps")
    for m in recipe.history:
        check(all(map(math.isfinite, (m["loss"], m["grad_norm"]))),
              f"sft step {m['step']}: non-finite loss/grad_norm")
        print(f"sft step {m['step']}: loss {m['loss']:.4f} grad_norm "
              f"{m['grad_norm']:.4f} step_time {m['step_time']:.4f} s",
              flush=True)
    B = int(cfg.get("step_scheduler.global_batch_size"))
    S = int(cfg.get("packed_sequence.packed_sequence_size"))
    tok_s = B * S * SFT_STEPS / wall
    flops_per_token = (recipe.model.flops_per_token()
                       + recipe.model.attention_flops_per_token(S))
    report = dict(
        steps=SFT_STEPS, batch=B, seq_len=S, wall_s=wall,
        step_ms=wall * 1e3 / SFT_STEPS, tokens_per_s=tok_s,
        nonpad_tokens_per_s=sum(m["tps"] * m["step_time"] for m in timed)
        / wall, flops_per_token=flops_per_token,
        mfu=tok_s * flops_per_token / BF16_OPS_PER_S,
        fwd_launches=fwd, bwd_launches=bwd, peak_mem_bytes=peak,
        losses=[m["loss"] for m in recipe.history],
        grad_norms=[m["grad_norm"] for m in recipe.history])
    print("sft_run " + json.dumps(report), flush=True)

    def more():
        recipe.step_scheduler.max_steps += SFT_PROFILED
        recipe.run_train_validation_loop()

    profile_window(more, SFT_PROFILED, "sft_b8_s2048", ("flash_",))
    return report


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    sys.path.insert(0, REPO)
    try:
        from automodel_tpu_torch.ops.kernel_lib import build
    except ImportError as e:
        fail(f"the automodel_tpu_torch package is not beside this script "
             f"({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})", flush=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)

    t0 = time.perf_counter()
    sources = ["paged_decode", "flash_attn_fwd", "flash_attn_bwd"]
    build.build_many(sources)
    print(f"build: {', '.join(n + '.cu' for n in sources)} (one nvcc each, "
          f"in parallel) in {time.perf_counter() - t0:.1f} s", flush=True)

    seg = sft_segment_ids()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    cases = kernel_phase(flush)
    attn_cases = attention_phase(flush, seg)
    del flush
    main_run = engine_phase()
    torch.cuda.empty_cache()
    sft = sft_phase()

    rep = cases[0]
    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": "automodel_tpu_torch/csrc/paged_decode.cu",
        "replaces": "automodel_tpu/ops/paged_attention_kernel.py:113",
        "launches": main_run["kernel_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": rep["ms"], "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"],
    }]
    for part, launches in (("fwd", sft["fwd_launches"]),
                           ("bwd", sft["bwd_launches"])):
        rep = attn_cases[0][part]
        kernels.append({
            "name": f"flash_attn_{part}", "route": "cuda",
            "source": f"automodel_tpu_torch/csrc/flash_attn_{part}.cu",
            "replaces": "automodel_tpu/ops/splash_attention.py:129",
            "launches": launches,
            "max_abs_err": max(c[part]["max_abs_err"] for c in attn_cases),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
