"""Compare the CUDA kernels' outputs of two checkouts, bit for bit.

Runs every matrix-product kernel of the port (qdot, the linear-CE forward,
dlogits, dh and dW, gmm and its dlhs, tgmm, gmm_quant) and both attention
rungs' forward and backward (splash: packed GQA and pure causal; flash:
MHA with padding) on inputs drawn from fixed seeds on the card, in a fresh
process per checkout, hashes each output's bytes and prints one
``kernel_digest`` JSON line: per kernel, both digests and whether they are
equal::

    python -m automodel_tpu_torch.tools.kernel_digest --a . --b <other>

A kernel whose arithmetic a change left alone gives equal digests; one
whose summation order changed (a new product) does not, however close.
Only the wrappers' calls that both checkouts share are used.  Needs a
card; each process builds its checkout's kernels at first use.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import torch


def _digest(t: torch.Tensor) -> str:
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]


def digests() -> dict:
    """The hashes of every kernel's outputs in this process's checkout."""
    from automodel_tpu_torch.ops import flash_attention as fa
    from automodel_tpu_torch.ops import gmm_kernel as gk
    from automodel_tpu_torch.ops import gmm_quant_kernel as gq
    from automodel_tpu_torch.ops import linear_ce_kernel as lce
    from automodel_tpu_torch.ops import qdot_kernel as qk
    from automodel_tpu_torch.ops import splash_attention as spl
    from automodel_tpu_torch.ops.quant import _operand_scales

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=g)
                * scale).bfloat16()

    out = {}
    e4, e5, i8 = torch.float8_e4m3fn, torch.float8_e5m2, torch.int8
    # qdot: forward (K-major both), dgrad (N-major b), wgrad (M-major a,
    # split K: a narrow output)
    x, w = randn(4096, 2048), randn(2048, 2048, scale=0.05)
    for name, a, b, a_q, b_q in (
            ("qdot_forward_e4m3", x, w.t(), e4, e4),
            ("qdot_forward_int8", x, w.t(), i8, i8),
            ("qdot_dgrad_e5m2", x, w, e5, e4),
            ("qdot_wgrad_e4m3_e5m2", x.t(), randn(4096, 512), e4, e5)):
        sa, sb = _operand_scales(a, b, a_q, b_q, False)
        out[name] = _digest(qk.qdot_cuda(a, b, sa, sb, a_q, b_q))
    # linear CE: T 4096, H 2048, V 50257 (a vocab tail), labels with -100
    T, H, V = 4096, 2048, 50257
    h, ws = randn(T, H), randn(V, H, scale=0.02)
    labels = torch.randint(0, V, (T,), device=dev, generator=g,
                           dtype=torch.int32)
    labels[::5] = -100
    lse, pick = lce.linear_ce_fwd_cuda(h, ws.t(), labels)
    out["linear_ce_fwd_lse"], out["linear_ce_fwd_pick"] = (_digest(lse),
                                                           _digest(pick))
    ref_lse, _ = lce.lse_and_pick_plain(h, ws.t(), labels)
    valid = (labels != -100).float()
    dl = torch.empty(2048, lce.padded_vocab(V), dtype=torch.bfloat16,
                     device=dev)
    lce.linear_ce_dlogits_cuda(h, ws, labels, ref_lse, valid, -valid, 0,
                               2048, dl)
    out["linear_ce_dlogits"] = _digest(dl)
    dh, dw = lce.linear_ce_bwd_cuda(h, ws.t(), labels, ref_lse, valid,
                                    -valid)
    out["linear_ce_dh"], out["linear_ce_dw"] = _digest(dh), _digest(dw)
    # grouped: straddling groups, an empty one, rows past the groups
    sizes = torch.tensor([1000, 0, 3001, 130, 1869], dtype=torch.int32,
                         device=dev)
    m, k, n = 6144, 2048, 768
    lhs, rhs, dout = randn(m, k), randn(5, k, n, scale=0.05), randn(m, n)
    lhs[int(sizes.sum()):] = 0
    out["gmm"] = _digest(gk.gmm_cuda(lhs, rhs, sizes))
    # the backward's dlhs: dout [m, n] against rhs [E, k, n] read as its
    # [n, k] transpose per group
    out["gmm_dlhs"] = _digest(gk.gmm_cuda(dout, rhs, sizes, trans_rhs=True))
    out["tgmm"] = _digest(gk.tgmm_cuda(lhs, dout, sizes))
    for name, q in (("gmm_quant_int8", i8), ("gmm_quant_e4m3", e4)):
        s_lhs = gq.lhs_scales(lhs, sizes, q, "tensorwise")
        s_rhs = gq.rhs_scales(rhs, q, "tensorwise").contiguous()
        out[name] = _digest(gq.gmm_quant_cuda(lhs, rhs, sizes, s_lhs, s_rhs,
                                              q, q))
    # attention: B 2, S 1000 (a ragged tail), 16/4 heads, head_dim 64;
    # three packed samples a row and a padding tail (segment 0)
    B, S, Hq, Hk, D = 2, 1000, 16, 4, 64
    q, do = randn(B, S, Hq, D), randn(B, S, Hq, D)
    k, v = randn(B, S, Hk, D), randn(B, S, Hk, D)
    seg = torch.zeros(B, S, dtype=torch.int32, device=dev)
    for b, cuts in enumerate(((0, 300, 610, 930), (0, 130, 700, 890))):
        for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
            seg[b, lo:hi] = i + 1
    for name, kw in (("splash_packed", dict(segment_ids=seg)),
                     ("splash_causal", {})):
        o, lse = spl.flash_attn_fwd_cuda(q, k, v, causal=True, **kw)
        grads = spl.flash_attn_bwd_cuda(q, k, v, o, lse, do, causal=True,
                                        **kw)
        for part, t in zip(("out", "lse", "dq", "dk", "dv"),
                           (o, lse, *grads)):
            out[f"{name}_{part}"] = _digest(t)
    qm, dom = q.transpose(1, 2).contiguous(), do.transpose(1, 2).contiguous()
    km, vm = (t.transpose(1, 2).repeat_interleave(Hq // Hk, dim=1)
              .contiguous() for t in (k, v))
    Sm = 896                                   # the flash rung: S % 128 == 0
    qm, dom, km, vm = (t[:, :, :Sm].contiguous() for t in (qm, dom, km, vm))
    segm = seg[:, :Sm].contiguous()
    o, lse = fa.flash_mha_fwd_cuda(qm, km, vm, segm, True, D ** -0.5)
    grads = fa.flash_mha_bwd_cuda(qm, km, vm, o, lse, dom, segm, True,
                                  D ** -0.5)
    for part, t in zip(("out", "lse", "dq", "dk", "dv"), (o, lse, *grads)):
        out[f"flash_packed_{part}"] = _digest(t)
    torch.cuda.synchronize()
    return out


def run_once(checkout: str, timeout: float) -> dict:
    """``digests()`` in a fresh process importing ``checkout``'s package."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(checkout))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--digest"], cwd=checkout, env=env,
                          capture_output=True, text=True, timeout=timeout)
    lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
    if proc.returncode != 0 or not lines:
        tail = "\n".join((proc.stdout + proc.stderr).splitlines()[-20:])
        raise RuntimeError(f"digests in {checkout} failed "
                           f"(rc {proc.returncode}):\n{tail}")
    return json.loads(lines[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", help="first checkout")
    ap.add_argument("--b", help="second checkout")
    ap.add_argument("--digest", action="store_true",
                    help="print this process's digests (one JSON line)")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if args.digest:
        print(json.dumps(digests()), flush=True)
        return 0
    if not (args.a and args.b):
        ap.error("--a and --b name the checkouts to compare")
    a, b = run_once(args.a, args.timeout), run_once(args.b, args.timeout)
    rows = {k: dict(a=a.get(k), b=b.get(k), equal=a.get(k) == b.get(k))
            for k in a}
    print("kernel_digest " + json.dumps(dict(a=args.a, b=args.b,
                                             kernels=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
