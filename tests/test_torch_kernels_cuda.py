"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a card these skip (the kernels have no CPU mode).
The file imports neither JAX nor the JAX package, so it also runs on a
machine with only PyTorch and the card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

``CASES`` / ``make_case`` are the paged-attention case matrix that
``test_torch_paged_attention.py`` also holds against the JAX package.
"""

import numpy as np
import pytest
import torch

from automodel_tpu_torch.ops import paged_attention as tpa
from automodel_tpu_torch.ops import paged_attention_kernel as tpak

CASES = [
    dict(name="decode_gqa", q_seq=1),
    dict(name="decode_int8_kv", q_seq=1, quantized=True),
    dict(name="decode_window", q_seq=1, window=24),
    dict(name="decode_soft_cap", q_seq=1, soft_cap=30.0),
    dict(name="spec_verify_w3", q_seq=3),
    dict(name="spec_verify_w5_int8_kv", q_seq=5, quantized=True),
    dict(name="spec_verify_window", q_seq=3, window=24),
    dict(name="chunked_prefill", q_seq=8),
    dict(name="chunked_prefill_int8_kv", q_seq=8, quantized=True),
    dict(name="chunked_prefill_32_window_cap", q_seq=32, window=40,
         soft_cap=20.0),
    dict(name="idle_row_null_page", q_seq=1, idle_row=True),
    dict(name="pad_table_entries", q_seq=8, pad_tables=True),
    dict(name="pad_columns", q_seq=8, pad_cols=3, quantized=True),
]


def make_case(case, *, B=2, Hq=4, Hk=2, D=64, BS=16, MB=4, seed=7):
    """numpy operands of one case (the parity harness's layout: scrambled
    per-row-disjoint tables, ragged context lengths, block 0 = null)."""
    rng = np.random.default_rng(seed)
    S = case["q_seq"]
    NB = B * MB + 1
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    if case.get("quantized"):
        kp = rng.integers(-127, 128, (NB, BS, Hk, D)).astype(np.int8)
        vp = rng.integers(-127, 128, (NB, BS, Hk, D)).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, (NB, BS, Hk)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, (NB, BS, Hk)).astype(np.float32)
    else:
        kp = rng.normal(size=(NB, BS, Hk, D)).astype(np.float32)
        vp = rng.normal(size=(NB, BS, Hk, D)).astype(np.float32)
        ks = vs = None
    tables = rng.permutation(np.arange(1, NB)).reshape(B, MB).astype(np.int32)
    ctx = np.maximum(np.asarray([MB * BS - 7, 2 * BS + 3][:B]), S)
    pos = ctx[:, None] - S + np.arange(S)[None, :]
    if case.get("pad_tables"):
        # pages past the context point at the null page, as the engine's do
        for b in range(B):
            tables[b, -(-ctx[b] // BS):] = 0
    if case.get("pad_cols"):
        # row 1 wrote only S - pad_cols tokens: pads repeat the last valid
        n = S - case["pad_cols"]
        pos[1, n:] = pos[1, n - 1]
        ctx[1] = pos[1, -1] + 1
    if case.get("idle_row"):
        tables[1] = 0
        ctx[1] = 1
        pos[1] = 0
    kw = {}
    if case.get("soft_cap"):
        kw["logits_soft_cap"] = float(case["soft_cap"])
    if case.get("window"):
        kw["local_window_size"] = int(case["window"])
    return (q, kp, vp, ks, vs, tables, ctx.astype(np.int32),
            pos.astype(np.int32)), kw


def _torch(args, device):
    return [None if a is None else torch.from_numpy(np.array(a)).to(device)
            for a in args]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


# fp32: another summation order and expf; bf16: the output's rounding
TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOLS), ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_cuda_kernel_matches_plain(case, dtype, cuda_device):
    """The kernel against the plain version on the same operands."""
    args, kw = make_case(case)
    t = _torch(args, cuda_device)
    t[0] = t[0].to(dtype)
    if t[3] is None:                                  # non-quantized pools
        t[1], t[2] = t[1].to(dtype), t[2].to(dtype)
    launches = tpak.launches
    out = tpak.paged_decode_cuda(*t, **kw)
    torch.cuda.synchronize()
    assert tpak.launches == launches + 1 and out.dtype == dtype
    ref = tpa.paged_attention_plain(*t, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOLS[dtype],
                               rtol=TOLS[dtype])


@pytest.mark.cuda
def test_cuda_engine_kernel_matches_plain(cuda_device):
    """A tiny fp32 Llama on the card: the engine through the kernel gives
    the same greedy tokens as through the plain attention, with one launch
    per layer per step."""
    from automodel_tpu_torch.generation import GenerationConfig
    from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from automodel_tpu_torch.serving import DecodeEngine, ServingConfig

    cfg = LlamaConfig(vocab_size=256, hidden_size=256,
                      intermediate_size=512, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      rope_theta=10000.0)
    model = LlamaForCausalLM(cfg, param_dtype=torch.float32,
                             compute_dtype=torch.float32,
                             device=cuda_device).init_weights(3)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, n) for n in (9, 40, 3, 70)]
    outs = {}
    for impl in ("kernel", "plain"):
        eng = DecodeEngine(model, ServingConfig(max_model_len=128),
                           generation=GenerationConfig(max_new_tokens=12),
                           attn_impl=impl)
        for p in prompts:
            eng.submit(p)
        outs[impl] = eng.run()
        st = eng.stats()
        expect = 2 * st["steps"] if impl == "kernel" else 0
        assert st["kernel_launches"] == expect
    assert outs["kernel"] == outs["plain"]


@pytest.mark.cuda
def test_cuda_long_queries_take_the_gather_by_shape(cuda_device):
    """S > 64 on a CUDA tensor runs the plain gather (the JAX registry's
    shape rule), counted apart from kernel launches."""
    args, kw = make_case(dict(q_seq=65), MB=8)
    t = _torch(args, cuda_device)
    launches, gathers = tpak.launches, tpa.long_q_gather_calls
    out = tpa.paged_attention(t[0], t[1], t[2], k_scale=t[3], v_scale=t[4],
                              block_tables=t[5], context_lens=t[6],
                              positions=t[7], **kw)
    assert (tpak.launches, tpa.long_q_gather_calls) == (launches,
                                                        gathers + 1)
    torch.testing.assert_close(out, tpa.paged_attention_plain(*t, **kw))


# The split-KV plan's edges: (name, context lengths, S, window, int8 pools,
# head_dim, span).  Tables of MB = 8 pages (128 keys); spans of 16-64 keys
# cut them into 2-8 splits.  test_torch_paged_decode_plan.py holds the same
# cases' split arithmetic against the JAX package on the CPU.
SPAN_CASES = [
    ("ctx_on_span_boundary", (64, 32), 1, None, False, 64, 32),
    ("ctx_one_past_boundary", (65, 33), 1, None, False, 64, 32),
    ("ctx_1", (1, 17), 1, None, False, 64, 16),
    ("window_mid_span", (120, 77), 4, 40, False, 64, 32),
    ("empty_spans_rows", (40, 128), 8, None, False, 64, 16),
    ("int8_scales", (100, 53), 1, None, True, 64, 32),
    ("d128_verify", (128, 90), 5, None, False, 128, 64),
    ("d128_int8_window", (128, 70), 3, 24, True, 128, 16),
    ("rows_int8_window", (90, 128), 8, 30, True, 64, 32),
    ("rows_s32_int8_d128", (128, 96), 32, None, True, 128, 32),
]


def make_span_case(ctx, S, window, quantized, D, *, Hq=4, Hk=2, BS=16, MB=8,
                   seed=11):
    """numpy operands with the given context lengths: scrambled tables whose
    pages past the context point at the null page 0, consecutive positions
    ending at ctx - 1."""
    rng = np.random.default_rng(seed)
    B = len(ctx)
    NB = B * MB + 1
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    if quantized:
        kp = rng.integers(-127, 128, (NB, BS, Hk, D)).astype(np.int8)
        vp = rng.integers(-127, 128, (NB, BS, Hk, D)).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, (NB, BS, Hk)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, (NB, BS, Hk)).astype(np.float32)
    else:
        kp = rng.normal(size=(NB, BS, Hk, D)).astype(np.float32)
        vp = rng.normal(size=(NB, BS, Hk, D)).astype(np.float32)
        ks = vs = None
    tables = rng.permutation(np.arange(1, NB)).reshape(B, MB).astype(np.int32)
    ctx = np.asarray(ctx, np.int32)
    for b in range(B):
        tables[b, -(-ctx[b] // BS):] = 0
    pos = (ctx[:, None] - S + np.arange(S)[None, :]).astype(np.int32)
    kw = {"local_window_size": int(window)} if window else {}
    return (q, kp, vp, ks, vs, tables, ctx, pos), kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOLS), ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", SPAN_CASES, ids=[c[0] for c in SPAN_CASES])
def test_cuda_split_kv_edges_match_plain(case, dtype, cuda_device):
    """The split-KV kernel at the span's edges, at the case's span and at
    split_plan's own, against the plain version; one counted launch per
    call (the merge launch does not count)."""
    _, ctx, S, window, quantized, D, span = case
    args, kw = make_span_case(ctx, S, window, quantized, D)
    t = _torch(args, cuda_device)
    t[0] = t[0].to(dtype)
    if t[3] is None:
        t[1], t[2] = t[1].to(dtype), t[2].to(dtype)
    ref = tpa.paged_attention_plain(*t, **kw)
    for sp in (span, None):
        launches = tpak.launches
        out = tpak.paged_decode_cuda(*t, **kw, span=sp)
        torch.cuda.synchronize()
        assert tpak.launches == launches + 1 and out.dtype == dtype
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=TOLS[dtype], rtol=TOLS[dtype])


# ---------------------------------------------------------------------------
# training attention (csrc/flash_attn_fwd.cu, csrc/flash_attn_bwd.cu)
# ---------------------------------------------------------------------------
ATTN_CASES = [
    # (name, B, S, Hq, Hk, D, segments, window, soft cap)
    ("causal_gqa_d64", 2, 256, 8, 2, 64, False, None, None),
    ("packed_gqa_d64", 2, 256, 8, 2, 64, True, None, None),
    ("packed_mha_d128", 2, 192, 4, 4, 128, True, None, None),
    ("ragged_window_d64", 1, 200, 4, 2, 64, False, 16, None),
    ("ragged_cap_d128", 1, 200, 4, 2, 128, True, None, 30.0),
    # head_dim 192 (MLA): BN 64 forward, dK and dV in two passes
    ("packed_mha_d192", 2, 256, 4, 4, 192, True, None, None),
    ("causal_gqa_d192", 2, 300, 8, 2, 192, False, None, None),
    ("ragged_window_cap_d192", 1, 200, 4, 4, 192, True, 40, 30.0),
    # head_dim 256 (Gemma): BN 64 forward, 32-key dQ tiles, 32-row dK / dV
    # tiles, dK and dV in two passes
    ("packed_gqa_d256", 2, 256, 8, 4, 256, True, None, None),
    ("causal_gqa_d256", 2, 300, 8, 2, 256, False, None, None),
    ("ragged_window_cap_d256", 1, 300, 4, 2, 256, True, 40, 50.0),
    ("window1024_d256", 1, 2560, 8, 4, 256, False, 1024, None),
    # head_dim 96 (Phi-3-mini): zero-padded to 128 in the wrappers
    ("packed_mha_d96_padded", 2, 256, 4, 4, 96, True, None, None),
    ("ragged_window_gqa_d96_padded", 1, 300, 8, 2, 96, False, 40, None),
]


def make_attn_case(B, S, Hq, Hk, D, segments, seed=0):
    """bf16 operands on the card; with ``segments`` every row holds 3 packed
    samples and a padding tail (segment 0)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hk, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hk, D)).astype(np.float32)
    dout = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    seg = None
    if segments:
        seg = np.zeros((B, S), np.int32)
        for b in range(B):
            cuts = np.sort(rng.choice(np.arange(8, S - 8), 3, replace=False))
            for i, (lo, hi) in enumerate(zip([0, *cuts[:2]], cuts)):
                seg[b, lo:hi] = i + 1
    dev = torch.device("cuda")
    t = [torch.from_numpy(a).to(dev, torch.bfloat16) for a in (q, k, v, dout)]
    return (*t, None if seg is None else torch.from_numpy(seg).to(dev))


def rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


# bf16 output: one ulp at |x| in [2, 4) is 1.6e-2 and the two versions sum
# in another order.  Gradients: the kernel rounds P and dS to bf16 before
# its products (the plain version keeps fp32), which moves each element by
# ~2^-9 relative, about 0.5 % in relative L2 over the whole tensor; a wrong
# formula moves it by O(1).
ATTN_ATOL = ATTN_RTOL = 2e-2
GRAD_REL_L2 = 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_cuda_flash_attn_matches_plain(case, cuda_device):
    """Forward and backward kernels against the plain versions on the same
    bf16 operands; rows with segment 0 must give 0 / zero gradient."""
    from automodel_tpu_torch.ops import splash_attention as sa

    _, B, S, Hq, Hk, D, segments, window, cap = case
    q, k, v, dout, seg = make_attn_case(B, S, Hq, Hk, D, segments)
    kw = dict(causal=True, segment_ids=seg, logits_soft_cap=cap,
              local_window_size=window)
    f0, b0 = sa.fwd_launches, sa.bwd_launches
    out, lse = sa.flash_attn_fwd_cuda(q, k, v, **kw)
    dq, dk, dv = sa.flash_attn_bwd_cuda(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert (sa.fwd_launches, sa.bwd_launches) == (f0 + 1, b0 + 1)
    ref_out, ref_lse = sa.splash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=ATTN_ATOL,
                               rtol=ATTN_RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=1e-2, rtol=1e-3)
    refs = sa.splash_attention_bwd_plain(q, k, v, ref_out, ref_lse, dout,
                                         **kw)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert bool(torch.isfinite(got).all()), name
        assert rel_l2(got, ref) < GRAD_REL_L2, (name, rel_l2(got, ref))
    if seg is not None:
        pad = seg == 0
        assert bool((out[pad] == 0).all()) and bool((lse.transpose(1, 2)[pad]
                                                     == 0).all())
        assert bool((dq[pad] == 0).all()) and bool((dk[pad] == 0).all())


# chip_smoke.py's attention shapes: ATTN_CASES (the splash rung, [B, S, H,
# D]: name, B, S, Hq, Hk, D, packed, window, cap) and FLASH_CASES (the
# flash rung, kv repeated to MHA: name, B, S, Hq, Hk, D, causal, packed)
SMOKE_ATTN_CASES = [
    ("sft_packed_d64", 8, 2048, 32, 8, 64, True, None, None),
    ("causal_d64", 8, 2048, 32, 8, 64, False, None, None),
    ("packed_d128", 8, 2048, 32, 8, 128, True, None, None),
    ("window256_d64", 8, 2048, 32, 8, 64, False, 256, None),
    ("packed_cap30_d64", 8, 2048, 32, 8, 64, True, None, 30.0),
    ("ragged_s1000_d64", 8, 1000, 32, 8, 64, False, None, None),
    ("mha_packed_d128", 8, 2048, 16, 16, 128, True, None, None),
    ("qwen3_gqa_d128", 8, 2048, 32, 4, 128, True, None, None),
    ("mla_packed_d192", 8, 2048, 16, 16, 192, True, None, None),
    ("mla_causal_d192", 8, 2048, 16, 16, 192, False, None, None),
    ("gemma3_4b_window1024_d256", 2, 4096, 8, 4, 256, False, 1024, None),
    ("gemma2_cap50_window4096_d256", 1, 4096, 8, 4, 256, False, 4096, 50.0),
    # GPT-2 124M (12 / 12 at 64), StarCoder2-3B (24 / 2 at 128, window
    # 4,096 at S 8,192), Phi-3.5-mini (32 / 32 at 96, padded)
    ("gpt2_mha_d64", 4, 1152, 12, 12, 64, False, None, None),
    ("starcoder2_window4096_d128", 1, 8192, 24, 2, 128, False, 4096, None),
    ("phi3_mini_packed_d96", 4, 2048, 32, 32, 96, True, None, None),
]
SMOKE_FLASH_CASES = [
    ("sft_flash_packed_d64", 8, 2048, 32, 8, 64, True, True),
    ("causal_d64", 8, 2048, 32, 8, 64, True, False),
    ("full_packed_d64", 8, 2048, 32, 8, 64, False, True),
    ("mha_packed_d128", 8, 2048, 16, 16, 128, True, True),
]


def packed_segments(B, S, seed, mean=700, pad=100):
    """Samples of 1 to 2 mean rows packed into each row, the tail past the
    last whole sample left as padding (segment 0), as the SFT loader packs."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        pos, i = 0, 1
        while True:
            n = int(rng.integers(1, 2 * mean))
            if pos + n > S - int(rng.integers(0, pad)):
                break
            seg[b, pos:pos + n] = i
            pos, i = pos + n, i + 1
    return seg


def check_attention(got, refs):
    """out / lse to the bf16 output's rounding, gradients in relative L2."""
    out, lse = got[:2]
    ref_out, ref_lse = refs[:2]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=ATTN_ATOL,
                               rtol=ATTN_RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=1e-2, rtol=1e-3)
    for name, g, r in zip(("dq", "dk", "dv"), got[2:], refs[2:]):
        assert bool(torch.isfinite(g).all()), name
        assert rel_l2(g, r) < GRAD_REL_L2, (name, rel_l2(g, r))


@pytest.mark.cuda
@pytest.mark.parametrize("case", SMOKE_ATTN_CASES,
                         ids=[c[0] for c in SMOKE_ATTN_CASES])
def test_cuda_splash_kernels_match_plain_at_the_smoke_shapes(case,
                                                             cuda_device):
    """Kernel 9's forward and backward against the plain versions at every
    shape ``chip_smoke.py`` times (rows with no key give 0 in both); the
    forward twice, bitwise equal."""
    from automodel_tpu_torch.ops import splash_attention as sa

    _, B, S, Hq, Hk, D, packed, window, cap = case
    g = torch.Generator(device=cuda_device).manual_seed(11)
    q, dout = (torch.randn(B, S, Hq, D, device=cuda_device, generator=g)
               .bfloat16() for _ in range(2))
    k, v = (torch.randn(B, S, Hk, D, device=cuda_device, generator=g)
            .bfloat16() for _ in range(2))
    seg = (torch.from_numpy(packed_segments(B, S, 5)).to(cuda_device)
           if packed else None)
    kw = dict(causal=True, segment_ids=seg, logits_soft_cap=cap,
              local_window_size=window)
    out, lse = sa.flash_attn_fwd_cuda(q, k, v, **kw)
    again = sa.flash_attn_fwd_cuda(q, k, v, **kw)
    grads = sa.flash_attn_bwd_cuda(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref = sa.splash_attention_plain(q, k, v, **kw)
    refs = sa.splash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    check_attention((out, lse, *grads), (*ref, *refs))


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.015625, 0.2])
def test_cuda_splash_kernels_take_a_custom_scale(scale, cuda_device):
    """Granite's ``attention_multiplier`` replaces ``D ** -0.5``: kernel 9
    at Granite-3.0-2B's heads (32 / 8 at 64) with that scale against the
    plain versions with the same scale."""
    from automodel_tpu_torch.ops import splash_attention as sa

    B, S, Hq, Hk, D = 2, 1024, 32, 8, 64
    g = torch.Generator(device=cuda_device).manual_seed(13)
    q, dout = (torch.randn(B, S, Hq, D, device=cuda_device, generator=g)
               .bfloat16() for _ in range(2))
    k, v = (torch.randn(B, S, Hk, D, device=cuda_device, generator=g)
            .bfloat16() for _ in range(2))
    seg = torch.from_numpy(packed_segments(B, S, 3, mean=300)).to(cuda_device)
    kw = dict(causal=True, segment_ids=seg, scale=scale)
    out, lse = sa.flash_attn_fwd_cuda(q, k, v, **kw)
    grads = sa.flash_attn_bwd_cuda(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    ref = sa.splash_attention_plain(q, k, v, **kw)
    refs = sa.splash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    check_attention((out, lse, *grads), (*ref, *refs))
    default = sa.flash_attn_fwd_cuda(q, k, v, causal=True, segment_ids=seg)
    assert not torch.equal(out, default[0])


@pytest.mark.cuda
@pytest.mark.parametrize("case", SMOKE_FLASH_CASES,
                         ids=[c[0] for c in SMOKE_FLASH_CASES])
def test_cuda_flash_kernels_match_plain_at_the_smoke_shapes(case,
                                                            cuda_device):
    """Kernel 10's forward and backward against the plain versions at every
    shape ``chip_smoke.py`` times, padding rows included; the forward and
    the backward twice, bitwise equal (no atomics)."""
    from automodel_tpu_torch.ops import flash_attention as fa

    _, B, S, Hq, Hk, D, causal, packed = case
    g = torch.Generator(device=cuda_device).manual_seed(13)
    q, dout = (torch.randn(B, Hq, S, D, device=cuda_device, generator=g)
               .bfloat16() for _ in range(2))
    k, v = (torch.randn(B, Hk, S, D, device=cuda_device, generator=g)
            .bfloat16().repeat_interleave(Hq // Hk, dim=1).contiguous()
            for _ in range(2))
    seg = (torch.from_numpy(packed_segments(B, S, 7)).to(cuda_device)
           if packed else None)
    scale = D ** -0.5
    out, lse = fa.flash_mha_fwd_cuda(q, k, v, seg, causal, scale)
    again = fa.flash_mha_fwd_cuda(q, k, v, seg, causal, scale)
    grads = fa.flash_mha_bwd_cuda(q, k, v, out, lse, dout, seg, causal,
                                  scale)
    grads2 = fa.flash_mha_bwd_cuda(q, k, v, out, lse, dout, seg, causal,
                                   scale)
    torch.cuda.synchronize()
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    for a, b in zip(grads, grads2):
        assert torch.equal(a, b)
    ref = fa.flash_mha_plain(q, k, v, seg, causal, scale)
    refs = fa.flash_mha_bwd_plain(q, k, v, out, lse, dout, seg, causal,
                                  scale)
    check_attention((out, lse, *grads), (*ref, *refs))


@pytest.mark.cuda
def test_cuda_training_step_through_the_kernels(cuda_device):
    """A small bf16 Llama (head_dim 64) on packed rows: loss and gradients
    through the attention kernels against the plain attention, with
    ``2 x layers`` forward launches (remat recomputes each layer) and
    ``layers`` backward launches per step.  bf16 through 2 layers: the
    loss within 1 %, the whole gradient within 5 % relative L2."""
    from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
    from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from automodel_tpu_torch.ops import splash_attention as sa
    from automodel_tpu_torch.training.train_step import microbatch_loss

    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, rope_theta=10000.0)
    model = LlamaForCausalLM(cfg, param_dtype=torch.bfloat16,
                             device=cuda_device).init_weights(0)
    rng = np.random.default_rng(1)
    B, S = 2, 300
    seg = np.zeros((B, S), np.int32)
    pos = np.zeros((B, S), np.int32)
    for b, cuts in enumerate(([0, 120, 250], [0, 60, 280])):
        for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
            seg[b, lo:hi] = i + 1
            pos[b, lo:hi] = np.arange(hi - lo)
    ids = rng.integers(1, 512, (B, S)).astype(np.int32)
    mb = {"input_ids": ids, "position_ids": pos, "segment_ids": seg,
          "labels": np.where(seg > 0, ids, -100).astype(np.int32)}
    mb = {k: torch.from_numpy(v).to(cuda_device) for k, v in mb.items()}
    out = {}
    for impl in ("plain", "kernel"):
        model.zero_grad(set_to_none=True)
        f0, b0 = sa.fwd_launches, sa.bwd_launches
        loss = microbatch_loss(model, MaskedCrossEntropy(), mb,
                               attn_impl=impl)
        loss.backward()
        torch.cuda.synchronize()
        launches = (sa.fwd_launches - f0, sa.bwd_launches - b0)
        assert launches == ((4, 2) if impl == "kernel" else (0, 0))
        out[impl] = (float(loss.detach()),
                     torch.cat([p.grad.float().flatten()
                                for p in model.parameters()]))
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    assert abs(lk - lp) <= 1e-2 * abs(lp)
    assert rel_l2(gk, gp) < 5e-2


# ---------------------------------------------------------------------------
# fused linear cross-entropy (csrc/linear_ce_fwd.cu, csrc/linear_ce_bwd.cu)
# ---------------------------------------------------------------------------
LCE_CASES = [
    # (name, T, H, V, label low, label high); T not a multiple of 128 and V
    # not of 256 (the forward's tiles) in the ragged cases; the bench SFT
    # path's shape last
    ("aligned", 256, 128, 384, 0, 384),
    ("ragged_vocab_tail_oob_labels", 300, 256, 1000, -5, 1040),
    ("gpt2_vocab", 1000, 512, 50257, 0, 50257),
    ("all_ignored", 200, 128, 512, -100, -99),
    ("bench_shape", 16384, 2048, 128256, 0, 128256),
    # Qwen3-0.6B's head (sft_qwen3_hellaswag): 151,936 = 593 x 256 + 128,
    # the first vocabulary whose last 256-column tile is half full
    ("qwen3_v151936", 2048, 1024, 151936, 0, 151936),
]


def make_lce_case(T, H, V, lo, hi, seed=0):
    """bf16 ``h [T, H]``, the head as the ``[H, V]`` view of a row-major
    ``[V, H]`` tensor (the model's layout), int32 labels in ``[lo, hi)``
    and the cotangents the loss gives (``dlse = g``, ``dpick = -g`` on
    rows with a label, 0 elsewhere)."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    h = torch.from_numpy(rng.normal(size=(T, H)).astype(np.float32))
    ws = torch.from_numpy((rng.normal(size=(V, H)) * 0.05).astype(np.float32))
    labels = rng.integers(lo, hi, T).astype(np.int32)
    if hi > 0:            # a label on the last vocab column, an ignored row
        labels[0], labels[-1] = V - 1, -100
    g = rng.uniform(0.5, 1.5, T).astype(np.float32) * (labels != -100)
    return (h.to(dev, torch.bfloat16), ws.to(dev, torch.bfloat16).t(),
            torch.from_numpy(labels).to(dev), torch.from_numpy(g).to(dev),
            torch.from_numpy(-g).to(dev))


# forward: one bf16 product against the same product in fp32, summed in
# another order (2e-2 + 2e-2 |ref|, as the other kernels).  Backward: the
# kernels and the plain version both round dlogits to bf16 before the
# products (the TPU kernel's own rounding), the kernels also write bf16;
# relative L2 over the whole tensor within 2e-2.
LCE_ATOL = LCE_RTOL = 2e-2
LCE_GRAD_REL_L2 = 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_rows", [2048, 96], ids=["one_chunk", "chunks"])
@pytest.mark.parametrize("case", LCE_CASES, ids=[c[0] for c in LCE_CASES])
def test_cuda_linear_ce_matches_plain(case, chunk_rows, cuda_device):
    """Forward (lse, pick) and backward (dh, dW) kernels against the plain
    versions on the same bf16 operands, one launch each per call / chunk
    (the forward's product-only timing run too); the kernel's split count
    is its Python plan's; all-ignored rows give exactly zero gradients."""
    from automodel_tpu_torch.ops import linear_ce_kernel as lce
    from automodel_tpu_torch.ops.qdot_kernel import _sms

    name, T, H, V, lo, hi = case
    h, w, labels, dlse, dpick = make_lce_case(T, H, V, lo, hi)
    assert lce._kernel("linear_ce_fwd_splits")(T, V) == \
        lce.linear_ce_fwd_plan(T, V, _sms(h.device)).splits
    lce.linear_ce_fwd_cuda(h, w, labels, timing="product")
    f0, c0 = lce.fwd_launches, (lce.dlogits_launches, lce.dh_launches,
                                lce.dw_launches)
    lse, pick = lce.linear_ce_fwd_cuda(h, w, labels)
    dh, dw = lce.linear_ce_bwd_cuda(h, w, labels, lse, dlse, dpick,
                                    chunk_rows=chunk_rows)
    torch.cuda.synchronize()
    n = lce.bwd_launches_per_call(T, chunk_rows)
    assert lce.fwd_launches == f0 + 1
    assert (lce.dlogits_launches, lce.dh_launches, lce.dw_launches) == tuple(
        c + n for c in c0)
    ref_lse, ref_pick = lce.lse_and_pick_plain(h, w, labels)
    torch.testing.assert_close(lse, ref_lse, atol=LCE_ATOL, rtol=LCE_RTOL)
    torch.testing.assert_close(pick, ref_pick, atol=LCE_ATOL, rtol=LCE_RTOL)
    assert dh.shape == h.shape and dw.shape == w.shape
    assert dw.t().is_contiguous()
    if name == "all_ignored":
        assert bool((dh == 0).all()) and bool((dw == 0).all())
        return
    ref_dh, ref_dw = lce.lse_and_pick_bwd_plain(h, w, labels, ref_lse, dlse,
                                                dpick)
    for gname, got, ref in (("dh", dh, ref_dh), ("dw", dw, ref_dw)):
        assert bool(torch.isfinite(got).all()), gname
        assert rel_l2(got, ref) < LCE_GRAD_REL_L2, (gname, rel_l2(got, ref))


# the heads of this slice's families with their logits divisor folded in
# (name, T, H, V, divisor): Granite-3.0-2B (V 49,155 = 192 x 256 + 3, odd
# rows of dlogits), OLMo-2 / Phi-4 (V 100,352), GPT-2 124M (V 50,304)
DIVISOR_LCE_CASES = [
    ("granite_v49155_div8", 4096, 2048, 49155, 8.0),
    ("olmo2_v100352", 2048, 4096, 100352, 1.0),
    ("gpt2_v50304", 4096, 768, 50304, 1.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DIVISOR_LCE_CASES,
                         ids=[c[0] for c in DIVISOR_LCE_CASES])
def test_cuda_linear_ce_with_a_folded_divisor_matches_plain(case,
                                                            cuda_device):
    """Kernels 2-4 on the head the model hands them, ``(W / d)`` as the
    ``[H, V]`` view of a row-major ``[V, H]`` tensor, against the plain
    versions on the same operand, and against the plain lse of the logits
    divided after the product."""
    from automodel_tpu_torch.ops import linear_ce_kernel as lce

    _, T, H, V, div = case
    h, w, labels, dlse, dpick = make_lce_case(T, H, V, 0, V, seed=3)
    head = (w.t() / torch.tensor(div, dtype=w.dtype, device=w.device)).t()
    assert head.t().is_contiguous()
    lse, pick = lce.linear_ce_fwd_cuda(h, head, labels)
    dh, dw = lce.linear_ce_bwd_cuda(h, head, labels, lse, dlse, dpick)
    torch.cuda.synchronize()
    ref_lse, ref_pick = lce.lse_and_pick_plain(h, head, labels)
    torch.testing.assert_close(lse, ref_lse, atol=LCE_ATOL, rtol=LCE_RTOL)
    torch.testing.assert_close(pick, ref_pick, atol=LCE_ATOL, rtol=LCE_RTOL)
    logits = (h.float() @ w.float()) / div
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1),
                               atol=LCE_ATOL, rtol=LCE_RTOL)
    ref_dh, ref_dw = lce.lse_and_pick_bwd_plain(h, head, labels, ref_lse,
                                                dlse, dpick)
    for gname, got, ref in (("dh", dh, ref_dh), ("dw", dw, ref_dw)):
        assert bool(torch.isfinite(got).all()), gname
        assert rel_l2(got, ref) < LCE_GRAD_REL_L2, (gname, rel_l2(got, ref))


@pytest.mark.cuda
def test_cuda_decode_kernel_refuses_head_dim_96(cuda_device):
    """Phi-3-mini's head_dim 96 has no decode tile config: the wrapper
    raises, naming the width, rather than launching."""
    args, kw = make_case(CASES[0], D=96)
    t = _torch(args, cuda_device)
    t[0], t[1], t[2] = (x.to(torch.bfloat16) for x in t[:3])
    launches = tpak.launches
    with pytest.raises(ValueError, match="head_dim 96"):
        tpak.paged_decode_cuda(*t, **kw)
    assert tpak.launches == launches


@pytest.mark.cuda
def test_cuda_training_step_through_linear_ce(cuda_device):
    """A small bf16 Llama with the fused linear CE: loss and gradients
    through the linear-CE kernels against their plain versions (attention
    on its kernels in both), with one forward launch per microbatch and
    one launch of each backward kernel per chunk.  bf16 through 2 layers:
    the loss within 1 %, the whole gradient within 5 % relative L2."""
    from automodel_tpu_torch.loss.linear_ce import FusedLinearCrossEntropy
    from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from automodel_tpu_torch.ops import linear_ce_kernel as lce
    from automodel_tpu_torch.training.train_step import microbatch_loss

    cfg = LlamaConfig(vocab_size=1000, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, rope_theta=10000.0)
    model = LlamaForCausalLM(cfg, param_dtype=torch.bfloat16,
                             device=cuda_device).init_weights(0)
    rng = np.random.default_rng(2)
    B, S = 2, 300
    ids = rng.integers(1, 1000, (B, S)).astype(np.int32)
    labels = ids.copy()
    labels[:, -40:] = -100
    mb = {"input_ids": ids, "labels": labels}
    mb = {k: torch.from_numpy(v).to(cuda_device) for k, v in mb.items()}
    out = {}
    for impl in ("plain", "kernel"):
        model.zero_grad(set_to_none=True)
        loss_fn = FusedLinearCrossEntropy(chunk_len=1024, impl=impl)
        counts = (lce.fwd_launches, lce.dlogits_launches, lce.dh_launches,
                  lce.dw_launches)
        loss = microbatch_loss(model, loss_fn, mb)
        loss.backward()
        torch.cuda.synchronize()
        got = tuple(a - b for a, b in zip(
            (lce.fwd_launches, lce.dlogits_launches, lce.dh_launches,
             lce.dw_launches), counts))
        assert got == ((1, 1, 1, 1) if impl == "kernel" else (0, 0, 0, 0))
        out[impl] = (float(loss.detach()),
                     torch.cat([p.grad.float().flatten()
                                for p in model.parameters()]))
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    assert abs(lk - lp) <= 1e-2 * abs(lp)
    assert rel_l2(gk, gp) < 5e-2


# ---------------------------------------------------------------------------
# grouped matmuls (csrc/gmm.cu)
# ---------------------------------------------------------------------------
GMM_CASES = [
    # (name, group sizes, m, k, n): straddling row tiles with an empty
    # group, one group holding every row with dropped tail rows, leading
    # and trailing empty groups, block-aligned segments (the sorted MoE
    # path's layout), a trailing empty group with the buffer exactly full,
    # ragged k / n (not multiples of the tiles), many groups of 0-127 rows
    # (a row tile meets several groups), one hot group that tgmm splits into
    # chunks (with a 64-row stage edge inside its last one), and group ends
    # off the 64-row stages (tgmm masks the rows past them)
    ("straddles", [130, 0, 277, 1, 100], 512, 256, 384),
    ("one_group_tail", [0, 700, 0, 0], 1000, 128, 256),
    ("leading_trailing_empty", [0, 0, 300, 250, 0, 0], 640, 192, 128),
    ("block_aligned", [256, 128, 0, 384, 128], 1024, 512, 768),
    ("full_buffer_trailing_empty", [384, 256, 0], 640, 128, 128),
    ("ragged_kn", [50, 90, 0, 60], 256, 136, 72),
    ("many_tiny_groups",
     [int(x) for x in np.random.default_rng(5).integers(0, 128, 40)],
     2600, 256, 384),
    ("hot_expert_split", [0, 0, 3001, 0, 0], 4096, 256, 384),
    ("unaligned_hi", [70, 200, 33, 129, 1], 512, 128, 256),
]
# bf16 operands, fp32 sums in another order, bf16 output: relative L2 over
# the whole tensor; a wrong group or tile moves it by O(1)
GMM_REL_L2 = 2e-2


def make_gmm_case(sizes, m, k, n, seed=0, device="cuda"):
    rng = np.random.default_rng(seed)
    E = len(sizes)
    t = [torch.from_numpy(a).to(device, torch.bfloat16) for a in (
        rng.normal(size=(m, k)).astype(np.float32),
        rng.normal(size=(E, k, n)).astype(np.float32) * 0.1,
        rng.normal(size=(m, n)).astype(np.float32))]
    return (*t, torch.tensor(sizes, dtype=torch.int32, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("case", GMM_CASES, ids=[c[0] for c in GMM_CASES])
def test_cuda_gmm_and_tgmm_match_plain(case, cuda_device):
    """``gmm``, its transposed-rhs form (the backward's dlhs) and ``tgmm``
    against the plain versions; rows past the groups and an empty group's
    ``tgmm`` block exactly 0; one launch each."""
    from automodel_tpu_torch.ops import gmm_kernel as gk

    _, sizes, m, k, n = case
    lhs, rhs, dout, gs = make_gmm_case(sizes, m, k, n, device=cuda_device)
    before = (gk.gmm_launches, gk.tgmm_launches)
    out = gk.gmm_cuda(lhs, rhs, gs)
    dlhs = gk.gmm_cuda(dout, rhs, gs, trans_rhs=True)
    drhs = gk.tgmm_cuda(lhs, dout, gs)
    torch.cuda.synchronize()
    assert (gk.gmm_launches - before[0], gk.tgmm_launches - before[1]) == \
        (2, 1)
    for name, got, ref in (
            ("gmm", out, gk.gmm_plain(lhs, rhs, gs)),
            ("dlhs", dlhs, gk.gmm_plain(dout, rhs, gs, trans_rhs=True)),
            ("tgmm", drhs, gk.tgmm_plain(lhs, dout, gs))):
        assert bool(torch.isfinite(got).all()), name
        assert rel_l2(got, ref) < GMM_REL_L2, (name, rel_l2(got, ref))
    total = sum(sizes)
    assert bool((out[total:] == 0).all()) and bool((dlhs[total:] == 0).all())
    for g, size in enumerate(sizes):
        if size == 0:
            assert bool((drhs[g] == 0).all()), g


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("mb", [5, 128])
def test_cuda_verify_rows_equal_decode_rows_bitwise(kv, mb, cuda_device):
    """A speculative verify step (S = 5, one query token a CTA at decode's
    span) gives each row the bits a decode step (S = 1) gives it at the
    same position: speculation cannot move greedy tokens."""
    _verify_rows_equal_decode_rows(kv, mb, 32, 8, 64, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("mb", [5, 128])
def test_cuda_verify_rows_equal_decode_rows_at_qwen3_heads(kv, mb,
                                                           cuda_device):
    """The same at Qwen3-30B-A3B's attention (32 / 4 heads, G 8, head_dim
    128; a verify step's rows are S x 8 = 40 a kv head)."""
    _verify_rows_equal_decode_rows(kv, mb, 32, 4, 128, cuda_device)


def _verify_rows_equal_decode_rows(kv, mb, Hq, Hk, D, cuda_device):
    B, BS = 8, 16
    g = torch.Generator(device=cuda_device).manual_seed(mb)
    NB = B * mb + 1
    if kv == "int8":
        k = torch.randint(-127, 128, (NB, BS, Hk, D), device=cuda_device,
                          dtype=torch.int8, generator=g)
        v = torch.randint(-127, 128, (NB, BS, Hk, D), device=cuda_device,
                          dtype=torch.int8, generator=g)
        ks = torch.rand(NB, BS, Hk, device=cuda_device, generator=g) * 0.01
        vs = torch.rand(NB, BS, Hk, device=cuda_device, generator=g) * 0.01
    else:
        k = torch.randn(NB, BS, Hk, D, device=cuda_device,
                        generator=g).bfloat16()
        v = torch.randn(NB, BS, Hk, D, device=cuda_device,
                        generator=g).bfloat16()
        ks = vs = None
    tables = (torch.randperm(NB - 1, device=cuda_device, generator=g)
              + 1).view(B, mb).int()
    ctx = torch.randint(6, mb * BS + 1, (B,), device=cuda_device,
                        generator=g).int()
    ctx[0], ctx[1] = mb * BS, 33          # a span edge inside the verify
    q5 = torch.randn(B, 5, Hq, D, device=cuda_device, generator=g).bfloat16()
    pos5 = (ctx[:, None] - 5 + torch.arange(5, device=cuda_device)[None]
            ).int()
    out5 = tpak.paged_decode_cuda(q5, k, v, ks, vs, tables, ctx, pos5)
    for s in range(5):
        p = pos5[:, s:s + 1].contiguous()
        out1 = tpak.paged_decode_cuda(q5[:, s:s + 1].contiguous(), k, v, ks,
                                      vs, tables, (p[:, 0] + 1).int(), p)
        assert torch.equal(out5[:, s], out1[:, 0]), s


@pytest.mark.cuda
def test_cuda_moe_router_and_routed_rows_do_not_depend_on_the_batch(
        cuda_device):
    """Qwen3-30B-A3B's router product (``moe.router_logits``: ``x [M,
    2048] @ [2048, 128]`` summed in float64, rounded to float32) and its
    routed block (top-8 of 128 dropless, the gmm kernel, the ordered
    combine) give the first 8 rows the same bits at M 8 (a decode step), 64
    and 256 (a prefill chunk), and two runs give the same bits.  (cuBLAS's
    float32 product alone parts at M 64 by ~7e-7 on an H100, which the
    float64 sum removes.)"""
    from automodel_tpu_torch.ops import moe

    H, E, inter, k = 2048, 128, 768, 8
    g = torch.Generator(device=cuda_device).manual_seed(3)

    def w(*shape):
        return (torch.randn(*shape, device=cuda_device, generator=g)
                * 0.02).bfloat16()

    gate, wg, wu, wd = w(H, E), w(E, H, inter), w(E, H, inter), w(E, inter, H)
    x8 = torch.randn(8, H, device=cuda_device, generator=g).bfloat16()

    def run(x):
        logits = moe.router_logits(x, gate)
        out, _ = moe.moe_mlp_block(x[None], gate, wg, wu, wd,
                                   num_experts_per_tok=k,
                                   capacity_factor=None, group_size=512)
        return logits[:8], out[0, :8]

    base = run(x8)
    again = run(x8)
    equal = {("again", 8): (torch.equal(base[0], again[0]),
                            torch.equal(base[1], again[1]))}
    for M in (64, 256):
        xx = torch.randn(M, H, device=cuda_device, generator=g).bfloat16()
        xx[:8] = x8
        got = run(xx)
        equal[("rows", M)] = (torch.equal(got[0], base[0]),
                              torch.equal(got[1], base[1]))
        equal[("router_max_abs", M)] = float(
            (got[0] - base[0]).abs().max())
        equal[("block_max_abs", M)] = float(
            (got[1].float() - base[1].float()).abs().max())
    assert all(v == (True, True) for k, v in equal.items()
               if k[0] in ("again", "rows")), equal


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 192, 256])
@pytest.mark.parametrize("S", [477, 502])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "causal"])
def test_cuda_splash_takes_any_sequence_length(packed, S, D, cuda_device):
    """Kernel 9 at sequence lengths off a multiple of 4 (a prompt's length
    at generate()'s prefill, left-padded rows included): the wrappers pad
    the rows so the kernels' 1-D segment-id / lse / delta boxes stay
    aligned; forward and backward against the plain versions."""
    from automodel_tpu_torch.ops import splash_attention as sa

    B, Hq = 8, 4
    q, k, v, dout, seg = make_attn_case(B, S, Hq, Hq, D, packed)
    if packed:                                 # leading pads, as generate's
        seg[:, :37] = 0
    kw = dict(causal=True, segment_ids=seg)
    f0, b0 = sa.fwd_launches, sa.bwd_launches
    out, lse = sa.flash_attn_fwd_cuda(q, k, v, **kw)
    grads = sa.flash_attn_bwd_cuda(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert (sa.fwd_launches, sa.bwd_launches) == (f0 + 1, b0 + 1)
    assert out.shape == q.shape and lse.shape == (B, Hq, S)
    ref = sa.splash_attention_plain(q, k, v, **kw)
    refs = sa.splash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    check_attention((out, lse, *grads), (*ref, *refs))


@pytest.mark.cuda
def test_cuda_deepseek_step_through_the_kernels(cuda_device):
    """A DeepSeek-V2 model at MLA's head_dim 192 (2 layers, 1 dense and 1
    routed, bf16): the loss and gradients of a step through kernel 9 and
    the gmm kernels against the plain versions, and the launches."""
    from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
    from automodel_tpu_torch.models.auto_model import build_model
    from automodel_tpu_torch.ops import gmm_kernel as gk
    from automodel_tpu_torch.ops import splash_attention as sa
    from automodel_tpu_torch.training.train_step import microbatch_loss

    model = build_model(dict(
        model_type="deepseek_v2", vocab_size=512, hidden_size=256,
        intermediate_size=512, num_hidden_layers=2, num_attention_heads=2,
        num_key_value_heads=2, kv_lora_rank=64, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, moe_intermediate_size=64,
        n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
        first_k_dense_replace=1, moe_capacity_factor=None,
        torch_dtype="bfloat16"), device=cuda_device, seed=1)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    B, S = 2, 256
    ids = torch.randint(1, 512, (B, S), device=cuda_device, generator=g)
    seg = torch.from_numpy(packed_segments(B, S, 9, mean=60, pad=20)).to(
        cuda_device)
    batch = {"input_ids": ids, "labels": ids.clone(), "segment_ids": seg,
             "position_ids": torch.arange(S, device=cuda_device).expand(B, S)}
    res = {}
    for impl in ("kernel", "plain"):
        model.gmm_impl = impl
        model.zero_grad(set_to_none=True)
        f0, b0, m0 = sa.fwd_launches, sa.bwd_launches, gk.gmm_launches
        loss = microbatch_loss(model, MaskedCrossEntropy(), batch,
                               attn_impl=impl)
        loss.backward()
        torch.cuda.synchronize()
        counts = (sa.fwd_launches - f0, sa.bwd_launches - b0,
                  gk.gmm_launches - m0)
        res[impl] = (float(loss), [p.grad.float().clone() for p in
                                   model.parameters() if p.grad is not None])
        if impl == "kernel":
            assert counts == (4, 2, 9), counts     # remat: 2 fwd a layer
    assert abs(res["kernel"][0] - res["plain"][0]) <= 1e-2 * abs(
        res["plain"][0])
    num = sum(float((a - b).square().sum())
              for a, b in zip(res["kernel"][1], res["plain"][1]))
    den = sum(float(b.square().sum()) for b in res["plain"][1])
    assert (num / den) ** 0.5 < 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("H", [64, 2048, 8192])
def test_cuda_rms_norm_rows_do_not_depend_on_the_batch(H, cuda_device):
    """A row's RMSNorm has the same bits in a call of 8 rows (a decode
    step), 40 (a verify step), 256 (a prefill chunk) or 2048."""
    from automodel_tpu_torch.ops.norms import rms_norm

    g = torch.Generator(device=cuda_device).manual_seed(H)
    w = torch.randn(H, device=cuda_device, generator=g).bfloat16()
    x8 = (torch.randn(8, H, device=cuda_device, generator=g) * 3).bfloat16()
    base = rms_norm(x8, w)
    for B, W in ((8, 5), (8, 32), (2048, 1)):
        xx = (torch.randn(B * W, H, device=cuda_device, generator=g)
              * 3).bfloat16()
        idx = torch.arange(8, device=cuda_device) * W
        xx[idx] = x8
        got = rms_norm(xx.view(B, W, H), w).view(B * W, H)[idx]
        assert torch.equal(got, base), (B, W)


# the multi-tenant LoRA delta's two rank-8 products (ops/lora_gmm.py):
# x [m, 2048] x A [E, 2048, 8], then h [m, 8] x B [E, 8, out]; E slots with
# slot 0 zero and idle tenants' groups empty
LORA_CASES = [
    ("decode_m8_e5", [1, 2, 0, 1, 3, 0, 0, 1], 1, 5, 2048),
    ("chunk_m256_e17", [0, 1, 2, 16, 3, 0, 1, 5], 32, 17, 2048),
    ("all_base_m8", [0] * 8, 1, 5, 512),
    ("one_tenant_m64_kv", [4] * 8, 8, 5, 512),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", LORA_CASES, ids=[c[0] for c in LORA_CASES])
def test_cuda_lora_delta_rank8_matches_plain(case, cuda_device):
    """K = 8 and N = 8 on the gmm kernel: the delta against the dense
    per-row plain version, two launches, base rows exactly 0."""
    from automodel_tpu_torch.ops import gmm_kernel as gk
    from automodel_tpu_torch.ops import lora_gmm

    _, ids, S, E, fout = case
    B, fin, r = len(ids), 2048, 8
    g = torch.Generator(device=cuda_device).manual_seed(len(ids) + E)
    x = torch.randn(B, S, fin, device=cuda_device, generator=g).bfloat16()
    a = (torch.randn(E, fin, r, device=cuda_device, generator=g)
         * 0.02).bfloat16()
    b = (torch.randn(E, r, fout, device=cuda_device, generator=g)
         * 0.02).bfloat16()
    a[0] = 0
    b[0] = 0
    aid = torch.tensor(ids, device=cuda_device)
    before = gk.gmm_launches
    got = lora_gmm.multi_lora_delta(x, a, b, aid)
    torch.cuda.synchronize()
    assert gk.gmm_launches - before == 2
    ref = lora_gmm.multi_lora_delta_reference(x, a, b, aid)
    assert bool(torch.isfinite(got).all())
    if any(ids):
        assert rel_l2(got, ref) < GMM_REL_L2, rel_l2(got, ref)
    for row, t in enumerate(ids):
        if t == 0:
            assert bool((got[row] == 0).all()), row


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(2048, 8), (8, 2048), (8, 8)])
def test_cuda_gmm_takes_rank8_k_and_n(k, n, cuda_device):
    from automodel_tpu_torch.ops import gmm_kernel as gk

    sizes = [0, 3, 0, 120, 5, 0]
    lhs, rhs, _, gs = make_gmm_case(sizes, 136, k, n, device=cuda_device)
    got = gk.gmm_cuda(lhs, rhs, gs)
    ref = gk.gmm_plain(lhs, rhs, gs)
    assert rel_l2(got[:128], ref[:128]) < GMM_REL_L2
    assert bool((got[128:] == 0).all())


@pytest.mark.cuda
def test_cuda_tgmm_split_groups_are_bitwise_deterministic(cuda_device):
    """A hot group is cut into row chunks whose fp32 partials a second
    launch adds in chunk order: two runs give the same bits, and the result
    matches the plain version."""
    from automodel_tpu_torch.ops import gmm_kernel as gk

    sizes, m, k, n = [0, 7000, 0, 500], 8192, 512, 768
    lhs, _, dout, gs = make_gmm_case(sizes, m, k, n, seed=3,
                                     device=cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    chunk = gk.tgmm_chunk_rows(m, k, n, sms)
    assert 7000 > chunk and gk.tgmm_workspace_slots(m, chunk) > 0
    first = gk.tgmm_cuda(lhs, dout, gs)
    second = gk.tgmm_cuda(lhs, dout, gs)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert rel_l2(first, gk.tgmm_plain(lhs, dout, gs)) < GMM_REL_L2
    assert bool((first[0] == 0).all()) and bool((first[2] == 0).all())


@pytest.mark.cuda
def test_cuda_grouped_matmuls_ignore_rows_outside_their_group(cuda_device):
    """Inf in one group's rows of lhs and dout, NaN in the rows past the
    groups: every other group's rows of ``gmm`` / dlhs and its ``tgmm``
    block stay finite and match the plain version, rows past the groups are
    exactly 0.  The group ends lie off the 64-row stages, so ``tgmm``'s last
    stage of groups 1, 3 and 4 holds poisoned rows that it must mask in
    both operands."""
    from automodel_tpu_torch.ops import gmm_kernel as gk

    sizes, m, k, n = [70, 200, 33, 129, 1], 512, 128, 256
    lhs, rhs, dout, gs = make_gmm_case(sizes, m, k, n, seed=11,
                                       device=cuda_device)
    ends = np.cumsum(sizes)
    lo, hi, total = int(ends[1]), int(ends[2]), int(ends[-1])
    for t in (lhs, dout):
        t[lo:hi] = float("inf")
        t[total:] = float("nan")
    keep = [g for g in range(len(sizes)) if g != 2]
    rows = torch.cat([torch.arange(0, lo), torch.arange(hi, total)])
    out = gk.gmm_cuda(lhs, rhs, gs)
    dlhs = gk.gmm_cuda(dout, rhs, gs, trans_rhs=True)
    drhs = gk.tgmm_cuda(lhs, dout, gs)
    torch.cuda.synchronize()
    for name, got, ref in (
            ("gmm", out[rows], gk.gmm_plain(lhs, rhs, gs)[rows]),
            ("dlhs", dlhs[rows],
             gk.gmm_plain(dout, rhs, gs, trans_rhs=True)[rows]),
            ("tgmm", drhs[keep], gk.tgmm_plain(lhs, dout, gs)[keep])):
        assert bool(torch.isfinite(got).all()), name
        assert rel_l2(got, ref) < GMM_REL_L2, (name, rel_l2(got, ref))
    assert bool((out[total:] == 0).all()) and bool((dlhs[total:] == 0).all())


@pytest.mark.cuda
def test_cuda_gmm_autograd_launches_and_matches_plain(cuda_device):
    """The autograd Function on the card: forward one gmm, backward one gmm
    (dlhs) and one tgmm, against the plain route's gradients."""
    from automodel_tpu_torch.ops import gmm_kernel as gk

    lhs, rhs, dout, gs = make_gmm_case([130, 0, 277, 1, 100], 512, 256, 384,
                                       seed=1, device=cuda_device)
    grads = {}
    for impl in ("plain", "kernel"):
        a, b = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
        before = (gk.gmm_launches, gk.tgmm_launches)
        (gk.gmm(a, b, gs, impl=impl).float() * dout.float()).sum().backward()
        torch.cuda.synchronize()
        launched = (gk.gmm_launches - before[0],
                    gk.tgmm_launches - before[1])
        assert launched == ((2, 1) if impl == "kernel" else (0, 0))
        grads[impl] = (a.grad, b.grad)
    for got, ref in zip(grads["kernel"], grads["plain"]):
        assert rel_l2(got, ref) < GMM_REL_L2


@pytest.mark.cuda
def test_cuda_gmm_refuses_what_it_does_not_take(cuda_device):
    """No fallback: fp32 operands or k / n that are no multiple of 8 raise
    on the card."""
    from automodel_tpu_torch.ops import gmm_kernel as gk

    lhs, rhs, _, gs = make_gmm_case([8, 8], 16, 16, 16, device=cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        gk.gmm(lhs.float(), rhs.float(), gs)
    with pytest.raises(ValueError, match="multiples of 8"):
        gk.gmm(lhs[:, :12].contiguous(), rhs[:, :12].contiguous(), gs)


# past 1024 groups the kernels read the group plan from a workspace
# (ops/gmm_kernel.py::plan_workspace): 2048 groups of 0-7 rows (a row tile
# meets many groups), and 2048 groups around one hot group that tgmm cuts
# into chunks (its reduction reads the workspace plan too)
MANY_GROUP_CASES = [
    ("e2048_tiny_groups",
     [int(x) for x in np.random.default_rng(12).integers(0, 8, 2048)],
     7424, 256, 384),
    ("e2048_hot_split", [0] * 1000 + [6000] + [1] * 1047, 8192, 256, 384),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MANY_GROUP_CASES,
                         ids=[c[0] for c in MANY_GROUP_CASES])
def test_cuda_grouped_matmuls_take_more_than_1024_groups(case, cuda_device):
    """gmm, its dlhs, tgmm and gmm_quant (int8, tensorwise) at 2048 groups
    against the plain versions: rows past the groups and empty groups'
    tgmm blocks exactly 0, int8 bit-identical."""
    from automodel_tpu_torch.ops import gmm_kernel as gk
    from automodel_tpu_torch.ops import gmm_quant_kernel as gq

    _, sizes, m, k, n = case
    assert len(sizes) > gk.SHARED_PLAN_GROUPS and sum(sizes) <= m
    lhs, rhs, dout, gs = make_gmm_case(sizes, m, k, n, device=cuda_device)
    out = gk.gmm_cuda(lhs, rhs, gs)
    dlhs = gk.gmm_cuda(dout, rhs, gs, trans_rhs=True)
    drhs = gk.tgmm_cuda(lhs, dout, gs)
    torch.cuda.synchronize()
    for name, got, ref in (
            ("gmm", out, gk.gmm_plain(lhs, rhs, gs)),
            ("dlhs", dlhs, gk.gmm_plain(dout, rhs, gs, trans_rhs=True)),
            ("tgmm", drhs, gk.tgmm_plain(lhs, dout, gs))):
        assert bool(torch.isfinite(got).all()), name
        assert rel_l2(got, ref) < GMM_REL_L2, (name, rel_l2(got, ref))
    total = sum(sizes)
    assert bool((out[total:] == 0).all()) and bool((dlhs[total:] == 0).all())
    empty = torch.tensor([s == 0 for s in sizes], device=cuda_device)
    assert bool((drhs[empty] == 0).all())
    lhs[total:] = 0
    s_lhs = gq.lhs_scales(lhs, gs, torch.int8, "tensorwise")
    s_rhs = gq.rhs_scales(rhs, torch.int8, "tensorwise").contiguous()
    got = gq.gmm_quant_cuda(lhs, rhs, gs, s_lhs, s_rhs, torch.int8,
                            torch.int8)
    torch.cuda.synchronize()
    assert torch.equal(got, gq.gmm_quant_plain(lhs, rhs, gs, s_lhs, s_rhs,
                                               torch.int8, torch.int8))


# ---------------------------------------------------------------------------
# quantized matmuls (csrc/qdot.cu, csrc/gmm_quant.cu)
# ---------------------------------------------------------------------------
QPAIRS = [("e4m3_e4m3", torch.float8_e4m3fn, torch.float8_e4m3fn),
          ("e5m2_e4m3", torch.float8_e5m2, torch.float8_e4m3fn),
          ("e4m3_e5m2", torch.float8_e4m3fn, torch.float8_e5m2),
          ("int8_int8", torch.int8, torch.int8)]
# the three orientations the training products read in place, at a ragged
# m (forward, dgrad) and a ragged contraction (wgrad: k = token rows)
QDOT_ORIENTATIONS = ["forward", "dgrad", "wgrad"]
# fp8: both versions multiply the same codes; the kernel sums in fp32, the
# plain version in float64, so they differ by fp32 rounding of the sums
# (~1e-7 relative L2 on the H100); a wrong tile, scale or
# code moves the result by O(1).  int8: int32 sums are exact and the
# rescale is the same fp32 product, so the results are bit-identical.
QDOT_FP8_REL_L2 = 1e-3


def make_qdot_case(orientation, m=300, k=256, n=384, seed=0, device="cuda"):
    """bf16 ``(a [m, k], b [k, n])`` views as the training products give
    them: forward x @ W^T (W [n, k] row-major), dgrad g @ W (W [k, n]), and
    wgrad x^T @ g with the contraction over ``m`` token rows."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.normal(size=shape) * scale).astype(np.float32)).to(
            device, torch.bfloat16)

    if orientation == "forward":
        return t(m, k), t(n, k, scale=0.05).t()
    if orientation == "dgrad":
        return t(m, k), t(k, n, scale=0.05)
    return t(m, k).t(), t(m, n)          # a [k, m] M-major, b [m, n]


@pytest.mark.cuda
@pytest.mark.parametrize("rowwise", [False, True], ids=["tensorwise",
                                                        "rowwise"])
@pytest.mark.parametrize("pair", QPAIRS, ids=[p[0] for p in QPAIRS])
@pytest.mark.parametrize("orientation", QDOT_ORIENTATIONS)
def test_cuda_qdot_matches_plain(orientation, pair, rowwise, cuda_device):
    """``qdot`` against its plain version on the same scales, fp32 and
    bf16 out, and into a transposed output; one launch per call; int8
    bit-identical."""
    from automodel_tpu_torch.ops import qdot_kernel as qk
    from automodel_tpu_torch.ops.quant import _operand_scales

    _, a_q, b_q = pair
    a, b = make_qdot_case(orientation, device=cuda_device)
    sa, sb = _operand_scales(a, b, a_q, b_q, rowwise)
    ref = qk.qdot_plain(a, b, sa, sb, a_q, b_q)
    before = qk.qdot_launches
    got = qk.qdot_cuda(a, b, sa, sb, a_q, b_q)
    got_bf16 = qk.qdot_cuda(a, b, sa, sb, a_q, b_q, out_dtype=torch.bfloat16)
    got_t = torch.empty(b.shape[1], a.shape[0], device=cuda_device).t()
    qk.qdot_cuda(a, b, sa, sb, a_q, b_q, out=got_t)
    torch.cuda.synchronize()
    assert qk.qdot_launches - before == 3
    assert bool(torch.isfinite(got).all())
    if a_q == torch.int8:
        assert torch.equal(got, ref)
        assert torch.equal(got_t, ref)
        assert torch.equal(got_bf16, ref.bfloat16())
    else:
        assert rel_l2(got, ref) < QDOT_FP8_REL_L2, rel_l2(got, ref)
        assert rel_l2(got_t, ref) < QDOT_FP8_REL_L2
        assert rel_l2(got_bf16, ref) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float8", "int8"])
def test_cuda_qdot_autograd_launches_and_matches_plain(dtype, cuda_device):
    """The autograd Function on the card: 1 launch forward, 2 backward
    (dx, dw), each against the plain route."""
    from automodel_tpu_torch.ops import qdot_kernel as qk
    from automodel_tpu_torch.ops.quant import qdot

    x, wt = make_qdot_case("forward", seed=3, device=cuda_device)
    dout = torch.randn(x.shape[0], wt.shape[1], device=cuda_device)
    res = {}
    for impl in ("plain", "kernel"):
        xi = x.clone().requires_grad_()
        W = wt.t().clone().requires_grad_()       # [n, k] as nn.Linear
        before = qk.qdot_launches
        out = qdot(xi, W.t(), "rowwise", dtype, impl=impl)
        (out.float() * dout).sum().backward()
        torch.cuda.synchronize()
        assert qk.qdot_launches - before == (3 if impl == "kernel" else 0)
        res[impl] = (out, xi.grad, W.grad)
    for got, ref in zip(res["kernel"], res["plain"]):
        assert got.dtype == ref.dtype == torch.bfloat16
        if dtype == "int8":
            assert torch.equal(got, ref)
        else:
            assert rel_l2(got, ref) < 1e-2


@pytest.mark.cuda
def test_cuda_qdot_refuses_what_it_does_not_take(cuda_device):
    """No fallback: fp32 operands, an operand in neither orientation, or a
    dtype pair _gemm_dtypes never makes raise on the card."""
    from automodel_tpu_torch.ops import qdot_kernel as qk
    from automodel_tpu_torch.ops.quant import _operand_scales

    a, b = make_qdot_case("dgrad", m=64, k=64, n=64, device=cuda_device)
    e4 = torch.float8_e4m3fn
    sa, sb = _operand_scales(a, b, e4, e4, False)
    with pytest.raises(ValueError, match="bfloat16"):
        qk.qdot(a.float(), b.float(), sa, sb, e4, e4)
    strided = torch.zeros(64, 64, 2, dtype=a.dtype, device=a.device)[..., 0]
    with pytest.raises(ValueError, match="row-major"):
        qk.qdot(strided, b, sa, sb, e4, e4)
    with pytest.raises(ValueError, match="pair"):
        qk.qdot(a, b, sa, sb, torch.int8, e4)


# shapes that reach each path of the wgmma product: tiles that fill the
# card (one K range), a narrow output over a long K (split K), 8- and
# 16-wide outputs, k = 2056 (kp = 2064 pads the last 128-code K tile with
# zeros), and a ragged m; (name, orientation, m, k, n) as make_qdot_case
QDOT_SHAPES = [
    ("unsplit", "forward", 8192, 512, 1024),
    ("split_k_wgrad", "wgrad", 8192, 512, 128),
    ("n8", "forward", 1000, 256, 8),
    ("n16", "dgrad", 1000, 256, 16),
    ("k2056", "forward", 512, 2056, 256),
    ("ragged_m", "forward", 1037, 1024, 512),
]


@pytest.mark.cuda
@pytest.mark.parametrize("pair", QPAIRS, ids=[p[0] for p in QPAIRS])
@pytest.mark.parametrize("shape", QDOT_SHAPES, ids=[s[0] for s in QDOT_SHAPES])
def test_cuda_qdot_shapes_match_plain(shape, pair, cuda_device):
    """Each product path against the plain version, fp32 and transposed
    out; int8 bit-identical; the split plan as intended."""
    from automodel_tpu_torch.ops import qdot_kernel as qk
    from automodel_tpu_torch.ops.quant import _operand_scales

    name, orientation, m, k, n = shape
    _, a_q, b_q = pair
    a, b = make_qdot_case(orientation, m=m, k=k, n=n, seed=5,
                          device=cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    splits, _ = qk.split_plan(a.shape[0], n, a.shape[1], a_q, sms)
    if name in ("unsplit", "split_k_wgrad"):
        assert (splits > 1) == (name == "split_k_wgrad"), splits
    sa, sb = _operand_scales(a, b, a_q, b_q, False)
    ref = qk.qdot_plain(a, b, sa, sb, a_q, b_q)
    got = qk.qdot_cuda(a, b, sa, sb, a_q, b_q)
    got_t = torch.empty(n, a.shape[0], device=cuda_device).t()
    qk.qdot_cuda(a, b, sa, sb, a_q, b_q, out=got_t)
    torch.cuda.synchronize()
    for out in (got, got_t):
        assert bool(torch.isfinite(out).all())
        if a_q == torch.int8:
            assert torch.equal(out, ref)
        else:
            assert rel_l2(out, ref) < QDOT_FP8_REL_L2, rel_l2(out, ref)


# dlogits and dh alone (csrc/linear_ce_bwd.cu::linear_ce_dlogits,
# linear_ce_dh): (name, T, H, V, label low, label high); ragged rows, a
# vocabulary past a 256-wide tile (GPT-2's: ldv 50304), H 4096, labels out
# of range and all labels ignored
DLDH_CASES = [
    ("ragged_rows_t1000", 1000, 512, 2000, 0, 2000),
    ("gpt2_vocab_oob_labels", 300, 256, 50257, -5, 50300),
    ("h4096", 256, 4096, 1000, 0, 1000),
    ("all_ignored", 200, 256, 1000, -100, -99),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DLDH_CASES, ids=[c[0] for c in DLDH_CASES])
def test_cuda_linear_ce_dlogits_dh_match_plain(case, cuda_device):
    """dlogits of a chunk (rows from 0, then from r0 = 128) against the
    plain version elementwise (2e-2 + 2e-2 |ref|), its pad columns 0; dh of
    the kernel's own dlogits against the plain product (fp32 sums in
    another order, bf16 out: 1e-2 relative L2); all-ignored rows give exact
    zeros; one launch of each per call."""
    from automodel_tpu_torch.ops import linear_ce_kernel as lce

    name, T, H, V, lo, hi = case
    h, w, labels, dlse, dpick = make_lce_case(T, H, V, lo, hi, seed=5)
    ws = lce.head_storage(w)
    lse, _ = lce.lse_and_pick_plain(h, w, labels)
    ldv = lce.padded_vocab(V)
    for r0 in (0, 128):
        rows = T - r0
        dl = torch.full((rows, ldv), float("nan"), dtype=torch.bfloat16,
                        device=cuda_device)
        dh = torch.full((rows, H), float("nan"), dtype=torch.bfloat16,
                        device=cuda_device)
        c0 = (lce.dlogits_launches, lce.dh_launches)
        lce.linear_ce_dlogits_cuda(h, ws, labels, lse, dlse, dpick, r0, rows,
                                   dl)
        lce.linear_ce_dh_cuda(dl, ws, rows, dh)
        torch.cuda.synchronize()
        assert (lce.dlogits_launches, lce.dh_launches) == (c0[0] + 1,
                                                           c0[1] + 1)
        sl = slice(r0, T)
        ref_dl = lce.dlogits_plain(h[sl], w, labels[sl], lse[sl], dlse[sl],
                                   dpick[sl]).float()
        torch.testing.assert_close(dl[:, :V].float(), ref_dl, atol=LCE_ATOL,
                                   rtol=LCE_RTOL)
        assert bool((dl[:, V:] == 0).all())
        if name == "all_ignored":
            assert bool((dl == 0).all()) and bool((dh == 0).all())
            continue
        ref_dh = lce.dh_plain(dl[:, :V], w)
        assert bool(torch.isfinite(dh).all())
        assert rel_l2(dh, ref_dh) < 1e-2, rel_l2(dh, ref_dh)


@pytest.mark.cuda
def test_cuda_dlogits_timing_runs_leave_out_alone(cuda_device):
    """The dlogits kernel's timing runs (no stores; no epilogue) launch
    and leave their output buffer as it was."""
    from automodel_tpu_torch.ops import linear_ce_kernel as lce

    h, w, labels, dlse, dpick = make_lce_case(300, 256, 1000, 0, 1000)
    ws = lce.head_storage(w)
    lse, _ = lce.lse_and_pick_plain(h, w, labels)
    for timing in lce.DLOGITS_TIMING:
        dl = torch.full((300, lce.padded_vocab(1000)), 7.0,
                        dtype=torch.bfloat16, device=cuda_device)
        lce.linear_ce_dlogits_cuda(h, ws, labels, lse, dlse, dpick, 0, 300,
                                   dl, timing=timing)
        torch.cuda.synchronize()
        assert bool((dl == 7.0).all()), timing


# the dW product alone (csrc/linear_ce_bwd.cu::linear_ce_dw) in its three
# modes: (name, chunk rows, H, V); V past a 128-row tile and rows past a
# 64-row K tile, the TMA boxes' zero fill
DW_CASES = [
    ("rows96_vocab_tail", 96, 256, 1000),
    ("ragged_rows_gpt2_vocab", 300, 512, 50257),
    ("h4096", 256, 4096, 1000),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DW_CASES, ids=[c[0] for c in DW_CASES])
def test_cuda_linear_ce_dw_modes_match_plain(case, cuda_device):
    """Mode 0 writes h^T dl into the fp32 buffer, mode 1 adds it again,
    mode 2 adds a third time and writes bf16; mode 2 without a previous
    buffer writes the product alone.  fp32 sums of exact bf16 products in
    another order: 1e-5 relative L2; bf16 out: one rounding, 1e-2."""
    from automodel_tpu_torch.ops import linear_ce_kernel as lce

    _, rows, H, V = case
    ldv = lce.padded_vocab(V)
    rng = np.random.default_rng(9)
    dl = torch.zeros(rows, ldv)
    dl[:, :V] = torch.from_numpy(
        (rng.normal(size=(rows, V)) * 1e-2).astype(np.float32))
    dl = dl.to(cuda_device, torch.bfloat16)
    h = torch.from_numpy(rng.normal(size=(rows, H)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    ref = lce.dw_plain(h, dl[:, :V]).t()                # [V, H] fp32
    dw32 = torch.full((V, H), float("nan"), device=cuda_device)
    dw = torch.empty(V, H, dtype=torch.bfloat16, device=cuda_device)
    before = lce.dw_launches
    lce.linear_ce_dw_cuda(dl, h, rows, dw32, dw, 0, False)
    torch.cuda.synchronize()
    assert rel_l2(dw32, ref) < 1e-5, rel_l2(dw32, ref)
    lce.linear_ce_dw_cuda(dl, h, rows, dw32, dw, 1, True)
    torch.cuda.synchronize()
    assert rel_l2(dw32, 2 * ref) < 1e-5
    lce.linear_ce_dw_cuda(dl, h, rows, dw32, dw, 2, True)
    torch.cuda.synchronize()
    assert rel_l2(dw, 3 * ref) < 1e-2
    lce.linear_ce_dw_cuda(dl, h, rows, None, dw, 2, False)
    torch.cuda.synchronize()
    assert rel_l2(dw, ref) < 1e-2
    assert lce.dw_launches - before == 4


# the grouped cases with k and n multiples of 16 (gmm_quant's granule),
# plus ragged k and n that are neither multiples of the 8-bit stage (128)
# nor of the tiles (256 / 128 columns)
QGMM_CASES = [c for c in GMM_CASES if c[3] % 16 == 0 and c[4] % 16 == 0] + [
    ("ragged_kn16", [50, 90, 0, 60], 256, 144, 80)]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("recipe", ["tensorwise", "rowwise"])
@pytest.mark.parametrize("pair", QPAIRS, ids=[p[0] for p in QPAIRS])
@pytest.mark.parametrize("case", QGMM_CASES, ids=[c[0] for c in QGMM_CASES])
def test_cuda_gmm_quant_matches_plain(case, pair, recipe, out_dtype,
                                      cuda_device):
    """``gmm_quant`` (its quantize pass and grouped product) against the
    plain version on the same scales, every operand pair and both recipes,
    fp32 and bf16 out: rows past the groups exactly 0, int8 bit-identical,
    fp8 within ``QDOT_FP8_REL_L2``; one launch.  The e5m2 x e4m3 pair (the
    backward's dlhs) reads the experts as the transpose view of ``[E, n,
    k]`` storage, the others as ``[E, k, n]``."""
    from automodel_tpu_torch.ops import gmm_quant_kernel as gq

    _, sizes, m, k, n = case
    _, a_q, b_q = pair
    lhs, rhs, _, gs = make_gmm_case(sizes, m, k, n, device=cuda_device)
    lhs[sum(sizes):] = 0               # the sorted buffer's tail rows
    if a_q == torch.float8_e5m2:
        rhs = rhs.transpose(1, 2).contiguous().transpose(1, 2)
    s_lhs = gq.lhs_scales(lhs, gs, a_q, recipe)
    s_rhs = gq.rhs_scales(rhs, b_q, recipe).contiguous()
    before = gq.gmm_quant_launches
    got = gq.gmm_quant_cuda(lhs, rhs, gs, s_lhs, s_rhs, a_q, b_q, out_dtype)
    torch.cuda.synchronize()
    assert gq.gmm_quant_launches - before == 1
    ref = gq.gmm_quant_plain(lhs, rhs, gs, s_lhs, s_rhs, a_q, b_q, out_dtype)
    assert bool(torch.isfinite(got).all())
    assert bool((got[sum(sizes):] == 0).all())
    if a_q == torch.int8:
        assert torch.equal(got, ref)
    else:
        assert rel_l2(got, ref) < QDOT_FP8_REL_L2, rel_l2(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float8", "int8"])
def test_cuda_gmm_quant_autograd_launches_and_matches_plain(dtype,
                                                            cuda_device):
    """The autograd Function on the card: forward one gmm_quant, backward
    one gmm_quant (dlhs) and one bf16 tgmm, against the plain route."""
    from automodel_tpu_torch.ops import gmm_kernel as gk
    from automodel_tpu_torch.ops import gmm_quant_kernel as gq

    lhs, rhs, dout, gs = make_gmm_case([130, 0, 277, 1, 100], 512, 256, 384,
                                       seed=1, device=cuda_device)
    res = {}
    for impl in ("plain", "kernel"):
        a, b = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
        before = (gq.gmm_quant_launches, gk.tgmm_launches, gk.gmm_launches)
        out = gq.gmm_quant(a, b, gs, dtype, "tensorwise", impl=impl)
        (out.float() * dout.float()).sum().backward()
        torch.cuda.synchronize()
        launched = (gq.gmm_quant_launches - before[0],
                    gk.tgmm_launches - before[1], gk.gmm_launches - before[2])
        assert launched == ((2, 1, 0) if impl == "kernel" else (0, 0, 0))
        res[impl] = (out, a.grad, b.grad)
    for got, ref in zip(res["kernel"], res["plain"]):
        assert rel_l2(got, ref) < GMM_REL_L2


# ---------------------------------------------------------------------------
# flash rung (csrc/flash_mha_fwd.cu, csrc/flash_mha_bwd.cu)
# ---------------------------------------------------------------------------
FLASH_CASES = [
    # (name, B, S, H, D, causal, segments)
    ("causal_d64", 2, 256, 4, 64, True, False),
    ("packed_padded_d64", 2, 384, 4, 64, True, True),
    ("full_packed_d64", 2, 256, 2, 64, False, True),
    ("packed_padded_d128", 2, 256, 4, 128, True, True),
    ("full_d128", 1, 128, 2, 128, False, False),
]


def make_flash_case(B, S, H, D, segments, seed=0):
    """bf16 ``[B, H, S, D]`` operands on the card; with ``segments`` every
    row holds 3 packed samples and a padding tail (segment 0) of at least
    70 rows, so whole 64-row tiles are padding."""
    rng = np.random.default_rng(seed)
    x = [rng.normal(size=(B, H, S, D)).astype(np.float32) for _ in range(4)]
    dev = torch.device("cuda")
    t = [torch.from_numpy(a).to(dev, torch.bfloat16) for a in x]
    seg = None
    if segments:
        seg = np.zeros((B, S), np.int32)
        for b in range(B):
            cuts = np.sort(rng.choice(np.arange(8, S - 70), 3, replace=False))
            for i, (lo, hi) in enumerate(zip([0, *cuts[:2]], cuts)):
                seg[b, lo:hi] = i + 1
        seg = torch.from_numpy(seg).to(dev)
    return (*t, seg)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_cuda_flash_mha_matches_plain(case, cuda_device):
    """The flash rung's forward and backward kernels against their plain
    versions on every row, padding rows (segment 0 attends segment 0)
    included: out and lse to the bf16 output's rounding, dq, dk, dv in
    relative L2 (the kernels round P and dS to bf16 before the products)."""
    from automodel_tpu_torch.ops import flash_attention as fa

    _, B, S, H, D, causal, segments = case
    q, k, v, dout, seg = make_flash_case(B, S, H, D, segments)
    scale = D ** -0.5
    f0, b0 = fa.fwd_launches, fa.bwd_launches
    out, lse = fa.flash_mha_fwd_cuda(q, k, v, seg, causal, scale)
    grads = fa.flash_mha_bwd_cuda(q, k, v, out, lse, dout, seg, causal, scale)
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.bwd_launches) == (f0 + 1, b0 + 1)
    ref_out, ref_lse = fa.flash_mha_plain(q, k, v, seg, causal, scale)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=ATTN_ATOL,
                               rtol=ATTN_RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=1e-2, rtol=1e-3)
    refs = fa.flash_mha_bwd_plain(q, k, v, ref_out, ref_lse, dout, seg,
                                  causal, scale)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert bool(torch.isfinite(got).all()), name
        assert rel_l2(got, ref) < GRAD_REL_L2, (name, rel_l2(got, ref))
    if seg is not None:        # padding rows have real outputs and gradients
        pad = (seg == 0)[:, None, :].expand(B, H, S)
        assert bool((out[pad].float().abs().sum(-1) > 0).all())
        assert rel_l2(grads[0][pad], refs[0][pad]) < GRAD_REL_L2
    again = fa.flash_mha_bwd_cuda(q, k, v, out, lse, dout, seg, causal, scale)
    for got, rerun in zip(grads, again):          # no atomics: deterministic
        assert torch.equal(got, rerun)


@pytest.mark.cuda
def test_cuda_flash_rung_autograd_launches_and_matches_plain(cuda_device):
    """``attention(impl="flash")`` on GQA bf16 operands ``[B, S, H, D]``
    with a padding mask: one forward and one backward launch, and out, dq,
    dk, dv (summed over each kv group by autograd) against the plain
    version run through the same autograd."""
    from automodel_tpu_torch.ops import flash_attention as fa
    from automodel_tpu_torch.ops.attention import attention

    rng = np.random.default_rng(2)
    B, S, Hq, Hk, D = 2, 256, 8, 2, 64
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(B, S, h, D))
                                      .astype(np.float32))
                     .to(cuda_device, torch.bfloat16)
                     for h in (Hq, Hk, Hk, Hq))
    mask = torch.ones(B, S, dtype=torch.int32, device=cuda_device)
    mask[1, 150:] = 0
    res = {}
    for impl in ("kernel", "plain"):
        qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
        f0, b0 = fa.fwd_launches, fa.bwd_launches
        if impl == "kernel":
            out = attention(qq, kk, vv, attention_mask=mask, impl="flash")
        else:
            out = fa.flash_attention_bshd(qq, kk, vv, attention_mask=mask,
                                          impl="plain")
        out.backward(dout)
        torch.cuda.synchronize()
        want = (1, 1) if impl == "kernel" else (0, 0)
        assert (fa.fwd_launches - f0, fa.bwd_launches - b0) == want
        res[impl] = (out, qq.grad, kk.grad, vv.grad)
    torch.testing.assert_close(res["kernel"][0].float(),
                               res["plain"][0].float(), atol=ATTN_ATOL,
                               rtol=ATTN_RTOL)
    for got, ref in zip(res["kernel"][1:], res["plain"][1:]):
        assert rel_l2(got, ref) < GRAD_REL_L2


@pytest.mark.cuda
def test_cuda_flash_refuses_what_it_does_not_take(cuda_device):
    from automodel_tpu_torch.ops import flash_attention as fa

    q = torch.zeros(1, 2, 128, 64, device=cuda_device, dtype=torch.bfloat16)
    for bad in (q.float(), q[..., :32].contiguous(), q[:, :, :100].contiguous(),
                q.transpose(2, 3)):
        with pytest.raises(ValueError):
            fa.flash_mha_fwd_cuda(bad, bad, bad, None, True, 0.125)


# ---------------------------------------------------------------------------
# LoRA / QLoRA: a frozen head (no dW), and one step against its CPU run
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("chunk_rows", [2048, 96], ids=["one_chunk", "chunks"])
@pytest.mark.parametrize("case", [c for c in LCE_CASES
                                  if c[0] != "all_ignored"],
                         ids=[c[0] for c in LCE_CASES
                              if c[0] != "all_ignored"])
def test_cuda_linear_ce_frozen_head_launches_no_dw(case, chunk_rows,
                                                   cuda_device):
    """Without ``need_dw`` (a frozen head) the backward launches dlogits and
    dh per chunk and no dW, and its dh equals the full backward's bit for
    bit; through autograd a head that needs no gradient gets none."""
    from automodel_tpu_torch.ops import linear_ce_kernel as lce

    name, T, H, V, lo, hi = case
    h, w, labels, dlse, dpick = make_lce_case(T, H, V, lo, hi)
    lse, _ = lce.linear_ce_fwd_cuda(h, w, labels)
    dh_full, _ = lce.linear_ce_bwd_cuda(h, w, labels, lse, dlse, dpick,
                                        chunk_rows=chunk_rows)
    c0 = (lce.dlogits_launches, lce.dh_launches, lce.dw_launches)
    dh, dw = lce.linear_ce_bwd_cuda(h, w, labels, lse, dlse, dpick,
                                    chunk_rows=chunk_rows, need_dw=False)
    torch.cuda.synchronize()
    n = lce.bwd_launches_per_call(T, chunk_rows)
    assert dw is None
    assert (lce.dlogits_launches, lce.dh_launches, lce.dw_launches) == (
        c0[0] + n, c0[1] + n, c0[2])
    assert torch.equal(dh, dh_full)
    hh = h.clone().requires_grad_(True)
    d0 = lce.dw_launches
    lse, pick = lce.lse_and_pick(hh, w, labels)
    (lse * dlse - pick * dlse).sum().backward()
    torch.cuda.synchronize()
    assert lce.dw_launches == d0 and w.grad is None
    assert hh.grad is not None and bool(torch.isfinite(hh.grad).all())


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [None, "int8"],
                         ids=["merge", "qlora_int8"])
def test_cuda_lora_step_matches_its_cpu_run(quantize, cuda_device):
    """One LoRA microbatch (merge; QLoRA: the bypass over an int8 base) of
    a small Llama with the fused linear CE: bf16 on the card through the
    attention and linear-CE kernels against the same weights in fp32 on
    the CPU (plain versions), within the first-step limits of
    ``chip_smoke.py`` (loss 1 %, adapter gradients 10 % relative L2; the
    same bf16 model on the CPU is 0.03 % / 1 % from fp32); the
    card launches 2 x layers attention forwards, layers backwards, one
    linear-CE forward, one dlogits and one dh, and no dW (the tied head is
    frozen)."""
    from automodel_tpu_torch.loss.linear_ce import FusedLinearCrossEntropy
    from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from automodel_tpu_torch.ops import linear_ce_kernel as lce
    from automodel_tpu_torch.ops import splash_attention as sa
    from automodel_tpu_torch.peft.lora import LoRAModel, PeftConfig
    from automodel_tpu_torch.training.train_step import microbatch_loss

    cfg = LlamaConfig(vocab_size=1000, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, rope_theta=10000.0)
    peft = PeftConfig(target_modules=["*_proj"], dim=8, alpha=16,
                      quantize_base=quantize)
    models = {}
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        base = LlamaForCausalLM(cfg, param_dtype=dtype, compute_dtype=dtype,
                                device=dev).init_weights(0)
        models[dev] = LoRAModel(base, peft, seed=1)
    # random adapters (a constant B makes dA a sum that cancels, which
    # bf16 cannot resolve: ~100 % apart from fp32 on the CPU alone)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in models["cpu"].adapters.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    assert models["cuda"].bypass == (quantize is not None)
    rng = np.random.default_rng(3)
    B, S = 2, 300
    ids = rng.integers(1, 1000, (B, S)).astype(np.int32)
    labels = ids.copy()
    labels[:, -40:] = -100
    out = {}
    for dev, model in models.items():
        mb = {"input_ids": torch.from_numpy(ids).to(dev),
              "labels": torch.from_numpy(labels).to(dev)}
        c0 = (sa.fwd_launches, sa.bwd_launches, lce.fwd_launches,
              lce.dlogits_launches, lce.dh_launches, lce.dw_launches)
        loss = microbatch_loss(model, FusedLinearCrossEntropy(chunk_len=1024),
                               mb)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            got = tuple(a - b for a, b in zip(
                (sa.fwd_launches, sa.bwd_launches, lce.fwd_launches,
                 lce.dlogits_launches, lce.dh_launches, lce.dw_launches), c0))
            assert got == (4, 2, 1, 1, 1, 0)
        assert all(p.grad is None for p in model.base_model.parameters())
        out[dev] = (float(loss.detach()), torch.cat(
            [p.grad.float().flatten().cpu()
             for p in model.adapters.parameters()]))
    (lk, gk), (lp, gp) = out["cuda"], out["cpu"]
    assert abs(lk - lp) <= 1e-2 * abs(lp)
    assert rel_l2(gk, gp) < 1e-1


@pytest.mark.cuda
@pytest.mark.parametrize("policy, per_layer", [
    ("nothing_saveable", 2), ("save_names:splash_residuals", 1)])
def test_cuda_saved_splash_residuals_launch_the_forward_once(
        policy, per_layer, cuda_device):
    """Under ``save_names:splash_residuals`` the checkpoint keeps the
    attention's ``(out, lse)``: the forward kernel launches once per
    layer (twice under ``nothing_saveable``), the backward once, and the
    loss and gradients equal the ``nothing_saveable`` ones bit for bit
    (the recomputation would produce the same bits)."""
    from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from automodel_tpu_torch.ops import splash_attention as sa

    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=3, num_attention_heads=4,
                      num_key_value_heads=2, rope_theta=10000.0)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        1, 512, (2, 256)).astype(np.int64)).to(cuda_device)
    out = {}
    for name in ("nothing_saveable", policy):
        model = LlamaForCausalLM(cfg, param_dtype=torch.bfloat16,
                                 remat_policy=name,
                                 device=cuda_device).init_weights(0)
        f0, b0 = sa.fwd_launches, sa.bwd_launches
        loss = model(ids)["logits"].float().square().mean()
        loss.backward()
        torch.cuda.synchronize()
        out[name] = (loss.detach(), [p.grad for p in model.parameters()])
        if name == policy:
            assert (sa.fwd_launches - f0, sa.bwd_launches - b0) == (
                per_layer * 3, 3)
    (la, ga), (lb, gb) = out["nothing_saveable"], out[policy]
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))


@pytest.mark.cuda
def test_cuda_pinned_metrics_copy_reads_the_step_values(cuda_device):
    """``MetricsCopy`` of a train step's packed metrics (copied to pinned
    memory behind an event, the step not waited for) reads the values a
    blocking read gives."""
    from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from automodel_tpu_torch.optim.builder import build_optimizer
    from automodel_tpu_torch.training.train_step import (
        MetricsCopy,
        TrainStep,
        to_device_batch,
    )
    from automodel_tpu_torch.utils.model_utils import jax_named_parameters

    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, rope_theta=10000.0)
    model = LlamaForCausalLM(cfg, param_dtype=torch.bfloat16,
                             device=cuda_device).init_weights(0)
    step = TrainStep(model, build_optimizer(
        list(jax_named_parameters(model)), grad_dtype=torch.float32,
        lr=1e-3))
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 512, (2, 2, 256)).astype(np.int32)
    batch = to_device_batch([{"input_ids": ids[a], "labels": ids[a]}
                             for a in range(2)], cuda_device)
    for _ in range(3):
        values = step.dispatch(batch)
        copy = MetricsCopy(values)
        assert copy.read() == values.tolist()
        assert copy.read()[2] == 2 * 2 * 256


@pytest.mark.cuda
def test_cuda_staged_batches_equal_synchronous_ones(cuda_device):
    """A batch staged from pinned memory on a side stream, after
    ``use_staged``, equals the synchronous copy bit for bit, while the
    compute stream is busy."""
    from automodel_tpu_torch.training.train_step import (
        stage_batch,
        to_device_batch,
        use_staged,
    )

    rng = np.random.default_rng(2)
    mbs = [{"input_ids": rng.integers(0, 1 << 17, (8, 2048)).astype(
        np.int32), "labels": rng.integers(-100, 500, (8, 2048)).astype(
        np.int32), "position_ids": np.tile(np.arange(2048, dtype=np.int32),
                                           (8, 1))} for _ in range(2)]
    stream = torch.cuda.Stream(cuda_device)
    busy = torch.randn(4096, 4096, device=cuda_device)
    for _ in range(3):
        for _ in range(8):
            busy = busy @ busy * 1e-3       # the compute stream is busy
        staged = stage_batch(mbs, cuda_device, stream)
        use_staged(staged, stream)
        want = to_device_batch(mbs, cuda_device)
        assert sorted(staged) == sorted(want)
        for k in want:
            assert torch.equal(staged[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("S", [1, 5], ids=["decode", "verify_s5"])
def test_cuda_paged_decode_at_g6_matches_plain(S, kv, cuda_device):
    """Kernel 1 at Qwen2.5-1.5B's attention (12 / 2 heads, G 6, head_dim
    128), the first group count off a power of two: a decode step and the
    speculative verify width against the plain version, contexts up to
    2048 keys over 16-key blocks."""
    B, BS, MB, Hq, Hk, D = 8, 16, 128, 12, 2, 128
    g = torch.Generator(device=cuda_device).manual_seed(60 + S)
    NB = B * MB + 1
    if kv == "int8":
        k, v = (torch.randint(-127, 128, (NB, BS, Hk, D), device=cuda_device,
                              dtype=torch.int8, generator=g)
                for _ in range(2))
        ks, vs = (torch.rand(NB, BS, Hk, device=cuda_device, generator=g)
                  * 0.01 + 0.005 for _ in range(2))
    else:
        k, v = (torch.randn(NB, BS, Hk, D, device=cuda_device,
                            generator=g).bfloat16() for _ in range(2))
        ks = vs = None
    tables = (torch.randperm(NB - 1, device=cuda_device, generator=g)
              + 1).view(B, MB).int()
    ctx = torch.randint(S, MB * BS + 1, (B,), device=cuda_device,
                        generator=g).int()
    ctx[0], ctx[1] = MB * BS, 37
    q = torch.randn(B, S, Hq, D, device=cuda_device, generator=g).bfloat16()
    pos = (ctx[:, None] - S + torch.arange(S, device=cuda_device)[None]
           ).int()
    launches = tpak.launches
    out = tpak.paged_decode_cuda(q, k, v, ks, vs, tables, ctx, pos)
    torch.cuda.synchronize()
    assert tpak.launches == launches + 1
    ref = tpa.paged_attention_plain(q, k, v, ks, vs, tables, ctx, pos)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_cuda_verify_rows_equal_decode_rows_at_qwen2_heads(kv, cuda_device):
    """The verify step's rows equal decode's bit for bit at G 6 too."""
    _verify_rows_equal_decode_rows(kv, 128, 12, 2, 128, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [256, 384])
def test_cuda_splash_on_padded_unpacked_rows_at_qwen3_heads(S, cuda_device):
    """Kernel 9 at Qwen3-0.6B's attention (16 / 8 heads, head_dim 128) on
    unpacked SFT rows: one sample a row, its padding tail folded into
    segment 0 as the model folds an ``attention_mask``; forward and
    backward against the plain versions (padding rows give 0)."""
    from automodel_tpu_torch.ops import splash_attention as sa
    from automodel_tpu_torch.ops.attention import fold_padding_into_segments

    B = 8
    q, k, v, dout, _ = make_attn_case(B, S, 16, 8, 128, False, seed=S)
    lens = np.random.default_rng(S).integers(60, S, B)
    lens[0] = S
    mask = torch.from_numpy(np.arange(S)[None, :] < lens[:, None]).to(
        cuda_device)
    seg = fold_padding_into_segments((B, S), None, mask).int().contiguous()
    kw = dict(causal=True, segment_ids=seg)
    f0, b0 = sa.fwd_launches, sa.bwd_launches
    out, lse = sa.flash_attn_fwd_cuda(q, k, v, **kw)
    grads = sa.flash_attn_bwd_cuda(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert (sa.fwd_launches, sa.bwd_launches) == (f0 + 1, b0 + 1)
    ref = sa.splash_attention_plain(q, k, v, **kw)
    refs = sa.splash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    check_attention((out, lse, *grads), (*ref, *refs))
    assert bool((out[seg == 0] == 0).all())


@pytest.mark.cuda
def test_cuda_moe_backward_is_bitwise_run_to_run(cuda_device):
    """The sorted expert path's gradients twice on the same inputs, bit for
    bit: its token gather adds each token's k gradient rows in a fixed
    order (``ops/moe.py::_SortedGather``) where ``index_select``'s backward
    used atomics.  At Qwen3-30B-A3B's routing (128 experts, top 8) over
    4096 tokens, through the gmm kernels, and through a DeepSeek-V2 model's
    whole step."""
    from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
    from automodel_tpu_torch.models.auto_model import build_model
    from automodel_tpu_torch.ops import moe
    from automodel_tpu_torch.training.train_step import microbatch_loss

    H, E, inter, k, T = 2048, 128, 768, 8, 4096
    g = torch.Generator(device=cuda_device).manual_seed(5)

    def w(*shape):
        return (torch.randn(*shape, device=cuda_device, generator=g)
                * 0.02).bfloat16()

    gate, wg, wu, wd = w(H, E), w(E, H, inter), w(E, H, inter), w(E, inter, H)
    x = torch.randn(1, T, H, device=cuda_device, generator=g).bfloat16()
    cot = torch.randn(1, T, H, device=cuda_device, generator=g).bfloat16()

    def grads():
        xs = [t.detach().clone().requires_grad_() for t in (x, gate, wg, wu,
                                                            wd)]
        out, _ = moe.moe_mlp_block(xs[0], *xs[1:], num_experts_per_tok=k,
                                   capacity_factor=None, group_size=T)
        (out.float() * cot.float()).sum().backward()
        return [t.grad for t in xs]

    a, b = grads(), grads()
    assert all(torch.equal(p, q) for p, q in zip(a, b))

    model = build_model(dict(
        model_type="deepseek_v2", vocab_size=512, hidden_size=256,
        intermediate_size=512, num_hidden_layers=2, num_attention_heads=2,
        num_key_value_heads=2, kv_lora_rank=64, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, moe_intermediate_size=64,
        n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
        first_k_dense_replace=1, moe_capacity_factor=None,
        torch_dtype="bfloat16"), device=cuda_device, seed=1)
    B, S = 2, 256
    ids = torch.randint(1, 512, (B, S), device=cuda_device, generator=g)
    batch = {"input_ids": ids, "labels": ids.clone(),
             "position_ids": torch.arange(S, device=cuda_device).expand(B, S)}
    runs = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        microbatch_loss(model, MaskedCrossEntropy(), batch).backward()
        runs.append([p.grad.clone() for p in model.parameters()
                     if p.grad is not None])
    assert all(torch.equal(p, q) for p, q in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["grpo", "dpo"])
def test_cuda_token_nll_row_cotangents_match_plain(kind, cuda_device):
    """The post-training logprob pass (``post_training/logprobs.py::
    token_nll``) through the linear-CE kernels against their plain route,
    under the objectives' cotangents: GRPO's differ in sign and size on
    every row, DPO's are constant within a sequence; both are 0 on prompt
    and pad rows.  Values within the forward's limits, dh and dW within
    the backward's relative L2."""
    from automodel_tpu_torch.post_training.logprobs import token_nll

    rng = np.random.default_rng(3)
    B, S, H, V = 4, 96, 256, 1000
    h = torch.from_numpy(rng.normal(size=(B, S, H)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(V, H)) * 0.05).astype(
        np.float32))
    labels = rng.integers(0, V, (B, S)).astype(np.int64)
    labels[:, :31] = -100                       # the prompt
    labels[1, 70:] = -100                       # a short completion
    if kind == "grpo":
        cot = rng.normal(size=(B, S)).astype(np.float32)
    else:
        cot = np.repeat(rng.uniform(-1, 1, (B, 1)), S, 1).astype(np.float32)
    lab = torch.from_numpy(labels).to(cuda_device)
    out = {}
    for impl in (None, "plain"):
        hh = h.to(cuda_device, torch.bfloat16).requires_grad_()
        ws = w.to(cuda_device, torch.bfloat16).requires_grad_()
        nll = token_nll(hh, ws.t(), lab, impl=impl)
        (nll * torch.from_numpy(cot).to(cuda_device)).sum().backward()
        out[impl] = (nll.detach(), hh.grad, ws.grad)
    torch.testing.assert_close(out[None][0], out["plain"][0], atol=LCE_ATOL,
                               rtol=LCE_RTOL)
    assert bool((out[None][0][lab == -100] == 0).all())
    for got, ref in zip(out[None][1:], out["plain"][1:]):
        assert rel_l2(got, ref) < LCE_GRAD_REL_L2


# Qwen2.5-VL's tower: kernel 9 non-causal at 16 heads, head_dim 80 (the
# wrappers zero-pad it to 128, the scale stays 80 ** -0.5) and 128, over
# whole frames and over windows whose pad slots are segment 0 (the
# key-padding mask, folded into segment ids); the decoder's causal rows at
# 16 / 2 heads (G 8), D 128.  (name, B, S, Hq, Hk, D, causal, key padding)
QWEN_ATTN_CASES = [
    ("frame_d80_padded", 2, 784, 16, 16, 80, False, False),
    ("frame_d128", 2, 784, 16, 16, 128, False, False),
    ("windows_pad_d80_padded", 12, 64, 16, 16, 80, False, True),
    ("windows_pad_gqa_d128", 12, 64, 16, 2, 128, False, True),
    ("ragged_pad_d80_padded", 1, 301, 8, 2, 80, False, True),
    ("ragged_d128", 1, 477, 4, 4, 128, False, False),
    ("text_causal_gqa8_d128", 1, 896, 16, 2, 128, True, False),
]


def key_padding(B, S, seed):
    """Segment ids ``[B, S]``: 1 on valid slots, 0 on pads (every row
    keeps at least half its slots; a window of pads in the middle and at
    the end, as a window grid's edge leaves them)."""
    rng = np.random.default_rng(seed)
    seg = np.ones((B, S), np.int32)
    for b in range(B):
        n = int(rng.integers(0, S // 2))
        seg[b, rng.choice(S, n, replace=False)] = 0
        seg[b, 0] = 1
    return seg


@pytest.mark.cuda
@pytest.mark.parametrize("case", QWEN_ATTN_CASES,
                         ids=[c[0] for c in QWEN_ATTN_CASES])
def test_cuda_splash_non_causal_matches_plain(case, cuda_device):
    """Kernel 9 with ``causal=False`` (and the decoder's causal GQA rows):
    forward and backward against the plain versions; pad slots (segment 0)
    give 0 output, lse 0 and zero gradients; at head_dim 80 the kernel's
    result equals the one at the padded width with the model's scale
    80 ** -0.5 passed explicitly."""
    from automodel_tpu_torch.ops import splash_attention as sa

    _, B, S, Hq, Hk, D, causal, padded = case
    q, k, v, dout, _ = make_attn_case(B, S, Hq, Hk, D, False, seed=21)
    seg = (torch.from_numpy(key_padding(B, S, 22)).to(cuda_device)
           if padded else None)
    kw = dict(causal=causal, segment_ids=seg)
    f0, b0 = sa.fwd_launches, sa.bwd_launches
    out, lse = sa.flash_attn_fwd_cuda(q, k, v, **kw)
    grads = sa.flash_attn_bwd_cuda(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert (sa.fwd_launches, sa.bwd_launches) == (f0 + 1, b0 + 1)
    ref = sa.splash_attention_plain(q, k, v, **kw)
    refs = sa.splash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    check_attention((out, lse, *grads), (*ref, *refs))
    if seg is not None:
        pad = seg == 0
        assert bool((out[pad] == 0).all())
        assert bool((lse.transpose(1, 2)[pad] == 0).all())
        for g in grads:
            assert bool((g[pad] == 0).all())
    if D == 80:
        wide = [torch.nn.functional.pad(t, (0, 48)) for t in (q, k, v)]
        out_w, lse_w = sa.flash_attn_fwd_cuda(*wide, scale=80 ** -0.5, **kw)
        assert torch.equal(out, out_w[..., :80].contiguous())
        assert torch.equal(lse, lse_w)
        assert not bool(out_w[..., 80:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(1, 60, 60), (2, 56, 56)],
                         ids=["image_60x60_pads", "video_2x56x56"])
def test_cuda_qwen_tower_attention_through_the_windows(grid, cuda_device):
    """The tower's attention as the model calls it (``ops/attention.py::
    attention``, non-causal) at Qwen2.5-VL-3B's geometry (16 heads, head_dim
    80, window 112 at patch 14): the window batch of a grid whose windows
    carry pad slots, and the per-frame full attention of a two-frame
    video; kernel against plain forward and backward through the gather
    and the scatter.  The kernel's pad-slot rows are 0; the scatter reads
    valid slots only, so poisoning the pad rows changes nothing it
    returns, and pads receive no gradient."""
    from automodel_tpu_torch.models.qwen2_5_vl import _grid_layout
    from automodel_tpu_torch.ops import splash_attention as sa
    from automodel_tpu_torch.ops.attention import attention

    dev = cuda_device
    lay = _grid_layout(grid, 2, 112, 14, 80)
    gather = torch.from_numpy(lay["gather"]).long().to(dev)
    valid = torch.from_numpy(lay["valid"]).to(dev)
    scatter = torch.from_numpy(lay["scatter"]).long().to(dev)
    nW, wlen = gather.shape
    L, H, D = int(np.prod(grid)), 16, 80
    g = torch.Generator(device=dev).manual_seed(31)
    q, k, v, dy = (torch.randn(1, L, H, D, device=dev, generator=g)
                   .bfloat16() for _ in range(4))
    assert bool(valid.reshape(-1)[scatter].all())

    def windows(impl, leaves):
        def win(z):
            return z.index_select(1, gather.reshape(-1)).reshape(
                nW, wlen, H, D)

        out = attention(*(win(z) for z in leaves), causal=False,
                        attention_mask=valid, impl=impl)
        return out, out.reshape(1, nW * wlen, H, D).index_select(1, scatter)

    def frames(impl, leaves):
        t = grid[0]
        out = attention(*(z.reshape(t, L // t, H, D) for z in leaves),
                        causal=False, impl=impl)
        return out, out.reshape(1, L, H, D)

    run = windows if not lay["valid"].all() else frames
    results = {}
    for impl in ("kernel", "plain"):
        leaves = [z.clone().requires_grad_() for z in (q, k, v)]
        f0 = sa.fwd_launches
        raw, y = run(impl, leaves)
        y.backward(dy)
        torch.cuda.synchronize()
        assert sa.fwd_launches - f0 == (1 if impl == "kernel" else 0)
        results[impl] = (raw.detach(), y.detach(),
                         [z.grad for z in leaves])
    raw, y, grads = results["kernel"]
    raw_p, y_p, grads_p = results["plain"]
    torch.testing.assert_close(y.float(), y_p.float(), atol=ATTN_ATOL,
                               rtol=ATTN_RTOL)
    for name, a, b in zip("qkv", grads, grads_p):
        assert rel_l2(a, b) < GRAD_REL_L2, (name, rel_l2(a, b))
    if run is windows:
        assert bool((raw[~valid] == 0).all())
        poisoned = raw.clone()
        poisoned[~valid] = float("nan")
        again = poisoned.reshape(1, nW * wlen, H, D).index_select(1, scatter)
        assert torch.equal(again, y)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [512, None], ids=["window512", "full"])
def test_cuda_splash_at_gemma3n_e4b_shapes(window, cuda_device):
    """Kernel 9 as Gemma-3n-E4B calls it: GQA 8 / 2 at head_dim 256,
    softmax scale 1.0 over q / k rms-normed per head (unit rows, so the
    logits stay within +-256), window 512 on the sliding layers and
    causal full on the others; forward and backward against the plain
    versions with the same scale."""
    from automodel_tpu_torch.models.gemma3n import _rms_norm
    from automodel_tpu_torch.ops import splash_attention as sa

    B, S, Hq, Hk, D = 2, 2048, 8, 2, 256
    g = torch.Generator(device=cuda_device).manual_seed(21)
    q, dout = (torch.randn(B, S, Hq, D, device=cuda_device, generator=g)
               .bfloat16() for _ in range(2))
    k, v = (torch.randn(B, S, Hk, D, device=cuda_device, generator=g)
            .bfloat16() for _ in range(2))
    q, k, v = (_rms_norm(t) for t in (q, k, v))
    kw = dict(causal=True, scale=1.0, local_window_size=window)
    out, lse = sa.flash_attn_fwd_cuda(q, k, v, **kw)
    grads = sa.flash_attn_bwd_cuda(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    ref = sa.splash_attention_plain(q, k, v, **kw)
    refs = sa.splash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    check_attention((out, lse, *grads), (*ref, *refs))


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True], ids=["sliding", "full"])
def test_cuda_gemma3n_layer_at_e4b_widths(full, cuda_device):
    """One Gemma-3n-E4B decoder layer at its published widths (hidden
    2,048, 8 / 2 heads at 256, ffn 16,384, PLE 256, Laurel 64, AltUp 4;
    the sliding layer with window 512 and a sparse gate, or the full
    one), bf16, rows of 1,024: the loss and every gradient through
    kernel 9 against the plain attention route, one forward and one
    backward launch."""
    from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
    from automodel_tpu_torch.models.auto_model import build_model
    from automodel_tpu_torch.ops import splash_attention as sa
    from automodel_tpu_torch.training.train_step import microbatch_loss

    model = build_model(dict(
        model_type="gemma3n_text", vocab_size=4096,
        vocab_size_per_layer_input=2048, hidden_size=2048,
        hidden_size_per_layer_input=256, intermediate_size=16384,
        num_hidden_layers=1, num_attention_heads=8, num_key_value_heads=2,
        head_dim=256, laurel_rank=64, altup_num_inputs=4,
        sliding_window=512, num_kv_shared_layers=0,
        layer_types=["full_attention" if full else "sliding_attention"],
        activation_sparsity_pattern=[0.0 if full else 0.95]),
        device=cuda_device, seed=3, remat=False)
    with torch.no_grad():
        for layer in model.layers:
            layer.altup.correct_output_scale.normal_(0.0, 0.5)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    B, S = 2, 1024
    ids = torch.randint(0, 4096, (B, S), device=cuda_device, generator=g)
    batch = {"input_ids": ids, "labels": ids.clone()}
    res = {}
    for impl in ("kernel", "plain"):
        model.zero_grad(set_to_none=True)
        f0, b0 = sa.fwd_launches, sa.bwd_launches
        loss = microbatch_loss(model, MaskedCrossEntropy(), batch,
                               attn_impl=impl)
        loss.backward()
        torch.cuda.synchronize()
        counts = (sa.fwd_launches - f0, sa.bwd_launches - b0)
        assert counts == ((1, 1) if impl == "kernel" else (0, 0)), counts
        res[impl] = (float(loss), [p.grad.float().clone() for p in
                                   model.parameters() if p.grad is not None])
    assert len(res["kernel"][1]) == len(res["plain"][1]) > 20
    assert abs(res["kernel"][0] - res["plain"][0]) <= 1e-2 * abs(
        res["plain"][0])
    num = sum(float((a - b).square().sum())
              for a, b in zip(res["kernel"][1], res["plain"][1]))
    den = sum(float(b.square().sum()) for b in res["plain"][1])
    assert (num / den) ** 0.5 < 0.1


@pytest.mark.cuda
def test_cuda_splash_at_phi4_mm_window_equals_causal(cuda_device):
    """Kernel 9 as Phi-4-multimodal's decoder calls it: GQA 24 / 8 at
    head_dim 128, causal and at the published window 262,144, forward and
    backward against the plain versions; through the dispatcher
    (``ops/attention.py::attention``, what the model calls) that window
    spans every row and gives the causal output and gradients bit for
    bit, one forward and one backward launch each."""
    from automodel_tpu_torch.ops import splash_attention as sa
    from automodel_tpu_torch.ops.attention import attention

    B, S, Hq, Hk, D = 4, 256, 24, 8, 128
    g = torch.Generator(device=cuda_device).manual_seed(31)
    q, dout = (torch.randn(B, S, Hq, D, device=cuda_device, generator=g)
               .bfloat16() for _ in range(2))
    k, v = (torch.randn(B, S, Hk, D, device=cuda_device, generator=g)
            .bfloat16() for _ in range(2))
    got = {}
    for window in (None, 262144):
        kw = dict(causal=True, local_window_size=window)
        out, lse = sa.flash_attn_fwd_cuda(q, k, v, **kw)
        grads = sa.flash_attn_bwd_cuda(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        ref = sa.splash_attention_plain(q, k, v, **kw)
        refs = sa.splash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
        check_attention((out, lse, *grads), (*ref, *refs))
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        f0, b0 = sa.fwd_launches, sa.bwd_launches
        o = attention(qq, kk, vv, causal=True, local_window_size=window,
                      impl="kernel")
        o.backward(dout)
        torch.cuda.synchronize()
        assert (sa.fwd_launches - f0, sa.bwd_launches - b0) == (1, 1)
        got[window] = (o.detach(), qq.grad, kk.grad, vv.grad)
    assert all(torch.equal(a, b) for a, b in zip(got[None], got[262144]))


def _phi4_published(text_layers=1, audio_blocks=1, vocab=4096):
    return dict(
        model_type="phi4_multimodal", vocab_size=vocab, hidden_size=3072,
        intermediate_size=8192, num_hidden_layers=text_layers,
        num_attention_heads=24, num_key_value_heads=8,
        partial_rotary_factor=0.75, tie_word_embeddings=True,
        rope_theta=10000.0, original_max_position_embeddings=4096,
        max_position_embeddings=131072, sliding_window=262144,
        rope_scaling={"type": "longrope", "short_factor": [1.0] * 48,
                      "long_factor": [1.0] * 48},
        audio_config=dict(num_blocks=audio_blocks, bias_max_distance=500,
                          audio_token_id=vocab - 1))


@pytest.mark.cuda
def test_cuda_phi4_mm_decoder_layer_at_published_widths(cuda_device):
    """One Phi-4-multimodal decoder layer at its published widths (hidden
    3,072, 24 / 8 heads at 128 with rope on 96 channels, ffn 8,192,
    window 262,144; a 4,096-token vocabulary), bf16, rows of 1,024: the
    loss and every gradient through kernel 9 against the plain attention
    route, one forward and one backward launch."""
    from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
    from automodel_tpu_torch.models.phi4_mm import build_phi4_mm
    from automodel_tpu_torch.ops import splash_attention as sa
    from automodel_tpu_torch.training.train_step import microbatch_loss

    model = build_phi4_mm(_phi4_published(), device=cuda_device, seed=3,
                          remat=False)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    B, S = 2, 1024
    ids = torch.randint(0, 4000, (B, S), device=cuda_device, generator=g)
    batch = {"input_ids": ids, "labels": ids.clone()}
    res = {}
    for impl in ("kernel", "plain"):
        model.zero_grad(set_to_none=True)
        f0, b0 = sa.fwd_launches, sa.bwd_launches
        loss = microbatch_loss(model, MaskedCrossEntropy(), batch,
                               attn_impl=impl)
        loss.backward()
        torch.cuda.synchronize()
        counts = (sa.fwd_launches - f0, sa.bwd_launches - b0)
        assert counts == ((1, 1) if impl == "kernel" else (0, 0)), counts
        res[impl] = (float(loss), [p.grad.float().clone() for p in
                                   model.language_model.parameters()
                                   if p.grad is not None])
    assert len(res["kernel"][1]) == len(res["plain"][1]) >= 7
    assert abs(res["kernel"][0] - res["plain"][0]) <= 1e-2 * abs(
        res["plain"][0])
    num = sum(float((a - b).square().sum())
              for a, b in zip(res["kernel"][1], res["plain"][1]))
    den = sum(float(b.square().sum()) for b in res["plain"][1])
    assert (num / den) ** 0.5 < 0.1


@pytest.mark.cuda
def test_cuda_phi4_mm_conformer_block_at_published_widths(cuda_device):
    """One conformer block at Phi-4-multimodal's published widths (D
    1,024, 16 heads, ffn 1,536, nemo 1,024 channels, time reduction 8) on
    the card in bf16 against the same weights on the CPU in fp32: two
    clips of 1,200 and 700 frames of 80 features (the +1 mask on the
    shorter), the encoder's output within 2e-2 of its largest magnitude
    and the same on every gradient's relative L2 norm within 0.1.  The
    block runs plain PyTorch on both (no kernel of the port)."""
    from automodel_tpu_torch.models.phi4_mm import (
        Phi4MMAudioConfig,
        Phi4MMAudioEncoder,
    )

    cfg = Phi4MMAudioConfig(num_blocks=1, bias_max_distance=500)
    encs = {}
    for dev, cd in ((cuda_device, torch.bfloat16), ("cpu", torch.float32)):
        enc = Phi4MMAudioEncoder(cfg, compute_dtype=cd, device=dev,
                                 remat=False)
        enc.init_weights(torch.Generator(device=dev).manual_seed(5))
        encs[str(dev)] = enc
    gpu, cpu = encs[str(cuda_device)], encs["cpu"]
    with torch.no_grad():
        for a, b in zip(cpu.parameters(), gpu.parameters()):
            a.copy_(b.cpu())
    rng = np.random.default_rng(6)
    feats = np.zeros((2, 1200, 80), np.float32)
    mask = np.zeros((2, 1200), bool)
    for i, n in enumerate((1200, 700)):
        feats[i, :n] = rng.normal(size=(n, 80))
        mask[i, :n] = True
    outs, grads = {}, {}
    for name, enc in (("gpu", gpu), ("cpu", cpu)):
        dev = next(enc.parameters()).device
        out = enc(torch.from_numpy(feats).to(dev),
                  torch.from_numpy(mask).to(dev))
        out.float().square().mean().backward()
        outs[name] = out.detach().float().cpu()
        grads[name] = [p.grad.float().cpu() for p in enc.parameters()]
    assert outs["gpu"].shape == (2, 150, 1024)
    top = float(outs["cpu"].abs().max())
    assert float((outs["gpu"] - outs["cpu"]).abs().max()) <= 2e-2 * top
    for a, b in zip(grads["gpu"], grads["cpu"]):
        assert float((a - b).norm()) <= 0.1 * float(b.norm()) + 1e-6


@pytest.mark.cuda
def test_cuda_gemma3_prefill_then_decode_at_d256(cuda_device):
    """Gemma-3 with a cache at head_dim 256 (8 / 4 heads; five sliding
    layers at window 64 and a full one, rows of 100-160 tokens past the
    window): ``generate()``'s prefill through kernel 9 (one forward
    launch a layer, none on a decode step) against the plain prefill:
    the prefill's last logits within 5 % of their range, the first tokens
    equal; and a decode step over the kernel-written cache against the
    full forward's last row."""
    from automodel_tpu_torch.generation import GenerationConfig, generate
    from automodel_tpu_torch.models.auto_model import build_model
    from automodel_tpu_torch.ops import splash_attention as sa

    model = build_model(dict(
        model_type="gemma3_text", vocab_size=4096, hidden_size=1024,
        intermediate_size=2048, num_hidden_layers=6, num_attention_heads=8,
        num_key_value_heads=4, head_dim=256, query_pre_attn_scalar=256,
        sliding_window=64), device=cuda_device, seed=7)
    rng = np.random.default_rng(8)
    lens = np.asarray([160, 100, 131, 117])
    ids = np.zeros((4, 160), np.int64)
    for b, n in enumerate(lens):
        ids[b, :n] = rng.integers(1, 4096, n)
    out = {}
    for impl in ("kernel", "plain"):
        sa.fwd_launches = 0
        out[impl] = generate(model, ids, lens,
                             GenerationConfig(max_new_tokens=6),
                             attn_impl=impl)
        assert sa.fwd_launches == (6 if impl == "kernel" else 0)
    assert (out["kernel"][:, 0] == out["plain"][:, 0]).all()
    t = torch.as_tensor(ids[:1, :160], device=cuda_device)
    with torch.inference_mode():
        full = model(t)["logits"][:, -1].float()
        cache = model.init_kv_cache(1, 161)
        mask = torch.ones(1, 161, dtype=torch.bool, device=cuda_device)
        model(t[:, :159], attention_mask=mask, kv_cache=cache, cache_index=0)
        step = model(t[:, 159:], attention_mask=mask, kv_cache=cache,
                     cache_index=159)["logits"][:, -1].float()
    span = float(full.abs().max())
    assert float((step - full).abs().max()) <= 5e-2 * span


@pytest.mark.cuda
def test_cuda_llama_generate_prefill_on_kernel9(cuda_device):
    """Llama-3.2-1B at its published widths and depth (random weights):
    ``generate()`` over 4 ragged prompts of 64-300 tokens, the prefill
    through kernel 9 (16 forward launches, one a layer; none on the 7
    decode steps) against the plain prefill: the prefill's last logits
    within 5 % of their range, the first tokens equal."""
    from automodel_tpu_torch.generation import GenerationConfig, generate
    from automodel_tpu_torch.generation.generate import left_align
    from automodel_tpu_torch.models.auto_model import build_model
    from automodel_tpu_torch.models.llama import llama3_2_1b_config
    from automodel_tpu_torch.ops import splash_attention as sa

    model = build_model(llama3_2_1b_config(), device=cuda_device, seed=0,
                        param_dtype="bfloat16")
    rng = np.random.default_rng(9)
    lens = np.asarray([300, 64, 211, 150])
    ids = np.zeros((4, 300), np.int64)
    for b, n in enumerate(lens):
        ids[b, :n] = rng.integers(1, 128000, n)
    last = {}
    with torch.inference_mode():
        ids_t = torch.as_tensor(ids, device=cuda_device)
        lens_t = torch.as_tensor(lens, device=cuda_device)
        left = left_align(ids_t, lens_t, 0)
        mask = (torch.arange(301, device=cuda_device)[None]
                >= (300 - lens_t)[:, None])
        pos = (torch.arange(300, device=cuda_device)[None]
               - (300 - lens_t)[:, None]).clamp(min=0)
        for impl in ("kernel", "plain"):
            last[impl] = model(left, position_ids=pos, attention_mask=mask,
                               kv_cache=model.init_kv_cache(4, 301),
                               cache_index=0, attn_impl=impl)[
                                   "logits"][:, -1].float()
    span = float(last["plain"].abs().max())
    assert float((last["kernel"] - last["plain"]).abs().max()) <= 5e-2 * span
    out = {}
    for impl in ("kernel", "plain"):
        sa.fwd_launches = sa.plain_fwd_calls = 0
        out[impl] = generate(model, ids, lens,
                             GenerationConfig(max_new_tokens=8),
                             attn_impl=impl)
        torch.cuda.synchronize()
        assert sa.fwd_launches == (16 if impl == "kernel" else 0)
        assert sa.plain_fwd_calls == (0 if impl == "kernel" else 16)
    assert (out["kernel"][:, 0] == out["plain"][:, 0]).all()


# ---------------------------------------------------------------------------
# quantized serving: qdot at decode rows, gmm_quant at decode groups, and a
# drilled fleet on the card
# ---------------------------------------------------------------------------
# (name, m, k, n): Llama-3.2-1B's q / k-v / gate-up / down projections at
# the engine's decode widths (1-8 rows) and its prefill chunk (256 rows)
QDOT_DECODE_SHAPES = [
    ("q_m1", 1, 2048, 2048), ("kv_m5", 5, 2048, 512),
    ("gate_m8", 8, 2048, 8192), ("down_m8", 8, 8192, 2048),
    ("q_m256", 256, 2048, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [QPAIRS[0], QPAIRS[3]],
                         ids=[QPAIRS[0][0], QPAIRS[3][0]])
@pytest.mark.parametrize("shape", QDOT_DECODE_SHAPES,
                         ids=[s[0] for s in QDOT_DECODE_SHAPES])
def test_cuda_qdot_decode_rows_match_plain(shape, pair, cuda_device):
    """``qdot`` at the serving engine's row counts (a 128-row tile holds
    1-8 real rows) against the plain version, bf16 out as the model asks:
    int8 bit-identical, e4m3 within ``QDOT_FP8_REL_L2`` of the fp32
    output; one launch a call."""
    from automodel_tpu_torch.ops import qdot_kernel as qk
    from automodel_tpu_torch.ops.quant import _operand_scales

    _, m, k, n = shape
    _, a_q, b_q = pair
    a, b = make_qdot_case("forward", m=m, k=k, n=n, seed=11,
                          device=cuda_device)
    sa, sb = _operand_scales(a, b, a_q, b_q, False)
    ref = qk.qdot_plain(a, b, sa, sb, a_q, b_q)
    before = qk.qdot_launches
    got = qk.qdot_cuda(a, b, sa, sb, a_q, b_q)
    got_bf16 = qk.qdot_cuda(a, b, sa, sb, a_q, b_q,
                            out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert qk.qdot_launches - before == 2
    assert bool(torch.isfinite(got).all())
    if a_q == torch.int8:
        assert torch.equal(got, ref)
        assert torch.equal(got_bf16, ref.bfloat16())
    else:
        assert rel_l2(got, ref) < QDOT_FP8_REL_L2, rel_l2(got, ref)
        assert rel_l2(got_bf16, ref) < 1e-2


def _decode_group_sizes(E, rows, seed):
    """``[E]`` sizes with ``rows`` rows spread over a few experts (0-2 rows
    each, most experts empty), as a decode step routes them."""
    rng = np.random.default_rng(seed)
    sizes = np.zeros(E, np.int64)
    for e in rng.choice(E, rows, replace=True):
        sizes[e] += 1
    return sizes.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [QPAIRS[0], QPAIRS[3]],
                         ids=[QPAIRS[0][0], QPAIRS[3][0]])
@pytest.mark.parametrize("padded", [False, True],
                         ids=["raw", "block128"])
def test_cuda_gmm_quant_decode_groups_match_plain(padded, pair,
                                                  cuda_device):
    """``gmm_quant`` over 128 experts at a decode step's groups (empty,
    one-row and two-row segments; ``block128``: each non-empty segment
    padded to 128 rows with zero rows, as ``sorted_expert_ffn`` lays
    them), Qwen3-30B-A3B's gate/up width (2048 -> 768): rows past the
    groups exactly 0, int8 bit-identical, e4m3 within
    ``QDOT_FP8_REL_L2``; one launch."""
    from automodel_tpu_torch.ops import gmm_quant_kernel as gq

    _, a_q, b_q = pair
    E, k, n = 128, 2048, 768
    sizes = _decode_group_sizes(E, 24, seed=7)
    assert 0 in sizes and 1 in sizes
    if padded:
        sizes = [-(-s // 128) * 128 for s in sizes]
    m = sum(sizes) + 16
    lhs, rhs, _, gs = make_gmm_case(sizes, m, k, n, seed=3,
                                    device=cuda_device)
    lhs[sum(sizes):] = 0
    s_lhs = gq.lhs_scales(lhs, gs, a_q, "tensorwise")
    s_rhs = gq.rhs_scales(rhs, b_q, "tensorwise").contiguous()
    before = gq.gmm_quant_launches
    got = gq.gmm_quant_cuda(lhs, rhs, gs, s_lhs, s_rhs, a_q, b_q,
                            torch.bfloat16)
    torch.cuda.synchronize()
    assert gq.gmm_quant_launches - before == 1
    ref = gq.gmm_quant_plain(lhs, rhs, gs, s_lhs, s_rhs, a_q, b_q,
                             torch.bfloat16)
    assert bool(torch.isfinite(got).all())
    assert bool((got[sum(sizes):] == 0).all())
    if a_q == torch.int8:
        assert torch.equal(got, ref)
    else:
        assert rel_l2(got, ref) < QDOT_FP8_REL_L2, rel_l2(got, ref)


@pytest.mark.cuda
def test_cuda_fleet_drill_on_the_card(cuda_device, monkeypatch):
    """A 2-replica tiny fleet on the card, one replica lost before any
    token is sampled, then grown back: every request FINISHED, tokens
    equal to one uninterrupted engine's, the admitted replica's weights
    equal its peer's bit for bit, every allocator free, and paged-decode
    launches equal layers x steps summed over the replicas."""
    from automodel_tpu_torch.checkpoint import replication as rep
    from automodel_tpu_torch.generation import GenerationConfig
    from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from automodel_tpu_torch.serving import (
        DecodeEngine,
        FleetRouter,
        ServingConfig,
    )
    from automodel_tpu_torch.utils import fault_injection as fi

    cfg = LlamaConfig(vocab_size=256, hidden_size=256,
                      intermediate_size=512, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      rope_theta=10000.0)
    model = LlamaForCausalLM(cfg, param_dtype=torch.bfloat16,
                             device=cuda_device).init_weights(3)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, n).tolist() for n in (9, 40, 3, 70)]
    gen = GenerationConfig(max_new_tokens=12)
    scfg = ServingConfig(max_model_len=128, replicas=2,
                         fleet_probation_polls=2)
    one = DecodeEngine(model, ServingConfig(max_model_len=128),
                       generation=gen)
    for p in prompts:
        one.submit(p)
    ref = one.run()
    monkeypatch.setenv("AUTOMODEL_LOST_REPLICA", "1")
    fleet = FleetRouter(model, scfg, generation=gen)
    rids = [fleet.submit(p) for p in prompts]
    fi.configure_faults("fleet_replica_loss:1")
    try:
        fleet.poll_health(step=0)
    finally:
        fi.reset_faults()
    assert fleet.replica_losses == 1 and not fleet.replicas[1].alive
    fleet.note_return(1)
    steps = 0
    while fleet.has_work():
        fleet.poll_health(step=steps + 1)
        fleet.step()
        steps += 1
    for p in range(2 * fleet.probation_polls):
        if fleet.replicas[1].alive:
            break
        fleet.poll_health(step=steps + 1 + p)
    assert fleet.readmissions == 1
    assert [fleet.requests[r].out_tokens for r in rids] == \
        [ref[i] for i in sorted(ref)]
    digests = [{k: s[0] for k, s in rep.serialize_tree(
        r.engine.model.state_dict()).items()} for r in fleet.replicas]
    assert digests[0] == digests[1]
    assert fleet.replicas[1].engine.model is not model
    assert fleet.all_free()
    st = fleet.stats()
    for rid_, r in st["per_replica"].items():
        assert r["kernel_launches"] + r["retired_kernel_launches"] == \
            2 * (r["steps"] + r["retired_steps"])
    fleet.teardown()
    assert rep.live_stores_snapshot() == {}
