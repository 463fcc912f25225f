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
