"""The split-KV plan of the port's paged-decode kernel
(``automodel_tpu_torch/ops/paged_attention_kernel.py::split_plan``) and a
plain emulation of the kernel's split arithmetic, on the CPU.

``csrc/paged_decode.cu`` cuts each row's keys into spans of whole pages,
one CTA per (span, row tile, kv head, row); each CTA writes the partial
(m, l, unnormalised acc) of its tile's rows over the keys of its span, and
a log-sum-exp merge joins a row's partials.  The kernel runs only on the
card; here the plan is checked (spans cover the table's keys once, on
page boundaries; the grid comes from shapes alone and fills the card at
the serving YAML's decode shape) and the emulation of the split arithmetic
is held in fp32 against the JAX package's XLA gather, its Pallas kernel in
interpret mode and the port's plain version, within ``ATOL`` = 1e-5 (the
same fp32 math summed in another order).  Inputs are made from a seed with
numpy.
"""

import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.ops import paged_attention as jpa
from automodel_tpu.ops import paged_attention_kernel as jpak
from automodel_tpu_torch.config.loader import load_yaml_config
from automodel_tpu_torch.ops import paged_attention as tpa
from automodel_tpu_torch.ops import paged_attention_kernel as tpak
from tests.test_torch_kernels_cuda import (
    CASES,
    SPAN_CASES,
    make_case,
    make_span_case,
)

torch.set_num_threads(1)

ATOL = 1e-5
H100_SMS = 132
BS = tpak.BLOCK_SIZE
NEG_INF = -0.7 * float(np.finfo(np.float32).max)
SERVE_YAML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "automodel_tpu_torch", "examples",
    "llama3_2_1b_serve.yaml")


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


def _torch(args):
    return [None if a is None else torch.from_numpy(np.array(a))
            for a in args]


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
PLAN_SHAPES = [
    # (B, S, Hq, Hk, MB)
    (8, 1, 32, 8, 128),       # Llama-3.2-1B decode at the serving YAML
    (8, 5, 32, 8, 128),       # speculative verify
    (8, 32, 32, 8, 128),      # chunked prefill
    (1, 1, 32, 8, 128),       # one request
    (2, 1, 4, 2, 4),          # the CPU tests' tables
    (3, 7, 12, 4, 9),         # ragged everything
    (64, 1, 64, 8, 512),      # a large batch at 8192 keys
    (1, 64, 8, 8, 3),         # MHA, the longest chunk
]


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=[str(s) for s in PLAN_SHAPES])
def test_split_plan_spans_cover_the_keys_once(shape, bf16):
    B, S, Hq, Hk, MB = shape
    plan = tpak.split_plan(B, S, Hq, Hk, MB, H100_SMS, bf16=bf16)
    R = S * Hq // Hk
    assert plan.span % BS == 0 and 0 < plan.span <= tpak.MAX_SPAN
    spans = [(s * plan.span, min((s + 1) * plan.span, MB * BS))
             for s in range(plan.splits)]
    assert all(lo < hi and lo % BS == 0 and hi % BS == 0 for lo, hi in spans)
    assert spans[0][0] == 0 and spans[-1][1] == MB * BS
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    G = Hq // Hk
    if bf16:
        # a verify width (S <= 8) keeps decode's key split
        mode = 3 if R <= 16 or S <= tpak.VERIFY_S else 2
    else:
        mode = 0 if R <= 8 else 1
    assert plan.mode == mode and plan.row_tile == (4, 16, 64, 16)[mode]
    assert (plan.tiles - 1) * plan.row_tile < R <= plan.tiles * plan.row_tile
    assert plan.grid == (plan.splits, Hk * plan.tiles, B)
    # halved only while the grid (one query token's in mode 3) is short of
    # the SMs, never below 4 pages
    grid_tiles = -(-G // plan.row_tile) if mode == 3 else plan.tiles
    if plan.span < min(tpak.SPAN_PAGES, MB) * BS:
        assert plan.span >= tpak.MIN_SPAN_PAGES * BS
        assert B * Hk * grid_tiles * -(-MB * BS // (2 * plan.span)) \
            < H100_SMS
    if mode == 3 and bf16:
        # the span of a verify width is decode's
        assert plan.span == tpak.split_plan(B, 1, Hq, Hk, MB, H100_SMS,
                                            bf16=bf16).span


def test_split_plan_depends_on_shapes_only():
    """The grid is a function of integer shapes (and the q dtype): the
    wrapper never reads context lengths or positions on the host."""
    params = inspect.signature(tpak.split_plan).parameters
    assert list(params) == ["B", "S", "Hq", "Hk", "MB", "sms", "span",
                            "bf16"]
    a = tpak.split_plan(8, 1, 32, 8, 128, H100_SMS)
    assert a == tpak.split_plan(8, 1, 32, 8, 128, H100_SMS)
    src = inspect.getsource(tpak.paged_decode_cuda)
    assert "context_lens.cpu" not in src and ".item()" not in src
    assert "tolist" not in src


def test_split_plan_fills_the_card_at_the_serving_yaml():
    """Decode at the serving YAML's shapes (max_num_seqs rows, its model's
    heads, max_model_len / 16 pages) launches more CTAs than 132 SMs."""
    cfg = load_yaml_config(SERVE_YAML)
    B = int(cfg.serving.max_num_seqs)
    MB = -(-int(cfg.serving.max_model_len) // int(cfg.serving.kv_block_size))
    Hq = int(cfg.model.config.num_attention_heads)
    Hk = int(cfg.model.config.num_key_value_heads)
    plan = tpak.split_plan(B, 1, Hq, Hk, MB, H100_SMS)
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] > H100_SMS
    assert plan.splits > 1 and plan.mode == 3


def test_split_plan_span_override_and_refusals():
    assert tpak.split_plan(2, 1, 4, 2, 8, span=16).splits == 8
    assert tpak.split_plan(2, 1, 4, 2, 8, span=1024).splits == 1
    for bad in (0, 8, 24, 2048):
        with pytest.raises(ValueError, match="span"):
            tpak.split_plan(2, 1, 4, 2, 8, span=bad)
    with pytest.raises(ValueError, match="shapes"):
        tpak.split_plan(2, 1, 6, 4, 8)


# ---------------------------------------------------------------------------
# the split arithmetic
# ---------------------------------------------------------------------------
def split_kv_reference(q, kp, vp, ks, vs, tables, ctx, pos, plan, *,
                       scale=None, logits_soft_cap=None,
                       local_window_size=None):
    """The kernel's split arithmetic written out in fp32: per (row, kv head,
    row tile) the splits whose span holds keys the tile may attend, each a
    partial (m, l, acc) over the whole pages of its span -- scores (q . k)
    times the key scale, masked to -0.7 f32max, p = exp(x - m), acc = (p
    times the value scale) @ v -- then the log-sum-exp merge (one split:
    acc / l).  Returns the output and the partials by (b, h, tile, split)."""
    B, S, Hq, D = q.shape
    Hk = kp.shape[2]
    G, R = Hq // Hk, S * Hq // Hk
    K = tables.shape[1] * BS
    scale = D ** -0.5 if scale is None else scale
    window = local_window_size or 0
    idx = tables.long()
    kr = kp[idx].reshape(B, K, Hk, D).float()
    vr = vp[idx].reshape(B, K, Hk, D).float()
    ones = torch.ones(B, K, Hk)
    ksc = ks[idx].reshape(B, K, Hk).float() if ks is not None else ones
    vsc = vs[idx].reshape(B, K, Hk).float() if vs is not None else ones
    out = torch.zeros(B, S, Hk, G, D)
    partials = {}
    span = plan.span
    for b in range(B):
        qpos = pos[b].long().repeat_interleave(G)               # [R]
        for h in range(Hk):
            qrows = q[b, :, h * G:(h + 1) * G].float().reshape(R, D)
            for tile in range(plan.tiles):
                r0, r1 = tile * plan.row_tile, min((tile + 1) * plan.row_tile,
                                                   R)
                qp = qpos[r0:r1]
                kv_end = min(int(ctx[b]), int(qp.max()) + 1)
                first = max(0, int(qp.min()) - window + 1) if window else 0
                parts = []
                for s in range(first // span, (kv_end - 1) // span + 1):
                    k0, k1 = max(s * span, first), min((s + 1) * span, kv_end)
                    kpos = torch.arange(k0 // BS * BS, -(-k1 // BS) * BS)
                    x = (qrows[r0:r1] @ kr[b, kpos, h].T) \
                        * ksc[b, kpos, h] * scale
                    if logits_soft_cap:
                        x = logits_soft_cap * torch.tanh(x / logits_soft_cap)
                    ok = (kpos[None] < int(ctx[b])) & (kpos[None] <= qp[:, None])
                    if window:
                        ok &= kpos[None] > qp[:, None] - window
                    x = torch.where(ok, x, torch.full_like(x, NEG_INF))
                    m = x.max(-1).values
                    p = torch.where(ok, torch.exp(x - m[:, None]),
                                    torch.zeros_like(x))
                    l = p.sum(-1)
                    acc = (p * vsc[b, kpos, h]) @ vr[b, kpos, h]
                    partials[b, h, tile, s] = (m, l, acc)
                    parts.append((m, l, acc))
                if len(parts) == 1:
                    m, l, acc = parts[0]
                    o = acc / torch.where(l == 0, torch.ones_like(l), l)[:, None]
                else:
                    ms = torch.stack([p[0] for p in parts])
                    ls = torch.stack([p[1] for p in parts])
                    accs = torch.stack([p[2] for p in parts])
                    M = torch.where(ls > 0, ms,
                                    torch.full_like(ms, NEG_INF)).max(0).values
                    w = torch.where(ls > 0, torch.exp(ms - M),
                                    torch.zeros_like(ms))
                    o = (accs * w[..., None]).sum(0) / (ls * w).sum(0)[:, None]
                rr = torch.arange(r0, r1)
                out[b, rr // G, h, rr % G] = o
    return out.reshape(B, S, Hq, D), partials


def _plan(args, span, bf16=False):
    q, tables = args[0], args[5]
    B, S, Hq, _ = q.shape
    return tpak.split_plan(B, S, Hq, args[1].shape[2], tables.shape[1],
                           H100_SMS, span, bf16)


@pytest.mark.parametrize("span", [16, 32])
@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_split_arithmetic_matches_jax_gather(case, span):
    """Every case of the paged-attention matrix, cut into 2-4 splits."""
    args, kw = make_case(case)
    ref = np.asarray(jpa._paged_gather_impl(None, *_jax(args), **kw))
    t = _torch(args)
    out, _ = split_kv_reference(*t, _plan(t, span), **kw)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("rows_mode", [False, True], ids=["fp32_tiles",
                                                          "bf16_tiles"])
@pytest.mark.parametrize("case", SPAN_CASES, ids=[c[0] for c in SPAN_CASES])
def test_split_edges_match_jax_gather_and_port_plain(case, rows_mode):
    """The span edges (a context ending on a span boundary and one past it,
    ctx 1, a window starting mid-span, splits with no key for the rows,
    int8 scales, D 128), at the case's span and at split_plan's own, with
    the row tiles of either q dtype, against the JAX gather and the port's
    plain version."""
    _, ctx, S, window, quantized, D, span = case
    args, kw = make_span_case(ctx, S, window, quantized, D)
    ref = np.asarray(jpa._paged_gather_impl(None, *_jax(args), **kw))
    t = _torch(args)
    plain = tpa.paged_attention_plain(*t, **kw).numpy()
    np.testing.assert_allclose(plain, ref, atol=ATOL, rtol=0)
    for sp in (span, None):
        out, _ = split_kv_reference(*t, _plan(t, sp, rows_mode), **kw)
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
        np.testing.assert_allclose(out.numpy(), plain, atol=ATOL, rtol=0)


PALLAS_CASES = [c for c in SPAN_CASES if c[0] in (
    "ctx_on_span_boundary", "ctx_one_past_boundary", "ctx_1",
    "window_mid_span", "int8_scales", "d128_int8_window")]


@pytest.mark.parametrize("case", PALLAS_CASES,
                         ids=[c[0] for c in PALLAS_CASES])
def test_split_edges_match_jax_pallas_kernel_interpret(case, monkeypatch):
    """The same edges at D 128 against the TPU kernel itself (Pallas in
    interpret mode; its head_dim must be a multiple of 128)."""
    monkeypatch.setattr(jpak, "_INTERPRET", True)
    _, ctx, S, window, quantized, _, span = case
    args, kw = make_span_case(ctx, S, window, quantized, 128)
    ref = np.asarray(jpak.paged_decode_pallas(*_jax(args), **kw))
    t = _torch(args)
    out, _ = split_kv_reference(*t, _plan(t, span), **kw)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_a_split_without_keys_for_a_row_weighs_zero():
    """A split the tile reads where a row's own mask leaves no key (row 0's
    positions 64 and 65 with a window of 2: the split [48, 64) holds key 63
    for position 64 and none for 65) has l = 0 and m = -0.7 f32max, and
    the merge gives it no weight."""
    args, kw = make_span_case((66, 77), 4, 2, False, 64)
    t = _torch(args)
    out, parts = split_kv_reference(*t, _plan(t, 16), **kw)
    dead = [(key, r) for key, (m, l, _) in parts.items()
            for r in range(len(l)) if l[r] == 0]
    assert dead, "the case must hold a split with no key for some row"
    for key, r in dead:
        assert float(parts[key][0][r]) == float(np.float32(NEG_INF))
        assert float(parts[key][2][r].abs().max()) == 0.0
    ref = np.asarray(jpa._paged_gather_impl(None, *_jax(args), **kw))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
