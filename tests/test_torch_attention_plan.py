"""The tile plan of the attention kernels (``csrc/attn_core.cuh``, mirrored
by ``automodel_tpu_torch/ops/attention_plan.py``) and an emulation of their
arithmetic over it, on the CPU.

The kernels run only on the card.  Here the Python mirror of their plan is
checked over seeded random packings (samples of many lengths, a padding
tail of segment 0, tails longer than a tile), pure causal and full masks,
trailing windows, sequence lengths off every tile edge, and both segment
rules (splash: segment 0 never attends and is never attended; the flash
rung's equality: segment 0 attends segment 0), for each of the three
passes (forward, dQ, dK / dV):

* every attended (query, key) pair lies in exactly one visited tile (one
  per query head of the group in the dK / dV pass), so no skipped tile
  holds one; every pair of a ``FULL`` tile attends (its mask is skipped);
* the items cover every (batch row, head, tile) once, the longest first.

Then an fp32 emulation of the kernels' walk -- the forward's online
softmax over the visited kv tiles in the kernels' order (the log2 domain,
the scale folded into one multiply, the per-element mask on ``PARTIAL``
tiles only), the dQ pass over kv tiles and the dK / dV pass over the q
tiles of every query head of a kv head -- is held against the JAX
package's functions run as their own tests run them: ``splash_attention_bshd``
in Pallas interpret mode (head_dim 128, as upstream splash needs here) on
the rows with segment >= 1 (the upstream gradient 0 elsewhere, as -100
labels make it), and the Pallas MHA flash under
``pltpu.force_tpu_interpret_mode()`` on every row.  Tolerance: fp32 on both
sides, sums and exponentials in another order: 1e-4 absolute and
relative.

Inputs are made from a seed with numpy.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from automodel_tpu.ops import flash_attention as jfa
from automodel_tpu.ops import splash_attention as jsa
from automodel_tpu.ops.kernel_lib import parity
from automodel_tpu_torch.ops import attention_plan as ap
from automodel_tpu_torch.ops import splash_attention as tsa

torch.set_num_threads(1)
TOL = 1e-4
LOG2E = np.float32(np.log2(np.e))
LN2 = np.float32(np.log(2.0))


def packing(S, kind, rng):
    """Segment ids [S] of one row: ``packed`` (samples of 1-300 rows, a
    padding tail of 0-150 rows), ``tiny`` (samples of 1-20 rows), ``one``
    (one sample and a tail past a tile), or None."""
    if kind is None:
        return None
    seg = np.zeros(S, np.int32)
    top = {"packed": 300, "tiny": 20, "one": S}[kind]
    tail = {"packed": int(rng.integers(0, 150)), "tiny": 3,
            "one": min(S // 2, 70)}[kind]
    pos, i = 0, 1
    while pos < S - tail:
        n = min(int(rng.integers(1, top + 1)), S - tail - pos)
        seg[pos:pos + n] = i
        pos, i = pos + n, i + 1
    return seg


def mask_of(S, causal, window, seg, seg_eq):
    """The attention mask [S, S] (query, key) as the kernels state it."""
    qi, kj = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    ok = np.ones((S, S), bool)
    if causal:
        ok &= kj <= qi
    if window:
        ok &= qi - kj < window
    if seg is not None:
        ok &= seg[:, None] == seg[None, :]
        if not seg_eq:
            ok &= seg[None, :] != 0
    return ok


# (S, causal, window, packing): ragged S off the 64- and 128-row tiles
GEOMETRY = [
    (64, True, 0, None), (200, True, 0, None), (300, False, 0, None),
    (1000, True, 0, "packed"), (777, False, 0, "packed"),
    (512, True, 0, "tiny"), (330, False, 0, "tiny"),
    (640, True, 0, "one"), (450, True, 100, None), (450, True, 130, "packed"),
    (1000, True, 16, "tiny"), (256, True, 300, "packed"),
]
RULES = [False, True]          # seg_eq


@pytest.mark.parametrize("seg_eq", RULES, ids=["splash_rule", "equality"])
@pytest.mark.parametrize("geom", GEOMETRY,
                         ids=[f"s{g[0]}_{'causal' if g[1] else 'full'}"
                              f"_w{g[2]}_{g[3]}" for g in GEOMETRY])
@pytest.mark.parametrize("kind", list(ap.PASSES))
def test_every_attended_pair_is_in_exactly_one_visited_tile(kind, geom,
                                                            seg_eq):
    S, causal, window, pack = geom
    rng = np.random.default_rng(S + 7 * window)
    seg = packing(S, pack, rng)
    ok = mask_of(S, causal, window, seg, seg_eq)
    bm, bn = ap.PASSES[kind]
    groups = 2 if kind == "dkv" else 1
    count = np.zeros((groups, S, S), np.int64)
    for _, _, first in ap.items(kind, 1, S, groups, 1):
        tiles = ap.visits(kind, S, causal, window, seg, seg_eq, first,
                          groups)
        per = len(tiles) // groups
        for n, (q0, k0, cls) in enumerate(tiles):
            region = ok[q0:q0 + bm, k0:k0 + bn]
            if cls == ap.SKIP:
                assert not region.any(), (q0, k0)
                continue
            count[n // per, q0:q0 + bm, k0:k0 + bn] += 1
            if cls == ap.FULL:
                assert q0 + bm <= S and k0 + bn <= S and region.all()
    for g in range(groups):
        assert (count[g][ok] == 1).all()
        assert (count[g] <= 1).all()


@pytest.mark.parametrize("seg_eq", RULES, ids=["splash_rule", "equality"])
@pytest.mark.parametrize("geom", GEOMETRY,
                         ids=[f"s{g[0]}_{'causal' if g[1] else 'full'}"
                              f"_w{g[2]}_{g[3]}" for g in GEOMETRY])
def test_head_dim_192_forward_tiles_cover_every_pair_once(geom, seg_eq):
    """The forward's 64-key tiles at head_dim 192 (MLA): every attended
    pair in exactly one visited tile, FULL tiles wholly attended."""
    S, causal, window, pack = geom
    seg = packing(S, pack, np.random.default_rng(S + 7 * window))
    ok = mask_of(S, causal, window, seg, seg_eq)
    bm, bn = ap.tiles("fwd", 192)
    assert (bm, bn) == (128, 64)
    count = np.zeros((S, S), np.int64)
    for _, _, first in ap.items("fwd", 1, S, 1, 1, head_dim=192):
        for q0, k0, cls in ap.visits("fwd", S, causal, window, seg, seg_eq,
                                     first, head_dim=192):
            region = ok[q0:q0 + bm, k0:k0 + bn]
            if cls == ap.SKIP:
                assert not region.any(), (q0, k0)
                continue
            count[q0:q0 + bm, k0:k0 + bn] += 1
            if cls == ap.FULL:
                assert q0 + bm <= S and k0 + bn <= S and region.all()
    assert (count[ok] == 1).all() and (count <= 1).all()


def test_head_dim_192_keeps_the_dq_and_dkv_tiles():
    """At head_dim 192 only the forward's tiles change (64 keys); the dQ
    and dK / dV passes (the latter run as dV, then dK) keep their tiles
    and items."""
    for kind in ("dq", "dkv"):
        assert ap.tiles(kind, 192) == ap.PASSES[kind]
        assert (ap.items(kind, 2, 700, 4, 4, head_dim=192)
                == ap.items(kind, 2, 700, 4, 4))


@pytest.mark.parametrize("seg_eq", RULES, ids=["splash_rule", "equality"])
@pytest.mark.parametrize("geom", GEOMETRY,
                         ids=[f"s{g[0]}_{'causal' if g[1] else 'full'}"
                              f"_w{g[2]}_{g[3]}" for g in GEOMETRY])
@pytest.mark.parametrize("kind", list(ap.PASSES))
def test_head_dim_256_tiles_cover_every_pair_once(kind, geom, seg_eq):
    """Every pass's tiles at head_dim 256 (Gemma): the forward's 64-key,
    the dQ pass's 32-key and the dK / dV passes' 32-row tiles, each 32-wide
    tile classified from the meta of the 64-row tile it lies in; every
    attended pair in exactly one visited tile per query head, FULL tiles
    wholly attended, SKIP tiles never attended."""
    S, causal, window, pack = geom
    seg = packing(S, pack, np.random.default_rng(S + 7 * window))
    ok = mask_of(S, causal, window, seg, seg_eq)
    bm, bn = ap.tiles(kind, 256)
    assert (bm, bn) == ap.PASSES_D256[kind]
    groups = 2 if kind == "dkv" else 1
    count = np.zeros((groups, S, S), np.int64)
    for _, _, first in ap.items(kind, 1, S, groups, 1, head_dim=256):
        tiles = ap.visits(kind, S, causal, window, seg, seg_eq, first,
                          groups, head_dim=256)
        per = len(tiles) // groups
        for n, (q0, k0, cls) in enumerate(tiles):
            region = ok[q0:q0 + bm, k0:k0 + bn]
            if cls == ap.SKIP:
                assert not region.any(), (q0, k0)
                continue
            count[n // per, q0:q0 + bm, k0:k0 + bn] += 1
            if cls == ap.FULL:
                assert q0 + bm <= S and k0 + bn <= S and region.all()
    for g in range(groups):
        assert (count[g][ok] == 1).all()
        assert (count[g] <= 1).all()


@pytest.mark.parametrize("kind", list(ap.PASSES))
def test_items_cover_every_tile_once_the_longest_first(kind):
    B, S, Hq, Hk = 2, 700, 8, 2
    bm, bn = ap.PASSES[kind]
    items = ap.items(kind, B, S, Hq, Hk)
    H, rows = (Hk, bn) if kind == "dkv" else (Hq, bm)
    assert sorted(items) == sorted(
        (b, h, t * rows) for b in range(B) for h in range(H)
        for t in range(-(-S // rows)))
    firsts = [it[2] for it in items]
    # forward / dQ: the last q tiles (the longest causal rows) first;
    # dK / dV: the first key tiles (seen by the most causal rows) first
    assert firsts == sorted(firsts, reverse=kind != "dkv")


def test_the_mirror_rule_is_the_plain_versions_mask():
    """``attention_plan.allowed`` against the plain versions' masks."""
    from automodel_tpu_torch.ops.attention import make_attention_mask
    from automodel_tpu_torch.ops.flash_attention import mha_mask

    S, window = 90, 17
    seg = packing(S, "tiny", np.random.default_rng(0))
    t = torch.from_numpy(seg)[None]
    splash = make_attention_mask(S, S, causal=True, segment_ids_q=t,
                                 segment_ids_kv=t,
                                 local_window_size=window)[0, 0].numpy()
    flash = mha_mask(S, True, t, "cpu")[0, 0].numpy()
    for qi, kj in itertools.product(range(S), range(S)):
        assert ap.allowed(qi, kj, S, True, window, seg[qi], seg[kj],
                          False) == splash[qi, kj]
        assert ap.allowed(qi, kj, S, True, 0, seg[qi], seg[kj],
                          True) == flash[qi, kj]


# ---------------------------------------------------------------------------
# the kernels' arithmetic, emulated in fp32 over the plan
# ---------------------------------------------------------------------------
def _tile(x, r0, rows):
    """Rows [r0, r0 + rows) of x, zero past its end (TMA's fill)."""
    t = np.zeros((rows,) + x.shape[1:], np.float32)
    n = max(0, min(rows, x.shape[0] - r0))
    t[:n] = x[r0:r0 + n]
    return t


def _scores(q_t, k_t, scale, cap):
    """The scores as they enter the softmax (times ``mult`` there): raw
    products, or with a cap the capped scaled ones; and the derivative of
    the capped score by the scaled one (1 without a cap)."""
    s = q_t @ k_t.T
    if cap is None:
        return s, np.ones_like(s)
    th = np.tanh(s * np.float32(scale) / np.float32(cap))
    return np.float32(cap) * th, 1 - th * th


def _tile_mask(ok, q0, bm, k0, bn):
    m = np.zeros((bm, bn), bool)
    part = ok[q0:q0 + bm, k0:k0 + bn]
    m[:part.shape[0], :part.shape[1]] = part
    return m


def emulate(q, k, v, dout, seg, causal, window, seg_eq, cap=None):
    """One batch row: q [S, Hq, D], k / v [S, Hk, D] -> out, lse [Hq, S],
    dq, dk, dv as the kernels compute them (fp32)."""
    S, Hq, D = q.shape
    Hk = k.shape[1]
    G = Hq // Hk
    scale = D ** -0.5
    mult = LOG2E if cap else np.float32(scale) * LOG2E
    ok = mask_of(S, causal, window, seg, seg_eq)
    out = np.zeros_like(q)
    lse = np.zeros((Hq, S), np.float32)
    bm, bn = ap.tiles("fwd", D)
    for _, h, q0 in ap.items("fwd", 1, S, Hq, Hk, head_dim=D):
        qt = _tile(q[:, h], q0, bm)
        m = np.full(bm, -np.inf, np.float32)
        ll = np.zeros(bm, np.float32)
        o = np.zeros((bm, D), np.float32)
        for _, k0, cls in ap.visits("fwd", S, causal, window, seg,
                                    seg_eq, q0, head_dim=D):
            if cls == ap.SKIP:
                continue
            s, _ = _scores(qt, _tile(k[:, h // G], k0, bn), scale, cap)
            if cls == ap.PARTIAL:
                s = np.where(_tile_mask(ok, q0, bm, k0, bn), s, -np.inf)
            m_new = np.maximum(m, s.max(1))
            ref = np.where(m_new == -np.inf, 0, m_new * mult)
            alpha = np.exp2(m * mult - ref)
            p = np.exp2(s * mult - ref[:, None])
            ll = ll * alpha + p.sum(1)
            o = o * alpha[:, None] + p @ _tile(v[:, h // G], k0, bn)
            m = m_new
        n = min(bm, S - q0)
        live = ll[:n] > 0
        out[q0:q0 + n, h] = np.where(live[:, None],
                                     o[:n] / np.where(live, ll[:n], 1)[:, None],
                                     0)
        lse[h, q0:q0 + n] = np.where(
            live, (m[:n] * mult + np.log2(np.where(live, ll[:n], 1))) * LN2,
            0)
    delta = (dout * out).sum(-1).T                       # [Hq, S]
    dq = np.zeros_like(q)
    bm, bn = ap.tiles("dq", D)
    for _, h, q0 in ap.items("dq", 1, S, Hq, Hk, head_dim=D):
        qt, dot = _tile(q[:, h], q0, bm), _tile(dout[:, h], q0, bm)
        l2 = _tile(lse[h][:, None], q0, bm)[:, 0] * LOG2E
        dl = _tile(delta[h][:, None], q0, bm)[:, 0]
        acc = np.zeros((bm, D), np.float32)
        for _, k0, cls in ap.visits("dq", S, causal, window, seg, seg_eq,
                                    q0, head_dim=D):
            if cls == ap.SKIP:
                continue
            kt, vt = _tile(k[:, h // G], k0, bn), _tile(v[:, h // G], k0, bn)
            s, dx = _scores(qt, kt, scale, cap)
            ds = np.exp2(s * mult - l2[:, None]) * (dot @ vt.T
                                                    - dl[:, None]) * dx
            if cls == ap.PARTIAL:
                ds = np.where(_tile_mask(ok, q0, bm, k0, bn), ds, 0)
            acc += ds @ kt
        n = min(bm, S - q0)
        dq[q0:q0 + n, h] = acc[:n] * scale
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    bm, bn = ap.tiles("dkv", D)
    for _, hk, k0 in ap.items("dkv", 1, S, Hq, Hk, head_dim=D):
        kt, vt = _tile(k[:, hk], k0, bn), _tile(v[:, hk], k0, bn)
        ak = np.zeros((bn, D), np.float32)
        av = np.zeros((bn, D), np.float32)
        tiles = ap.visits("dkv", S, causal, window, seg, seg_eq, k0, G,
                          head_dim=D)
        per = len(tiles) // G
        for n, (q0, _, cls) in enumerate(tiles):
            if cls == ap.SKIP:
                continue
            h = hk * G + n // per
            qt, dot = _tile(q[:, h], q0, bm), _tile(dout[:, h], q0, bm)
            l2 = _tile(lse[h][:, None], q0, bm)[:, 0] * LOG2E
            dl = _tile(delta[h][:, None], q0, bm)[:, 0]
            s, dx = _scores(kt, qt, scale, cap)             # S^T [keys, q]
            pt = np.exp2(s * mult - l2[None, :])
            dst = pt * (vt @ dot.T - dl[None, :]) * dx
            if cls == ap.PARTIAL:
                keep = _tile_mask(ok, q0, bm, k0, bn).T
                pt, dst = np.where(keep, pt, 0), np.where(keep, dst, 0)
            av += pt @ dot
            ak += dst @ qt
        n = min(bn, S - k0)
        dk[k0:k0 + n, hk] = ak[:n] * scale
        dv[k0:k0 + n, hk] = av[:n]
    return out, lse, dq, dk, dv


def make_inputs(B, S, Hq, Hk, D, pack, seed, cap=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    if cap:
        q *= 40.0
    k, v = (rng.normal(size=(B, S, Hk, D)).astype(np.float32)
            for _ in range(2))
    dout = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    seg = (None if pack is None
           else np.stack([packing(S, pack, rng) for _ in range(B)]))
    return q, k, v, dout, seg


def emulate_batch(q, k, v, dout, seg, causal, window, seg_eq, cap=None):
    res = [emulate(q[b], k[b], v[b], dout[b],
                   None if seg is None else seg[b], causal, window, seg_eq,
                   cap) for b in range(q.shape[0])]
    return [np.stack(x) for x in zip(*res)]


def jax_run(fn, q, k, v, dout, kw):
    out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, **kw),
                       *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(out)] + [np.asarray(g)
                                for g in vjp(jnp.asarray(dout))]


# splash: (name, S, Hq, Hk, window, packing, cap); head_dim 128
SPLASH_CASES = [
    ("packed_ragged_s300", 300, 4, 2, None, "packed", None),
    ("window100_packed_s300", 300, 4, 2, 100, "packed", None),
    ("tiny_segments_s256", 256, 2, 2, None, "tiny", None),
    ("cap30_s200", 200, 4, 2, None, None, 30.0),
]
# head_dim 192 (MLA's width; query heads = kv heads, as the model runs it)
SPLASH_D192_CASES = [
    ("mla_packed_ragged_s300", 300, 2, 2, None, "packed", None),
    ("mla_causal_s200", 200, 2, 2, None, None, None),
]


# head_dim 256 (Gemma's width: GQA, the window, the soft cap)
SPLASH_D256_CASES = [
    ("gemma_packed_window40_s300", 300, 4, 2, 40, "packed", None),
    ("gemma2_cap50_s200", 200, 2, 1, None, None, 50.0),
]


@pytest.mark.parametrize("case", SPLASH_CASES,
                         ids=[c[0] for c in SPLASH_CASES])
def test_emulated_walk_matches_splash_interpret(case):
    _check_against_splash(case, 128)


@pytest.mark.parametrize("case", SPLASH_D192_CASES,
                         ids=[c[0] for c in SPLASH_D192_CASES])
def test_emulated_walk_matches_splash_interpret_at_head_dim_192(case):
    _check_against_splash(case, 192)


@pytest.mark.parametrize("case", SPLASH_D256_CASES,
                         ids=[c[0] for c in SPLASH_D256_CASES])
def test_emulated_walk_matches_splash_interpret_at_head_dim_256(case):
    _check_against_splash(case, 256)


def _check_against_splash(case, D):
    _, S, Hq, Hk, window, pack, cap = case
    q, k, v, dout, seg = make_inputs(1, S, Hq, Hk, D, pack, seed=S,
                                     cap=cap)
    valid = np.ones((1, S), bool) if seg is None else seg > 0
    dout[~valid] = 0.0
    got = emulate_batch(q, k, v, dout, seg, True, window or 0, False, cap)
    with parity.interpret_mode():
        want = jax_run(jsa.splash_attention_bshd, q, k, v, dout, dict(
            causal=True, segment_ids=None if seg is None
            else jnp.asarray(seg), logits_soft_cap=cap,
            local_window_size=window))
    np.testing.assert_allclose(got[0][valid], want[0][valid], atol=TOL,
                               rtol=TOL, err_msg="out")
    for name, g, w in zip(("dq", "dk", "dv"), got[2:], want[1:]):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)
    assert np.all(got[0][~valid] == 0) and np.all(got[1][0][:, ~valid[0]]
                                                  == 0)
    # and the lse against the port's plain forward
    _, lse = tsa.splash_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
        segment_ids=None if seg is None else torch.from_numpy(seg),
        logits_soft_cap=cap, local_window_size=window)
    np.testing.assert_allclose(got[1], lse.numpy(), atol=TOL, rtol=TOL)


# flash (equality rule): (name, S, Hq, Hk, D, causal, packing)
FLASH_CASES = [
    ("causal_packed_s256_d64", 256, 4, 2, 64, True, "packed"),
    ("full_packed_s256_d64", 256, 2, 2, 64, False, "packed"),
    ("causal_s128_d128", 128, 2, 1, 128, True, None),
    ("full_tiny_s256_d128", 256, 2, 2, 128, False, "tiny"),
]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[c[0] for c in FLASH_CASES])
def test_emulated_walk_matches_the_flash_kernel_interpreted(case):
    _, S, Hq, Hk, D, causal, pack = case
    q, k, v, dout, seg = make_inputs(2, S, Hq, Hk, D, pack, seed=D + S)
    got = emulate_batch(q, k, v, dout, seg, causal, 0, True)
    with pltpu.force_tpu_interpret_mode():
        want = jax_run(jfa.flash_attention_bshd, q, k, v, dout, dict(
            causal=causal,
            segment_ids=None if seg is None else jnp.asarray(seg)))
    for name, g, w in zip(("out", "dq", "dk", "dv"), got[:1] + got[2:],
                          want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)
