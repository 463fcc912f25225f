"""The plan of the port's linear-CE forward kernel
(``automodel_tpu_torch/ops/linear_ce_kernel.py::linear_ce_fwd_plan``) and a
plain emulation of the kernel's arithmetic over it, on the CPU.

``csrc/linear_ce_fwd.cu`` runs the forward as a persistent ``wgmma``
product whose CTAs walk runs of vocab tiles of one row tile, folding each
128 x 256 logits tile into per-thread running (max, sumexp, pick) and
writing one partial per run; a second launch merges the splits' partials
in order.  The kernel runs only on the card; here:

* the plan covers every (row tile, vocab tile) exactly once; each run
  stays inside one row tile and one split; the CTAs' run counts differ by
  at most one and splits by at most one tile, so their item counts differ
  by at most one run (and one tile a run); the grid fits the SMs;
* an emulation of the arithmetic in fp32 over the plan -- each lane of a
  quad folding its 64 columns of each tile (masked past V), the quad
  combined by the kernel's butterfly at the run's end, the splits merged
  in order -- against the JAX package's ``lse_and_pick`` (its Pallas
  ``_fwd_pallas`` in interpret mode, ``_INTERPRET`` monkeypatched as
  ``tests/test_torch_linear_ce.py`` does) and the port's plain version.
  Cases: V not a multiple of 256, T not a multiple of 128, labels -100, a
  label at V - 1, labels past V, and every label ignored; plans with
  several groups, idle row tiles and uneven splits.  Tolerance: fp32 on
  every side, the same products and exponentials summed in another order:
  1e-5 absolute and relative, as ``tests/test_torch_linear_ce.py``.

Inputs are made from a seed with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import automodel_tpu.ops.linear_ce_kernel as jlck
from automodel_tpu_torch.ops import linear_ce_kernel as lce

torch.set_num_threads(1)

TM, TV = lce.FWD_TILE_M, lce.FWD_TILE_V
TOL = dict(atol=1e-5, rtol=1e-5)
NEG_INIT = np.float32(-1e30)
LOG2E = np.float32(1.4426950408889634)

# (T, V, sms): the bench SFT path's forward on an H100, a ragged last
# group (idle row tiles), small T (many splits), GPT-2's vocabulary, fewer
# SMs than row tiles, and tiny shapes
PLAN_SHAPES = [
    (16384, 128256, 132),
    (16384 + 5 * 128 + 7, 128256, 132),
    (1000, 128256, 132),
    (4096, 50257, 132),
    (16384, 128256, 7),
    (600, 2600, 8),
    (200, 1800, 3),
    (130, 600, 132),
    (1, 1, 132),
]


def cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("T,V,sms", PLAN_SHAPES,
                         ids=[f"t{t}_v{v}_sms{s}" for t, v, s in PLAN_SHAPES])
def test_plan_covers_every_tile_once_in_runs_of_one_row_tile(T, V, sms):
    plan = lce.linear_ce_fwd_plan(T, V, sms)
    n_m, n_v = cdiv(T, TM), cdiv(V, TV)
    assert (plan.n_m, plan.n_v) == (n_m, n_v)
    assert plan.grid <= sms and plan.row_tiles <= lce.FWD_ROW_TILES_MAX
    assert 1 <= plan.splits <= n_v
    seen = np.zeros((n_m, n_v), np.int64)
    real, runs = [], []
    for c in range(plan.grid):
        items = plan.items(c)
        assert len(items) == plan.groups * plan.run
        real.append(sum(it.vocab_tile >= 0 for it in items))
        runs.append(sum(it.run_end and it.row_tile < n_m for it in items))
        for r0 in range(0, len(items), plan.run):
            run = items[r0:r0 + plan.run]
            assert [it.run_end for it in run] == [False] * (plan.run - 1) + [
                True]
            assert len({(it.row_tile, it.split) for it in run}) == 1
            q = run[0].split
            lo, hi = q * n_v // plan.splits, (q + 1) * n_v // plan.splits
            tiles = [it.vocab_tile for it in run if it.vocab_tile >= 0]
            # a contiguous range of the split, from its start, the idle
            # items after it
            assert tiles == list(range(lo, lo + len(tiles)))
            assert all(it.vocab_tile < 0 for it in run[len(tiles):])
            if run[0].row_tile < n_m:
                assert tiles == list(range(lo, hi))
            for v in tiles:
                seen[run[0].row_tile, v] += 1
    assert (seen == 1).all()
    # the CTAs' runs differ by at most one, and runs by at most one tile
    # in length, so their items by at most one run (and a tile a run)
    assert max(runs) - min(runs) <= 1
    assert max(real) - min(real) <= plan.run + plan.groups - 1


def test_the_bench_plan_fills_the_card_and_keeps_h_in_l2():
    """T 16384, V 128256 on 132 SMs: 32 row tiles (16 MB of h at H 2048)
    in 4 splits, 128 CTAs, 4 passes over the head."""
    plan = lce.linear_ce_fwd_plan(16384, 128256, 132)
    assert (plan.row_tiles, plan.splits, plan.groups, plan.run) == (32, 4, 4,
                                                                    126)
    assert plan.grid == 128


# ---------------------------------------------------------------------------
# the plan's arithmetic against the JAX package and the plain version
# ---------------------------------------------------------------------------
def emulate_forward(h, w, labels, sms):
    """lse, pick as csrc/linear_ce_fwd.cu computes them over its plan, in
    fp32: lane t of a quad holds the columns j of a tile with (j % 8) // 2
    == t; per item it folds its columns' masked logits into (m, s, p);
    at a run's end the quad combines by xor-1 then xor-2 exchanges and the
    run's partial is written; then the splits merge in order."""
    T, _ = h.shape
    V = w.shape[1]
    plan = lce.linear_ce_fwd_plan(T, V, sms)
    wp = np.zeros((w.shape[0], plan.n_v * TV), np.float32)
    wp[:, :V] = w
    lanes = [np.flatnonzero((np.arange(TV) % 8) // 2 == t) for t in range(4)]
    part = np.full((3, plan.splits, T), np.nan, np.float32)
    for c in range(plan.grid):
        for k, it in enumerate(plan.items(c)):
            rows = it.row_tile * TM + np.arange(TM)
            valid = rows < T
            if k % plan.run == 0:                  # a run starts
                m = np.full((TM, 4), NEG_INIT, np.float32)
                s = np.zeros((TM, 4), np.float32)
                p = np.zeros((TM, 4), np.float32)
                lab = np.full(TM, -1, np.int64)
                lab[valid] = labels[rows[valid]]
                lab[(lab < 0) | (lab >= V)] = -1
            if it.vocab_tile >= 0:
                n0 = it.vocab_tile * TV
                hr = np.zeros((TM, h.shape[1]), np.float32)
                hr[valid] = h[rows[valid]]
                cols = n0 + np.arange(TV)
                x = np.where(cols[None, :] < V, hr @ wp[:, n0:n0 + TV],
                             -np.inf).astype(np.float32)
                for t in range(4):
                    xt = x[:, lanes[t]]
                    m_new = np.maximum(m[:, t], np.maximum(NEG_INIT,
                                                           xt.max(1)))
                    mb = m_new * LOG2E
                    s[:, t] = (s[:, t] * np.exp2(m[:, t] * LOG2E - mb)
                               + np.exp2(xt * LOG2E - mb[:, None]).sum(1))
                    m[:, t] = m_new
                    hit = cols[lanes[t]][None, :] == lab[:, None]
                    p[:, t] += np.where(hit, xt, 0).sum(1)
            if it.run_end:
                for off in (1, 2):
                    other = [t ^ off for t in range(4)]
                    mo, so, po = m[:, other], s[:, other], p[:, other]
                    mn = np.maximum(m, mo)
                    s = (s * np.exp2((m - mn) * LOG2E)
                         + so * np.exp2((mo - mn) * LOG2E))
                    m, p = mn, p + po
                for j, a in enumerate((m, s, p)):
                    part[j, it.split, rows[valid]] = a[valid, 0]
    assert not np.isnan(part).any()
    pm, ps, pp = part
    mm = np.maximum(NEG_INIT, pm.max(0))
    lse = mm + np.log((ps * np.exp(pm - mm[None])).sum(0))
    return lse.astype(np.float32), pp.sum(0).astype(np.float32)


# (name, T, V, sms, labels): plans of several groups, idle row tiles and
# uneven splits (600 x 2600 on 8 SMs: 2 row tiles x 4 splits of 2-3 tiles,
# 3 groups, the last half idle), one row tile per group (200 x 1800 on 3),
# runs of one tile (130 x 600 on 132)
ARITH_CASES = [
    ("groups_idle_rows_uneven_splits", 600, 2600, 8, "mixed"),
    ("one_row_tile_groups", 200, 1800, 3, "mixed"),
    ("runs_of_one_tile", 130, 600, 132, "mixed"),
    ("all_ignored", 200, 1800, 3, "ignored"),
]


def arith_case(T, V, kind, H=128, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(T, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) * 0.1).astype(np.float32)
    if kind == "ignored":
        return h, w, np.full(T, -100, np.int32)
    labels = rng.integers(0, V, T).astype(np.int32)
    labels[rng.permutation(T)[:T // 5]] = -100
    labels[0], labels[1], labels[2] = V - 1, V, V + 300   # edge, past V
    labels[-1] = 0
    return h, w, labels


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jlck, "_INTERPRET", True)


@pytest.mark.parametrize("name,T,V,sms,kind", ARITH_CASES,
                         ids=[c[0] for c in ARITH_CASES])
def test_emulated_forward_matches_jax_pallas_and_the_plain_version(
        interpret, name, T, V, sms, kind):
    h, w, labels = arith_case(T, V, kind)
    lse, pick = emulate_forward(h, w, labels, sms)
    jlse, jpick = jax.jit(lambda a, b, c: jlck.lse_and_pick(a, b, c,
                                                            "pallas"))(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels))
    np.testing.assert_allclose(lse, np.asarray(jlse), **TOL)
    np.testing.assert_allclose(pick, np.asarray(jpick), **TOL)
    plse, ppick = lce.lse_and_pick_plain(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(labels))
    np.testing.assert_allclose(lse, plse.numpy(), **TOL)
    np.testing.assert_allclose(pick, ppick.numpy(), **TOL)
    if kind == "ignored":
        assert not pick.any()
