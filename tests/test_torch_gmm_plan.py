"""The work-item plans of the port's grouped matmuls
(``automodel_tpu_torch/ops/gmm_kernel.py``: ``gmm_work_items``,
``tgmm_work_items``, ``tgmm_chunk_rows``, ``tgmm_workspace_slots``) and a
plain emulation of the kernels' arithmetic over those items, on the CPU.

``csrc/gmm.cu`` runs ``gmm`` and ``tgmm`` as persistent ``wgmma`` products
over work items fixed by shapes alone; each item finds its group on the
device.  The kernels run only on the card; here the Python mirrors of their
item plans are checked over group layouts that the MoE path and its edges
give (padded routed segments, one hot expert, raw sizes with empty groups
first, inside and last, many groups of 1-127 rows so that a row tile meets
several groups, a trailing group that ends inside a tile, groups that fill
the buffer):

* ``gmm``: every row of the output, in every column tile, is written by
  exactly one item; an item writes sums only for its own group's rows and
  zeros only for rows past the groups; ``n_n (n_m + E)`` items;
* ``tgmm``: every block ``(g, k tile, n tile)`` is covered once, its chunks
  covering ``[lo, hi)`` (an empty group's by one item of zeros);
  ``n_k n_n (E + m // C)`` items; split groups' partials in distinct
  workspace slots below ``tgmm_workspace_slots``; the longest-first snake
  order leaves the CTAs' stage counts within one longest item of each
  other;
* the emulation of the items' fp32 sums (``gmm``: the whole 128-row tile
  times the item's group, only its rows kept; ``tgmm``: chunk partials added
  in chunk order) against the plain versions and the JAX package's ``gmm``
  / ``tgmm`` (Pallas in interpret mode, as ``tests/test_torch_gmm.py`` runs
  them).  Tolerance: fp32 on every side, the same products summed in
  another order over up to 900 rows: 1e-4 absolute and relative.

Inputs are made from a seed with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import automodel_tpu.ops.gmm_kernel as jgk
from automodel_tpu_torch.ops import gmm_kernel as gk

torch.set_num_threads(1)

H100_SMS = 132
TOL = dict(atol=1e-4, rtol=1e-4)

TINY = [int(x) for x in np.random.default_rng(3).integers(1, 128, 24)]
LAYOUTS = [
    # (name, group sizes, m)
    ("padded_routed", [256, 128, 0, 384, 128, 256, 0, 128], 1536),
    ("hot_expert", [0, 0, 900, 0], 1024),
    ("raw_empty_first_inside_last", [0, 70, 0, 130, 45, 0, 200, 0], 512),
    ("many_tiny_groups", TINY, sum(TINY) + 37),
    ("trailing_group_ends_inside_a_tile", [128, 200], 384),
    ("groups_fill_the_buffer", [100, 156], 256),
]
LAYOUT_IDS = [c[0] for c in LAYOUTS]
# past 1024 groups the kernels keep the group plan in a global workspace
# (ops/gmm_kernel.py::plan_workspace) and read the same items from there
_E2048 = [int(x) for x in np.random.default_rng(21).integers(0, 8, 2048)]
_E4096 = [int(x) for x in np.random.default_rng(22).integers(0, 4, 4096)]
MANY_GROUPS = [
    ("e2048_tiny_groups", _E2048, sum(_E2048) + 37),
    ("e4096_clipped_by_m", _E4096, sum(_E4096) - 100),
]
COVER = LAYOUTS + MANY_GROUPS
COVER_IDS = [c[0] for c in COVER]
# (k, n): Qwen3-30B-A3B's gate/up and down products, and ragged tiles
SHAPES = [(2048, 768), (768, 2048), (136, 72)]


def cdiv(a, b):
    return -(-a // b)


def clipped_ends(sizes, m):
    return np.minimum(np.cumsum(np.asarray(sizes, np.int64)), m)


def tgmm_items(sizes, m, k, n, chunk_rows, sms=H100_SMS):
    """tgmm's items for the grid its wrapper launches on ``sms`` SMs."""
    work = cdiv(k, gk.TILE_M) * cdiv(n, gk.TILE_N) * (len(sizes)
                                                      + m // chunk_rows)
    grid = min(work, sms)
    return gk.tgmm_work_items(sizes, m, k, n, chunk_rows, grid), grid


@pytest.mark.parametrize("k,n", SHAPES, ids=["gate_up", "down", "ragged"])
@pytest.mark.parametrize("name,sizes,m", COVER, ids=COVER_IDS)
def test_gmm_items_write_every_row_once(name, sizes, m, k, n):
    items = gk.gmm_work_items(sizes, m, k, n)
    E, n_m, n_n = len(sizes), cdiv(m, gk.TILE_M), cdiv(n, gk.TILE_N)
    assert len(items) == n_n * (n_m + E)
    ends = clipped_ends(sizes, m)
    total = int(ends[-1])
    # the group of each row (E past the groups)
    group_of = np.searchsorted(ends, np.arange(m), side="right")
    writes = np.zeros((m, n_n), np.int64)
    for it in items:
        if it.group == -1:                     # idle: no load, no store
            assert it.nk == 0 and it.r_lo == it.r_hi == it.z_hi
            continue
        m1 = min(it.m0 + gk.TILE_M, m)
        assert it.m0 <= it.r_lo <= it.r_hi <= it.z_hi <= m1
        assert it.nk == (cdiv(k, gk.STAGE_K) if it.group < E else 0)
        assert (group_of[it.r_lo:it.r_hi] == it.group).all()
        assert it.z_hi == it.r_hi or it.r_hi >= total   # zeros past groups
        writes[it.r_lo:it.z_hi, it.n0 // gk.TILE_N] += 1
    assert (writes == 1).all()


@pytest.mark.parametrize("name,sizes,m", MANY_GROUPS,
                         ids=[c[0] for c in MANY_GROUPS])
def test_many_groups_take_the_workspace_plan(name, sizes, m):
    """Past 1024 groups the wrappers hand the kernels an int32 plan
    workspace (``gmm`` the clipped ends, ``tgmm`` ends, chunk prefix,
    slots, split groups, their count and order: ``5 E + 2``); at or below,
    none (the plan stays in shared memory)."""
    E = len(sizes)
    assert E > gk.SHARED_PLAN_GROUPS
    assert gk.plan_workspace(gk.SHARED_PLAN_GROUPS, "gmm", "cpu") is None
    assert tuple(gk.plan_workspace(E, "gmm", "cpu").shape) == (E,)
    assert tuple(gk.plan_workspace(E, "tgmm", "cpu").shape) == (5 * E + 2,)
    # the items reach groups past the shared-memory plan's 1024
    items = gk.gmm_work_items(sizes, m, 136, 72)
    assert max(it.group for it in items if it.group < E) > 1024


def test_padded_segments_run_one_item_per_output_tile():
    """The sorted MoE path pads every segment to 128 rows: no extra item is
    active, so the products are exactly the output tiles, in row order."""
    sizes, m = LAYOUTS[0][1:]
    items = gk.gmm_work_items(sizes, m, 2048, 768)
    n_m, n_n = cdiv(m, gk.TILE_M), cdiv(768, gk.TILE_N)
    assert all(it.group == -1 for it in items[n_m * n_n:])
    assert [(it.m0, it.n0) for it in items[:n_m * n_n]] == [
        (tm * gk.TILE_M, tn * gk.TILE_N) for tm in range(n_m)
        for tn in range(n_n)]
    assert all(it.r_lo == it.m0 for it in items[:n_m * n_n])


@pytest.mark.parametrize("k,n", SHAPES, ids=["gate_up", "down", "ragged"])
@pytest.mark.parametrize("name,sizes,m", COVER, ids=COVER_IDS)
@pytest.mark.parametrize("chunk", ["plan", 64, 192])
def test_tgmm_items_cover_every_block_once(name, sizes, m, k, n, chunk):
    C = gk.tgmm_chunk_rows(m, k, n, H100_SMS) if chunk == "plan" else chunk
    items, _ = tgmm_items(sizes, m, k, n, C)
    E, n_k, n_n = len(sizes), cdiv(k, gk.TILE_M), cdiv(n, gk.TILE_N)
    assert len(items) == n_k * n_n * (E + m // C)
    ends = clipped_ends(sizes, m)
    blocks = {}
    for it in items:
        if it.group >= 0:
            blocks.setdefault((it.group, it.k0, it.n0), []).append(it)
    assert len(blocks) == E * n_k * n_n
    slots = gk.tgmm_workspace_slots(m, C)
    used = {}
    for (g, k0, n0), its in blocks.items():
        lo, hi = (int(ends[g - 1]) if g else 0), int(ends[g])
        its.sort(key=lambda it: it.chunk)
        assert [it.chunk for it in its] == list(range(len(its)))
        if hi == lo:
            assert len(its) == 1 and its[0].nk == 0 and its[0].slot == -1
            continue
        covered = lo
        for it in its:
            assert it.r0 == covered and 0 < it.rows <= C
            assert it.nk == cdiv(it.rows, gk.STAGE_K)
            covered += it.rows
        assert covered == hi
        if len(its) == 1:
            assert its[0].slot == -1           # written in bf16 directly
        else:
            for it in its:
                assert 0 <= it.slot < slots
                assert used.setdefault((it.slot, k0, n0), g) == g
    # a split group's chunks take distinct slots
    own = {}
    for its in blocks.values():
        for it in its:
            if it.slot >= 0:
                own.setdefault(it.group, set()).add(it.slot)
    for g in range(E):
        n_chunks = len(blocks[(g, 0, 0)])
        assert len(own.get(g, ())) in (0, n_chunks)


def skewed_sizes(E, routed, seed):
    """40 groups of 1-127 rows, 6 of ten shares of the rest, the others one
    share each (``chip_smoke.py``'s ``skewed_small``)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(E)
    sizes = np.zeros(E, np.int64)
    sizes[order[:40]] = rng.integers(1, 128, 40)
    share = np.ones(E)
    share[order[:40]] = 0
    share[order[40:46]] = 10
    sizes += rng.multinomial(routed - int(sizes.sum()), share / share.sum())
    return [int(x) for x in sizes]


BALANCE = LAYOUTS + [
    # Qwen3-30B-A3B's buffer: segments padded to 128 rows of a random
    # router's sizes, a skewed routing, one expert taking every row
    ("routed_padded_qwen3",
     [128 * cdiv(int(x), 128) for x in
      np.random.default_rng(9).multinomial(131072, np.random.default_rng(
          10).dirichlet(np.full(128, 2.0)))], 147456),
    ("skewed_qwen3", skewed_sizes(128, 131072, seed=17), 147456),
    ("hot_qwen3", [0] * 37 + [131072] + [0] * 90, 147456),
]


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("k,n", SHAPES, ids=["gate_up", "down", "ragged"])
@pytest.mark.parametrize("name,sizes,m", BALANCE,
                         ids=[c[0] for c in BALANCE])
def test_tgmm_snake_order_balances_the_ctas(name, sizes, m, k, n, sms):
    """Item ``i`` runs on CTA ``i % grid``: the longest-first snake order
    keeps every CTA's 64-row stages within one longest item of every
    other's, whatever the group sizes."""
    C = gk.tgmm_chunk_rows(m, k, n, sms)
    items, grid = tgmm_items(sizes, m, k, n, C, sms)
    stages = np.zeros(grid, np.int64)
    for i, it in enumerate(items):
        stages[i % grid] += it.nk
    assert stages.max() - stages.min() <= max(it.nk for it in items)


@pytest.mark.parametrize("k,n", SHAPES, ids=["gate_up", "down", "ragged"])
@pytest.mark.parametrize("m", [256, 1000, 147456])
def test_tgmm_chunk_rows_keeps_two_waves_for_one_hot_group(m, k, n):
    C = gk.tgmm_chunk_rows(m, k, n, H100_SMS)
    tiles = cdiv(k, gk.TILE_M) * cdiv(n, gk.TILE_N)
    assert C % gk.STAGE_K == 0 and C >= gk.STAGE_K
    assert tiles * cdiv(m, C) >= 2 * H100_SMS or C == gk.STAGE_K
    slots = gk.tgmm_workspace_slots(m, C)
    assert slots == (0 if m <= C else 2 * m // C)


def test_the_main_path_never_splits_a_group():
    """Qwen3-30B-A3B's routed buffer (147,456 rows): the largest group a
    random router gave on the card (7,168 rows) stays one chunk, so tgmm
    writes its bf16 blocks directly; one expert holding all 131,072 routed
    rows splits."""
    for k, n in SHAPES[:2]:
        C = gk.tgmm_chunk_rows(147456, k, n, H100_SMS)
        assert 7168 <= C < 131072


# ---------------------------------------------------------------------------
# the items' arithmetic against the plain versions and the JAX package
# ---------------------------------------------------------------------------
def operands(sizes, m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(len(sizes), k, n)).astype(np.float32),
            rng.normal(size=(m, n)).astype(np.float32),
            np.asarray(sizes, np.int32))


def emulate_gmm(lhs, rhs, sizes, trans_rhs=False):
    """gmm_fwd's items in fp32: each multiplies its whole 128-row tile by its
    group's weights and stores its rows' sums and its zero rows."""
    m, k = lhs.shape
    n = rhs.shape[1] if trans_rhs else rhs.shape[2]
    out = np.full((m, n), np.nan, np.float32)
    for it in gk.gmm_work_items(sizes, m, k, n):
        cols = slice(it.n0, it.n0 + gk.TILE_N)
        if it.nk:
            w = rhs[it.group].T if trans_rhs else rhs[it.group]
            tile = lhs[it.m0:it.m0 + gk.TILE_M] @ w[:, cols]
            out[it.r_lo:it.r_hi, cols] = tile[it.r_lo - it.m0:
                                              it.r_hi - it.m0]
        out[it.r_hi:it.z_hi, cols] = 0.0
    return out


def emulate_tgmm(lhs, dout, sizes, chunk_rows):
    """tgmm's items in fp32: chunk partials of split groups added in chunk
    order (the reduction launch), other blocks written directly."""
    m, k = lhs.shape
    n = dout.shape[1]
    out = np.full((len(sizes), k, n), np.nan, np.float32)
    parts = {}
    for it in tgmm_items(sizes, m, k, n, chunk_rows)[0]:
        if it.group < 0:
            continue
        ks, ns = slice(it.k0, it.k0 + gk.TILE_M), slice(it.n0,
                                                       it.n0 + gk.TILE_N)
        rows = slice(it.r0, it.r0 + it.rows)
        tile = lhs[rows, ks].T @ dout[rows, ns]
        if it.slot < 0:
            out[it.group, ks, ns] = tile
        else:
            parts.setdefault((it.group, it.k0, it.n0), []).append(
                (it.chunk, tile))
    for (g, k0, n0), ps in parts.items():
        total = ps[0][1].copy()
        for c, (chunk, p) in enumerate(ps):
            assert chunk == c
            if c:
                total += p
        out[g, k0:k0 + gk.TILE_M, n0:n0 + gk.TILE_N] = total
    return out


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jgk, "_INTERPRET", True)


@pytest.mark.parametrize("name,sizes,m", LAYOUTS, ids=LAYOUT_IDS)
def test_gmm_item_sums_match_the_plain_version_and_jax(interpret, name,
                                                      sizes, m):
    k, n = 24, 40
    lhs, rhs, dout, gs = operands(sizes, m, k, n, seed=11)
    out = emulate_gmm(lhs, rhs, sizes)
    dlhs = emulate_gmm(dout, rhs, sizes, trans_rhs=True)
    assert not np.isnan(out).any() and not np.isnan(dlhs).any()
    t = [torch.from_numpy(a) for a in (lhs, rhs, dout, gs)]
    np.testing.assert_allclose(out, gk.gmm_plain(t[0], t[1], t[3]).numpy(),
                               **TOL)
    np.testing.assert_allclose(
        dlhs, gk.gmm_plain(t[2], t[1], t[3], trans_rhs=True).numpy(), **TOL)
    ref = np.asarray(jax.jit(jgk.gmm)(jnp.asarray(lhs), jnp.asarray(rhs),
                                      jnp.asarray(gs)))
    np.testing.assert_allclose(out, ref, **TOL)
    assert not out[int(sum(sizes)):].any()


@pytest.mark.parametrize("chunk", ["plan", 64, 192])
@pytest.mark.parametrize("name,sizes,m", LAYOUTS, ids=LAYOUT_IDS)
def test_tgmm_chunked_sums_match_the_plain_version_and_jax(interpret, name,
                                                          sizes, m, chunk):
    k, n = 24, 40
    lhs, _, dout, gs = operands(sizes, m, k, n, seed=12)
    C = gk.tgmm_chunk_rows(m, k, n, H100_SMS) if chunk == "plan" else chunk
    out = emulate_tgmm(lhs, dout, sizes, C)
    assert not np.isnan(out).any()
    plain = gk.tgmm_plain(torch.from_numpy(lhs), torch.from_numpy(dout),
                          torch.from_numpy(gs)).numpy()
    np.testing.assert_allclose(out, plain, **TOL)
    ref = np.asarray(jgk.tgmm(jnp.asarray(lhs), jnp.asarray(dout),
                              jnp.asarray(gs)))
    np.testing.assert_allclose(out, ref, **TOL)
    for g, size in enumerate(sizes):
        if size == 0:
            assert not out[g].any()               # exactly 0
