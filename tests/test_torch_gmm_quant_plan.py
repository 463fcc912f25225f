"""The work items of the port's quantized grouped matmul on the CPU: the
grouped forward plan of ``csrc/gmm_items.cuh``
(``automodel_tpu_torch/ops/gmm_kernel.py::gmm_work_items``) at the 8-bit
product's shapes -- K stages of 128 codes, 256-column tiles for int8 and
128-column tiles for the fp8 pairs -- and a plain emulation of
``csrc/gmm_quant.cu``'s arithmetic over those items.

* Over ``tests/test_torch_gmm_plan.py``'s group layouts: every output row,
  in every column tile, is written by exactly one item; an item writes
  sums only for its own group's rows and zeros only past the groups;
  ``n_n (n_m + E)`` items, each with ``ceil(k / 128)`` K stages.
* The emulation quantizes both operands (``quant_cast``, the pack pass's
  codes), sums each item's whole 128-row tile against its group's codes
  (int8: exact integer sums; fp8: fp32 sums added stage by stage, as the
  kernel promotes every 128 of K), keeps its group's rows and rescales them
  as the epilogue does, ``(raw * s_lhs[row]) * s_rhs[g, col]`` in fp32.
  Against the JAX package's ``gmm_quant`` (its Pallas ``gmm`` in interpret
  mode, ``_INTERPRET`` monkeypatched as ``tests/test_torch_gmm_quant.py``
  does): int8 exactly equal; fp8 within 1e-5 of the largest magnitude, the
  tolerance of ``tests/test_torch_gmm_quant.py`` (JAX sums the same
  products in fp32 in another order).  Rows past the groups are exactly 0.

Inputs are made from a seed with numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import automodel_tpu.ops.gmm_kernel as jgk
from automodel_tpu.ops import gmm_quant_kernel as jgq
from automodel_tpu_torch.ops import gmm_kernel as gk
from automodel_tpu_torch.ops import gmm_quant_kernel as gq
from automodel_tpu_torch.ops.qdot_kernel import tile_n
from automodel_tpu_torch.ops.quant import _gemm_dtypes, quant_cast
from tests.test_torch_gmm_plan import LAYOUT_IDS, LAYOUTS, cdiv, clipped_ends

torch.set_num_threads(1)

# (k, n): Qwen3-30B-A3B's gate/up and down products, and ragged tiles
# (multiples of 16, the pack's granule, but of neither 128 nor 256)
SHAPES = [(2048, 768), (768, 2048), (144, 272)]
SHAPE_IDS = ["gate_up", "down", "ragged"]
# the 8-bit products' tile widths: int8 256 columns, fp8 128 (the fp32
# promotion's registers)
WIDTHS = {"int8": tile_n(torch.int8), "float8": tile_n(torch.float8_e4m3fn)}


@pytest.mark.parametrize("dtype", list(WIDTHS))
@pytest.mark.parametrize("k,n", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("name,sizes,m", LAYOUTS, ids=LAYOUT_IDS)
def test_items_write_every_row_once_at_the_8bit_tiles(name, sizes, m, k, n,
                                                       dtype):
    bn = WIDTHS[dtype]
    items = gk.gmm_work_items(sizes, m, k, n, tile_n=bn,
                              stage_k=gq.STAGE_K8)
    E, n_m, n_n = len(sizes), cdiv(m, gk.TILE_M), cdiv(n, bn)
    assert len(items) == n_n * (n_m + E)
    ends = clipped_ends(sizes, m)
    total = int(ends[-1])
    group_of = np.searchsorted(ends, np.arange(m), side="right")
    writes = np.zeros((m, n_n), np.int64)
    for it in items:
        assert it.n0 % bn == 0 and it.n0 < n
        if it.group == -1:                     # idle: no load, no store
            assert it.nk == 0 and it.r_lo == it.r_hi == it.z_hi
            continue
        m1 = min(it.m0 + gk.TILE_M, m)
        assert it.m0 <= it.r_lo <= it.r_hi <= it.z_hi <= m1
        assert it.nk == (cdiv(k, gq.STAGE_K8) if it.group < E else 0)
        assert (group_of[it.r_lo:it.r_hi] == it.group).all()
        assert it.z_hi == it.r_hi or it.r_hi >= total   # zeros past groups
        writes[it.r_lo:it.z_hi, it.n0 // bn] += 1
    assert (writes == 1).all()


def emulate(lhs, rhs, sizes, dtype, recipe):
    """csrc/gmm_quant.cu's output over its items, fp32 out: per item, the
    whole 128-row tile of lhs codes times its group's codes, its rows
    rescaled, its zero rows 0."""
    a_q, b_q = _gemm_dtypes(dtype, None)
    gs = torch.from_numpy(np.asarray(sizes, np.int32))
    tl, tr = torch.from_numpy(lhs), torch.from_numpy(rhs)
    s_lhs = gq.lhs_scales(tl, gs, a_q, recipe).numpy()[:, 0]     # [m]
    s_rhs = gq.rhs_scales(tr, b_q, recipe).numpy()[:, 0, :]      # [E, n|1]
    lq = quant_cast(tl, torch.from_numpy(s_lhs)[:, None], a_q).float()
    rq = quant_cast(tr, torch.from_numpy(s_rhs)[:, None, :], b_q).float()
    lq, rq = lq.numpy(), rq.numpy()
    m, k = lhs.shape
    n = rhs.shape[2]
    bn = WIDTHS[dtype]
    out = np.full((m, n), np.nan, np.float32)
    for it in gk.gmm_work_items(sizes, m, k, n, tile_n=bn,
                                stage_k=gq.STAGE_K8):
        cols = slice(it.n0, min(it.n0 + bn, n))
        rows = slice(it.m0, min(it.m0 + gk.TILE_M, m))
        if it.nk:
            a, b = lq[rows], rq[it.group][:, cols]
            if dtype == "int8":     # s32 sums, exact
                raw = (a.astype(np.int64) @ b.astype(np.int64)).astype(
                    np.float32)
            else:                   # fp32 sums, added stage by stage
                raw = np.zeros((a.shape[0], b.shape[1]), np.float32)
                for k0 in range(0, k, gq.STAGE_K8):
                    ks = slice(k0, k0 + gq.STAGE_K8)
                    raw += (a[:, ks].astype(np.float64)
                            @ b[ks].astype(np.float64)).astype(np.float32)
            sg = s_rhs[it.group][cols] if s_rhs.shape[1] > 1 else \
                s_rhs[it.group][0]
            tile = (raw * s_lhs[rows, None]) * sg
            out[it.r_lo:it.r_hi, cols] = tile[it.r_lo - it.m0:
                                              it.r_hi - it.m0]
        out[it.r_hi:it.z_hi, cols] = 0.0
    return out


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jgk, "_INTERPRET", True)


COMBOS = [("int8", "tensorwise"), ("int8", "rowwise"),
          ("float8", "tensorwise"), ("float8", "rowwise")]


@pytest.mark.parametrize("dtype,recipe", COMBOS,
                         ids=[f"{d}_{r}" for d, r in COMBOS])
@pytest.mark.parametrize("name,sizes,m", LAYOUTS, ids=LAYOUT_IDS)
def test_emulated_items_match_jax_gmm_quant(interpret, name, sizes, m,
                                            dtype, recipe):
    k, n = SHAPES[-1]
    rng = np.random.default_rng(21)
    lhs = rng.normal(size=(m, k)).astype(np.float32)
    lhs[int(sum(sizes)):] = 0          # the sorted buffer's tail rows
    rhs = (rng.normal(size=(len(sizes), k, n)) * 0.1).astype(np.float32)
    out = emulate(lhs, rhs, sizes, dtype, recipe)
    assert not np.isnan(out).any()
    ref = np.asarray(jgq.gmm_quant(jnp.asarray(lhs), jnp.asarray(rhs),
                                   jnp.asarray(np.asarray(sizes, np.int32)),
                                   dtype, recipe))
    if dtype == "int8":
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    assert not out[int(sum(sizes)):].any()
