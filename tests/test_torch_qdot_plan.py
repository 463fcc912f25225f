"""The split-K plan of the port's quantized matmul (``automodel_tpu_torch/
ops/qdot_kernel.py::split_plan``) and a plain emulation of the split
product's arithmetic, on the CPU.

``csrc/qdot.cu`` splits K when its output tiles would not fill the card:
each split sums its own range of K tiles into a partial (s32 for int8,
fp32 for fp8), and a fixed-order reduction adds the partials, then
rescales.  The kernel runs only on the card; here the plan is checked
(every split non-empty and a whole number of K tiles, the splits cover K
exactly, tiles x splits cover the SMs as far as K has tiles) and the
emulation of its sums is held against the unsplit plain version and
against the JAX package's ``qdot`` (the Pallas kernel in interpret mode):
int8 bit for bit, fp8 within ``QDOT_FP8_REL_L2``, the limit the card's
kernel cases use.  Inputs are made from a seed with numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.ops import qdot_kernel as jqk
from automodel_tpu.ops import quant as jq
from automodel_tpu.ops.kernel_lib.parity import interpret_mode
from automodel_tpu_torch.ops import qdot_kernel as qk
from automodel_tpu_torch.ops.quant import _operand_scales, quant_cast

torch.set_num_threads(1)

H100_SMS = 132
QDOT_FP8_REL_L2 = 1e-3
E4, E5, I8 = torch.float8_e4m3fn, torch.float8_e5m2, torch.int8

PLAN_CASES = [
    # (name, m, n, k): the output [m, n] and the contraction k
    ("kv_wgrad", 2048, 512, 16384),      # Llama-3.2-1B k/v weight gradient
    ("q_wgrad", 2048, 2048, 16384),
    ("moe_o_wgrad", 4096, 2048, 16384),
    ("q_forward", 16384, 2048, 2048),    # fills the card: no split
    ("one_tile", 100, 8, 4096),
    ("short_k", 256, 128, 200),          # fewer K tiles than wanted
    ("k_pads_past_16", 256, 128, 2056),
    ("one_k_tile", 64, 64, 96),
]


@pytest.mark.parametrize("a_dtype", [E4, I8], ids=["fp8", "int8"])
@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_split_plan_covers_the_sms_with_whole_k_tiles(case, a_dtype):
    _, m, n, k = case
    splits, kt_split = qk.split_plan(m, n, k, a_dtype, H100_SMS)
    kp = -(-k // 16) * 16
    kt = -(-kp // qk.TILE_K)
    tiles = -(-m // qk.TILE_M) * -(-n // qk.tile_n(a_dtype))
    assert splits >= 1 and kt_split >= 1
    # the ranges, in codes: whole K tiles, the last clipped to kp
    ranges = [(s * kt_split * qk.TILE_K,
               min((s + 1) * kt_split * qk.TILE_K, kp))
              for s in range(splits)]
    assert all(lo < hi for lo, hi in ranges), "an empty split"
    assert all(lo % qk.TILE_K == 0 for lo, _ in ranges)
    assert all((hi - lo) % qk.TILE_K == 0 for lo, hi in ranges[:-1])
    assert sum(hi - lo for lo, hi in ranges) == kp
    if tiles >= H100_SMS:
        assert splits == 1
    else:
        assert tiles * splits >= H100_SMS or splits == kt


def test_split_plan_of_the_kv_wgrad():
    """The main path's narrow weight gradient: [2048, 512] over 16,384
    tokens is 64 fp8 tiles (32 int8 tiles) on 132 SMs."""
    assert qk.split_plan(2048, 512, 16384, E4, H100_SMS) == (3, 43)
    assert qk.split_plan(2048, 512, 16384, I8, H100_SMS) == (5, 26)
    assert qk.split_plan(16384, 512, 2048, E4, H100_SMS) == (1, 16)


def split_product(a, b, sa, sb, a_q, b_q, splits, kt_split):
    """The split kernel's arithmetic written out: codes of both operands,
    each split's raw sums over its K range in the kernel's accumulator
    type (s32, or fp32 from exact fp8 products), the partials added in
    split order, then ``(raw * sa) * sb`` in fp32."""
    aq = quant_cast(a, sa, a_q)
    bq = quant_cast(b, sb, b_q)
    step = kt_split * qk.TILE_K
    total = None
    for s in range(splits):
        sl = slice(s * step, (s + 1) * step)
        if a_q == I8:
            part = (aq[:, sl].long() @ bq[sl].long()).int()
        else:
            part = (aq[:, sl].double() @ bq[sl].double()).float()
        total = part if total is None else total + part
    return total.float() * sa.float() * sb.float()


def operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(m, k))).astype(np.float32)
    b = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(b)


EMU_PAIRS = [("e4m3_e4m3", E4, E4, jnp.float8_e4m3fn, jnp.float8_e4m3fn),
             ("e5m2_e4m3", E5, E4, jnp.float8_e5m2, jnp.float8_e4m3fn),
             ("e4m3_e5m2", E4, E5, jnp.float8_e4m3fn, jnp.float8_e5m2),
             ("int8_int8", I8, I8, jnp.int8, jnp.int8)]


@pytest.mark.parametrize("rowwise", [False, True],
                         ids=["tensorwise", "rowwise"])
@pytest.mark.parametrize("pair", EMU_PAIRS, ids=[p[0] for p in EMU_PAIRS])
def test_split_k_sums_match_the_unsplit_plain_version_and_jax(pair, rowwise):
    """A narrow output over a long K (a weight gradient's shape) is split
    by the plan; the split sums equal the unsplit ones (int8 bit for bit,
    fp8 within QDOT_FP8_REL_L2) and JAX's Pallas qdot."""
    _, a_q, b_q, ja_q, jb_q = pair
    m, k, n = 136, 1000, 24
    a, b = operands(m, k, n, seed=11)
    splits, kt_split = qk.split_plan(m, n, k, a_q, H100_SMS)
    assert splits > 1
    sa, sb = _operand_scales(a, b, a_q, b_q, rowwise)
    got = split_product(a, b, sa, sb, a_q, b_q, splits, kt_split)
    ref = qk.qdot_plain(a, b, sa, sb, a_q, b_q)
    ja, jb = jnp.asarray(a.numpy()), jnp.asarray(b.numpy())
    jsa, jsb = jq._operand_scales(ja, jb, ja_q, jb_q, rowwise)
    np.testing.assert_array_equal(sa.numpy(), np.asarray(jsa))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(jsb))
    with interpret_mode():
        jref = np.array(jqk.qdot_pallas(ja, jb, jsa, jsb, ja_q, jb_q))
    if a_q == I8:
        assert torch.equal(got, ref)
        np.testing.assert_array_equal(got.numpy(), jref)
    else:
        for r in (ref, torch.from_numpy(jref)):
            rel = float((got - r).norm() / r.norm())
            assert rel <= QDOT_FP8_REL_L2, rel
