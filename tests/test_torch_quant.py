"""The port's quantized compute (``automodel_tpu_torch/ops/quant.py`` and
``ops/qdot_kernel.py``) against the JAX package's ``automodel_tpu/ops/
quant.py`` and ``ops/qdot_kernel.py`` on the CPU, inputs from a seed with
numpy.

* ``quant_cast`` gives the same codes as JAX, byte for byte, for int8,
  e4m3 and e5m2: normal values at several scales, exact ties (x.5 for int8,
  midpoints between neighbouring fp8 values), their neighbours one ulp
  away, values past +-qmax, fp8's subnormal range and zero rows.
* ``_operand_scales`` equal JAX's exactly.
* ``quantized_matmul`` (the plain version on CPU tensors) against both JAX
  rungs, ``qdot.xla`` and ``qdot.pallas`` in interpret mode, for every
  operand pair ``_gemm_dtypes`` makes, both recipes and a ragged m: int8
  exactly (int32 sums are exact on both sides and the rescale is the same
  fp32 product); fp8 within 1e-5 relative to the output's largest
  magnitude (JAX sums the same products in fp32, the port in float64).
* ``qdot`` forward and both gradients against ``jax.grad`` of JAX's
  ``qdot``, int8 exactly, fp8 within 1e-5 of the largest magnitude.
* ``maybe_qdot``'s filter and 16-alignment rules give ``x @ w`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.ops import qdot_kernel as jqk
from automodel_tpu.ops import quant as jq
from automodel_tpu.ops.kernel_lib.parity import interpret_mode
from automodel_tpu_torch.ops import qdot_kernel as qk
from automodel_tpu_torch.ops import quant as tq

torch.set_num_threads(1)

QTYPES = {"int8": (torch.int8, jnp.int8),
          "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
          "e5m2": (torch.float8_e5m2, jnp.float8_e5m2)}
PAIRS = [("e4m3_e4m3", "e4m3", "e4m3"), ("e5m2_e4m3", "e5m2", "e4m3"),
         ("e4m3_e5m2", "e4m3", "e5m2"), ("int8_int8", "int8", "int8")]
FP8_REL = 1e-5


def _jt(a):
    return jnp.asarray(a)


def _codes(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy() if t.dtype != torch.int8 else \
        t.numpy().view(np.uint8)


def cast_inputs(name: str, seed=0):
    """``(x [rows, 64], scale [rows, 1])``: rows of normals at several
    scales with their rowwise scales, rows of exact ties and their
    neighbours at scale 1, rows past +-qmax, fp8's subnormal range and a
    zero row."""
    tdt, _ = QTYPES[name]
    qmax = tq.qmax_for(tdt)
    rng = np.random.default_rng(seed)
    rows, scales = [], []
    for s in (1e-3, 1.0, 37.0):
        x = (rng.normal(size=(6, 64)) * s).astype(np.float32)
        rows.append(x)
        scales += list(np.maximum(np.abs(x).max(1), 1e-12) / np.float32(qmax))
    if name == "int8":
        ties = np.arange(-130, 130, dtype=np.float32) + np.float32(0.5)
    else:
        vals = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
            tdt).float().numpy()
        vals = np.unique(vals[np.isfinite(vals)])
        ties = ((vals[1:].astype(np.float64) + vals[:-1]) / 2).astype(
            np.float32)
    ties = np.concatenate([ties, np.nextafter(ties, np.float32(np.inf)),
                           np.nextafter(ties, np.float32(-np.inf))])
    ties = np.concatenate([ties, np.full(-ties.size % 64, 0.5, np.float32)])
    past = np.float32(qmax) * np.array([1.0, 1.01, 1.5, 4.0, 1e3],
                                       np.float32)
    tiny = np.float32(2.0) ** np.arange(-20, -4, 0.25).astype(np.float32)
    special = np.concatenate([
        ties, np.resize(np.concatenate([past, -past]), 64),
        np.resize(np.concatenate([tiny, -tiny]), 64), np.zeros(64)])
    special = special.astype(np.float32).reshape(-1, 64)
    rows.append(special)
    scales += [1.0] * special.shape[0]
    return (np.concatenate(rows).astype(np.float32),
            np.asarray(scales, np.float32)[:, None])


@pytest.mark.parametrize("name", sorted(QTYPES))
def test_quant_cast_codes_equal_jax(name):
    tdt, jdt = QTYPES[name]
    x, scale = cast_inputs(name)
    got = tq.quant_cast(torch.from_numpy(x), torch.from_numpy(scale), tdt)
    ref = np.asarray(jq.quant_cast(_jt(x), _jt(scale), jdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(_codes(got), ref.view(np.uint8))
    # bf16 operands divide in fp32 as JAX's astype(f32) / scale does
    xb = torch.from_numpy(x).bfloat16()
    ref_b = np.asarray(jq.quant_cast(_jt(xb.float().numpy()).astype(
        jnp.bfloat16), _jt(scale), jdt))
    np.testing.assert_array_equal(
        _codes(tq.quant_cast(xb, torch.from_numpy(scale), tdt)),
        ref_b.view(np.uint8))


def operands(m=200, k=128, n=256, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            (rng.normal(size=(k, n)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("rowwise", [False, True],
                         ids=["tensorwise", "rowwise"])
@pytest.mark.parametrize("pair", PAIRS, ids=[p[0] for p in PAIRS])
def test_operand_scales_equal_jax(pair, rowwise):
    _, an, bn = pair
    a, b = operands(m=37, k=64, n=48)
    sa, sb = tq._operand_scales(torch.from_numpy(a), torch.from_numpy(b),
                                QTYPES[an][0], QTYPES[bn][0], rowwise)
    jsa, jsb = jq._operand_scales(_jt(a), _jt(b), QTYPES[an][1],
                                  QTYPES[bn][1], rowwise)
    np.testing.assert_array_equal(sa.numpy(), np.asarray(jsa))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(jsb))


def _assert_matches(got, ref, int8):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    if int8:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=FP8_REL * np.abs(ref).max())


@pytest.mark.parametrize("rung", ["xla", "pallas"])
@pytest.mark.parametrize("rowwise", [False, True],
                         ids=["tensorwise", "rowwise"])
@pytest.mark.parametrize("pair", PAIRS, ids=[p[0] for p in PAIRS])
def test_quantized_matmul_matches_both_jax_rungs(pair, rowwise, rung):
    """m = 200 is ragged against the Pallas rung's 128-row tiles (it pads
    rows with scale 1; the port's kernel masks them)."""
    _, an, bn = pair
    a, b = operands()
    got = tq.quantized_matmul(torch.from_numpy(a), torch.from_numpy(b),
                              a_qdtype=QTYPES[an][0], b_qdtype=QTYPES[bn][0],
                              rowwise=rowwise)
    ja, jb = _jt(a), _jt(b)
    sa, sb = jq._operand_scales(ja, jb, QTYPES[an][1], QTYPES[bn][1],
                                rowwise)
    if rung == "xla":
        request = {"a_dtype": str(jnp.dtype(QTYPES[an][1])),
                   "b_dtype": str(jnp.dtype(QTYPES[bn][1]))}
        ref = jq._qdot_xla_impl(request, ja, jb, sa, sb)
    else:
        with interpret_mode():
            ref = jqk.qdot_pallas(ja, jb, sa, sb, QTYPES[an][1],
                                  QTYPES[bn][1])
    assert got.dtype == torch.float32
    _assert_matches(got.numpy(), ref, an == "int8")


@pytest.mark.parametrize("recipe", ["tensorwise", "rowwise"])
@pytest.mark.parametrize("dtype", ["float8", "int8"])
def test_qdot_forward_and_grads_match_jax_grad(dtype, recipe):
    """``x [2, 37, 64] @ w [64, 48]`` with a random cotangent: the output,
    ``dx = g @ w^T`` and ``dw = x^T @ g`` (the port reads ``w`` as the
    ``[K, N]`` view of an ``[N, K]`` weight, as the models pass it, and
    writes ``dw`` into that storage)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 37, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 48)) * 0.1).astype(np.float32)
    c = rng.normal(size=(2, 37, 48)).astype(np.float32)

    def loss(a, b):
        return jnp.sum(jq.qdot(a, b, recipe, dtype) * c)

    ref = jq.qdot(_jt(x), _jt(w), recipe, dtype)
    jdx, jdw = jax.grad(loss, argnums=(0, 1))(_jt(x), _jt(w))
    tx = torch.from_numpy(x).requires_grad_()
    W = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    out = tq.qdot(tx, W.t(), recipe, dtype)
    (out * torch.from_numpy(c)).sum().backward()
    int8 = dtype == "int8"
    _assert_matches(out.detach().numpy(), ref, int8)
    _assert_matches(tx.grad.numpy(), jdx, int8)
    _assert_matches(W.grad.numpy().T, jdw, int8)
    assert W.grad.is_contiguous()


def test_maybe_qdot_filter_and_alignment_match_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 32)).astype(np.float32)
    w = rng.normal(size=(32, 48)).astype(np.float32)
    w_odd = rng.normal(size=(32, 40)).astype(np.float32)   # N % 16 != 0
    tcfg = tq.QuantConfig(enabled=True, dtype="int8",
                          filter_fqns=["lm_head"])
    jcfg = jq.QuantConfig(enabled=True, dtype="int8", filter_fqns=["lm_head"])
    tx = torch.from_numpy(x)
    for wt, name, quantized in ((w, "lm_head", False),
                                (w_odd, "mlp.up_proj", False),
                                (w, "mlp.up_proj", True)):
        got = tq.maybe_qdot(tx, torch.from_numpy(wt), tcfg, name).numpy()
        ref = np.asarray(jq.maybe_qdot(_jt(x), _jt(wt), jcfg, name))
        np.testing.assert_array_equal(got, ref)
        plain = (tx @ torch.from_numpy(wt)).numpy()
        assert np.array_equal(got, plain) != quantized, name
    assert tq.maybe_qdot(tx, torch.from_numpy(w), None).shape == (4, 48)


def test_quant_config_and_the_filter_rule_match_jax():
    assert tq.QUANT_DTYPES == jq.QUANT_DTYPES
    assert tq.QUANT_RECIPES == jq.QUANT_RECIPES
    assert (tq.E4M3_MAX, tq.E5M2_MAX, tq.INT8_MAX) == (
        jq.E4M3_MAX, jq.E5M2_MAX, jq.INT8_MAX)
    cfg = tq.QuantConfig(enabled=True, recipe_name="none", dtype="null",
                         filter_fqns=["lm_head", "experts"])
    assert (cfg.recipe_name, cfg.dtype) == ("tensorwise", "float8")
    for bad in (dict(dtype="fp4"), dict(recipe_name="blockwise")):
        with pytest.raises(ValueError, match="fp8"):
            tq.QuantConfig(enabled=True, **bad)
    jcfg = jq.QuantConfig(enabled=True, filter_fqns=["lm_head", "experts"])
    for name in ("self_attn.q_proj", "block_sparse_moe.experts", "lm_head"):
        assert (tq.quant_for(cfg, name) is None) == \
            (jq.quant_for(jcfg, name) is None), name
    assert tq.quant_for(tq.QuantConfig(enabled=False), "x") is None
    for dtype in ("float8", "int8"):
        for side in (None, "a", "b"):
            got = tq._gemm_dtypes(dtype, side)
            ref = jq._gemm_dtypes(dtype, side)
            assert [str(t).removeprefix("torch.") for t in got] == \
                [jnp.dtype(t).name for t in ref]
    assert tq.accum_dtype(torch.int8, torch.int8) == torch.int32
    assert tq.accum_dtype(torch.float8_e5m2, torch.float8_e4m3fn) == \
        torch.float32


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    a, b = (torch.from_numpy(t) for t in operands(m=16, k=32, n=16))
    e4 = torch.float8_e4m3fn
    sa, sb = tq._operand_scales(a, b, e4, e4, False)
    before = qk.qdot_launches
    torch.testing.assert_close(qk.qdot(a, b, sa, sb, e4, e4),
                               qk.qdot_plain(a, b, sa, sb, e4, e4),
                               atol=0, rtol=0)
    assert qk.qdot_launches == before
    with pytest.raises(ValueError, match="CUDA"):
        qk.qdot(a, b, sa, sb, e4, e4, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        qk.qdot(a, b, sa, sb, e4, e4, impl="xla")
