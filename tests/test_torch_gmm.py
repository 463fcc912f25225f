"""The port's grouped matmuls (``automodel_tpu_torch/ops/gmm_kernel.py``:
``gmm``, ``tgmm`` and their autograd Function) against the JAX package's,
on the CPU, where the port takes its plain versions and the JAX package
runs its Pallas kernels in interpret mode (``_INTERPRET`` monkeypatched, as
``tests/unit_tests/test_moe_dispatch.py`` does).

Inputs are fp32 numpy arrays from a seed; the group-size cases are the JAX
tests' (straddles and an empty group, one group holding every row,
leading empty groups with dropped tail rows, equal groups) plus a trailing
empty group when the groups fill the buffer exactly.  Tolerance: fp32 on
both sides, the same products summed in another order: 1e-5 absolute and
relative for the outputs, 1e-4 for the gradients (sums over up to 64
rows); rows past the groups and an empty group's ``tgmm`` block must be
exactly 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import automodel_tpu.ops.gmm_kernel as jgk
from automodel_tpu_torch.ops import gmm_kernel as gk

torch.set_num_threads(1)

CASES = [
    # (name, group sizes, m)
    ("straddles_and_empty", [13, 0, 27, 1, 23], 64),
    ("one_group_takes_all", [64, 0, 0, 0, 0], 64),
    ("leading_empty_dropped_tail", [0, 0, 0, 0, 40], 64),
    ("equal_groups", [8, 8, 8, 8, 8], 64),
    ("trailing_empty_full_buffer", [256, 0], 256),
]
IDS = [c[0] for c in CASES]


def operands(sizes, m, k=16, n=24, seed=0):
    rng = np.random.default_rng(seed)
    E = len(sizes)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(E, k, n)).astype(np.float32),
            rng.normal(size=(m, n)).astype(np.float32),
            np.asarray(sizes, np.int32))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jgk, "_INTERPRET", True)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("sizes,m", [c[1:] for c in CASES], ids=IDS)
def test_gmm_matches_the_jax_kernel(interpret, sizes, m):
    lhs, rhs, _, gs = operands(sizes, m)
    ref = np.asarray(jax.jit(jgk.gmm)(jnp.asarray(lhs), jnp.asarray(rhs),
                                      jnp.asarray(gs)))
    out = gk.gmm(*_t(lhs, rhs, gs)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    assert not out[int(gs.sum()):].any()          # rows past the groups


@pytest.mark.parametrize("sizes,m", [c[1:] for c in CASES], ids=IDS)
def test_tgmm_matches_the_jax_kernel(interpret, sizes, m):
    lhs, _, dout, gs = operands(sizes, m, seed=1)
    ref = np.asarray(jgk.tgmm(jnp.asarray(lhs), jnp.asarray(dout),
                              jnp.asarray(gs)))
    out = gk.tgmm(*_t(lhs, dout, gs)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    for g, size in enumerate(sizes):
        if size == 0:
            assert not out[g].any()               # exactly 0


@pytest.mark.parametrize("sizes,m", [c[1:] for c in CASES], ids=IDS)
def test_gmm_gradients_match_jax_grad_through_the_kernel(interpret, sizes, m):
    """Both gradients of ``sum(gmm(lhs, rhs) * c)`` for a random cotangent
    ``c``: ``dlhs = gmm(c, rhs^T)`` and ``drhs = tgmm(lhs, c)`` against
    ``jax.grad`` through the Pallas kernel's custom VJP."""
    lhs, rhs, cot, gs = operands(sizes, m, seed=2)

    def loss(lhs, rhs):
        return jnp.sum(jgk.gmm(lhs, rhs, jnp.asarray(gs)) * cot)

    jl, jr = jax.grad(loss, argnums=(0, 1))(jnp.asarray(lhs),
                                            jnp.asarray(rhs))
    tl, tr = (t.requires_grad_() for t in _t(lhs, rhs))
    (gk.gmm(tl, tr, torch.from_numpy(gs)) * torch.from_numpy(cot)).sum() \
        .backward()
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jr), atol=1e-4,
                               rtol=1e-4)
    assert not tl.grad[int(gs.sum()):].any()      # zero grad past the groups
    for g, size in enumerate(sizes):
        if size == 0:
            assert not tr.grad[g].any()


def test_block_aligned_promise_is_accepted():
    """``block_aligned`` / ``block_rows`` are the JAX signature's; the
    answer is the same with or without the promise."""
    lhs, rhs, _, gs = operands([16, 0, 8, 24], 64)
    a = gk.gmm(*_t(lhs, rhs, gs))
    b = gk.gmm(*_t(lhs, rhs, gs), block_aligned=True, block_rows=8)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    with pytest.raises(ValueError, match="block_rows"):
        gk.gmm(*_t(lhs, rhs, gs), block_rows=0)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    lhs, rhs, dout, gs = operands([13, 0, 27, 1, 23], 64)
    before = (gk.gmm_launches, gk.tgmm_launches)
    torch.testing.assert_close(
        gk.gmm(*_t(lhs, rhs, gs)),
        gk.gmm(*_t(lhs, rhs, gs), impl="plain"), atol=0, rtol=0)
    gk.tgmm(*_t(lhs, dout, gs))
    assert (gk.gmm_launches, gk.tgmm_launches) == before
    with pytest.raises(ValueError, match="impl"):
        gk.gmm(*_t(lhs, rhs, gs), impl="xla")


def test_the_kernel_route_raises_on_cpu_tensors():
    """No fallback: asking for the kernel with CPU tensors raises instead of
    quietly taking the plain version."""
    lhs, rhs, dout, gs = operands([13, 0, 27, 1, 23], 64)
    with pytest.raises(ValueError, match="CUDA"):
        gk.gmm(*_t(lhs, rhs, gs), impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        gk.tgmm(*_t(lhs, dout, gs), impl="kernel")
