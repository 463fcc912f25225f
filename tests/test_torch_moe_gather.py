"""The sorted expert path's token gather (``ops/moe.py::_SortedGather``)
and its backward.  The backward gathers each token's k gradient rows and
adds them left to right, where ``index_select``'s own backward was an
``index_add`` (atomics on the card, in another order run to run).  On the
CPU, fp32, at ``test_torch_moe.py``'s sizes, dropless and with capacity
drops, k 1, 2 and 4: the forward and every gradient of
``sorted_expert_ffn`` against the ``index_select`` gather's, within fp32
rounding (1e-6 relative, 1e-7 absolute: the same k rows added in the same
order, so equal in practice), and two runs bit for bit.  JAX's own
gradient of the same function is held by ``test_torch_moe.py``.
"""

import numpy as np
import pytest
import torch

from automodel_tpu_torch.ops import moe
from tests.test_torch_moe import G, M, H, routed, weights

torch.set_num_threads(1)


def index_select_gather(x_flat, tok, in_seg, rows, sink):
    """The gather as it was: autograd's ``index_select`` (an ``index_add``
    backward)."""
    return torch.where(in_seg[:, None], x_flat.index_select(0, tok),
                       x_flat.new_zeros(()))


def run(k, capacity, gather=None, seed=0):
    xg, w8, idx = routed(seed + k, k)
    _, wg, wu, wd = weights(10 + k)
    cot = np.random.default_rng(3).normal(size=(G, M, H)).astype(np.float32)
    ts = [torch.from_numpy(np.array(a)).requires_grad_()
          for a in (xg, w8, wg, wu, wd)]
    mp = pytest.MonkeyPatch()
    if gather is not None:
        mp.setattr(moe._SortedGather, "apply", staticmethod(gather))
    try:
        out = moe.sorted_expert_ffn(
            ts[0], ts[1], torch.from_numpy(np.array(idx)), *ts[2:],
            capacity=capacity, compute_dtype=torch.float32)
        (out * torch.from_numpy(cot)).sum().backward()
    finally:
        mp.undo()
    return out.detach(), [t.grad for t in ts]


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("capacity", [None, 10], ids=["dropless", "drops"])
def test_ordered_backward_matches_index_add(k, capacity):
    out, grads = run(k, capacity)
    ref_out, ref_grads = run(k, capacity, gather=index_select_gather)
    assert torch.equal(out, ref_out)
    for name, g, r in zip(("x", "weights", "w_gate", "w_up", "w_down"),
                          grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    assert float(grads[0].abs().max()) > 0


@pytest.mark.parametrize("k", [2, 4])
def test_two_runs_are_bit_equal(k):
    a_out, a = run(k, 10)
    b_out, b = run(k, 10)
    assert torch.equal(a_out, b_out)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_a_dropped_assignment_adds_nothing():
    """Capacity 1: most assignments drop; a token whose every assignment
    dropped gets a zero gradient from the experts."""
    out, grads = run(2, 1)
    _, ref = run(2, 1, gather=index_select_gather)
    assert torch.equal(grads[0], ref[0])
    dead = (out.abs().sum(-1) == 0)
    assert bool(dead.any())
    assert float(grads[0][dead].abs().max()) == 0.0
