"""The port's MoE routing and expert compute (``automodel_tpu_torch/ops/
moe.py``) against the JAX package's ``automodel_tpu/ops/moe.py`` on the
CPU, fp32, inputs from a seed with numpy.

The JAX sorted path runs its grouped matmuls as the JAX package does on
the CPU (the block-segment XLA route behind ``block_aligned=True``), the
port's the plain versions of its kernels.  Routing is held exactly (top-k
indices, capacity positions); outputs and routing statistics within 1e-5
absolute and relative (fp32, the same sums in another order); gradients
within 1e-4 of each gradient's largest element (the scatter-add and the
grouped products sum in another order), absolute for gradients below 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.ops import moe as jmoe
from automodel_tpu_torch.ops import moe

torch.set_num_threads(1)

G, M, H, I, E = 2, 48, 16, 24, 8


def weights(seed, H=H, I=I, E=E):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(H, E)).astype(np.float32) * 0.3,
            rng.normal(size=(E, H, I)).astype(np.float32) * 0.2,
            rng.normal(size=(E, H, I)).astype(np.float32) * 0.2,
            rng.normal(size=(E, I, H)).astype(np.float32) * 0.2)


def routed(seed, k, skew=0.3):
    """Grouped tokens and their routing (JAX's ``topk_routing``), skewed
    toward low expert ids for uneven loads."""
    rng = np.random.default_rng(seed)
    xg = rng.normal(size=(G, M, H)).astype(np.float32)
    gate = rng.normal(size=(H, E)).astype(np.float32)
    logits = xg @ gate - skew * np.arange(E, dtype=np.float32)
    w, idx, _ = jmoe.topk_routing(jnp.asarray(logits), k)
    return xg, np.asarray(w), np.asarray(idx)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close_grads(got, want, err_msg=""):
    # the JAX tests' convention: relative to the largest element, absolute
    # below 1 (with k = 1 the renormalised weight is 1 and the router's
    # gradient is rounding noise on both sides)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-4,
                               err_msg=err_msg)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cf", [None, 2.0], ids=["dropless", "cf2"])
def test_sorted_expert_ffn_matches_jax(cf, k):
    xg, w8, idx = routed(k, k)
    _, wg, wu, wd = weights(10 + k)
    _, C = jmoe.group_and_capacity(G * M, M, E, k, cf)
    cot = np.random.default_rng(3).normal(size=(G, M, H)).astype(np.float32)

    def jloss(xg, wg, wu, wd):
        out = jmoe.sorted_expert_ffn(xg, jnp.asarray(w8), jnp.asarray(idx),
                                     wg, wu, wd, capacity=C,
                                     compute_dtype=jnp.float32)
        return jnp.sum(out * cot), out

    (_, ref), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                      has_aux=True)(
        *map(jnp.asarray, (xg, wg, wu, wd)))
    tx, twg, twu, twd = (t.requires_grad_() for t in _t(xg, wg, wu, wd))
    out = moe.sorted_expert_ffn(tx, *_t(w8, idx), twg, twu, twd, capacity=C,
                                compute_dtype=torch.float32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    (out * torch.from_numpy(cot)).sum().backward()
    for name, t, g in zip(("x", "w_gate", "w_up", "w_down"),
                          (tx, twg, twu, twd), jg):
        _close_grads(t.grad.numpy(), np.asarray(g), name)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cf", [None, 2.0], ids=["dropless", "cf2"])
def test_moe_mlp_block_matches_jax(cf, k):
    """The whole block (router, padding of the last token group, routing
    statistics, sorted dispatch): T = 2 x 45 tokens in groups of 32, so the
    last group carries 6 pad tokens."""
    rng = np.random.default_rng(20 + k)
    x = rng.normal(size=(2, 45, H)).astype(np.float32)
    gate, wg, wu, wd = weights(30 + k)
    cot = rng.normal(size=x.shape).astype(np.float32)
    kw = dict(num_experts_per_tok=k, capacity_factor=cf, group_size=32)

    def jloss(*args):
        out, aux = jmoe.moe_mlp_block(*args, compute_dtype=jnp.float32, **kw)
        return jnp.sum(out * cot), (out, aux)

    (_, (ref, (jtpe, jrp))), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *map(jnp.asarray, (x, gate, wg, wu, wd)))
    ts = [t.requires_grad_() for t in _t(x, gate, wg, wu, wd)]
    out, (tpe, rp) = moe.moe_mlp_block(*ts, compute_dtype=torch.float32,
                                       **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tpe.numpy(), np.asarray(jtpe), atol=1e-6)
    np.testing.assert_allclose(rp.detach().numpy(), np.asarray(jrp),
                               atol=1e-6)
    (out * torch.from_numpy(cot)).sum().backward()
    for name, t, g in zip(("x", "gate", "w_gate", "w_up", "w_down"), ts, jg):
        _close_grads(t.grad.numpy(), np.asarray(g), name)


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("cf", [None, 1.0, 2.0],
                         ids=["dropless", "cf1", "cf2"])
def test_sorted_matches_onehot_in_the_port(cf, k):
    """The sorted path against the port's own one-hot oracle, drops
    included, outputs and gradients."""
    xg, w8, idx = routed(40 + k, k)
    _, wg, wu, wd = weights(50 + k)
    _, C = moe.group_and_capacity(G * M, M, E, k, cf)
    grads, outs = [], []
    for dispatch in ("onehot", "sorted"):
        ts = [t.requires_grad_() for t in _t(xg, wg, wu, wd)]
        out = moe.expert_ffn(ts[0], *_t(w8, idx), *ts[1:], capacity=C,
                             dispatch=dispatch, compute_dtype=torch.float32)
        out.square().sum().backward()
        outs.append(out.detach().numpy())
        grads.append([t.grad.numpy() for t in ts])
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-5, rtol=1e-5)
    for a, b in zip(grads[1], grads[0]):
        _close_grads(a, b)


def test_capacity_positions_and_drops_match_jax():
    """The slot-major capacity queue positions (which decide the drops) are
    the JAX function's exactly, on a skewed routing with drops."""
    _, _, idx = routed(60, 2, skew=1.5)
    ref = np.asarray(jmoe._assignment_positions(jnp.asarray(idx), E))
    got = moe._assignment_positions(*_t(idx), E).numpy()
    np.testing.assert_array_equal(got, ref)
    _, C = moe.group_and_capacity(G * M, M, E, 2, 1.0)
    assert (got >= C).sum() > 0                     # some are dropped


@pytest.mark.parametrize("norm_topk", [True, False])
def test_routing_and_aux_loss_match_jax(norm_topk):
    """``topk_routing``, ``routing_stats`` (with and without the pad-token
    mask) and ``load_balancing_loss`` against JAX."""
    rng = np.random.default_rng(70)
    logits = rng.normal(size=(G, M, E)).astype(np.float32)
    jw, jidx, jp = jmoe.topk_routing(jnp.asarray(logits), 2,
                                     norm_topk=norm_topk)
    w, idx, p = moe.topk_routing(torch.from_numpy(logits), 2,
                                 norm_topk=norm_topk)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-6)
    valid = np.arange(G * M).reshape(G, M) < G * M - 5
    jidx_pad = jnp.where(jnp.asarray(valid)[..., None], jidx, E)
    idx_pad = torch.where(torch.from_numpy(valid)[..., None], idx, E)
    for v in (None, valid):
        jstats = jmoe.routing_stats(jp, jidx if v is None else jidx_pad, E,
                                    None if v is None else jnp.asarray(v))
        stats = moe.routing_stats(p, idx if v is None else idx_pad, E,
                                  None if v is None else torch.from_numpy(v))
        for a, b in zip(stats, jstats):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
        np.testing.assert_allclose(
            float(moe.load_balancing_loss(*stats)),
            float(jmoe.load_balancing_loss(*jstats)), rtol=1e-6)


def test_group_tokens_pads_and_masks_like_jax():
    x = np.arange(7 * 3, dtype=np.float32).reshape(7, 3)
    jxg, jpad = jmoe.group_tokens(jnp.asarray(x), 4)
    xg, pad = moe.group_tokens(torch.from_numpy(x), 4)
    assert pad == jpad == 1
    np.testing.assert_array_equal(xg.numpy(), np.asarray(jxg))
    assert moe.group_and_capacity(1031, 512, 8, 2, 2.0) == \
        jmoe.group_and_capacity(1031, 512, 8, 2, 2.0)


def test_dispatch_enum_quant_and_sentinel():
    assert moe.resolve_moe_dispatch(None) == "sorted"
    assert moe.resolve_moe_dispatch("onehot") == "onehot"
    assert moe.normalize_moe_dispatch("null") is None
    assert moe.MOE_DISPATCHES == jmoe.MOE_DISPATCHES
    with pytest.raises(ValueError, match="moe.dispatch"):
        moe.resolve_moe_dispatch("blocktree")
    # quantized compute: the onehot oracle ignores ``quant`` and the sorted
    # path keeps its bf16 grouped matmuls when I (24 here) is no multiple
    # of 16, as in JAX; both give the unquantized result exactly
    from automodel_tpu_torch.ops.quant import QuantConfig

    gate, wg, wu, wd = _t(*weights(80))
    x = torch.from_numpy(np.random.default_rng(81).normal(
        size=(1, 4, H)).astype(np.float32))
    quant = QuantConfig(enabled=True, dtype="int8")
    for dispatch in ("onehot", "sorted"):
        ref, _ = moe.moe_mlp_block(x, gate, wg, wu, wd, num_experts_per_tok=2,
                                   dispatch=dispatch)
        got, _ = moe.moe_mlp_block(x, gate, wg, wu, wd, num_experts_per_tok=2,
                                   dispatch=dispatch, quant=quant)
        torch.testing.assert_close(got, ref, atol=0, rtol=0, msg=dispatch)
