"""The port's ring attention (``automodel_tpu_torch/ops/ring_attention.py``)
in 4 gloo ranks against the JAX package's ``sharded_ring_attention`` on 4
of the virtual CPU devices, on the same inputs from a numpy seed: meshes
cp 4 and dp 2 x cp 2, the zig-zag and contiguous layouts, with and
without packed segment ids (padding rows included), GQA (4 query heads
on 2 kv heads); a sliding window and a soft cap on the CPU's
position-masked blocks.  The output and dq / dk / dv are compared, and
the assembled output against the port's unsharded plain attention.

Tolerance: fp32 on both sides, blockwise softmax merged in another order
(JAX's tiles vs the port's pieces): 2e-5 absolute + 1e-5 relative.

The key-side segment ids of kernel 9's plain versions: with the keys'
ids equal to the queries' the forward and backward are bit for bit
today's (the form the kernels took before), but for an empty row's lse
(``-inf`` in place of 0); with other ids they are the dense masked
softmax."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.distributed.mesh import MeshManager as JaxMesh
from automodel_tpu.ops.ring_attention import sharded_ring_attention
from automodel_tpu.ops.zigzag import zigzag_permute
from automodel_tpu_torch.ops import splash_attention as sa
from tests.torch_dist import run_ranks
from tests.torch_dist_workers import RING_B, RING_S, ring_cases, ring_inputs

ATOL, RTOL = 2e-5, 1e-5

CASES = []
for mesh_name, mesh in (("cp4", dict(cp_size=4)),
                        ("dp2xcp2", dict(dp_size=2, cp_size=2))):
    for layout in ("zigzag", "contiguous"):
        for segments in (True, False):
            CASES.append(dict(name=f"{mesh_name}-{layout}-"
                                   f"{'seg' if segments else 'noseg'}",
                              mesh=mesh, layout=layout, segments=segments,
                              seed=len(CASES)))
CASES.append(dict(name="cp4-zigzag-seg-window", mesh=dict(cp_size=4),
                  layout="zigzag", segments=True, seed=50, window=5))
CASES.append(dict(name="dp2xcp2-contiguous-cap", mesh=dict(dp_size=2,
                                                           cp_size=2),
                  layout="contiguous", segments=False, seed=51, cap=3.0))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_ranks(ring_cases, 4, tmp_path_factory.mktemp("ring"), CASES,
                     timeout=180)


def _jax_ring(case):
    mm = JaxMesh(devices=jax.devices()[:4], **case["mesh"])
    q, k, v, dout, seg = ring_inputs(case["seed"], case["segments"])
    cp = mm.cp_size
    if case["layout"] == "zigzag":
        q, k, v, dout = (zigzag_permute(x, cp, axis=1) for x in (q, k, v,
                                                                 dout))
        seg = None if seg is None else zigzag_permute(seg, cp)
    fn = functools.partial(
        sharded_ring_attention, mesh=mm.mesh, layout=case["layout"],
        local_window_size=case.get("window"),
        logits_soft_cap=case.get("cap"))

    @jax.jit
    def run(q, k, v, dout, seg):
        out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, segment_ids=seg),
                           q, k, v)
        return (out, *vjp(dout))

    got = run(*(None if x is None else jnp.asarray(x)
                for x in (q, k, v, dout, seg)))
    return [np.asarray(x) for x in got], cp


def _assemble(ranks, c, cp):
    """The ranks' shards of case ``c`` -> global [B, S, ...] arrays in
    layout order (out, dq, dk, dv)."""
    n = RING_S // cp
    full = None
    for res in ranks:
        rows, ci, *arrs = res[c]
        if full is None:
            full = [np.zeros((RING_B, RING_S) + a.shape[2:], a.dtype)
                    for a in arrs]
        for f, a in zip(full, arrs):
            f[np.asarray(rows)[:, None], np.arange(ci * n, (ci + 1) * n)] = a
    return full


@pytest.mark.parametrize("c", range(len(CASES)),
                         ids=[c["name"] for c in CASES])
def test_ring_matches_jax(port, c):
    case = CASES[c]
    want, cp = _jax_ring(case)
    got = _assemble(port, c, cp)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{case['name']} {name}")


@pytest.mark.parametrize("c", range(len(CASES)),
                         ids=[c["name"] for c in CASES])
def test_ring_matches_unsharded_plain(port, c):
    case = CASES[c]
    cp = case["mesh"]["cp_size"]
    q, k, v, dout, seg = ring_inputs(case["seed"], case["segments"])
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = sa.splash_attention_plain(
        tq, tk, tv, causal=True,
        segment_ids=None if seg is None else torch.from_numpy(seg),
        local_window_size=case.get("window"),
        logits_soft_cap=case.get("cap"))
    grads = sa.splash_attention_bwd_plain(
        tq, tk, tv, out, lse, torch.from_numpy(dout), causal=True,
        segment_ids=None if seg is None else torch.from_numpy(seg),
        local_window_size=case.get("window"),
        logits_soft_cap=case.get("cap"))
    want = [x.detach().numpy() for x in (out, *grads)]
    if case["layout"] == "zigzag":
        want = [zigzag_permute(x, cp, axis=1) for x in want]
    got = _assemble(port, c, cp)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{case['name']} {name}")


def _plain_inputs(seed):
    q, k, v, dout, seg = ring_inputs(seed, True)
    return [torch.from_numpy(x) for x in (q, k, v, dout, seg)]


@pytest.mark.parametrize("causal", [True, False])
def test_kv_ids_equal_to_q_ids_are_todays_form(causal):
    q, k, v, dout, seg = _plain_inputs(7)
    out0, lse0 = sa.splash_attention_plain(q, k, v, causal=causal,
                                           segment_ids=seg)
    out1, lse1 = sa.splash_attention_plain(q, k, v, causal=causal,
                                           segment_ids=seg,
                                           kv_segment_ids=seg.clone())
    assert torch.equal(out0, out1)
    empty = (seg == 0)[:, None, :].expand_as(lse0)
    assert torch.equal(lse0[~empty], lse1[~empty])
    assert bool((lse0[empty] == 0).all()) and bool(
        torch.isneginf(lse1[empty]).all())
    g0 = sa.splash_attention_bwd_plain(q, k, v, out0, lse0, dout,
                                       causal=causal, segment_ids=seg)
    g1 = sa.splash_attention_bwd_plain(q, k, v, out0, lse0, dout,
                                       causal=causal, segment_ids=seg,
                                       kv_segment_ids=seg.clone())
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_kv_ids_of_their_own_are_the_masked_softmax():
    q, k, v, dout, seg = _plain_inputs(8)
    seg_kv = torch.roll(seg, 5, dims=1)
    out, lse = sa.splash_attention_plain(q, k, v, causal=False,
                                         segment_ids=seg,
                                         kv_segment_ids=seg_kv)
    B, S, Hq, D = q.shape
    kk = k.repeat_interleave(Hq // k.shape[2], 2)
    vv = v.repeat_interleave(Hq // v.shape[2], 2)
    x = torch.einsum("bqhd,bkhd->bhqk", q, kk) * D ** -0.5
    mask = (seg[:, :, None] == seg_kv[:, None, :]) & (seg_kv != 0)[:, None]
    x = x.masked_fill(~mask[:, None], float("-inf"))
    want_lse = torch.logsumexp(x, -1)
    p = torch.softmax(x, -1).nan_to_num(0.0)
    want = torch.einsum("bhqk,bkhd->bqhd", p, vv)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    finite = torch.isfinite(want_lse)
    torch.testing.assert_close(lse[finite], want_lse[finite], atol=1e-5,
                               rtol=1e-5)
    assert bool(torch.isneginf(lse[~finite]).all())
