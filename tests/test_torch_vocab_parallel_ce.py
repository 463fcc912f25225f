"""The port's vocab-parallel fused linear CE (``loss/linear_ce.py::
_sharded_lse_pick``) in gloo ranks against the JAX package's on its
virtual CPU devices: tp 2 (2 ranks) and dp 2 x tp 2 (4 ranks), a vocab
shard on a multiple of 128 and one off it (V 200: 100 a shard, where the
JAX function takes its plain XLA route and the port kernel 2's plain
version), the per-token loss and the gradients of hidden states and head
under per-token weights.  Then a tiny Llama over dp 2 x tp 2 (tied head:
the vocab-sharded embedding; untied; with and without sequence
parallelism; and a Granite, which keeps Llama's decoder and adds its
four multipliers) through the fused linear CE against the same model on
one process: the loss and every parameter's gradient.

Tolerance: fp32 on both sides, the lse merged over the shards in another
order: 1e-5 absolute and relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.distributed import shardings as js
from automodel_tpu.distributed.mesh import MeshManager as JaxMesh
from automodel_tpu.loss.linear_ce import _sharded_lse_pick
from automodel_tpu_torch.loss.linear_ce import FusedLinearCrossEntropy
from tests.torch_dist import run_ranks
from tests.torch_dist_workers import (
    CE_B,
    ce_inputs,
    tp_model_and_batch,
    tp_model_grads,
    vocab_ce_cases,
)

TOL = 1e-5
MESHES = {2: dict(tp_size=2), 4: dict(dp_size=2, tp_size=2)}
CASES = {world: [dict(mesh=mesh, V=V, seed=10 * world + i)
                 for i, V in enumerate((200, 256))]
         for world, mesh in MESHES.items()}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return {world: run_ranks(vocab_ce_cases, world,
                             tmp_path_factory.mktemp(f"ce{world}"),
                             CASES[world], timeout=150)
            for world in MESHES}


def _jax(case, world):
    mm = JaxMesh(devices=jax.devices()[:world], **case["mesh"])
    h, w, labels, wgt = ce_inputs(case["seed"], case["V"])
    rules = js.default_rules()

    @jax.jit
    def run(h, w):
        def loss(h, w):
            tok = _sharded_lse_pick(h, w, jnp.asarray(labels), mm.mesh,
                                    rules, "pallas")
            return jnp.sum(tok * wgt), tok
        (_, tok), grads = jax.value_and_grad(loss, (0, 1), has_aux=True)(
            h, w)
        return tok, grads

    tok, (dh, dw) = run(jnp.asarray(h), jnp.asarray(w))
    return np.asarray(tok), np.asarray(dh), np.asarray(dw)


@pytest.mark.parametrize("world,c", [(w, c) for w in MESHES
                                     for c in range(2)],
                         ids=[f"{'tp2' if w == 2 else 'dp2xtp2'}-"
                              f"V{CASES[w][c]['V']}" for w in MESHES
                              for c in range(2)])
def test_sharded_lse_pick_matches_jax(port, world, c):
    case = CASES[world][c]
    tok_j, dh_j, dw_j = _jax(case, world)
    V = case["V"]
    tp = case["mesh"]["tp_size"]
    vl = V // tp
    tok = np.zeros_like(tok_j)
    dh = np.zeros_like(dh_j)
    dw = np.zeros_like(dw_j)
    for rows, t, tok_r, dh_r, dw_r in (r[c] for r in port[world]):
        tok[rows] = tok_r
        dh[rows] = dh_r
        dw[:, t * vl:(t + 1) * vl] += dw_r       # summed over data ranks
    np.testing.assert_allclose(tok, tok_j, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dh, dh_j, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dw, dw_j, atol=TOL, rtol=TOL)
    assert CE_B % (world // tp) == 0


MODEL_CASES = [dict(tied=True, sp=False, seed=3),
               dict(tied=False, sp=False, seed=4),
               dict(tied=True, sp=True, seed=5),
               dict(tied=False, sp=True, seed=6),
               dict(tied=False, sp=True, seed=7, granite=True)]


@pytest.fixture(scope="module")
def model_runs(tmp_path_factory):
    return run_ranks(tp_model_grads, 4, tmp_path_factory.mktemp("tpm"),
                     MODEL_CASES, timeout=150)


@pytest.mark.parametrize("c", range(len(MODEL_CASES)),
                         ids=[f"{'granite-' if m.get('granite') else ''}"
                              f"{'tied' if m['tied'] else 'untied'}-"
                              f"{'sp' if m['sp'] else 'nosp'}"
                              for m in MODEL_CASES])
def test_tp_model_matches_one_process(model_runs, c):
    model, batch = tp_model_and_batch(MODEL_CASES[c])
    labels = torch.from_numpy(batch["labels"])
    o = model(torch.from_numpy(batch["input_ids"]), return_hidden=True)
    loss = FusedLinearCrossEntropy()(o["hidden_states"], o["lm_head_kernel"],
                                     labels)
    loss = loss / (labels != -100).sum()
    loss.backward()
    for rank in range(4):
        got_loss, grads = model_runs[rank][c]
        np.testing.assert_allclose(got_loss, float(loss.detach()), rtol=TOL)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(grads[name], p.grad.numpy(),
                                       atol=TOL, rtol=TOL, err_msg=name)
