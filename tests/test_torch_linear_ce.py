"""The port's fused linear cross-entropy against the JAX package, on the
CPU in fp32: ``ops/linear_ce_kernel.py::lse_and_pick`` (its plain
versions, the CPU route of the kernels' ``autograd.Function``) against the
JAX ``lse_and_pick(..., "pallas")`` run through the Pallas interpreter;
``FusedLinearCrossEntropy`` (both routes) and ``ChunkedCrossEntropy``
against their JAX classes; the SFT recipe with the fused loss against the
JAX recipe step for step; and the bench YAML of the port against the JAX
one.

Tolerances: the forward within 1e-5 (one fp32 product, summed in another
order); ``(dh, dW)`` for random ``(dlse, dpick)`` cotangents within 2e-4
relative to the largest entry (the JAX kernel sums dW over row tiles, the
port over row chunks); the losses and their gradients within 1e-5 / 1e-4;
the recipe trajectory within 1e-4 (as the MaskedCE recipe test).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import automodel_tpu.ops.linear_ce_kernel as jlck
from automodel_tpu.config.arg_parser import (
    parse_args_and_load_config as jax_config,
)
from automodel_tpu.loss.chunked_ce import ChunkedCrossEntropy as JaxChunkedCE
from automodel_tpu.loss.linear_ce import FusedLinearCrossEntropy as JaxFusedCE
from automodel_tpu.ops.kernel_lib import parity
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JaxRecipe,
)
from automodel_tpu_torch.config.loader import (
    load_yaml_config,
    parse_args_and_load_config,
)
from automodel_tpu_torch.loss.chunked_ce import ChunkedCrossEntropy
from automodel_tpu_torch.loss.linear_ce import FusedLinearCrossEntropy
from automodel_tpu_torch.models.weights import load_jax_recipe_params
from automodel_tpu_torch.ops import linear_ce_kernel as lce
from automodel_tpu_torch.recipes.llm import train_ft

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TINY = os.path.join(REPO, "automodel_tpu_torch", "examples",
                         "tiny_llama_sft.yaml")
JAX_TINY = os.path.join(REPO, "examples", "llm_finetune",
                        "tiny_llama_mock.yaml")
PORT_BENCH = os.path.join(REPO, "automodel_tpu_torch", "examples",
                          "llama3_2_1b_bench.yaml")
JAX_BENCH = os.path.join(REPO, "examples", "llm_finetune", "llama3_2",
                         "llama3_2_1b_bench.yaml")
FUSED = "automodel_tpu.loss.linear_ce.FusedLinearCrossEntropy"

# (name, T, H, V, label low, label high, ignored rows)
CASES = [
    ("out_of_range_labels", 64, 128, 256, -5, 256 + 40, 0),
    ("vocab_tail_v300", 48, 128, 300, 0, 300, 0),
    ("ragged_rows_t200", 200, 128, 384, 0, 384, 0),
    ("ignore_rows", 96, 128, 256, 0, 256, 30),
]


def _case(T, H, V, lo, hi, ignored, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(T, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) * 0.05).astype(np.float32)
    labels = rng.integers(lo, hi, T).astype(np.int32)
    labels[rng.permutation(T)[:ignored]] = -100
    dlse = rng.normal(size=T).astype(np.float32)
    dpick = rng.normal(size=T).astype(np.float32)
    return h, w, labels, dlse, dpick


def _port_w(w):
    """The port's head layout: the [H, V] view of a row-major [V, H]."""
    return torch.from_numpy(np.ascontiguousarray(w.T)).t()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_lse_and_pick_matches_jax_pallas(case):
    _, T, H, V, lo, hi, ignored = case
    h, w, labels, dlse, dpick = _case(T, H, V, lo, hi, ignored)
    with parity.interpret_mode():
        (jlse, jpick), vjp = jax.vjp(
            lambda a, b: jlck.lse_and_pick(a, b, jnp.asarray(labels),
                                           "pallas"),
            jnp.asarray(h), jnp.asarray(w))
        jdh, jdw = vjp((jnp.asarray(dlse), jnp.asarray(dpick)))

    th = torch.from_numpy(h).requires_grad_()
    tw = _port_w(w).requires_grad_()
    lse, pick = lce.lse_and_pick(th, tw, torch.from_numpy(labels))
    dh, dw = torch.autograd.grad((lse, pick), (th, tw),
                                 (torch.from_numpy(dlse),
                                  torch.from_numpy(dpick)))
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pick.detach().numpy(), np.asarray(jpick),
                               rtol=1e-5, atol=1e-5)
    for got, want in ((dh, jdh), (dw, jdw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-4 * np.abs(want).max())


def test_plain_backward_is_autograd_of_the_plain_forward():
    """The plain versions walked in chunks of 32 rows: the forward equals
    the dense fp32 logsumexp and pick, and the written-out backward (the
    formula the kernels implement) equals torch's autograd of it."""
    h, w, labels, dlse, dpick = _case(70, 32, 90, -3, 95, 10, seed=3)
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    lab = torch.from_numpy(labels)
    tdlse, tdpick = torch.from_numpy(dlse), torch.from_numpy(dpick)
    lse, pick = lce.lse_and_pick_plain(th.detach(), tw.detach(), lab,
                                       chunk_rows=32)
    got = lce.lse_and_pick_bwd_plain(th.detach(), tw.detach(), lab, lse,
                                     tdlse, tdpick, chunk_rows=32)
    logits = th @ tw
    ok = (lab >= 0) & (lab < 90)
    rl = torch.logsumexp(logits, -1)
    rp = torch.where(ok, logits.gather(1, lab.long().clamp(0, 89)[:, None])
                     [:, 0], torch.zeros(70))
    ref = torch.autograd.grad((rl * tdlse + rp * tdpick).sum(), (th, tw))
    for a, b in ((lse, rl), (pick, rp), *zip(got, ref)):
        torch.testing.assert_close(a, b.detach(), rtol=1e-5, atol=1e-5)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    h = torch.zeros(8, 16)
    w = torch.zeros(16, 32)
    lab = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        lce.linear_ce_fwd_cuda(h, w, lab)
    with pytest.raises(ValueError, match="CUDA"):
        lce.lse_and_pick(h, w, lab, impl="kernel")
    with pytest.raises(ValueError, match="row-major"):
        lce.head_storage(w)          # a contiguous [H, V], not the view
    assert lce.head_storage(w.t().contiguous().t()).shape == (32, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lce.lse_and_pick(h, w, lab, bwd_mode="xla")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FusedLinearCrossEntropy(bwd_mode="xla")
    assert lce.bwd_launches_per_call(16384) == 8
    assert lce.bwd_launches_per_call(1000, 96) == 11
    assert lce.padded_vocab(50257) == 50304


def _loss_inputs(seed=0, B=2, S=40, H=128, V=300):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(B, S, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) * 0.05).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[0, -7:] = -100
    mask = (rng.uniform(size=(B, S)) > 0.2).astype(np.int32)
    return hidden, w, labels, mask


@pytest.mark.parametrize("use_kernel", [None, False], ids=["kernel_route",
                                                           "chunked_route"])
def test_fused_linear_ce_matches_jax(use_kernel):
    hidden, w, labels, mask = _loss_inputs()
    n = float((labels != -100).sum())
    jloss = JaxFusedCE(chunk_len=16, use_kernel=use_kernel)

    def jfn(a, b):
        return jloss(a, b, jnp.asarray(labels), mask=jnp.asarray(mask),
                     num_label_tokens=jnp.float32(n))

    with parity.interpret_mode():
        if use_kernel is None:
            jloss.use_kernel = True         # the Pallas rung, interpreted
        jval, (jdh, jdw) = jax.value_and_grad(jfn, argnums=(0, 1))(
            jnp.asarray(hidden), jnp.asarray(w))

    th = torch.from_numpy(hidden).requires_grad_()
    tw = _port_w(w).requires_grad_()
    loss = FusedLinearCrossEntropy(chunk_len=16, use_kernel=use_kernel)(
        th, tw, torch.from_numpy(labels), mask=torch.from_numpy(mask),
        num_label_tokens=torch.tensor(n))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jval),
                               rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-4,
                               atol=1e-6)


def test_chunked_ce_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 45, 64)).astype(np.float32) * 3
    labels = rng.integers(0, 64, (2, 45)).astype(np.int32)
    labels[1, :9] = -100
    mask = (rng.uniform(size=(2, 45)) > 0.25).astype(np.int32)
    jval, jgrad = jax.value_and_grad(
        lambda x: JaxChunkedCE(chunk_len=16)(
            x, jnp.asarray(labels), mask=jnp.asarray(mask),
            num_label_tokens=jnp.float32(50.0)))(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    loss = ChunkedCrossEntropy(chunk_len=16)(
        tl, torch.from_numpy(labels), mask=torch.from_numpy(mask),
        num_label_tokens=torch.tensor(50.0))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jval),
                               rtol=1e-5)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def fused_runs():
    """The JAX recipe and the port's on the tiny YAMLs with the fused loss
    (one device, fp32, no checkpoints), the port from the JAX weights."""
    jcfg = jax_config(["--config", JAX_TINY,
                       "--checkpoint.enabled", "false",
                       "--dataloader.prefetch_depth", "0",
                       "--model.config.torch_dtype", "float32",
                       "--model.compute_dtype", "float32",
                       "--loss_fn._target_", FUSED])
    real = jax.devices
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "devices", lambda *a: real(*a)[:1])    # one device
    try:
        jr = JaxRecipe(jcfg).setup()
    finally:
        mp.undo()
    jsteps = []
    finalize = jr._finalize_metrics

    def record_step(pending):
        out = finalize(pending)
        jsteps.append(out)
        return out

    jr._finalize_metrics = record_step
    weights = jax.tree.map(np.asarray, jr.params)
    jr.run_train_validation_loop()

    pr = train_ft.TrainFinetuneRecipeForNextTokenPrediction(
        parse_args_and_load_config(["-c", PORT_TINY, "--device", "cpu",
                                    "--loss_fn._target_", FUSED]))
    pr.setup()
    load_jax_recipe_params(pr, weights)
    pr.run_train_validation_loop()
    return jsteps, pr


def test_fused_loss_recipe_steps_match_jax(fused_runs):
    jsteps, pr = fused_runs
    assert isinstance(pr.loss_fn, FusedLinearCrossEntropy)
    assert [m["step"] for m in jsteps] == [m["step"] for m in pr.history]
    for key in ("num_label_tokens", "lr"):
        assert [m[key] for m in jsteps] == [m[key] for m in pr.history]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([m[key] for m in pr.history],
                                   [m[key] for m in jsteps], rtol=1e-4,
                                   err_msg=key)


def test_bench_yaml_is_the_jax_bench_yaml():
    """Every section as written (the port translates the targets at
    instantiation), and the recipe accepts it: the fused loss with
    chunk_len 1024, prefetch depth 2, compile, kernels.autotune off and fp8
    off."""
    with open(PORT_BENCH) as f:
        port = yaml.safe_load(f)
    with open(JAX_BENCH) as f:
        ref = yaml.safe_load(f)
    assert port == ref
    cfg = load_yaml_config(PORT_BENCH)
    train_ft.check_ported(cfg)
    loss = cfg.loss_fn.instantiate()
    assert isinstance(loss, FusedLinearCrossEntropy)
    assert loss.chunk_len == 1024 and loss.use_kernel is None
    assert cfg.get("dataloader.prefetch_depth") == 2
    assert cfg.get("kernels.autotune") is False      # YAML 1.1 ``off``
