"""The port's remat policies (``ops/remat.py``) against the JAX model's.

A 4-layer tiny Llama (hidden 64, 4/2 heads, vocab 128, fp32) from the JAX
model's weights, on packed rows with a padding tail: under every policy
name and ``scan_block`` 1 and 2, the summed CE loss and every parameter's
gradient against ``jax.value_and_grad`` of the JAX step's microbatch loss
under the same policy and block.  Tolerance: 2e-6 relative on the loss
and on each gradient as a whole (relative L2; fp32 on both sides, sums in
another order: measured 7.8e-8 on the loss, 6.0e-7 on the
gradients).  Recomputation repeats the same ops
on the same inputs, so on the port every policy gives the
``nothing_saveable`` result bit for bit.

The plain attention's calls count the forwards:
``save_names:splash_residuals`` keeps its ``(out, lse)``, so it runs once
per layer and microbatch (the backward does not run it again), against
twice under ``nothing_saveable``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.loss.masked_ce import MaskedCrossEntropy as JaxCE
from automodel_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from automodel_tpu.models.llama import LlamaForCausalLM as JaxLlama
from automodel_tpu.ops.remat import resolve_remat_policy as jax_resolve
from automodel_tpu.training.train_step import _microbatch_loss
from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from automodel_tpu_torch.models.weights import jax_leaves, load_jax_params
from automodel_tpu_torch.ops import splash_attention as sa
from automodel_tpu_torch.ops.remat import resolve_remat_policy
from automodel_tpu_torch.training.train_step import microbatch_loss
from tests.test_torch_train_model import TINY, packed_batch

torch.set_num_threads(1)

CFG = dict(TINY, num_hidden_layers=4)
REL = 2e-6
POLICIES = ["nothing_saveable", "none", "everything_saveable",
            "dots_saveable", "checkpoint_dots",
            "dots_with_no_batch_dims_saveable",
            "checkpoint_dots_with_no_batch_dims",
            "save_names:attn_core", "save_names:mlp_silu",
            "save_names:splash_residuals",
            "save_names:attn_core,mlp_silu,splash_residuals"]


@pytest.fixture(scope="module")
def weights():
    jm = JaxLlama(JaxLlamaConfig(**CFG), param_dtype=jnp.float32,
                  compute_dtype=jnp.float32)
    return jax.tree.map(np.asarray, jm.init(jax.random.key(1)))


@pytest.fixture(scope="module")
def batch():
    return packed_batch(seed=11)


def _port(weights, policy="nothing_saveable", block=1):
    model = LlamaForCausalLM(LlamaConfig(**CFG), param_dtype=torch.float32,
                             compute_dtype=torch.float32, device="cpu",
                             remat_policy=policy, scan_block=block)
    load_jax_params(model, weights)
    return model


def _port_step(model, batch):
    model.zero_grad(set_to_none=True)
    loss = microbatch_loss(model, MaskedCrossEntropy(),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    grads = []
    for path, target, transposed in jax_leaves(model):
        g = (np.stack([p.grad.numpy() for p in target])
             if isinstance(target, list) else target.grad.numpy())
        grads.append((path, np.swapaxes(g, -1, -2) if transposed else g))
    return float(loss.detach()), grads


@pytest.fixture(scope="module")
def reference(weights, batch):
    return _port_step(_port(weights), batch)


@pytest.mark.parametrize("block", [1, 2])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_jax(weights, batch, reference, policy, block):
    jm = JaxLlama(JaxLlamaConfig(**CFG), param_dtype=jnp.float32,
                  compute_dtype=jnp.float32, remat_policy=policy,
                  scan_block=block)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: _microbatch_loss(jm, JaxCE(), p, {
            k: jnp.asarray(v) for k, v in batch.items()})))(
        jax.tree.map(jnp.asarray, weights))
    loss, grads = _port_step(_port(weights, policy, block), batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=REL)
    flat = {tuple(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    for path, got in grads:
        want = flat[path]
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= REL, (".".join(path), rel)
    # the port's recomputation is exact: nothing_saveable bit for bit
    ref_loss, ref_grads = reference
    assert loss == ref_loss
    for (path, got), (_, want) in zip(grads, ref_grads):
        np.testing.assert_array_equal(got, want, err_msg=".".join(path))


@pytest.mark.parametrize("policy, per_layer", [
    ("nothing_saveable", 2), ("save_names:splash_residuals", 1),
    ("save_names:attn_core", 2), ("dots_saveable", 2),
    ("everything_saveable", 1)])
@pytest.mark.parametrize("block", [1, 2])
def test_attention_forward_calls(weights, batch, policy, per_layer, block):
    model = _port(weights, policy, block)
    before = sa.plain_fwd_calls
    _port_step(model, batch)
    assert sa.plain_fwd_calls - before == per_layer * CFG[
        "num_hidden_layers"]


@pytest.mark.parametrize("policy", ["save_names:splash_residuals",
                                    "save_names:attn_core,mlp_silu"])
def test_a_second_backward_recomputes_alike(weights, batch, policy):
    """Two backwards through one graph (``retain_graph``): each
    recomputation replays what the forward kept, and both give the
    ``nothing_saveable`` gradients.  (PyTorch's selective checkpointing,
    under the ``dots_*`` policies, refuses a second backward.)"""
    model = _port(weights, policy)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = microbatch_loss(model, MaskedCrossEntropy(), t)
    grads = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        loss.backward(retain_graph=True)
        grads.append([p.grad.clone() for p in model.parameters()])
    ref = _port(weights)
    microbatch_loss(ref, MaskedCrossEntropy(), t).backward()
    for a, b, r in zip(*grads, ref.parameters()):
        assert torch.equal(a, b) and torch.equal(a, r.grad)


@pytest.mark.parametrize("name", ["dots_everything", "save_only_these_names",
                                  "save_names:", "save_names:qkv"])
def test_unknown_policies_raise_value_error(name):
    with pytest.raises(ValueError):
        resolve_remat_policy(name)


def test_unknown_name_raises_as_in_jax():
    with pytest.raises(ValueError, match="Unknown remat policy"):
        jax_resolve("dots_everything")
    with pytest.raises(ValueError, match="Unknown remat policy"):
        resolve_remat_policy("dots_everything")


@pytest.mark.parametrize("name", ["offload_dot_with_no_batch_dims",
                                  "save_and_offload_only_these_names"])
def test_host_offload_policies_are_not_ported(name):
    with pytest.raises(NotImplementedError):
        resolve_remat_policy(name)


@pytest.mark.parametrize("block, match", [(0, "must be >= 1"),
                                          (3, "must divide")])
def test_scan_block_checked_as_in_jax(weights, block, match):
    with pytest.raises(ValueError, match=match):
        _port(weights, block=block)


def test_scan_unroll_is_accepted(weights):
    model = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu", scan_unroll=4)
    assert model.scan_block == 1
