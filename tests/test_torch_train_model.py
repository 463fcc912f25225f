"""The port's Llama training forward against the JAX model at the tiny SFT
size (2 layers, hidden 64, 4/2 heads, vocab 128, fp32) on packed rows:
``segment_ids`` with a padding tail and ``position_ids`` restarting per
sample.  Logits, the summed CE loss and every parameter's gradient are held
against ``jax.value_and_grad`` of the JAX step's ``_microbatch_loss``
through ``load_jax_params``; remat on and off give the same gradients.

Logits are compared on the rows with segment >= 1 (the padding rows have
no key to attend; the two packages give them different stated values and
their labels are -100).  Tolerance: fp32 on both sides, sums taken in
another order: logits 1e-4 relative/1e-5 absolute, loss 1e-5 relative,
gradients 1e-4 relative plus 1e-5 of each gradient's largest element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.loss.masked_ce import MaskedCrossEntropy as JaxCE
from automodel_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from automodel_tpu.models.llama import LlamaForCausalLM as JaxLlama
from automodel_tpu.training.train_step import _microbatch_loss
from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from automodel_tpu_torch.models.weights import jax_leaves, load_jax_params
from automodel_tpu_torch.training.train_step import microbatch_loss

torch.set_num_threads(1)

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, rope_theta=10000.0,
            tie_word_embeddings=True)


def packed_batch(B=2, S=64, seed=3):
    """Rows of 3 packed samples and a padding tail, as the packer makes
    them: positions restart per sample, pads continue the count, labels
    are the ids with -100 on the pads."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 128, (B, S)).astype(np.int32)
    seg = np.zeros((B, S), np.int32)
    pos = np.zeros((B, S), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(6, S - 6), 3, replace=False))
        start = 0
        for i, end in enumerate(cuts):
            seg[b, start:end] = i + 1
            pos[b, start:end] = np.arange(end - start)
            start = end
        pos[b, start:] = np.arange(start, S)
        ids[b, start:] = 0
    labels = np.where(seg > 0, ids, -100).astype(np.int32)
    return {"input_ids": ids, "position_ids": pos, "segment_ids": seg,
            "labels": labels}


@pytest.fixture(scope="module")
def pair():
    jm = JaxLlama(JaxLlamaConfig(**TINY), param_dtype=jnp.float32,
                  compute_dtype=jnp.float32, remat=True)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    model = LlamaForCausalLM(LlamaConfig(**TINY), param_dtype=torch.float32,
                             compute_dtype=torch.float32, device="cpu")
    load_jax_params(model, params)
    return jm, params, model


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_weights_round_trip_and_logits_match_jax(pair):
    jm, params, model = pair
    flat = {tuple(k.key for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    for path, target, transposed in jax_leaves(model):
        got = (np.stack([p.detach().numpy() for p in target])
               if isinstance(target, list) else target.detach().numpy())
        np.testing.assert_array_equal(
            np.swapaxes(got, -1, -2) if transposed else got, flat[path])
    batch = packed_batch()
    ref = np.asarray(jm(params, jnp.asarray(batch["input_ids"]),
                        position_ids=jnp.asarray(batch["position_ids"]),
                        segment_ids=jnp.asarray(batch["segment_ids"]))
                     ["logits"])
    t = _torch_batch(batch)
    with torch.no_grad():
        out = model(t["input_ids"], position_ids=t["position_ids"],
                    segment_ids=t["segment_ids"])["logits"].numpy()
    valid = batch["segment_ids"] > 0
    np.testing.assert_allclose(out[valid], ref[valid], rtol=1e-4, atol=1e-5)


def _port_grads(model, batch):
    model.zero_grad(set_to_none=True)
    loss = microbatch_loss(model, MaskedCrossEntropy(), _torch_batch(batch))
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in
                         model.named_parameters()}


def test_loss_and_grads_match_jax(pair):
    jm, params, model = pair
    batch = packed_batch(seed=4)
    jloss, jgrads = jax.value_and_grad(
        lambda p: _microbatch_loss(jm, JaxCE(), p, {
            k: jnp.asarray(v) for k, v in batch.items()}))(
        jax.tree.map(jnp.asarray, params))
    loss, _ = _port_grads(model, batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    flat = {tuple(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    for path, target, transposed in jax_leaves(model):
        got = (np.stack([p.grad.numpy() for p in target])
               if isinstance(target, list) else target.grad.numpy())
        if transposed:
            got = np.swapaxes(got, -1, -2)
        ref = flat[path]
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=".".join(path))


def test_remat_on_and_off_give_the_same_grads(pair):
    _, _, model = pair
    batch = packed_batch(seed=5)
    model.remat = True
    loss_on, on = _port_grads(model, batch)
    model.remat = False
    try:
        loss_off, off = _port_grads(model, batch)
    finally:
        model.remat = True
    assert loss_on == loss_off
    for name in on:
        torch.testing.assert_close(on[name], off[name], atol=0, rtol=0,
                                   msg=name)


def test_return_hidden_gives_the_head(pair):
    _, _, model = pair
    t = _torch_batch(packed_batch())
    with torch.no_grad():
        out = model(t["input_ids"], position_ids=t["position_ids"],
                    segment_ids=t["segment_ids"], return_hidden=True)
        logits = model(t["input_ids"], position_ids=t["position_ids"],
                       segment_ids=t["segment_ids"])["logits"]
    assert out["lm_head_kernel"].shape == (64, 128)
    torch.testing.assert_close(out["hidden_states"] @ out["lm_head_kernel"],
                               logits)


def test_flops_per_token_match_jax(pair):
    jm, _, model = pair
    assert model.flops_per_token() == jm.flops_per_token()
    for s, causal in ((64, True), (2048, True), (100, False)):
        assert model.attention_flops_per_token(s, causal) == \
            jm.attention_flops_per_token(s, causal)
