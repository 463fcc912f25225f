"""The port's Gemma-3 text and Gemma-2 decoders (``models/gemma3.py``,
``models/gemma2.py``) and the ops they add (``ops/norms.py``'s ``(1 +
w)`` offset and ``layer_norm``) against the JAX package on the CPU, fp32.

* ``rms_norm(offset=1.0)`` and ``layer_norm`` on seeded rows: within 1e-6.
* Gemma-3 text at head_dim 256 over a mixed stack (layers 0-4 sliding with
  window 8 and ``rope_local_base_freq``, layer 5 full with ``rope_theta``
  and linear rope scaling 8), rows of 32 packed tokens: every leaf carried
  by ``load_jax_params``; logits, the summed MaskedCE loss and every
  leaf's gradient against ``jax.value_and_grad`` of the JAX step's loss
  within 5e-5 relative (atol 5e-5 of each tensor's largest element: fp32,
  sums in another order; the JAX attention runs its XLA reference on the
  CPU, the port's kernel 9 its plain version).  With the fused linear CE
  the loss and gradients agree the same way.
* Gemma-2 with both soft caps (attention 50 on kernel 9, final logits 30):
  the same, through MaskedCE; a hidden-state loss raises in both packages.
* ``flops_per_token`` equal; HF repos written by one package read by the
  other both ways, and ``from_pretrained`` over a local directory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.loss.linear_ce import FusedLinearCrossEntropy as JaxLCE
from automodel_tpu.loss.masked_ce import MaskedCrossEntropy as JaxCE
from automodel_tpu.models import hf_io as jhf
from automodel_tpu.models.gemma2 import Gemma2Config as JaxGemma2Config
from automodel_tpu.models.gemma2 import Gemma2ForCausalLM as JaxGemma2
from automodel_tpu.models.gemma3 import Gemma3Config as JaxGemma3Config
from automodel_tpu.models.gemma3 import Gemma3ForCausalLM as JaxGemma3
from automodel_tpu.ops import norms as jnorms
from automodel_tpu.training.train_step import _microbatch_loss
from automodel_tpu_torch.loss.linear_ce import FusedLinearCrossEntropy
from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
from automodel_tpu_torch.models import hf_io
from automodel_tpu_torch.models.auto_model import AutoModelForCausalLM
from automodel_tpu_torch.models.gemma2 import Gemma2Config, Gemma2ForCausalLM
from automodel_tpu_torch.models.gemma3 import Gemma3Config, Gemma3ForCausalLM
from automodel_tpu_torch.models.weights import jax_leaves, load_jax_params
from automodel_tpu_torch.ops import norms
from automodel_tpu_torch.training.train_step import microbatch_loss

torch.set_num_threads(1)

REL = 5e-5
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=6, num_attention_heads=4,
            num_key_value_heads=2, head_dim=256,
            query_pre_attn_scalar=256.0, sliding_window=8,
            max_position_embeddings=512)
FAMILIES = {
    "gemma3": (dict(TINY, rope_scaling={"rope_type": "linear",
                                        "factor": 8.0}),
               JaxGemma3Config, JaxGemma3, Gemma3Config, Gemma3ForCausalLM),
    "gemma2": (dict(TINY, num_hidden_layers=4, attn_logit_softcapping=50.0,
                    final_logit_softcapping=30.0),
               JaxGemma2Config, JaxGemma2, Gemma2Config, Gemma2ForCausalLM),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {tuple(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def make_pair(family, seed=0):
    cfg, jcfg_cls, jcls, cfg_cls, cls = FAMILIES[family]
    jm = jcls(jcfg_cls(**cfg), param_dtype=jnp.float32,
              compute_dtype=jnp.float32, remat=True)
    params = jm.init(jax.random.key(seed))
    leaves, td = jax.tree.flatten(params)
    rng = np.random.default_rng(5)   # norms away from 0, scores near the cap
    params = jax.tree.unflatten(td, [
        np.asarray(l) * 4.0 + 0.1 * rng.normal(size=l.shape).astype(
            np.float32) for l in leaves])
    model = cls(cfg_cls(**cfg), param_dtype=torch.float32,
                compute_dtype=torch.float32, device="cpu")
    load_jax_params(model, params)
    return jm, params, model


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def pair(request):
    return make_pair(request.param)


def packed_batch(B=2, S=32, seed=3, vocab=128):
    """Rows of 3 packed samples that fill the row (no padding tail)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, vocab, (B, S)).astype(np.int32)
    seg = np.zeros((B, S), np.int32)
    pos = np.zeros((B, S), np.int32)
    for b in range(B):
        cuts = [0, *np.sort(rng.choice(np.arange(4, S - 4), 2,
                                       replace=False)), S]
        for i in range(3):
            seg[b, cuts[i]:cuts[i + 1]] = i + 1
            pos[b, cuts[i]:cuts[i + 1]] = np.arange(cuts[i + 1] - cuts[i])
    return {"input_ids": ids, "position_ids": pos, "segment_ids": seg,
            "labels": ids.copy()}


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_norms_match_jax(offset):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 48)).astype(np.float32) * 3
    w = rng.normal(size=48).astype(np.float32)
    b = rng.normal(size=48).astype(np.float32)
    got = norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6,
                         offset=offset)
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6,
                           offset=offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    got = norms.layer_norm(*(torch.from_numpy(a) for a in (x, w, b)), 1e-6)
    want = jnorms.layer_norm(*(jnp.asarray(a) for a in (x, w, b)), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)


def test_load_jax_params_fills_every_leaf(pair):
    jm, params, model = pair
    flat = _flat(params)
    seen = set()
    for path, target, transposed in jax_leaves(model):
        got = (np.stack([p.detach().numpy() for p in target])
               if isinstance(target, list) else target.detach().numpy())
        np.testing.assert_array_equal(
            np.swapaxes(got, -1, -2) if transposed else got, flat[path])
        seen.add(path)
    assert seen == set(flat)
    kinds = [layer.full for layer in model.layers]
    assert kinds == [t == "full_attention" for t in
                     jm.config.layer_types]
    assert any(kinds) and not all(kinds)
    np.testing.assert_array_equal(model.inv_freq.numpy(),
                                  np.asarray(jm.inv_freq_global))
    np.testing.assert_array_equal(model.inv_freq_local.numpy(),
                                  np.asarray(jm.inv_freq_local))


def _check_grads(model, jgrads):
    flat = _flat(jgrads)
    for path, target, transposed in jax_leaves(model):
        ref = flat[path]
        grads = [p.grad for p in (target if isinstance(target, list)
                                  else [target])]
        got = np.stack([g.numpy() for g in grads]) if isinstance(
            target, list) else grads[0].numpy()
        if transposed:
            got = np.swapaxes(got, -1, -2)
        np.testing.assert_allclose(got, ref, rtol=REL,
                                   atol=REL * np.abs(ref).max(),
                                   err_msg=".".join(path))


def test_logits_loss_and_grads_match_jax(pair):
    jm, params, model = pair
    batch = packed_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = jm(params, jb["input_ids"], position_ids=jb["position_ids"],
             segment_ids=jb["segment_ids"])
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        out = model(t["input_ids"], position_ids=t["position_ids"],
                    segment_ids=t["segment_ids"])
    want = np.asarray(ref["logits"])
    np.testing.assert_allclose(out["logits"].numpy(), want, rtol=REL,
                               atol=REL * np.abs(want).max())
    jloss, jgrads = jax.value_and_grad(
        lambda p: _microbatch_loss(jm, JaxCE(), p, jb))(
        jax.tree.map(jnp.asarray, params))
    model.zero_grad(set_to_none=True)
    loss = microbatch_loss(model, MaskedCrossEntropy(), t)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=REL)
    _check_grads(model, jgrads)


def test_fused_loss_matches_jax_or_refuses_the_final_cap(pair):
    jm, params, model = pair
    t = {k: torch.from_numpy(v) for k, v in packed_batch(seed=4).items()}
    jb = {k: jnp.asarray(v.numpy()) for k, v in t.items()}
    if model.config.final_logit_softcapping is not None:
        with pytest.raises(NotImplementedError, match="softcapping"):
            microbatch_loss(model, FusedLinearCrossEntropy(), t)
        with pytest.raises(NotImplementedError, match="softcapping"):
            _microbatch_loss(jm, JaxLCE(), jax.tree.map(jnp.asarray, params),
                             jb)
        return
    jloss, jgrads = jax.value_and_grad(
        lambda p: _microbatch_loss(jm, JaxLCE(), p, jb))(
        jax.tree.map(jnp.asarray, params))
    model.zero_grad(set_to_none=True)
    loss = microbatch_loss(model, FusedLinearCrossEntropy(), t)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=REL)
    _check_grads(model, jgrads)


def test_flops_per_token_match_jax(pair):
    jm, _, model = pair
    assert model.flops_per_token() == jm.flops_per_token()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_hf_repos_cross_the_packages_both_ways(family, tmp_path):
    jm, params, model = make_pair(family, seed=4)
    cfg, _, _, cfg_cls, cls = FAMILIES[family]
    jhf.save_hf_weights(jm, _np(params), str(tmp_path / "jax"))
    fresh = cls(cfg_cls(**cfg), param_dtype=torch.float32,
                compute_dtype=torch.float32, device="cpu")
    hf_io.load_hf_weights(fresh, str(tmp_path / "jax"))
    for (path, a, _), (_, b, _) in zip(jax_leaves(fresh), jax_leaves(model)):
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            torch.testing.assert_close(x, y, rtol=0, atol=0,
                                       msg=".".join(path))
    hf_io.save_hf_weights(model, str(tmp_path / "port"))
    back = jhf.load_hf_weights(jm, str(tmp_path / "port"))
    for a, b in zip(jax.tree.leaves(_np(back)), jax.tree.leaves(_np(params))):
        np.testing.assert_array_equal(a, b)
    loaded = AutoModelForCausalLM.from_pretrained(
        str(tmp_path / "port"), load_weights=True, device="cpu",
        param_dtype="float32", compute_dtype="float32")
    assert type(loaded) is cls and loaded.checkpoint_dir == str(
        tmp_path / "port")
    assert loaded.config.layer_types == model.config.layer_types
    for (_, a, _), (_, b, _) in zip(jax_leaves(loaded), jax_leaves(model)):
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            assert torch.equal(x, y)


def test_embeddings_are_scaled_in_the_compute_dtype():
    """``sqrt(H)`` is rounded to the compute dtype before the product, as
    the JAX model's ``jnp.asarray(H ** 0.5, compute_dtype)``."""
    cfg = Gemma3Config(**dict(TINY, hidden_size=48, head_dim=16))
    model = Gemma3ForCausalLM(cfg, compute_dtype=torch.bfloat16,
                              device="cpu").init_weights(0)
    ids = torch.arange(10)[None]
    got = model._embed(ids)
    scale = torch.tensor(48 ** 0.5, dtype=torch.bfloat16)
    want = model.embed_tokens.weight[ids].to(torch.bfloat16) * scale
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert float(scale) != 48 ** 0.5
