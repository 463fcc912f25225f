"""Granite, OLMo-2, StarCoder-2 and Phi-3 in the port against the JAX
package, float32 on the CPU at a tiny size (2 layers, hidden 64, 4 / 2
heads of 16, vocab 256), each from the same HF directory: random weights
from a seed (biases and norms moved off their zeros and ones) written by
the port, ``config.json`` in the published form, read by both packages'
``from_pretrained``:

* the weights each package reads, bit for bit; a directory the JAX
  package writes reads back in the port bit for bit;
* logits and the gradient of every parameter under ``MaskedCrossEntropy``
  and, for Granite (whose ``logits_scaling`` the head carries), under
  ``FusedLinearCrossEntropy`` too;
* greedy tokens through both decode engines, and the dense decode
  cache's logits against the cache-free forward;
* the rope tables: longrope's short and long branches and their
  amplitude, partial rotary, and a longrope Phi-3's logits on rows on
  either side of the original context length;
* kernel 9's zero-padded route for head_dim 96 (Phi-3-mini), its
  arithmetic against unpadded plain attention.

Tolerances: logits and gradients within 1e-5 relative L2 over each tensor
(float32, sums in another order, as ``test_torch_llama_families.py``);
rope tables exactly; greedy tokens and weights exactly; the padded
attention within 1e-5 relative L2 (float32 sums over 128 channels, 32 of
them zero).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.loss.linear_ce import FusedLinearCrossEntropy as JaxFused
from automodel_tpu.loss.masked_ce import MaskedCrossEntropy as JaxCE
from automodel_tpu.models import auto_model as jauto
from automodel_tpu.models import hf_io as jhf
from automodel_tpu.ops import rotary as jrotary
from automodel_tpu.training.train_step import _microbatch_loss
from automodel_tpu_torch.loss.linear_ce import FusedLinearCrossEntropy
from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
from automodel_tpu_torch.models import auto_model, hf_io
from automodel_tpu_torch.models.weights import jax_leaves
from automodel_tpu_torch.ops import rotary
from automodel_tpu_torch.ops import splash_attention as sa
from automodel_tpu_torch.training.train_step import microbatch_loss
from tests.torch_serving_pair import make_engine, seeded_prompts

torch.set_num_threads(1)

REL = 1e-5
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-6,
            rope_theta=10000.0, max_position_embeddings=512,
            tie_word_embeddings=True, torch_dtype="float32")
LONGROPE = {"rope_type": "longrope",
            "short_factor": [1.0, 1.2, 1.5, 2.0],
            "long_factor": [1.1, 2.0, 3.5, 6.0]}
# each family's published config.json keys at tiny widths
HF_CONFIGS = {
    "granite": dict(TINY, model_type="granite", embedding_multiplier=12.0,
                    attention_multiplier=0.2, residual_multiplier=0.22,
                    logits_scaling=8.0, attention_dropout=0.1,
                    architectures=["GraniteForCausalLM"]),
    "olmo2": dict(TINY, model_type="olmo2", num_key_value_heads=4,
                  tie_word_embeddings=False,
                  architectures=["Olmo2ForCausalLM"]),
    "starcoder2": dict(TINY, model_type="starcoder2", use_bias=True,
                       norm_epsilon=1e-5, sliding_window=5,
                       architectures=["Starcoder2ForCausalLM"]),
    "phi3": dict(TINY, model_type="phi3", partial_rotary_factor=0.5,
                 tie_word_embeddings=False, sliding_window=None,
                 architectures=["Phi3ForCausalLM"]),
}
# a longrope Phi-3 (full rotary: the JAX model builds its head_dim
# tables before the partial ones, so its longrope lists must fit
# head_dim): rows of 16 pass the original length 8 (the long table), rows
# of 6 do not
PHI3_LONGROPE = dict(
    HF_CONFIGS["phi3"], partial_rotary_factor=1.0,
    original_max_position_embeddings=8, max_position_embeddings=32,
    rope_scaling={"rope_type": "longrope",
                  "short_factor": [1.0, 1.1, 1.2, 1.3, 1.5, 1.7, 2.0, 2.4],
                  "long_factor": [1.1, 1.5, 2.0, 2.6, 3.5, 4.4, 6.0, 8.0]})


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def write_hf_dir(path, hf_cfg, seed=0):
    """The port's model of ``hf_cfg`` from ``seed``, every parameter
    perturbed, written as an HF directory with ``hf_cfg`` as its
    ``config.json``."""
    model = auto_model.AutoModelForCausalLM.from_config(
        hf_cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(
                0.05 * rng.standard_normal(p.shape).astype(np.float32)))
    hf_io.save_hf_weights(model, str(path))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f)
    return model


def load_both(path):
    jm = jauto.AutoModelForCausalLM.from_pretrained(
        str(path), load_weights=True, compute_dtype=jnp.float32,
        remat=False)
    model = auto_model.AutoModelForCausalLM.from_pretrained(
        str(path), load_weights=True, device="cpu",
        compute_dtype=torch.float32, remat=False)
    return jm, model


def _flat(tree):
    return {tuple(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _leaf_values(model, grad=False):
    for path, target, transposed in jax_leaves(model):
        ts = target if isinstance(target, list) else [target]
        got = np.stack([(t.grad if grad else t).detach().numpy() for t in ts])
        if not isinstance(target, list):
            got = got[0]
        yield path, np.swapaxes(got, -1, -2) if transposed else got


def row_batch(S=16, seed=7):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 250, (2, S)).astype(np.int32)
    return {"input_ids": ids,
            "position_ids": np.tile(np.arange(S, dtype=np.int32), (2, 1)),
            "labels": ids.copy()}


@pytest.mark.parametrize("family", sorted(HF_CONFIGS))
def test_weights_logits_and_every_gradient_match_jax(tmp_path, family):
    write_hf_dir(tmp_path, HF_CONFIGS[family])
    jm, model = load_both(tmp_path)
    assert type(model).__name__ == type(jm).__name__
    # the rope tables (Phi-3's at its partial rotary dim, 8 of 16)
    np.testing.assert_array_equal(model.inv_freq.numpy(),
                                  np.asarray(jm.inv_freq))
    assert model._rotary_dim() == getattr(jm, "_rotary_dim", 16)
    flat = _flat(jm.params)
    seen = set()
    for path, got in _leaf_values(model):
        np.testing.assert_array_equal(got, flat[path], err_msg=str(path))
        seen.add(path)
    assert seen == set(flat)

    batch = row_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlogits = np.asarray(jm(jm.params, jb["input_ids"])["logits"])
    with torch.no_grad():
        logits = model(tb["input_ids"])["logits"].numpy()
    assert rel_l2(logits, jlogits) < REL
    losses = [(JaxCE(), MaskedCrossEntropy())]
    if family == "granite":
        losses.append((JaxFused(), FusedLinearCrossEntropy()))
    for jloss_fn, loss_fn in losses:
        jloss, jgrads = jax.value_and_grad(
            lambda p: _microbatch_loss(jm, jloss_fn, p, jb))(jm.params)
        model.zero_grad(set_to_none=True)
        loss = microbatch_loss(model, loss_fn, tb)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-6)
        jflat = _flat(jgrads)
        for path, got in _leaf_values(model, grad=True):
            assert rel_l2(got, jflat[path]) < REL, path


def test_a_jax_written_directory_reads_in_the_port(tmp_path):
    """StarCoder-2 (biases, LayerNorms) saved by the JAX writer loads in the
    port bit for bit."""
    write_hf_dir(tmp_path / "src", HF_CONFIGS["starcoder2"], seed=3)
    jm, _ = load_both(tmp_path / "src")
    jhf.save_hf_weights(jm, jm.params, str(tmp_path / "jax"))
    model = auto_model.AutoModelForCausalLM.from_pretrained(
        str(tmp_path / "jax"), load_weights=True, device="cpu")
    flat = _flat(jm.params)
    for path, got in _leaf_values(model):
        np.testing.assert_array_equal(got, flat[path], err_msg=str(path))


@pytest.mark.parametrize("family", sorted(HF_CONFIGS))
def test_greedy_tokens_match_the_jax_engine(tmp_path, family):
    write_hf_dir(tmp_path, HF_CONFIGS[family], seed=1)
    jm, model = load_both(tmp_path)
    models = (jm, jm.params, model)
    prompts = seeded_prompts(3, (5, 11, 17, 8))
    tokens = {}
    for kind in ("jax", "port"):
        eng = make_engine(kind, models)
        rids = [eng.submit(p) for p in prompts]
        eng.run()
        tokens[kind] = [list(eng.requests[r].out_tokens) for r in rids]
    assert tokens["port"] == tokens["jax"]
    assert all(len(t) == 8 for t in tokens["port"])


@pytest.mark.parametrize("family", sorted(HF_CONFIGS))
def test_dense_cache_forward_matches_cache_free(tmp_path, family):
    """``generate()``'s dense decode cache (prefill, then one token at a
    time) gives the cache-free logits: Granite's scale and multipliers,
    OLMo-2's norms, StarCoder-2's window and Phi-3's partial rotary reach
    the cached path."""
    write_hf_dir(tmp_path, HF_CONFIGS[family], seed=4)
    model = auto_model.AutoModelForCausalLM.from_pretrained(
        str(tmp_path), load_weights=True, device="cpu",
        compute_dtype=torch.float32).eval()
    ids = torch.from_numpy(np.random.default_rng(5).integers(2, 250, (2, 12)))
    with torch.no_grad():
        want = model(ids)["logits"]
        cache = model.init_kv_cache(2, 12, dtype=torch.float32)
        got = [model(ids[:, :8], kv_cache=cache, cache_index=0)["logits"]]
        for t in range(8, 12):
            got.append(model(ids[:, t:t + 1], kv_cache=cache,
                             cache_index=t)["logits"])
    torch.testing.assert_close(torch.cat(got, 1), want, rtol=1e-5, atol=1e-5)


def test_starcoder2_flops_count_its_two_mlp_matrices():
    """A recorded difference from JAX (ROADMAP Queue 3): the JAX
    StarCoder-2 inherits the Llama count, three MLP matrices; the port's
    ``flops_per_token`` counts StarCoder-2's two (``c_fc``, ``c_proj``).
    Every other family's count is JAX's."""
    cfg = HF_CONFIGS["starcoder2"]
    jm = jauto.AutoModelForCausalLM.from_config(dict(cfg))
    model = auto_model.AutoModelForCausalLM.from_config(dict(cfg),
                                                        device="cpu")
    L, H, I = 2, cfg["hidden_size"], cfg["intermediate_size"]
    assert model.flops_per_token() == jm.flops_per_token() - 6.0 * L * H * I
    for family in ("granite", "olmo2", "phi3"):
        jm = jauto.AutoModelForCausalLM.from_config(dict(HF_CONFIGS[family]))
        model = auto_model.AutoModelForCausalLM.from_config(
            dict(HF_CONFIGS[family]), device="cpu")
        assert model.flops_per_token() == jm.flops_per_token(), family


@pytest.mark.parametrize("seq_len", [1, 8, 9, 64])
@pytest.mark.parametrize("original", [None, 8])
def test_longrope_tables_match_jax(seq_len, original):
    """Both branches (short up to the original length, long past it) and
    the amplitude, with and without a config-level original length."""
    scaling = dict(LONGROPE, factor=4.0)
    kw = dict(max_position_embeddings=32,
              original_max_position_embeddings=original, seq_len=seq_len)
    got, got_scale = rotary.rope_tables(8, 10000.0, scaling, **kw)
    want, want_scale = jrotary.rope_parameters(8, 10000.0, scaling, **kw)
    np.testing.assert_array_equal(got, want)
    assert got_scale == want_scale
    assert got_scale > 1.0


def test_longrope_phi3_picks_its_table_by_position_as_jax(tmp_path):
    """A longrope Phi-3: the model's two tables equal JAX's, and logits on
    rows of 6 (short) and 16 (long) match."""
    write_hf_dir(tmp_path, PHI3_LONGROPE, seed=2)
    jm, model = load_both(tmp_path)
    assert model._rotary_dim() == jm._rotary_dim == 16
    np.testing.assert_array_equal(model.inv_freq.numpy(),
                                  np.asarray(jm.inv_freq))
    np.testing.assert_array_equal(model.inv_freq_long.numpy(),
                                  np.asarray(jm._rope_long[0]))
    assert model.rope_attention_scaling == jm.rope_attention_scaling
    assert model.rope_original_max == jm._rope_original_max == 8
    for S in (6, 16):
        ids = np.random.default_rng(S).integers(2, 250, (2, S))
        want = np.asarray(jm(jm.params, jnp.asarray(ids, jnp.int32))[
            "logits"])
        with torch.no_grad():
            got = model(torch.from_numpy(ids))["logits"].numpy()
        assert rel_l2(got, want) < REL, S


@pytest.mark.parametrize("window", [None, 7])
def test_head_dim_96_padded_route_matches_unpadded_plain(window):
    """Kernel 9's wrapper route for head_dim 96: q, k, v, out and dout
    zero-padded to 128, the scale 96 ** -0.5, results sliced back."""
    assert sa.padded_head_dim(96) == 128
    assert sa.padded_head_dim(128) is None and sa.padded_head_dim(512) is None
    rng = np.random.default_rng(0)
    B, S, Hq, Hk, D = 2, 24, 4, 2, 96
    q, k, v, dout = (torch.from_numpy(
        rng.standard_normal((B, S, h, D)).astype(np.float32))
        for h in (Hq, Hk, Hk, Hq))
    seg = torch.from_numpy(np.repeat([[1] * 10 + [2] * 14], B, 0).astype(
        np.int32))
    kw = dict(causal=True, segment_ids=seg, local_window_size=window)
    out, lse = sa.splash_attention_plain(q, k, v, **kw)
    grads = sa.splash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    qp, kp, vp, dop = sa._pad_channels(128, q, k, v, dout)
    kw["scale"] = D ** -0.5
    out_p, lse_p = sa.splash_attention_plain(qp, kp, vp, **kw)
    assert float(out_p[..., D:].abs().max()) == 0.0
    grads_p = sa.splash_attention_bwd_plain(qp, kp, vp, out_p, lse_p, dop,
                                            **kw)
    assert rel_l2(out_p[..., :D].numpy(), out.numpy()) < REL
    assert rel_l2(lse_p.numpy(), lse.numpy()) < REL
    for got, want in zip(grads_p, grads):
        assert rel_l2(got[..., :D].numpy(), want.numpy()) < REL
