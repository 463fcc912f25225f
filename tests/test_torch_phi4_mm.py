"""The port's Phi-4-multimodal (``models/phi4_mm.py``) against the JAX package
on the CPU, fp32, tiny widths, inputs from numpy seeds.

* The configs from an HF dict: the text fields at the top level,
  ``audio_config`` nested, ``vision_config`` dropped, HF's remote-code
  spelling ``depthwise_seperable_out_channel`` dropped to the default in
  both packages; the derived ``head_dim``, ``nemo_final_size`` and
  ``num_buckets``.
* The subsampling stack at ``time_reduction`` 4 and 8, and the relative
  bias (symmetric and not), within 1e-6 (the bias gathers: exact).
* The encoder on a batch of two clips of different lengths: the +1 mask
  (padded frames are not masked to -inf, so the padding's content reaches
  the valid frames, in both packages), outputs within 1e-5 relative and
  every encoder gradient within 1e-4 (atol 1e-5 of the largest gradient);
  the convolution module alone the same.  Measured: about 1e-6.
* The whole model (partial rotary 0.5, untied head) on audio + text and
  on text alone: logits, the MaskedCE loss and every leaf's gradient
  within 5e-5 relative (atol 5e-5 of the leaf's largest element, and at
  least 1e-2 of the largest gradient of its sub-tree).  Measured: about
  1e-6; fp32 sums in another order.
* The flat audio scatter over a batch whose rows hold 0, 1 and 2 clips
  (JAX's cross-batch order; ``audio_embed_sizes`` None = every clip full).
* The refusals: more than 500 frames after subsampling, a streaming
  ``chunk_size``, a LoRA bypass on the fused projections (the JAX
  message).
* ``load_jax_params`` fills every parameter; HF directories cross the
  packages both ways bit for bit (JAX-written read by the port,
  port-written read by JAX), and the port's ``config.json`` (HF's layout)
  builds the same model through ``from_pretrained``; FLOPs per token equal
  JAX's.

Weights are the JAX init plus N(0, 0.1) on every leaf, so that no path is
zero (the GLU's channel biases and the normalisation start at 0 / 1).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.loss.masked_ce import MaskedCrossEntropy as JaxCE
from automodel_tpu.models import hf_io as jhf
from automodel_tpu.models import phi4_mm as jp
from automodel_tpu.training.train_step import _microbatch_loss
from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
from automodel_tpu_torch.models import hf_io
from automodel_tpu_torch.models import phi4_mm as tp
from automodel_tpu_torch.models.auto_model import (
    AutoModelForImageTextToText,
    build_model,
)
from automodel_tpu_torch.models.llama import LayerAdapter
from automodel_tpu_torch.models.weights import jax_leaves, load_jax_params
from automodel_tpu_torch.training.train_step import microbatch_loss

torch.set_num_threads(1)

REL = 5e-5
AUDIO_TOKEN = 200
AUDIO = dict(hidden_size=32, intermediate_size=48, num_blocks=2,
             num_attention_heads=4, ext_pw_out_channel=32,
             depthwise_separable_out_channel=32, kernel_size=3,
             input_size=20, time_reduction=4, bias_max_distance=16,
             nemo_conv_channels=16, audio_token_id=AUDIO_TOKEN)
TINY = dict(model_type="phi4_multimodal", vocab_size=256, hidden_size=64,
            intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            rope_theta=10000.0, max_position_embeddings=128,
            tie_word_embeddings=False, partial_rotary_factor=0.5,
            audio_config=AUDIO)


def _flat(tree):
    return {tuple(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _perturbed(params, seed=5):
    leaves, td = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(td, [
        np.asarray(l) + 0.1 * rng.normal(size=l.shape).astype(np.float32)
        for l in leaves])


def _grads_match(targets_by_path, jgrads, rel, top_of=lambda p: p[0]):
    flat = _flat(jgrads)
    tops = {}
    for p, g in flat.items():
        tops[top_of(p)] = max(tops.get(top_of(p), 0.0), np.abs(g).max())
    seen = set()
    for path, target, transposed in targets_by_path:
        targets = target if isinstance(target, list) else [target]
        # an unused leaf (the vision_speech projectors) has no gradient:
        # JAX's is zeros
        got = np.stack([np.zeros(tuple(p.shape), np.float32) if p.grad is None
                        else p.grad.numpy() for p in targets])
        if not isinstance(target, list):
            got = got[0]
        if transposed:
            got = np.swapaxes(got, -1, -2)
        np.testing.assert_allclose(got, flat[path], rtol=rel,
                                   atol=rel * max(np.abs(flat[path]).max(),
                                                  1e-2 * tops[top_of(path)]),
                                   err_msg=".".join(path))
        seen.add(path)
    assert seen == set(flat)


def _pair(cfg=TINY, seed=0):
    jm = jp.Phi4MMForCausalLM(jp.Phi4MMConfig.from_hf_config(
        json.loads(json.dumps(cfg))), param_dtype=jnp.float32,
        compute_dtype=jnp.float32, remat=False)
    params = _perturbed(jax.jit(jm.init)(jax.random.key(seed)))
    model = tp.build_phi4_mm(json.loads(json.dumps(cfg)), device="cpu",
                             compute_dtype=torch.float32)
    load_jax_params(model, params)
    return jm, params, model


def _encoder_pair(audio=AUDIO, seed=1):
    jcfg = jp.Phi4MMAudioConfig.from_hf_config(audio)
    je = jp.Phi4MMAudioEncoder(jcfg, param_dtype=jnp.float32,
                               compute_dtype=jnp.float32, remat=False)
    params = _perturbed(jax.jit(je.init)(jax.random.key(seed)))
    enc = tp.Phi4MMAudioEncoder(tp.Phi4MMAudioConfig.from_hf_config(audio),
                                compute_dtype=torch.float32, device="cpu")
    load_jax_params(enc, params)
    return je, params, enc


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _clips(rng, frames, F=20):
    feats = np.zeros((len(frames), max(frames), F), np.float32)
    mask = np.zeros((len(frames), max(frames)), bool)
    for i, f in enumerate(frames):
        feats[i, :f] = rng.normal(size=(f, F))
        mask[i, :f] = True
    return feats, mask


def test_configs_from_an_hf_dict_match_jax():
    hf = dict(TINY, vision_config={"hidden_size": 8},
              audio_config=dict(AUDIO, depthwise_seperable_out_channel=7,
                                depthwise_separable_out_channel=None))
    hf["audio_config"].pop("depthwise_separable_out_channel")
    ours = tp.Phi4MMConfig.from_hf_config(hf)
    theirs = jp.Phi4MMConfig.from_hf_config(hf)
    a, b = ours.audio_config, theirs.audio_config
    for f in ("hidden_size", "num_blocks", "depthwise_separable_out_channel",
              "time_reduction", "bias_max_distance", "audio_token_id"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.depthwise_separable_out_channel == 1024      # the default
    assert (a.head_dim, a.nemo_final_size, a.num_buckets) == (
        b.head_dim, b.nemo_final_size, b.num_buckets) == (8, 5, 32)
    t, u = ours.text_config, theirs.text_config
    for f in ("vocab_size", "hidden_size", "num_attention_heads", "head_dim",
              "partial_rotary_factor", "tie_word_embeddings"):
        assert getattr(t, f) == getattr(u, f), f
    assert t.model_type == u.model_type == "phi4_multimodal_text"
    sym = tp.Phi4MMAudioConfig.from_hf_config(dict(AUDIO,
                                                   bias_symmetric=True))
    assert sym.num_buckets == 16


@pytest.mark.parametrize("tr", [4, 8])
def test_subsampling_matches_jax(tr):
    audio = dict(AUDIO, time_reduction=tr)
    je, params, enc = _encoder_pair(audio)
    rng = np.random.default_rng(tr)
    x = rng.normal(size=(2, 45, 20)).astype(np.float32)
    ref = np.asarray(je._subsample(jnp.asarray(x),
                                   jax.tree.map(jnp.asarray, params)))
    with torch.no_grad():
        got = enc.subsample(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, enc.out_frames(45), 32)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("symmetric", [False, True])
def test_relative_bias_matches_jax(symmetric):
    audio = dict(AUDIO, bias_symmetric=symmetric, bias_max_distance=5)
    je, params, enc = _encoder_pair(audio)
    ref = np.asarray(je._rel_bias(jax.tree.map(jnp.asarray, params), 13))
    with torch.no_grad():
        got = enc.rel_bias(13).numpy()
    assert got.shape == (1, 4, 13, 13)
    np.testing.assert_array_equal(got, ref)


def test_encoder_with_the_additive_mask_and_its_gradients_match_jax():
    je, params, enc = _encoder_pair()
    rng = np.random.default_rng(3)
    feats, mask = _clips(rng, [40, 24])
    w = rng.normal(size=(2, 10, 32)).astype(np.float32)
    jpar = jax.tree.map(jnp.asarray, params)

    def jfwd(p, f):
        return je(p, f, jnp.asarray(mask))

    ref = np.asarray(jax.jit(jfwd)(jpar, jnp.asarray(feats)))
    _, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(jfwd(p, jnp.asarray(feats)) * w)))(jpar)
    out = enc(torch.from_numpy(feats), torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    (out * torch.from_numpy(w)).sum().backward()
    _grads_match(jax_leaves(enc), jgrads, 1e-4, top_of=lambda p: 0)
    # the +1 mask: the padding's content reaches the short clip's valid
    # frames, in both packages
    other = feats.copy()
    other[1, 24:] = rng.normal(size=(16, 20))
    with torch.no_grad():
        moved = enc(torch.from_numpy(other), torch.from_numpy(mask)).numpy()
    jmoved = np.asarray(jax.jit(jfwd)(jpar, jnp.asarray(other)))
    assert np.abs(moved[1, :6] - out.detach().numpy()[1, :6]).max() > 1e-4
    np.testing.assert_allclose(moved, jmoved, rtol=1e-5,
                               atol=1e-5 * np.abs(jmoved).max())


def test_conv_module_and_its_gradients_match_jax():
    je, params, enc = _encoder_pair()
    block = jax.tree.map(lambda a: jnp.asarray(a[0]),
                         params["encoders"])["conv"]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 32)).astype(np.float32)
    w = rng.normal(size=(2, 9, 32)).astype(np.float32)
    cfg = je.config

    def jfwd(p, xx):
        return jp._conv_module(xx, p, cfg, jnp.float32)

    ref = np.asarray(jfwd(block, jnp.asarray(x)))
    jgx = np.asarray(jax.grad(lambda xx: jnp.sum(jfwd(block, xx) * w))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    out = enc._conv_module(enc.blocks[0].conv, xt)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-6)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), jgx, rtol=1e-5, atol=1e-6)


def _audio_batch(rng, frames=(40, 24), rows=None):
    """Two rows of text around each clip's placeholders, right-padded, the
    labels the ids."""
    feats, mask = _clips(rng, list(frames))
    sizes = np.asarray([int(np.ceil(f / 4)) for f in frames], np.int32)
    ids = []
    for n in sizes:
        row = (rng.integers(1, 190, 4).tolist() + [AUDIO_TOKEN] * int(n)
               + rng.integers(1, 190, 5).tolist())
        ids.append(row + [0] * (19 - len(row)))
    ids = np.asarray(ids, np.int32)
    return {"input_ids": ids, "labels": np.where(ids > 0, ids, -100),
            "input_audio_embeds": feats, "audio_embed_sizes": sizes,
            "audio_attention_mask": mask}


def _check_step(jm, params, model, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jpar = jax.tree.map(jnp.asarray, params)
    kw = {k: v for k, v in jb.items() if k not in ("input_ids", "labels")}
    ref = np.asarray(jax.jit(lambda p: jm(p, jb["input_ids"], **kw)[
        "logits"])(jpar))
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    with torch.no_grad():
        out = model(t["input_ids"], **{k: v for k, v in t.items()
                                       if k not in ("input_ids", "labels")})
    np.testing.assert_allclose(out["logits"].numpy(), ref, rtol=REL,
                               atol=REL * np.abs(ref).max())
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: _microbatch_loss(jm, JaxCE(), p, jb)))(jpar)
    model.zero_grad(set_to_none=True)
    loss = microbatch_loss(model, MaskedCrossEntropy(), t)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=REL)
    return jgrads


def test_audio_and_text_step_matches_jax(pair):
    jm, params, model = pair
    batch = _audio_batch(np.random.default_rng(6))
    jgrads = _check_step(jm, params, model, batch)
    _grads_match(jax_leaves(model), jgrads, REL)


def test_text_only_step_matches_jax(pair):
    jm, params, model = pair
    rng = np.random.default_rng(7)
    ids = rng.integers(1, 190, (2, 16)).astype(np.int32)
    jgrads = _check_step(jm, params, model,
                         {"input_ids": ids, "labels": ids.copy()})
    flat = _flat(jgrads)
    assert not np.abs(flat[("audio_embed", "up_proj_for_speech",
                            "kernel")]).any()
    for path, target, transposed in jax_leaves(model):
        if path[0] == "audio_embed":
            ts = target if isinstance(target, list) else [target]
            assert all(p.grad is None or not p.grad.any() for p in ts)
    _grads_match([l for l in jax_leaves(model) if l[0][0] != "audio_embed"],
                 {"language_model": jgrads["language_model"]}, REL)


@pytest.mark.parametrize("sizes_given", [True, False])
def test_flat_scatter_over_rows_of_zero_one_and_two_clips(pair, sizes_given):
    """Row 0 holds no clip, row 1 one, row 2 two: the placeholders take the
    clips' valid frames in one order over the whole batch."""
    jm, params, model = pair
    rng = np.random.default_rng(8)
    frames = [32, 20, 28] if sizes_given else [32, 32, 32]
    feats, mask = _clips(rng, frames)
    sizes = np.asarray([int(np.ceil(f / 4)) for f in frames], np.int32)
    rows = [rng.integers(1, 190, 12).tolist(),
            [AUDIO_TOKEN] * int(sizes[0]) + rng.integers(1, 190, 4).tolist(),
            ([AUDIO_TOKEN] * int(sizes[1]) + [7]
             + [AUDIO_TOKEN] * int(sizes[2]))]
    width = max(len(r) for r in rows)
    ids = np.asarray([r + [0] * (width - len(r)) for r in rows], np.int32)
    kw = dict(input_audio_embeds=feats,
              audio_embed_sizes=sizes if sizes_given else None)
    ref = np.asarray(jm(jax.tree.map(jnp.asarray, params), jnp.asarray(ids),
                        **{k: None if v is None else jnp.asarray(v)
                           for k, v in kw.items()})["logits"])
    with torch.no_grad():
        got = model(torch.from_numpy(ids), **{
            k: None if v is None else torch.from_numpy(v)
            for k, v in kw.items()})["logits"].numpy()
    np.testing.assert_allclose(got, ref, rtol=REL,
                               atol=REL * np.abs(ref).max())


def test_the_refusals_of_both_packages(pair):
    jm, params, model = pair
    je, eparams, enc = _encoder_pair()
    long = np.zeros((1, 4 * 501, 20), np.float32)
    with pytest.raises(AssertionError, match="exceeds the absolute"):
        je(jax.tree.map(jnp.asarray, eparams), jnp.asarray(long))
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="exceeds the absolute"):
        enc(torch.from_numpy(long))
    chunked = dict(AUDIO, chunk_size=8)
    je2, p2, enc2 = _encoder_pair(chunked)
    short = np.zeros((1, 16, 20), np.float32)
    with pytest.raises(NotImplementedError, match="streaming chunk"):
        je2(jax.tree.map(jnp.asarray, p2), jnp.asarray(short))
    with torch.no_grad(), pytest.raises(NotImplementedError,
                                        match="streaming chunk"):
        enc2(torch.from_numpy(short))
    lm = model.language_model
    ad = LayerAdapter(A=torch.zeros(64, 2), B=torch.zeros(2, 64 + 64))
    with pytest.raises(NotImplementedError,
                       match="rank-r LoRA bypass is not wired"):
        lm(torch.ones(1, 4, dtype=torch.long),
           adapters=[{"self_attn.qkv_proj": ad}] * 2)


def test_load_jax_params_fills_every_leaf(pair):
    jm, params, model = pair
    flat = _flat(params)
    paths = {p for p, _, _ in jax_leaves(model)}
    assert paths == set(flat)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(a.size for a in flat.values()) == model.num_params


def test_hf_directories_cross_the_packages_both_ways(pair, tmp_path):
    jm, params, model = pair
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jhf.save_hf_weights(jm, jax.tree.map(jnp.asarray, params), str(jdir))
    fresh = tp.build_phi4_mm(json.loads(json.dumps(TINY)), device="cpu",
                             seed=9)
    hf_io.load_hf_weights(fresh, str(jdir))
    for (path, a, _), (_, b, _) in zip(jax_leaves(model), jax_leaves(fresh)):
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            assert torch.equal(x, y), path
    hf_io.save_hf_weights(model, str(pdir))
    back = _flat(jhf.load_hf_weights(jm, str(pdir)))
    for path, want in _flat(params).items():
        np.testing.assert_array_equal(np.asarray(back[path]), want,
                                      err_msg=".".join(path))
    with open(pdir / "config.json") as f:
        cfg = json.load(f)
    assert cfg["architectures"] == ["Phi4MultimodalForCausalLM"]
    assert cfg["hidden_size"] == 64 and cfg["audio_config"][
        "hidden_size"] == 32
    again = AutoModelForImageTextToText.from_pretrained(
        str(pdir), load_weights=True, device="cpu",
        compute_dtype=torch.float32)
    assert isinstance(again, tp.Phi4MMForCausalLM)
    for (path, a, _), (_, b, _) in zip(jax_leaves(model), jax_leaves(again)):
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            assert torch.equal(x, y), path


def test_build_model_and_flops(pair):
    jm, _, model = pair
    assert model.flops_per_token() == jm.flops_per_token()
    m = build_model({"model_type": "phi4_multimodal", **TINY}, device="cpu")
    assert isinstance(m, tp.Phi4MMForCausalLM)
    # the encoder's count grows with the clips and their frames
    assert model.audio_flops(2, 40) == 2 * model.audio_flops(1, 40)
    assert model.audio_flops(1, 80) > 2 * model.audio_flops(1, 40) * 0.9
