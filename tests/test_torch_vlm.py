"""The port's VLM models (``models/vision.py``, ``models/gemma3.py``'s
``Gemma3ForConditionalGeneration``, ``models/vlm.py``'s llava and
``merge_image_embeds``) against the JAX package on the CPU, fp32.

* The SigLIP tower on seeded images: ``patchify`` equal, features within
  1e-5 relative (atol 1e-5 of the largest element: fp32, sums in another
  order), and every leaf's gradient of a seeded projection of the
  features within 1e-4 relative (atol 1e-5 of the tower's largest
  gradient).
* ``merge_image_embeds`` in the per-row slot layout ``[B, I, H, W, C]``
  (rows with 0, 1 and 2 images) and the flat layout: equal to JAX's.
* Gemma-3 VL (window and full layers at head_dim 256, pooled image tokens)
  and llava: logits on rows with image placeholders, the MaskedCE loss and
  every leaf's gradient within 5e-5 of ``jax.value_and_grad`` of the JAX
  step's loss, the tower's within 2e-4 (its gradients pass the decoder
  and the projector first); atol that tolerance times the leaf's largest
  element, and at least 1e-2 of its sub-tree's (the tower's ``k_proj``
  bias has a gradient of 0 up to rounding).
* HF repos of both families written by one package read by the other both
  ways (the patch embedding through HF's Conv2d layout), and
  ``from_pretrained`` over a local directory; ``flops_per_image`` equal.
* The int8 base (``peft.quantize_base``) refused on both VLMs, as the JAX
  transform fails on their trees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.loss.masked_ce import MaskedCrossEntropy as JaxCE
from automodel_tpu.models import hf_io as jhf
from automodel_tpu.models.gemma3 import Gemma3ForConditionalGeneration as JG3
from automodel_tpu.models.gemma3 import Gemma3VLConfig as JaxG3Config
from automodel_tpu.models.vision import VisionConfig as JaxVisionConfig
from automodel_tpu.models.vision import VisionTower as JaxVisionTower
from automodel_tpu.models.vlm import VLMConfig as JaxVLMConfig
from automodel_tpu.models.vlm import VLMForConditionalGeneration as JaxLlava
from automodel_tpu.models.vlm import merge_image_embeds as jax_merge
from automodel_tpu.training.train_step import _microbatch_loss
from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
from automodel_tpu_torch.models import hf_io
from automodel_tpu_torch.models.auto_model import (
    AutoModelForImageTextToText,
)
from automodel_tpu_torch.models.gemma3 import (
    Gemma3ForConditionalGeneration,
    Gemma3VLConfig,
)
from automodel_tpu_torch.models.vision import VisionConfig, VisionTower
from automodel_tpu_torch.models.vlm import (
    VLMConfig,
    VLMForConditionalGeneration,
    merge_image_embeds,
)
from automodel_tpu_torch.models.weights import jax_leaves, load_jax_params
from automodel_tpu_torch.training.train_step import microbatch_loss

torch.set_num_threads(1)

REL = 5e-5
IMG = 7            # the image placeholder id of both configs
VISION = dict(hidden_size=24, intermediate_size=48, num_hidden_layers=2,
              num_attention_heads=4, image_size=16, patch_size=4)
FAMILIES = {
    "gemma3": (dict(
        model_type="gemma3", image_token_index=IMG, mm_tokens_per_image=4,
        text_config=dict(
            model_type="gemma3_text", vocab_size=96, hidden_size=32,
            intermediate_size=64, num_hidden_layers=6,
            num_attention_heads=4, num_key_value_heads=2, head_dim=256,
            query_pre_attn_scalar=256.0, sliding_window=6,
            rope_scaling={"rope_type": "linear", "factor": 8.0}),
        vision_config=VISION), 4,
        JaxG3Config, JG3, Gemma3VLConfig, Gemma3ForConditionalGeneration),
    "llava": (dict(
        model_type="llava", image_token_id=IMG,
        text_config=dict(model_type="llama", vocab_size=96, hidden_size=32,
                         intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         rope_theta=10000.0),
        vision_config=VISION), 16,
        JaxVLMConfig, JaxLlava, VLMConfig, VLMForConditionalGeneration),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {tuple(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _perturbed(params, seed=5):
    leaves, td = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(td, [
        np.asarray(l) * 4.0 + 0.1 * rng.normal(size=l.shape).astype(
            np.float32) for l in leaves])


def make_pair(family, seed=0):
    cfg, _, jcfg_cls, jcls, cfg_cls, cls = FAMILIES[family]
    jm = jcls(jcfg_cls.from_hf_config(cfg), param_dtype=jnp.float32,
              compute_dtype=jnp.float32)
    params = _perturbed(jm.init(jax.random.key(seed)))
    model = cls(cfg_cls.from_hf_config(cfg), param_dtype=torch.float32,
                compute_dtype=torch.float32, device="cpu")
    load_jax_params(model, params)
    return jm, params, model


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def pair(request):
    return make_pair(request.param)


def image_batch(tokens, B=3, S=40, seed=2):
    """Rows with 2, 1 and 0 images (placeholder runs of ``tokens`` ids at
    random starts), labels = ids, and per-row image slots (2 each, the
    unused ones zero)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(8, 96, (B, S)).astype(np.int32)
    counts = [2, 1, 0][:B]
    for b, n in enumerate(counts):
        starts = [1, 3 + tokens + int(rng.integers(0, 4))][:n]
        for s in starts:
            ids[b, s:s + tokens] = IMG
    pv = np.zeros((B, 2, 16, 16, 3), np.float32)
    for b, n in enumerate(counts):
        pv[b, :n] = rng.normal(size=(n, 16, 16, 3))
    return {"input_ids": ids, "pixel_values": pv, "labels": ids.copy()}


def test_vision_tower_matches_jax():
    cfg = dict(VISION, num_channels=3)
    jt = JaxVisionTower(JaxVisionConfig(**cfg), param_dtype=jnp.float32,
                        compute_dtype=jnp.float32)
    params = _perturbed(jt.init(jax.random.key(1)))
    tower = VisionTower(VisionConfig(**cfg), param_dtype=torch.float32,
                        compute_dtype=torch.float32, device="cpu")
    load_jax_params(tower, params)
    rng = np.random.default_rng(0)
    pv = rng.normal(size=(3, 16, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tower.patchify(torch.from_numpy(pv)).numpy(),
        np.asarray(jt.patchify(jnp.asarray(pv))))
    w = rng.normal(size=(3, 16, 24)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jt(p, jnp.asarray(pv)) * w)

    want, jgrads = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray,
                                                          params))
    feats = tower(torch.from_numpy(pv))
    ref = np.asarray(jt(jax.tree.map(jnp.asarray, params), jnp.asarray(pv)))
    np.testing.assert_allclose(feats.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    (feats * torch.from_numpy(w)).sum().backward()
    flat = _flat(jgrads)
    # k_proj's bias moves every score of a row alike, so its gradient is 0
    # up to rounding: the atol is taken from the tower's largest gradient
    top = max(np.abs(g).max() for g in flat.values())
    for path, target, transposed in jax_leaves(tower):
        targets = target if isinstance(target, list) else [target]
        got = np.stack([p.grad.numpy() for p in targets])
        if not isinstance(target, list):
            got = got[0]
        if transposed:
            got = np.swapaxes(got, -1, -2)
        np.testing.assert_allclose(got, flat[path], rtol=1e-4,
                                   atol=1e-5 * top, err_msg=".".join(path))


@pytest.mark.parametrize("layout", ["slots", "flat"])
def test_merge_image_embeds_matches_jax(layout):
    rng = np.random.default_rng(3)
    B, S, H, P = 3, 24, 8, 4
    ids = rng.integers(8, 50, (B, S)).astype(np.int32)
    ids[0, 2:6] = ids[0, 10:14] = IMG       # two images
    ids[1, 5:9] = IMG                       # one
    embeds = rng.normal(size=(B, S, H)).astype(np.float32)
    if layout == "slots":                 # [B, I, h, w, C] images
        pv = rng.normal(size=(B, 2, 1, 3, H)).astype(np.float32)
    else:                                 # [B_img, h, w, C]
        pv = rng.normal(size=(3, 1, 3, H)).astype(np.float32)
    proj = rng.normal(size=(H, H)).astype(np.float32)

    def jenc(x):                          # [n, 1, 3, H] -> [n, P, H]
        y = (x.reshape(x.shape[0], 3, H) @ proj).sum(1, keepdims=True)
        return jnp.repeat(y, P, 1) + jnp.arange(
            P, dtype=jnp.float32)[None, :, None]

    def tenc(x):
        y = (x.reshape(x.shape[0], 3, H) @ torch.from_numpy(proj)).sum(
            1, keepdim=True)
        return y.repeat(1, P, 1) + torch.arange(
            P, dtype=torch.float32)[None, :, None]

    want = jax_merge(jnp.asarray(embeds), jnp.asarray(ids), jnp.asarray(pv),
                     jenc, IMG)
    got = merge_image_embeds(torch.from_numpy(embeds), torch.from_numpy(ids),
                             torch.from_numpy(pv), tenc, IMG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_logits_loss_and_grads_match_jax(pair):
    jm, params, model = pair
    tokens = FAMILIES[type(model).__name__.startswith("Gemma") and "gemma3"
                      or "llava"][1]
    batch = image_batch(tokens)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jax.tree.map(jnp.asarray, params)
    ref = np.asarray(jm(jp, jb["input_ids"],
                        pixel_values=jb["pixel_values"])["logits"])
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        out = model(t["input_ids"], pixel_values=t["pixel_values"])
    np.testing.assert_allclose(out["logits"].numpy(), ref, rtol=REL,
                               atol=REL * np.abs(ref).max())
    jloss, jgrads = jax.value_and_grad(
        lambda p: _microbatch_loss(jm, JaxCE(), p, jb))(jp)
    model.zero_grad(set_to_none=True)
    loss = microbatch_loss(model, MaskedCrossEntropy(), t)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=REL)
    flat = _flat(jgrads)
    top = {p[0]: max(np.abs(g).max() for q, g in flat.items() if q[0] == p[0])
           for p in flat}
    for path, target, transposed in jax_leaves(model):
        targets = target if isinstance(target, list) else [target]
        got = np.stack([p.grad.numpy() for p in targets])
        if not isinstance(target, list):
            got = got[0]
        if transposed:
            got = np.swapaxes(got, -1, -2)
        # the tower's k_proj bias has a gradient of 0 up to rounding: its
        # atol comes from the largest gradient of the leaf's sub-tree; the
        # tower's gradients come back through the decoder and the
        # projector, twice the sums of the decoder's own, hence 4x REL
        tol = 4 * REL if path[0] == "vision_tower" else REL
        np.testing.assert_allclose(got, flat[path], rtol=tol,
                                   atol=tol * max(np.abs(flat[path]).max(),
                                                  1e-2 * top[path[0]]),
                                   err_msg=".".join(path))
    assert model.flops_per_image() == jm.flops_per_image()
    assert model.flops_per_token() == jm.flops_per_token()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_hf_repos_cross_the_packages_both_ways(family, tmp_path):
    jm, params, model = make_pair(family, seed=4)
    cfg, _, _, _, cfg_cls, cls = FAMILIES[family]
    jhf.save_hf_weights(jm, _np(params), str(tmp_path / "jax"))
    fresh = cls(cfg_cls.from_hf_config(cfg), param_dtype=torch.float32,
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
    header, _ = hf_io.read_safetensors_header(
        str(tmp_path / "port" / hf_io.SAFETENSORS_FILE))
    patch = [n for n in header if n.endswith("patch_embedding.weight")]
    assert len(patch) == 1 and header[patch[0]]["shape"] == [24, 3, 4, 4]
    loaded = AutoModelForImageTextToText.from_pretrained(
        str(tmp_path / "port"), load_weights=True, device="cpu",
        param_dtype="float32", compute_dtype="float32")
    assert type(loaded) is cls
    for (_, a, _), (_, b, _) in zip(jax_leaves(loaded), jax_leaves(model)):
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            assert torch.equal(x, y)


def test_int8_base_is_refused_on_a_vlm(pair):
    """A VLM has no decoder stack at ``layers``: the port's int8 base
    (``peft.quantize_base``) raises rather than leave the base dense, as
    the JAX transform fails on the same tree; ``is_quantized`` is False."""
    from automodel_tpu.quantization import weight_only as jwo
    from automodel_tpu_torch.quantization import weight_only as wo

    _, params, model = pair
    with pytest.raises(KeyError):
        jwo.quantize_base_params(params)
    assert not wo.is_quantized(model)
    with pytest.raises(NotImplementedError, match="decoder stack"):
        wo.quantize_base_params(model)
    assert not wo.is_quantized(model)
