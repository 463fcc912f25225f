"""The port's Qwen2.5-VL (``models/qwen2_5_vl.py``) against the JAX package on
the CPU, fp32, tiny widths, inputs from numpy seeds.

* ``_grid_layout``: every array equal to JAX's at ``[1, 4, 4]``, at
  ``[1, 6, 6]`` (window 16 at patch 4: windows with pad slots) and at the
  video grid ``[2, 4, 4]``.
* The windowed tower at those grids: features within 1e-5 relative (atol
  1e-5 of the largest element; fp32 sums in another order), and every
  leaf's gradient of a seeded projection of the features within 1e-4
  (atol 1e-5 of the tower's largest gradient).  Pad query slots get 0
  from the port's attention and the mean of the v rows from JAX's SDPA;
  the scatter reads valid slots only, so neither shows.
* The M-RoPE decoder: logits for ``[B, S, 3]`` and ``[B, S]`` ids within
  5e-5 of JAX's.
* The whole model on image, video and text-only batches: logits, the
  MaskedCE loss and every leaf's gradient within 5e-5 relative (the
  tower's within 2e-4: its gradients pass the decoder first; atol that
  tolerance times the leaf's largest element, and at least 1e-2 of its
  sub-tree's; measured: about 1e-6 of each leaf's largest element).  A
  text-only batch sends no gradient into the tower, in either package.

Weights are the JAX init plus N(0, 0.1) noise on every leaf.  (Four times
the init plus that noise, as the SigLIP tests draw theirs, makes this
model's attention so sharp that fp32 rounding alone moves the video
batch's decoder gradients by 3e-4 relative; at these weights both
packages agree to 1e-6.)
* HF repos written by one package read by the other, bit for bit, both
  ways (the patch embedding through HF's Conv3d layout), the legacy flat
  names read too, and ``from_pretrained`` over a local directory with
  ``image_grid`` passed through.
* The RDR YAML's ``freeze_config``: the same mask as JAX's (the tower
  trainable, as its regex misses ``visual``; the embeddings frozen);
  ``flops_per_token`` equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.datasets.vlm.qwen_rope import (
    qwen_mrope_position_ids as jax_mrope_ids,
)
from automodel_tpu.loss.masked_ce import MaskedCrossEntropy as JaxCE
from automodel_tpu.models import hf_io as jhf
from automodel_tpu.models import qwen2_5_vl as jq
from automodel_tpu.training.train_step import _microbatch_loss
from automodel_tpu.utils.model_utils import (
    apply_parameter_freezing as jax_freezing,
)
from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
from automodel_tpu_torch.models import hf_io
from automodel_tpu_torch.models import qwen2_5_vl as tq
from automodel_tpu_torch.models.auto_model import (
    AutoModelForImageTextToText,
)
from automodel_tpu_torch.models.weights import jax_leaves, load_jax_params
from automodel_tpu_torch.training.train_step import microbatch_loss
from automodel_tpu_torch.utils.model_utils import make_freeze_mask

torch.set_num_threads(1)

REL = 5e-5
VISION = dict(depth=3, hidden_size=32, intermediate_size=64, num_heads=2,
              in_channels=3, patch_size=4, temporal_patch_size=2,
              spatial_merge_size=2, window_size=16,
              fullatt_block_indexes=[1], out_hidden_size=64)
CONFIG = dict(
    model_type="qwen2_5_vl", image_token_id=6, video_token_id=12,
    vision_start_token_id=5, tie_word_embeddings=True,
    text_config=dict(
        model_type="qwen2_5_vl_text", vocab_size=96, hidden_size=64,
        intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, rope_theta=10000.0,
        rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]}),
    vision_config=VISION)
IMAGE_GRID, VIDEO_GRID = (1, 6, 6), (2, 4, 4)
GRIDS = [(1, 4, 4), (1, 6, 6), (2, 4, 4)]


def _flat(tree):
    return {tuple(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _perturbed(params, seed=5):
    """The JAX init plus N(0, 0.1) on every leaf (norm weights around 1,
    biases away from 0)."""
    leaves, td = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(td, [
        np.asarray(l) + 0.1 * rng.normal(size=l.shape).astype(np.float32)
        for l in leaves])


def _grads_match(model, jgrads, rel_of):
    """Every leaf's ``.grad`` against the JAX gradient tree."""
    flat = _flat(jgrads)
    top = {p[0]: max(np.abs(g).max() for q, g in flat.items()
                     if q[0] == p[0]) for p in flat}
    for path, target, transposed in jax_leaves(model):
        targets = target if isinstance(target, list) else [target]
        got = np.stack([p.grad.numpy() for p in targets])
        if not isinstance(target, list):
            got = got[0]
        if transposed:
            got = np.swapaxes(got, -1, -2)
        tol = rel_of(path)
        np.testing.assert_allclose(got, flat[path], rtol=tol,
                                   atol=tol * max(np.abs(flat[path]).max(),
                                                  1e-2 * top[path[0]]),
                                   err_msg=".".join(path))


def make_pair(seed=0, **grids):
    jcfg = jq.Qwen25VLConfig.from_hf_config(json.loads(json.dumps(CONFIG)))
    jm = jq.Qwen25VLForConditionalGeneration(
        jcfg, param_dtype=jnp.float32, compute_dtype=jnp.float32, **grids)
    params = _perturbed(jm.init(jax.random.key(seed)))
    model = tq.Qwen25VLForConditionalGeneration(
        tq.Qwen25VLConfig.from_hf_config(json.loads(json.dumps(CONFIG))),
        param_dtype=torch.float32, compute_dtype=torch.float32,
        device="cpu", **grids)
    load_jax_params(model, params)
    return jm, params, model


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
def test_grid_layout_matches_jax(grid):
    args = (grid, 2, 16, 4, 16)
    got, want = tq._grid_layout(*args), jq._grid_layout(*args)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    if grid == (1, 6, 6):
        assert not got["valid"].all()       # the windows carry pad slots


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
def test_tower_and_its_gradients_match_jax(grid):
    jcfg = jq.Qwen25VisionConfig.from_hf_config(VISION)
    jt = jq.Qwen25VisionTower(jcfg, param_dtype=jnp.float32,
                              compute_dtype=jnp.float32)
    params = _perturbed(jt.init(jax.random.key(1)))
    tower = tq.Qwen25VisionTower(tq.Qwen25VisionConfig.from_hf_config(VISION),
                                 param_dtype=torch.float32,
                                 compute_dtype=torch.float32, device="cpu")
    load_jax_params(tower, params)
    rng = np.random.default_rng(0)
    L = int(np.prod(grid))
    patches = rng.normal(size=(2, L, jcfg.patch_dim)).astype(np.float32)
    units = L // 4
    w = rng.normal(size=(2, units, VISION["out_hidden_size"])).astype(
        np.float32)

    def jloss(p):
        return jnp.sum(jt(p, jnp.asarray(patches), grid) * w)

    jp = jax.tree.map(jnp.asarray, params)
    _, jgrads = jax.value_and_grad(jloss)(jp)
    ref = np.asarray(jt(jp, jnp.asarray(patches), grid))
    feats = tower(torch.from_numpy(patches), grid)
    np.testing.assert_allclose(feats.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    (feats * torch.from_numpy(w)).sum().backward()
    flat = _flat(jgrads)
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


def _rows(kind, B=2, S=40, seed=2):
    """``input_ids [B, S]`` with vision spans (vision start 5, then the
    placeholders) of ``kind`` ("image": rows with 1 and 2 images, "video":
    one video a row, "text": none), the flat patch rows and grids, and the
    JAX package's M-RoPE ids (``[B, S]`` for text)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(13, 96, (B, S)).astype(np.int32)
    out = {}
    if kind == "text":
        out["position_ids"] = np.broadcast_to(
            np.arange(S, dtype=np.int32), (B, S)).copy()
    else:
        grid = IMAGE_GRID if kind == "image" else VIDEO_GRID
        tok = 6 if kind == "image" else 12
        units = grid[0] * (grid[1] // 2) * (grid[2] // 2)
        counts = [1, 2] if kind == "image" else [1, 1]
        for b, n in enumerate(counts):
            pos = 2
            for _ in range(n):
                ids[b, pos] = 5
                ids[b, pos + 1:pos + 1 + units] = tok
                pos += units + 3
        n = sum(counts)
        pv = rng.normal(size=(n * int(np.prod(grid)), 96)).astype(np.float32)
        g = np.asarray([grid] * n, np.int32)
        key = "" if kind == "image" else "_videos"
        out[f"pixel_values{key}"] = pv
        out[f"{kind}_grid_thw"] = g
        out["position_ids"] = jax_mrope_ids(
            ids, g if kind == "image" else None,
            video_grid_thw=g if kind == "video" else None,
            second_per_grid_ts=(np.asarray([0.5] * n) if kind == "video"
                                else None),
            image_token_id=6, video_token_id=12, vision_start_token_id=5)
    out["input_ids"] = ids
    out["labels"] = ids.copy()
    return out


@pytest.fixture(scope="module")
def pair():
    return make_pair(image_grid=IMAGE_GRID, video_grid=VIDEO_GRID)


@pytest.mark.parametrize("ids", ["mrope", "plain"])
def test_text_model_rope_matches_jax(ids, pair):
    jm, params, model = pair
    batch = _rows("image")
    pos = batch["position_ids"]
    if ids == "plain":
        pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)).copy()
    jp = jax.tree.map(jnp.asarray, params)
    ref = np.asarray(jm.language_model(jp["language_model"],
                                       jnp.asarray(batch["input_ids"]),
                                       position_ids=jnp.asarray(pos))[
        "logits"])
    with torch.no_grad():
        got = model.language_model(torch.from_numpy(batch["input_ids"]),
                                   position_ids=torch.from_numpy(pos))
    np.testing.assert_allclose(got["logits"].numpy(), ref, rtol=REL,
                               atol=REL * np.abs(ref).max())


@pytest.mark.parametrize("kind", ["image", "video", "text"])
def test_logits_loss_and_grads_match_jax(kind, pair):
    jm, params, model = pair
    batch = _rows(kind)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jax.tree.map(jnp.asarray, params)
    kwargs = {k: v for k, v in jb.items() if k not in ("input_ids",
                                                         "labels")}
    ref = np.asarray(jm(jp, jb["input_ids"], **kwargs)["logits"])
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        out = model(t["input_ids"], **{k: v for k, v in t.items()
                                       if k not in ("input_ids", "labels")})
    np.testing.assert_allclose(out["logits"].numpy(), ref, rtol=REL,
                               atol=REL * np.abs(ref).max())
    jloss, jgrads = jax.value_and_grad(
        lambda p: _microbatch_loss(jm, JaxCE(), p, jb))(jp)
    model.zero_grad(set_to_none=True)
    loss = microbatch_loss(model, MaskedCrossEntropy(), t)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=REL)
    if kind == "text":
        # the tower takes no part: no gradient reaches it on either side
        assert all(p.grad is None for p in model.visual.parameters())
        assert all(not np.abs(g).any()
                   for g in jax.tree.leaves(_np(jgrads["visual"])))
        return
    _grads_match(model, jgrads,
                 lambda path: 4 * REL if path[0] == "visual" else REL)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_batch_key_outside_extra_batch_keys_is_refused(pair):
    _, _, model = pair
    batch = {k: torch.from_numpy(v) for k, v in _rows("image").items()}
    batch["input_audio_embeds"] = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="not consumed"):
        microbatch_loss(model, MaskedCrossEntropy(), batch)


def test_patch_count_must_divide_the_grid(pair):
    _, _, model = pair
    with pytest.raises(ValueError, match="does not divide"):
        model.encode_images(torch.zeros(37, 96), IMAGE_GRID)


def test_hf_repos_cross_the_packages_both_ways(tmp_path):
    jm, params, model = make_pair(seed=4, image_grid=IMAGE_GRID)
    jhf.save_hf_weights(jm, _np(params), str(tmp_path / "jax"))
    fresh = tq.Qwen25VLForConditionalGeneration(
        tq.Qwen25VLConfig.from_hf_config(json.loads(json.dumps(CONFIG))),
        param_dtype=torch.float32, compute_dtype=torch.float32,
        device="cpu")
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
    assert header["model.visual.patch_embed.proj.weight"]["shape"] == [
        32, 3, 2, 4, 4]
    assert "model.language_model.layers.1.self_attn.q_proj.bias" in header
    assert "model.visual.merger.mlp.2.bias" in header
    # the older flat naming (``model.layers.`` / ``visual.``) reads too
    state = hf_io.read_safetensors(
        str(tmp_path / "port" / hf_io.SAFETENSORS_FILE))
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    hf_io.write_safetensors(str(legacy / hf_io.SAFETENSORS_FILE), {
        n.replace("model.language_model.", "model.").replace(
            "model.visual.", "visual."): t for n, t in state.items()})
    flat = tq.Qwen25VLForConditionalGeneration(
        tq.Qwen25VLConfig.from_hf_config(json.loads(json.dumps(CONFIG))),
        param_dtype=torch.float32, compute_dtype=torch.float32,
        device="cpu")
    hf_io.load_hf_weights(flat, str(legacy))
    for (_, a, _), (_, b, _) in zip(jax_leaves(flat), jax_leaves(model)):
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            assert torch.equal(x, y)
    with open(tmp_path / "port" / "config.json") as f:
        written = json.load(f)
    assert written["architectures"] == ["Qwen2_5_VLForConditionalGeneration"]
    loaded = AutoModelForImageTextToText.from_pretrained(
        str(tmp_path / "port"), load_weights=True, device="cpu",
        param_dtype="float32", compute_dtype="float32",
        image_grid=[1, 6, 6])
    assert type(loaded) is tq.Qwen25VLForConditionalGeneration
    assert loaded.image_grid == IMAGE_GRID
    for (_, a, _), (_, b, _) in zip(jax_leaves(loaded), jax_leaves(model)):
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            assert torch.equal(x, y)


def test_freeze_mask_and_flops_match_jax(pair):
    jm, params, model = pair
    rdr = {"freeze_embeddings": True, "freeze_vision_tower": True,
           "freeze_language_model": False}
    jmask = {".".join(k): bool(v) for k, v in _flat(
        jax_freezing(jax.tree.map(jnp.asarray, params), rdr)).items()}
    mask = make_freeze_mask(model, **rdr)
    assert mask == jmask
    assert mask["visual.patch_embed.kernel"]
    assert mask["visual.merger.fc1.kernel"]
    assert not mask["language_model.embed_tokens.embedding"]
    assert model.flops_per_token() == jm.flops_per_token()


def test_published_config_builds_as_jax_builds_it():
    """Qwen2.5-VL-3B's published widths: the same parameter dtype (the
    config carries no ``torch_dtype`` field, so fp32 in both), head
    dims, vision geometry and M-RoPE sections, from the config alone
    (meta tensors, nothing allocated)."""
    cfg = dict(
        model_type="qwen2_5_vl", tie_word_embeddings=True,
        text_config=dict(
            vocab_size=151936, hidden_size=2048, intermediate_size=11008,
            num_hidden_layers=36, num_attention_heads=16,
            num_key_value_heads=2, rope_theta=1000000.0,
            rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]}),
        vision_config=dict(
            depth=32, hidden_size=1280, intermediate_size=3420,
            num_heads=16, window_size=112, out_hidden_size=2048,
            fullatt_block_indexes=[7, 15, 23, 31]))
    jc = jq.Qwen25VLConfig.from_hf_config(json.loads(json.dumps(cfg)))
    tc = tq.Qwen25VLConfig.from_hf_config(json.loads(json.dumps(cfg)))
    assert getattr(jc, "torch_dtype", None) is None
    assert getattr(tc, "torch_dtype", None) is None
    assert tc.text_config.head_dim == jc.text_config.head_dim == 128
    assert tc.text_config.attention_bias and jc.text_config.attention_bias
    assert tc.vision_config.head_dim == jc.vision_config.head_dim == 80
    assert tc.vision_config.patch_dim == jc.vision_config.patch_dim == 1176
    assert tc.mrope_section == jc.mrope_section == (16, 24, 24)
    with torch.device("meta"):
        model = tq.Qwen25VLForConditionalGeneration(tc, device="meta")
    jm = jq.Qwen25VLForConditionalGeneration(jc)
    assert model.param_dtype == torch.float32
    assert jm.param_dtype == jnp.float32
    shapes = {tuple(k.key for k in path): tuple(v.shape) for path, v in
              jax.tree_util.tree_flatten_with_path(
                  jm.abstract_params())[0]}
    for path, target, transposed in jax_leaves(model):
        t = target if isinstance(target, list) else [target]
        shape = tuple(t[0].shape[::-1] if transposed else t[0].shape)
        if isinstance(target, list):
            shape = (len(t),) + shape
        assert shape == shapes[path], path
    assert model.flops_per_token() == jm.flops_per_token()
    lay = tq._grid_layout((1, 56, 56), 2, 112, 14, 80)
    assert lay["gather"].shape == (49, 64) and lay["valid"].all()
    lay = tq._grid_layout((1, 60, 60), 2, 112, 14, 80)
    assert lay["gather"].shape == (64, 64) and not lay["valid"].all()
