"""The port's Gemma-3n (``models/gemma3n.py``) against the JAX package on the
CPU, fp32, tiny widths, inputs from numpy seeds.

* The plain RMSNorm (``x / sqrt(mean(x^2) + eps) * w``, no ``(1 + w)``)
  within 1e-6 of JAX's, and the sparsity constants (``_ppf``, the fp32
  ``std_mult`` a layer gets) equal to JAX's bit for bit.
* The native conv tower and every leaf's gradient of a seeded projection
  of its soft tokens, at an even image side (XLA pads the stride-2 stem
  (0, 1)) and an odd one ((1, 1)): features within 1e-5 relative, the
  gradients within 1e-4 (atol 1e-5 of the largest gradient).
* The text decoder over five layers (four sliding with window 8 and one
  full; the gate sparse on layers 0, 2 and 4 (one of them full), dense on
  1 and 3; ids past the per-layer vocabulary; two packed segments a row):
  logits, the MaskedCE loss and every leaf's gradient within 5e-5
  relative (atol 5e-5 of the leaf's largest element, and at least 1e-2 of
  the largest gradient of its sub-tree).  Measured: about 1e-6; fp32 sums
  in another order.
* The multimodal model (the tiny YAML's config: hard-path ids, placeholder
  ids scattered over): the same limits, the tower's and the embedder's
  gradients included, but for the gradients' 2e-4: the sparse gate's
  relu is discontinuous at its cutoff, and an activation within rounding
  of ``mean + std * std_mult`` passes in one package and not in the
  other.  Measured: 8e-5 of the largest element of ``gate_proj``'s
  gradient, 3e-6 with the gate made dense.  A batch whose rows carry
  different image counts agrees with JAX's flat cross-batch scatter, and
  a per-row scatter (``models/vlm.py::merge_image_embeds``) would give
  other logits.
* ``load_jax_params`` fills every parameter of both trees (the ``[A - 1,
  H, H]`` AltUp kernels and the tower's stacked HWIO kernels among them),
  HF directories cross the packages both ways for both types bit for bit
  (the tower's HWIO tensors whole under ``model.vision_tower.native.``),
  and ``from_pretrained`` builds both types.
* The medpix YAML's freeze mask equals JAX's on every leaf (the per-layer
  table frozen as a prefix match of ``embed_tokens``, ``embed_vision``
  trainable); ``flops_per_token`` equal.
* LoRA on the multimodal model with the PEFT YAML's section: JAX's target
  set (the seven decoder projections), the merged path, the trainable
  count, logits equal to JAX's LoRA forward, adapter files read across
  the packages; the bypass, dropout and an int8 base refused, as in JAX.
* The refusals of both packages: a cache, a hidden-state loss (the soft
  cap), heterogeneous MatFormer widths.

Weights are the JAX init plus N(0, 0.1) on every leaf, so that no path is
zero (``correct_output_scale`` starts at zero and would hide the per-layer
gate).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from automodel_tpu.loss.masked_ce import MaskedCrossEntropy as JaxCE
from automodel_tpu.models import gemma3n as jg
from automodel_tpu.models import hf_io as jhf
from automodel_tpu.peft import lora as jlora
from automodel_tpu.training.train_step import _microbatch_loss
from automodel_tpu.utils.model_utils import (
    apply_parameter_freezing as jax_freezing,
)
from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
from automodel_tpu_torch.models import gemma3n as tg
from automodel_tpu_torch.models import hf_io
from automodel_tpu_torch.models.auto_model import (
    AutoModelForCausalLM,
    AutoModelForImageTextToText,
)
from automodel_tpu_torch.models.vlm import merge_image_embeds
from automodel_tpu_torch.models.weights import jax_leaves, load_jax_params
from automodel_tpu_torch.peft import lora
from automodel_tpu_torch.training.train_step import microbatch_loss
from automodel_tpu_torch.utils.model_utils import make_freeze_mask

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VLM_YAMLS = os.path.join(REPO, "examples", "vlm_finetune")
REL = 5e-5
GATE_REL = 2e-4       # gradients through the sparse gate's cutoff
TEXT = dict(
    model_type="gemma3n_text", vocab_size=300, vocab_size_per_layer_input=260,
    hidden_size=64, hidden_size_per_layer_input=16, intermediate_size=128,
    num_hidden_layers=5, num_attention_heads=4, num_key_value_heads=2,
    head_dim=16, laurel_rank=8, altup_num_inputs=4, sliding_window=8,
    num_kv_shared_layers=2,
    activation_sparsity_pattern=[0.95, 0.0, 0.5, 0.0, 0.95])
with open(os.path.join(VLM_YAMLS, "tiny_gemma3n_mock.yaml")) as _f:
    VL = yaml.safe_load(_f)["model"]["config"]
VISION = dict(hidden_size=32, vocab_size=20, vocab_offset=280,
              stem_channels=16, depth=2)


def _flat(tree):
    return {tuple(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturbed(params, seed=5):
    """The JAX init plus N(0, 0.1) on every leaf."""
    leaves, td = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(td, [
        np.asarray(l) + 0.1 * rng.normal(size=l.shape).astype(np.float32)
        for l in leaves])


def _grads_match(model, jgrads, rel):
    """Every leaf's ``.grad`` against the JAX gradient tree."""
    flat = _flat(jgrads)
    top = {p[0]: max(np.abs(g).max() for q, g in flat.items()
                     if q[0] == p[0]) for p in flat}
    seen = set()
    for path, target, transposed in jax_leaves(model):
        targets = target if isinstance(target, list) else [target]
        got = np.stack([p.grad.numpy() for p in targets])
        if not isinstance(target, list):
            got = got[0]
        if transposed:
            got = np.swapaxes(got, -1, -2)
        np.testing.assert_allclose(got, flat[path], rtol=rel,
                                   atol=rel * max(np.abs(flat[path]).max(),
                                                  1e-2 * top[path[0]]),
                                   err_msg=".".join(path))
        seen.add(path)
    assert seen == set(flat)


def _text_pair(seed=0):
    jm = jg.Gemma3nForCausalLM(jg.Gemma3nTextConfig.from_hf_config(TEXT),
                               param_dtype=jnp.float32,
                               compute_dtype=jnp.float32)
    params = _perturbed(jax.jit(jm.init)(jax.random.key(seed)))
    model = tg.Gemma3nForCausalLM(
        tg.Gemma3nTextConfig.from_hf_config(TEXT), param_dtype=torch.float32,
        compute_dtype=torch.float32, device="cpu")
    load_jax_params(model, params)
    return jm, params, model


def _vl_pair(seed=0):
    cfg = json.loads(json.dumps(VL))
    jm = jg.build_gemma3n_vl(cfg, param_dtype=jnp.float32,
                             compute_dtype=jnp.float32)
    params = _perturbed(jax.jit(jm.init)(jax.random.key(seed)))
    model = tg.build_gemma3n_vl(cfg, device="cpu", param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    load_jax_params(model, params)
    return jm, params, model


def _port_vl():
    return tg.build_gemma3n_vl(json.loads(json.dumps(VL)), device="cpu")


@pytest.fixture(scope="module")
def text_pair():
    return _text_pair()


@pytest.fixture(scope="module")
def vl_pair():
    return _vl_pair()


def test_plain_rms_norm_and_sparsity_constants_match_jax(text_pair):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32) * 4
    w = (1.0 + 0.1 * rng.normal(size=48)).astype(np.float32)
    for weight in (w, None):
        want = np.asarray(jg._rms_norm(jnp.asarray(x), None if weight is None
                                       else jnp.asarray(weight)))
        got = tg._rms_norm(torch.from_numpy(x), None if weight is None
                           else torch.from_numpy(weight)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the (1 + w) form is another function
    assert not np.allclose(
        tg._rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jg._rms_norm(jnp.asarray(x), jnp.asarray(1 + w))))
    for p in (0.95, 0.5, 0.75, 0.999, 0.1):
        assert tg._ppf(p) == jg._ppf(p)
        assert tg._erfinv(2 * p - 1) == jg._erfinv(2 * p - 1)
    jm, _, model = text_pair
    want = [float(m) if s else None
            for m, s in zip(jm._std_mult, jm._sparse_flag)]
    assert [l.std_mult for l in model.layers] == want
    assert want[0] is not None and want[1] is None


@pytest.mark.parametrize("side,pads", [(16, (0, 1)), (15, (1, 1))])
def test_tower_and_its_gradients_match_jax(side, pads):
    assert tg._same_pads(side, 3, 2) == pads
    jcfg = jg.Gemma3nVisionConfig.from_hf_config(VISION)
    jt = jg.Gemma3nVisionTower(jcfg, 4, param_dtype=jnp.float32,
                               compute_dtype=jnp.float32)
    params = _perturbed(jax.jit(jt.init)(jax.random.key(1)))
    tower = tg.Gemma3nVisionTower(
        tg.Gemma3nVisionConfig.from_hf_config(VISION), 4,
        param_dtype=torch.float32, compute_dtype=torch.float32, device="cpu")
    load_jax_params(tower, params)
    rng = np.random.default_rng(side)
    images = rng.normal(size=(3, side, side, 3)).astype(np.float32)
    w = rng.normal(size=(3, 4, VISION["hidden_size"])).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    ref = np.asarray(jax.jit(jt)(jp, jnp.asarray(images)))
    _, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(jt(p, jnp.asarray(images)) * w)))(jp)
    feats = tower(torch.from_numpy(images))
    np.testing.assert_allclose(feats.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    (feats * torch.from_numpy(w)).sum().backward()
    flat = _flat(jgrads)
    top = max(np.abs(g).max() for g in flat.values())
    for path, target, _ in jax_leaves(tower):
        np.testing.assert_allclose(target.grad.numpy(), flat[path],
                                   rtol=1e-4, atol=1e-5 * top,
                                   err_msg=".".join(path))


def _text_batch(B=2, S=24, seed=2):
    """Ids over the whole vocabulary (some past the per-layer one), two
    packed segments a row with restarting positions, labels the ids."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TEXT["vocab_size"], (B, S)).astype(np.int32)
    seg = np.ones((B, S), np.int32)
    seg[:, 14:] = 2
    pos = np.concatenate([np.arange(14), np.arange(S - 14)])[None].repeat(
        B, 0).astype(np.int32)
    assert (ids >= TEXT["vocab_size_per_layer_input"]).any()
    return {"input_ids": ids, "labels": ids.copy(), "segment_ids": seg,
            "position_ids": pos}


def _check_step(jm, params, model, batch, rel=REL, grad_rel=REL):
    """Logits, the MaskedCE loss and every gradient against JAX's."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jax.tree.map(jnp.asarray, params)
    kw = {k: v for k, v in jb.items() if k not in ("input_ids", "labels")}
    ref = np.asarray(jax.jit(lambda p: jm(p, jb["input_ids"], **kw)[
        "logits"])(jp))
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        out = model(t["input_ids"], **{k: v for k, v in t.items()
                                       if k not in ("input_ids", "labels")})
    np.testing.assert_allclose(out["logits"].numpy(), ref, rtol=rel,
                               atol=rel * np.abs(ref).max())
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: _microbatch_loss(jm, JaxCE(), p, jb)))(jp)
    model.zero_grad(set_to_none=True)
    loss = microbatch_loss(model, MaskedCrossEntropy(), t)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=rel)
    _grads_match(model, jgrads, grad_rel)
    return out["logits"].numpy()


def test_text_logits_loss_and_grads_match_jax(text_pair):
    jm, params, model = text_pair
    layers = model.layers
    assert [l.full for l in layers] == [False] * 4 + [True]
    assert [l.std_mult is not None for l in layers] == [True, False, True,
                                                         False, True]
    _check_step(jm, params, model, _text_batch())


def _vl_batch(counts=(1, 1), S=32, seed=3):
    """Rows with ``counts`` images each (slots ``[B, max, 16, 16, 3]``,
    trailing slots zero, 4 placeholders 285 an image) and hard-path ids
    (280 .. 299) among the text."""
    rng = np.random.default_rng(seed)
    B, I = len(counts), max(counts)
    ids = rng.integers(0, 280, (B, S)).astype(np.int32)
    ids[:, -3:] = rng.integers(280, 300, (B, 3))
    ids[ids == 285] = 7
    pv = np.zeros((B, I, 16, 16, 3), np.float32)
    for b, n in enumerate(counts):
        for j in range(n):
            ids[b, 2 + 6 * j:6 + 6 * j] = 285
            pv[b, j] = rng.normal(size=(16, 16, 3))
    assert ((ids >= 280) & (ids != 285)).any()
    return {"input_ids": ids, "labels": ids.copy(), "pixel_values": pv}


def test_vl_logits_loss_and_grads_match_jax(vl_pair):
    jm, params, model = vl_pair
    _check_step(jm, params, model, _vl_batch(), grad_rel=GATE_REL)
    assert model.vision_tower.stem.kernel.grad.abs().max() > 0
    assert model.embed_vision.embedding.weight.grad.abs().max() > 0


def test_cross_batch_image_scatter_is_jax_s(vl_pair):
    """Rows with 1 and 2 images: the flat scatter over the whole batch
    (JAX's) hands row 1 the second slot of row 0 (zeros) first; both
    packages agree, and a per-row scatter would give other logits."""
    jm, params, model = vl_pair
    batch = _vl_batch(counts=(1, 2))
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "labels"}
    ref = np.asarray(jax.jit(lambda p: jm(p, **jb)["logits"])(
        jax.tree.map(jnp.asarray, params)))
    t = {k: torch.from_numpy(v) for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        got = model(**t)["logits"].numpy()
        np.testing.assert_allclose(got, ref, rtol=REL,
                                   atol=REL * np.abs(ref).max())
        ids = t["input_ids"]
        lm = model.language_model
        embeds = torch.where(
            (ids >= 280)[..., None], model._embed_hard(ids),
            lm._embed(ids))
        per_row = merge_image_embeds(embeds, ids, t["pixel_values"],
                                     lambda x: model.encode_images(x).reshape(
                                         x.shape[0], 4, -1), 285)
        other = lm(ids, inputs_embeds=per_row)["logits"].numpy()
    assert np.allclose(other[0], got[0], rtol=REL,
                       atol=REL * np.abs(ref).max())
    assert np.abs(other[1] - got[1]).max() > 1e-2 * np.abs(ref).max()


def test_load_jax_params_fills_every_parameter(text_pair, vl_pair):
    for jm, params, model in (text_pair, vl_pair):
        covered = {id(t) for _, target, _ in jax_leaves(model)
                   for t in (target if isinstance(target, list)
                             else [target])}
        assert all(id(p) in covered for p in model.parameters())
        assert {p for p, _, _ in jax_leaves(model)} == set(_flat(params))
    _, params, model = vl_pair
    flat = _flat(params)
    A = VL["text_config"]["altup_num_inputs"]
    k = flat[("language_model", "altup_projections", "kernel")]
    assert k.shape == (A - 1, 64, 64)
    np.testing.assert_array_equal(
        model.language_model.altup_projections[0].weight.detach().numpy(),
        k[0].T)
    np.testing.assert_array_equal(
        model.vision_tower.blocks.depthwise.kernel.detach().numpy(),
        flat[("vision_tower", "blocks", "depthwise", "kernel")])


def _same_leaves(a, b):
    for (path, x, _), (_, y, _) in zip(jax_leaves(a), jax_leaves(b)):
        for u, v in zip(x if isinstance(x, list) else [x],
                        y if isinstance(y, list) else [y]):
            torch.testing.assert_close(u, v, rtol=0, atol=0,
                                       msg=".".join(path))


@pytest.mark.parametrize("kind", ["text", "vl"])
def test_hf_directories_cross_the_packages_both_ways(kind, tmp_path):
    jm, params, model = _text_pair(3) if kind == "text" else _vl_pair(3)
    jhf.save_hf_weights(jm, _np(params), str(tmp_path / "jax"))
    fresh = (tg.Gemma3nForCausalLM(
        tg.Gemma3nTextConfig.from_hf_config(TEXT), param_dtype=torch.float32,
        device="cpu") if kind == "text" else _port_vl())
    hf_io.load_hf_weights(fresh, str(tmp_path / "jax"))
    _same_leaves(fresh, model)
    hf_io.save_hf_weights(model, str(tmp_path / "port"))
    back = jhf.load_hf_weights(jm, str(tmp_path / "port"))
    for path, a in _flat(back).items():
        np.testing.assert_array_equal(a, _flat(params)[path],
                                      err_msg=".".join(path))
    header, _ = hf_io.read_safetensors_header(
        str(tmp_path / "port" / hf_io.SAFETENSORS_FILE))
    jheader, _ = hf_io.read_safetensors_header(
        str(tmp_path / "jax" / hf_io.SAFETENSORS_FILE))
    assert sorted(header) == sorted(jheader)
    with open(tmp_path / "port" / "config.json") as f:
        written = json.load(f)
    if kind == "vl":
        assert header["model.vision_tower.native.blocks.depthwise.kernel"][
            "shape"] == [2, 3, 3, 1, 32]
        assert header["model.vision_tower.native.stem.kernel"]["shape"] == [
            3, 3, 3, 16]
        assert header["model.language_model.altup_projections.0.weight"][
            "shape"] == [64, 64]
        assert written["architectures"] == ["Gemma3nForConditionalGeneration"]
        loaded = AutoModelForImageTextToText.from_pretrained(
            str(tmp_path / "port"), load_weights=True, device="cpu",
            compute_dtype="float32")
        assert type(loaded) is tg.Gemma3nForConditionalGeneration
        # no torch_dtype field on the multimodal config: fp32, as in JAX
        assert loaded.param_dtype == torch.float32
    else:
        assert "model.layers.4.altup.correct_output_scale" in header
        assert "model.altup_projections.2.weight" in header
        assert written["architectures"] == ["Gemma3nForCausalLM"]
        loaded = AutoModelForCausalLM.from_pretrained(
            str(tmp_path / "port"), load_weights=True, device="cpu",
            param_dtype="float32")
        assert type(loaded) is tg.Gemma3nForCausalLM
    _same_leaves(loaded, model)


def test_freeze_mask_and_flops_match_jax(vl_pair):
    jm, params, model = vl_pair
    with open(os.path.join(VLM_YAMLS, "gemma3n_vl_medpix.yaml")) as f:
        freeze = yaml.safe_load(f)["freeze_config"]
    jmask = {".".join(k): bool(v) for k, v in _flat(
        jax_freezing(jax.tree.map(jnp.asarray, params), freeze)).items()}
    mask = make_freeze_mask(model, **freeze)
    assert mask == jmask
    assert not mask["language_model.embed_tokens.embedding"]
    assert not mask["language_model.embed_tokens_per_layer.embedding"]
    assert mask["embed_vision.embedding.embedding"]
    assert mask["vision_tower.stem.kernel"]
    assert model.flops_per_token() == jm.flops_per_token()
def test_text_flops_match_jax(text_pair):
    tj, _, tm = text_pair
    assert tm.flops_per_token() == tj.flops_per_token()


def _peft_config():
    with open(os.path.join(VLM_YAMLS, "gemma3n_vl_medpix_peft.yaml")) as f:
        section = yaml.safe_load(f)["peft"]
    section.pop("_target_")
    return section


def test_lora_on_the_multimodal_model_is_jax_s(vl_pair, tmp_path):
    jm, params, model = _vl_pair(7)
    section = _peft_config()
    jw = jlora.LoRAModel(jm, jlora.PeftConfig(**section))
    wrapped = lora.LoRAModel(model, lora.PeftConfig(**section), seed=0)
    projs = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
             "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
             "mlp.down_proj")
    assert sorted(wrapped.targets) == sorted(jw.targets) == sorted(
        f"language_model.layers.{p}" for p in projs)
    assert not wrapped.bypass and not jw._bypass
    assert wrapped.num_trainable_params == jw.num_trainable_params
    assert sum(p.numel() for p in wrapped.parameters()
               if p.requires_grad) == jw.num_trainable_params
    # adapters away from B = 0, the same in both
    jl = _perturbed(jw.init_lora(jax.random.key(0)), seed=8)
    wrapped.load_adapter_tree(jl)
    batch = _vl_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "labels"}
    ref = np.asarray(jax.jit(lambda p: jw(p, **jb)["logits"])(
        {"base": jax.tree.map(jnp.asarray, params),
         "lora": jax.tree.map(jnp.asarray, jl)}))
    with torch.no_grad():
        got = wrapped(**{k: torch.from_numpy(v) for k, v in batch.items()
                         if k != "labels"})["logits"].numpy()
    np.testing.assert_allclose(got, ref, rtol=REL,
                               atol=REL * np.abs(ref).max())
    # adapter files across the packages
    jlora.save_adapters(jw, {"lora": jl}, str(tmp_path / "jax"))
    jfull = {"base": _np(params), "lora": jl}
    again = lora.LoRAModel(_port_vl(), lora.PeftConfig(**section))
    lora.load_adapters(again, str(tmp_path / "jax"))
    for a, b in zip(again.adapters.parameters(),
                    wrapped.adapters.parameters()):
        assert torch.equal(a, b)
    lora.save_adapters(wrapped, str(tmp_path / "port"))
    back = jlora.load_adapters(jw, jfull, str(tmp_path / "port"))
    for k, ab in _np(back["lora"]).items():
        for part in ("A", "B"):
            np.testing.assert_array_equal(ab[part], np.asarray(jl[k][part]))
    # the bypass, dropout and an int8 base are refused, as in JAX
    for over, match in (({"use_rank_r_bypass": True}, "bypass"),
                        ({"dropout": 0.1}, "merged path"),
                        ({"quantize_base": "int8"}, "weight-only")):
        with pytest.raises(ValueError, match=match):
            jlora.LoRAModel(jm, jlora.PeftConfig(**section, **over))
        with pytest.raises(ValueError, match=match):
            lora.LoRAModel(_port_vl(), lora.PeftConfig(**section, **over))


def test_refusals_match_jax(text_pair, vl_pair):
    jm, params, model = text_pair
    ids = np.zeros((1, 8), np.int32)
    jp = jax.tree.map(jnp.asarray, params)
    for call in (lambda: jm(jp, jnp.asarray(ids), kv_cache={}),
                 lambda: model(torch.from_numpy(ids), kv_cache={}),
                 lambda: model.init_kv_cache(1, 8)):
        with pytest.raises(NotImplementedError, match="cacheless"):
            call()
    for call in (lambda: jm(jp, jnp.asarray(ids), return_hidden=True),
                 lambda: model(torch.from_numpy(ids), return_hidden=True)):
        with pytest.raises(NotImplementedError,
                           match="final_logit_softcapping"):
            call()
    vj, vparams, vm = vl_pair
    vp = jax.tree.map(jnp.asarray, vparams)
    for call in (lambda: vj(vp, jnp.asarray(ids), cache_index=0),
                 lambda: vm(torch.from_numpy(ids), cache_index=0)):
        with pytest.raises(NotImplementedError, match="cacheless"):
            call()
    hetero = dict(TEXT, intermediate_size=[128, 256, 128, 128, 128])
    for cls in (jg.Gemma3nTextConfig, tg.Gemma3nTextConfig):
        with pytest.raises(NotImplementedError, match="MatFormer"):
            cls.from_hf_config(hetero)
        assert cls.from_hf_config(
            dict(TEXT, intermediate_size=[96] * 5)).intermediate_size == 96
