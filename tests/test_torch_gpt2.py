"""GPT-2 and the pretraining entry in the port against the JAX package,
on the CPU:

* logits and the gradient of every parameter from the same perturbed JAX
  parameters (float32, 2 layers, 64 wide, 4 heads, vocab 256), on one row
  per sample and on packed rows with restarting positions, under
  ``MaskedCrossEntropy`` and the tied head under
  ``FusedLinearCrossEntropy``;
* positions past ``n_positions - 1`` read the table's last row, as the JAX
  model's clamping gather does;
* the HF key map both ways: a directory the port writes loads in the JAX
  package bit for bit and one the JAX package writes loads in the port; a
  checkpoint with HF's ``transformer.`` prefix reads;
* ``examples/llm_pretrain/nanogpt_pretrain.yaml`` through ``automodel-torch
  pretrain llm`` (the port's ``examples/pretrain.py`` main) and through
  the JAX recipe on the same local shards, at tiny overrides (2 layers, 64
  wide, vocab 512, rows of 64 tokens, float32 compute, 4 steps), from the
  JAX recipe's initial weights; the end-of-run safetensors checkpoint.

Tolerances: logits and gradients within 1e-5 relative L2 over each tensor
(float32, sums in another order); the recipe's loss and grad_norm within
1e-4 relative over the 4 steps, label-token counts and learning rates
exactly, as ``tests/test_torch_hf_yamls.py``; weights read from a
directory exactly.
"""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.config.arg_parser import (
    parse_args_and_load_config as jax_config,
)
from automodel_tpu.loss.linear_ce import FusedLinearCrossEntropy as JaxFused
from automodel_tpu.loss.masked_ce import MaskedCrossEntropy as JaxCE
from automodel_tpu.models import auto_model as jauto
from automodel_tpu.models import hf_io as jhf
from automodel_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from automodel_tpu.models.gpt2 import GPT2LMHeadModel as JaxGPT2
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JaxRecipe,
)
from automodel_tpu.training.train_step import _microbatch_loss
from automodel_tpu_torch.datasets.llm.nanogpt_dataset import write_shard
from automodel_tpu_torch.datasets.prefetch import PrefetchDataLoader
from automodel_tpu_torch.loss.linear_ce import FusedLinearCrossEntropy
from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
from automodel_tpu_torch.models import auto_model, hf_io
from automodel_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from automodel_tpu_torch.models.weights import (
    jax_leaves,
    load_jax_params,
    load_jax_recipe_params,
)
from automodel_tpu_torch.recipes.llm import train_ft
from automodel_tpu_torch.training.train_step import microbatch_loss
from tests.test_torch_moe_model import packed_batch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "examples", "llm_pretrain", "nanogpt_pretrain.yaml")
PRETRAIN = os.path.join(REPO, "automodel_tpu_torch", "examples",
                        "pretrain.py")
REL = 1e-5
STEP_REL = 1e-4
SMALL = dict(vocab_size=256, n_positions=64, n_embd=64, n_layer=2, n_head=4)


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


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


def gpt2_pair(seed=0, tied=True):
    cfg = dict(SMALL, tie_word_embeddings=tied)
    jm = JaxGPT2(JaxGPT2Config(**cfg), param_dtype=jnp.float32,
                 compute_dtype=jnp.float32, remat=False)
    params = jm.init(jax.random.key(seed))
    leaves, td = jax.tree.flatten(params)
    rng = np.random.default_rng(seed + 5)
    params = jax.tree.unflatten(td, [
        np.asarray(l) + 0.05 * rng.normal(size=l.shape).astype(np.float32)
        for l in leaves])
    model = GPT2LMHeadModel(GPT2Config(**cfg), param_dtype=torch.float32,
                            compute_dtype=torch.float32, remat=True,
                            device="cpu")
    load_jax_params(model, params)
    return jm, params, model


def _batches():
    one_row = packed_batch(B=2, S=16, seed=7)
    one_row["segment_ids"] = np.ones_like(one_row["segment_ids"])
    one_row["position_ids"] = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    return {"one_row": one_row, "packed": packed_batch(B=2, S=48, seed=3)}


@pytest.mark.parametrize("rows", ["one_row", "packed"])
@pytest.mark.parametrize("loss", ["masked", "fused"])
def test_logits_and_every_gradient_match_jax(rows, loss):
    jm, params, model = gpt2_pair()
    batch = _batches()[rows]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    kw = dict(position_ids=jb["position_ids"], segment_ids=jb["segment_ids"])
    jlogits = np.asarray(jm(jax.tree.map(jnp.asarray, params),
                            jb["input_ids"], **kw)["logits"])
    with torch.no_grad():
        logits = model(tb["input_ids"], position_ids=tb["position_ids"],
                       segment_ids=tb["segment_ids"])["logits"].numpy()
    assert rel_l2(logits, jlogits) < REL
    jloss_fn, loss_fn = ((JaxCE(), MaskedCrossEntropy()) if loss == "masked"
                         else (JaxFused(), FusedLinearCrossEntropy()))
    jloss, jgrads = jax.value_and_grad(
        lambda p: _microbatch_loss(jm, jloss_fn, p, jb))(
        jax.tree.map(jnp.asarray, params))
    out = microbatch_loss(model, loss_fn, tb)
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(jloss), rtol=1e-6)
    flat = _flat(jgrads)
    seen = set()
    for path, got in _leaf_values(model, grad=True):
        assert rel_l2(got, flat[path]) < REL, path
        seen.add(path)
    assert seen == set(flat)


def test_positions_past_the_table_clamp_as_jax():
    jm, params, model = gpt2_pair(seed=1, tied=False)
    ids = np.random.default_rng(0).integers(0, 256, (1, 80))  # n_positions 64
    want = np.asarray(jm(jax.tree.map(jnp.asarray, params),
                         jnp.asarray(ids, jnp.int32))["logits"])
    with torch.no_grad():
        got = model(torch.from_numpy(ids))["logits"].numpy()
    assert rel_l2(got, want) < REL


def test_hf_key_map_round_trips_with_jax(tmp_path):
    jm, params, model = gpt2_pair(seed=2, tied=False)
    hf_io.save_hf_weights(model, str(tmp_path / "port"))
    jload = jauto.AutoModelForCausalLM.from_pretrained(
        str(tmp_path / "port"), load_weights=True)
    assert type(jload).__name__ == "GPT2LMHeadModel"
    jflat = _flat(jload.params)
    for path, got in _leaf_values(model):
        np.testing.assert_array_equal(got, jflat[path], err_msg=str(path))
    jhf.save_hf_weights(jm, params, str(tmp_path / "jax"))
    back = auto_model.AutoModelForCausalLM.from_pretrained(
        str(tmp_path / "jax"), load_weights=True, device="cpu")
    assert isinstance(back, GPT2LMHeadModel)
    flat = _flat(params)
    for path, got in _leaf_values(back):
        np.testing.assert_array_equal(got, flat[path], err_msg=str(path))


def test_transformer_prefixed_checkpoint_reads(tmp_path):
    """HF's ``GPT2LMHeadModel.save_pretrained`` names carry
    ``transformer.``: the port reads them."""
    _, _, model = gpt2_pair(seed=3)
    state = {"transformer." + k: v for k, v in hf_io.hf_state(model).items()}
    hf_io.save_hf_weights(model, str(tmp_path), state=state)
    back = auto_model.AutoModelForCausalLM.from_pretrained(
        str(tmp_path), load_weights=True, device="cpu", seed=9)
    for (_, a), (_, b) in zip(_leaf_values(model), _leaf_values(back)):
        np.testing.assert_array_equal(a, b)


def test_serving_refuses_gpt2():
    from automodel_tpu_torch.serving import DecodeEngine

    _, _, model = gpt2_pair()
    with pytest.raises(NotImplementedError, match="no decode cache"):
        DecodeEngine(model, device="cpu")


def test_a_tokenizer_that_fails_to_load_gives_none(monkeypatch, caplog):
    """The recipe's tokenizer fallback takes any failure of
    ``AutoTokenizer`` as "no tokenizer", as the JAX recipe's ``except
    Exception`` does (``transformers`` raises ``TypeError`` on a directory
    with a GPT-2-style config and no vocabulary files)."""
    import types

    def broken(path):
        raise TypeError("expected str, bytes or os.PathLike object")

    fake = types.SimpleNamespace(
        AutoTokenizer=types.SimpleNamespace(from_pretrained=broken))
    monkeypatch.setitem(sys.modules, "transformers", fake)
    _, _, model = gpt2_pair()
    model.checkpoint_dir = "/nonexistent"
    cfg = train_ft.parse_args_and_load_config(["-c", YAML])
    assert train_ft.build_tokenizer(cfg, model) is None
    assert "No tokenizer found" in caplog.text


def _shards(path, n_files=2, tokens=40_000, vocab=512, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    for i in range(n_files):
        write_shard(os.path.join(path, f"train_{i:06d}.bin"),
                    rng.integers(0, vocab, tokens).astype(np.uint16))
    return os.path.join(path, "*.bin")


def _overrides(pattern, ckpt_dir):
    return ["--dataset.file_pattern", pattern, "--dataset.seq_len", "64",
            "--model.vocab_size", "512", "--model.n_embd", "64",
            "--model.n_layer", "2", "--model.n_head", "4",
            "--model.n_positions", "64", "--model.compute_dtype", "float32",
            "--step_scheduler.max_steps", "4",
            "--checkpoint.checkpoint_dir", ckpt_dir]


def test_nanogpt_yaml_runs_as_written_and_follows_jax(tmp_path, monkeypatch):
    pattern = _shards(str(tmp_path / "data"))
    jcfg = jax_config(["--config", YAML, *_overrides(
        pattern, str(tmp_path / "jck")), "--dataloader.prefetch_depth", "0"])
    real = jax.devices
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "devices", lambda *a: real(*a)[:1])    # one device
    try:
        jr = JaxRecipe(jcfg).setup()
    finally:
        mp.undo()
    jsteps = []
    finalize = jr._finalize_metrics

    def record(pending):
        out = finalize(pending)
        jsteps.append(out)
        return out

    jr._finalize_metrics = record
    weights = jax.tree.map(np.array, jr.params)
    jr.run_train_validation_loop()

    # the port through its pretraining entry (examples/pretrain.py), with
    # the JAX recipe's initial weights
    captured = {}
    setup = train_ft.TrainFinetuneRecipeForNextTokenPrediction.setup

    def setup_from_jax(self):
        setup(self)
        load_jax_recipe_params(self, weights)
        captured["recipe"] = self
        return self

    monkeypatch.setattr(train_ft.TrainFinetuneRecipeForNextTokenPrediction,
                        "setup", setup_from_jax)
    monkeypatch.setattr(sys, "argv", [
        PRETRAIN, "-c", YAML, "--device", "cpu",
        *_overrides(pattern, str(tmp_path / "pck"))])
    runpy.run_path(PRETRAIN, run_name="__main__")
    pr = captured["recipe"]
    # the YAML names no prefetch depth: the async pipeline two deep, as
    # the JAX recipe defaults
    assert isinstance(pr.dataloader, PrefetchDataLoader)
    assert pr.cfg.get("dataloader.prefetch_depth") == 2
    assert isinstance(pr.model, GPT2LMHeadModel)
    assert pr.model.config.n_layer == 2 and pr.model.remat
    assert isinstance(pr.loss_fn, FusedLinearCrossEntropy)
    assert [m["step"] for m in pr.history] == [1, 2, 3, 4]
    for k in ("num_label_tokens", "lr"):
        assert [m[k] for m in pr.history] == [m[k] for m in jsteps], k
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([m[k] for m in pr.history],
                                   [float(m[k]) for m in jsteps],
                                   rtol=STEP_REL, err_msg=k)
    # the end-of-run consolidated safetensors: the trained weights, read
    # back by both packages
    names = sorted(os.listdir(tmp_path / "pck"))
    assert names == sorted(os.listdir(tmp_path / "jck")) == ["epoch_0_step_4"]
    model_dir = str(tmp_path / "pck" / names[0] / "model")
    back = auto_model.AutoModelForCausalLM.from_pretrained(
        model_dir, load_weights=True, device="cpu")
    jback = _flat(jauto.AutoModelForCausalLM.from_pretrained(
        model_dir, load_weights=True).params)
    for (path, a), (_, b) in zip(_leaf_values(pr.model),
                                 _leaf_values(back)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
        np.testing.assert_array_equal(a, jback[path], err_msg=str(path))
