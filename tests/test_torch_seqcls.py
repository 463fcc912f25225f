"""Sequence classification in the port against the JAX package, on the CPU:

* logits and the gradient of every parameter of a classifier on a tiny
  Llama backbone (float32, 2 layers, hidden 64, vocab 128, 3 labels) from
  the same perturbed JAX parameters, in each of the three pooling cases:
  a padding mask, a pad id (a row with padding and one without, which
  wraps to the last position), neither;
* ``build_classification_dataset`` gives JAX's rows for the same seed, and
  ``classification_collater`` JAX's batch (labels ``[B]``);
* a classifier from a causal-LM directory: the backbone read bit for bit
  as JAX reads it, a fresh ``score`` head (the directory has none), the
  classifier's own directory (``score.weight``, ``LlamaForSequence
  Classification``) read by the JAX package bit for bit;
* ``examples/llm_finetune/tiny_llama_seqcls_mock.yaml`` as written through
  both recipes over its 8 steps (bf16 weights and compute as the YAML
  gives them, the shuffled loader, 8 microbatches of 2 rows), from the JAX
  recipe's initial weights, and the same with float32 weights and compute
  (``--model.config.torch_dtype float32 --model.compute_dtype float32``).

Tolerances: logits and gradients within 1e-5 relative L2 over each tensor
(float32, sums in another order); the recipe's loss and grad_norm within
1e-4 relative in float32 (as ``tests/test_torch_hf_yamls.py``); in bf16
as written (bf16 forward and backward on both sides) the first step within
1e-3 (measured 5.3e-4) and the 8 steps' loss within 2e-3 and grad_norm
within 2e-2 (measured 1.1e-3 and 1.4e-2: bf16 roundings compound over
the steps on 16 examples; the float32 run is the parity check); label
counts and learning rates exactly; rows, batches and read weights
exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.config.arg_parser import (
    parse_args_and_load_config as jax_config,
)
from automodel_tpu.datasets import utils as jdu
from automodel_tpu.datasets.llm import mock as jmock
from automodel_tpu.loss.masked_ce import MaskedCrossEntropy as JaxCE
from automodel_tpu.models import auto_model as jauto
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JaxRecipe,
)
from automodel_tpu.training.train_step import _microbatch_loss
from automodel_tpu_torch.config.loader import parse_args_and_load_config
from automodel_tpu_torch.datasets import utils as du
from automodel_tpu_torch.datasets.llm import mock
from automodel_tpu_torch.loss.linear_ce import FusedLinearCrossEntropy
from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
from automodel_tpu_torch.models import auto_model, hf_io
from automodel_tpu_torch.models.sequence_classification import (
    ForSequenceClassification,
)
from automodel_tpu_torch.models.weights import (
    jax_leaves,
    load_jax_params,
    load_jax_recipe_params,
)
from automodel_tpu_torch.recipes.llm import train_ft
from automodel_tpu_torch.training.train_step import microbatch_loss

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "examples", "llm_finetune",
                    "tiny_llama_seqcls_mock.yaml")
REL = 1e-5
STEP_REL = {"float32": {"loss": 1e-4, "grad_norm": 1e-4},
            "bf16_as_written": {"loss": 2e-3, "grad_norm": 2e-2}}
FIRST_STEP_REL = 1e-3
FLOAT32 = ["--model.config.torch_dtype", "float32",
           "--model.compute_dtype", "float32"]
PAD = 0
BACKBONE = dict(model_type="llama", vocab_size=128, hidden_size=64,
                intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2,
                rope_theta=10000.0, tie_word_embeddings=True,
                torch_dtype="float32")


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


def classifier_pair(pad_token_id, seed=0):
    kw = dict(num_labels=3, pad_token_id=pad_token_id)
    jm = jauto.AutoModelForSequenceClassification.from_config(
        dict(BACKBONE), compute_dtype=jnp.float32, remat=False, **kw)
    params = jm.init(jax.random.key(seed))
    leaves, td = jax.tree.flatten(params)
    rng = np.random.default_rng(seed + 5)
    params = jax.tree.unflatten(td, [
        np.asarray(l) + 0.05 * rng.normal(size=l.shape).astype(np.float32)
        for l in leaves])
    model = auto_model.AutoModelForSequenceClassification.from_config(
        dict(BACKBONE), compute_dtype=torch.float32, remat=True,
        device="cpu", **kw)
    load_jax_params(model, params)
    return jm, params, model


def pooling_batch(case):
    """Two rows of 12: the first padded after 7 tokens, the second full."""
    rng = np.random.default_rng(4)
    ids = rng.integers(1, 128, (2, 12)).astype(np.int32)
    ids[0, 7:] = PAD
    batch = {"input_ids": ids, "labels": np.array([2, 0], np.int32)}
    if case == "mask":
        batch["attention_mask"] = (ids != PAD).astype(np.int32)
    return batch


@pytest.mark.parametrize("case", ["mask", "pad_id", "neither"])
def test_logits_and_every_gradient_match_jax(case):
    jm, params, model = classifier_pair(PAD if case == "pad_id" else None)
    batch = pooling_batch(case)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    mask = batch.get("attention_mask")
    idx = model.last_token_index(
        tb["input_ids"], None if mask is None else tb["attention_mask"])
    assert idx.tolist() == {"mask": [6, 11], "pad_id": [6, 11],
                            "neither": [11, 11]}[case]
    jparams = jax.tree.map(jnp.asarray, params)
    jlogits = np.asarray(jm(jparams, jb["input_ids"],
                            attention_mask=jb.get("attention_mask"))[
        "logits"])
    with torch.no_grad():
        logits = model(tb["input_ids"],
                       attention_mask=tb.get("attention_mask"))["logits"]
    assert logits.shape == (2, 3)
    assert rel_l2(logits.numpy(), jlogits) < REL
    jloss, jgrads = jax.value_and_grad(
        lambda p: _microbatch_loss(jm, JaxCE(), p, jb))(jparams)
    loss = microbatch_loss(model, MaskedCrossEntropy(), tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    flat = _flat(jgrads)
    seen = set()
    for path, got in _leaf_values(model, grad=True):
        assert rel_l2(got, flat[path]) < REL, path
        seen.add(path)
    assert seen == set(flat)
    assert ("score", "kernel") in seen
    with pytest.raises(ValueError, match="MaskedCrossEntropy"):
        microbatch_loss(model, FusedLinearCrossEntropy(), tb)


def test_classification_rows_and_batches_match_jax():
    kw = dict(num_examples=20, num_labels=3, vocab_size=64, mean_len=9,
              seed=5)
    rows, jrows = (mock.build_classification_dataset(**kw),
                   jmock.build_classification_dataset(**kw))
    assert rows == jrows
    assert all(r["labels"] == r["input_ids"][0] % 3 for r in rows)
    got = du.classification_collater(rows[:4], pad_seq_len_divisible=8)
    want = jdu.classification_collater([dict(r) for r in jrows[:4]],
                                       pad_seq_len_divisible=8)
    assert rows[0].get("labels") is not None          # rows left as given
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["labels"].shape == (4,)


def test_fresh_head_from_a_causal_lm_directory(tmp_path):
    causal = auto_model.AutoModelForCausalLM.from_config(
        dict(BACKBONE), seed=3, device="cpu")
    hf_io.save_hf_weights(causal, str(tmp_path / "lm"))
    model = auto_model.AutoModelForSequenceClassification.from_pretrained(
        str(tmp_path / "lm"), load_weights=True, num_labels=4, device="cpu",
        seed=1)
    jm = jauto.AutoModelForSequenceClassification.from_pretrained(
        str(tmp_path / "lm"), load_weights=True, num_labels=4)
    jflat = _flat(jm.params)
    for path, got in _leaf_values(model):
        if path[0] == "backbone":
            np.testing.assert_array_equal(got, jflat[path], err_msg=str(path))
    head = model.score.weight.detach()
    assert tuple(head.shape) == (4, 64) and float(head.abs().max()) > 0
    assert 0.01 < float(head.std()) < 0.03              # N(0, 0.02), fresh
    # the classifier's own directory: read by JAX bit for bit
    hf_io.save_hf_weights(model, str(tmp_path / "cls"))
    import json

    with open(tmp_path / "cls" / "config.json") as f:
        cfg = json.load(f)
    assert cfg["architectures"] == ["LlamaForSequenceClassification"]
    assert cfg["num_labels"] == 4
    jback = _flat(jauto.AutoModelForSequenceClassification.from_pretrained(
        str(tmp_path / "cls"), load_weights=True).params)
    for path, got in _leaf_values(model):
        np.testing.assert_array_equal(got, jback[path], err_msg=str(path))


@pytest.mark.parametrize("precision", sorted(STEP_REL))
def test_seqcls_yaml_runs_as_written_and_follows_jax(precision):
    over = FLOAT32 if precision == "float32" else []
    jcfg = jax_config(["--config", YAML, "--dataloader.prefetch_depth", "0",
                       *over])
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

    pr = train_ft.TrainFinetuneRecipeForNextTokenPrediction(
        parse_args_and_load_config(["-c", YAML, "--device", "cpu",
                                    *over])).setup()
    assert isinstance(pr.model, ForSequenceClassification)
    assert pr.model.param_dtype == (torch.float32 if over
                                    else torch.bfloat16)
    assert pr.model.num_labels == 2 and pr.model.pad_token_id == 0
    assert pr.step_scheduler.grad_acc_steps == 8
    load_jax_recipe_params(pr, weights)
    pr.run_train_validation_loop()
    assert [m["step"] for m in pr.history] == list(range(1, 9))
    for k in ("num_label_tokens", "lr"):
        assert [m[k] for m in pr.history] == [m[k] for m in jsteps], k
    assert all(m["num_label_tokens"] == 16 for m in pr.history)
    for k in ("loss", "grad_norm"):
        got, want = ([m[k] for m in pr.history],
                     [float(m[k]) for m in jsteps])
        np.testing.assert_allclose(got[0], want[0], rtol=FIRST_STEP_REL,
                                   err_msg=k)
        np.testing.assert_allclose(got, want, rtol=STEP_REL[precision][k],
                                   err_msg=k)
