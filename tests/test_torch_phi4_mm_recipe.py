"""Phi-4-multimodal through the port's VLM recipe against the JAX recipe on
the CPU.

* ``examples/vlm_finetune/tiny_phi4_mm_mock.yaml`` as written (6 steps of
  8 one-row microbatches; the mock audio rows, the clips' frame counts
  differ between microbatches, so ``stack_microbatches`` pads the frames):
  both recipes from the JAX recipe's initial params with the same seeded
  data, fp32 (``compute_dtype``, ``grad_dtype``), the input pipeline
  synchronous in both.  The steps, label counts and learning rates are
  equal, loss and grad_norm within 1e-4 relative (measured: about 1e-6;
  fp32 sums in another order).  The trainable set is JAX's
  (``freeze_embeddings``: the token table frozen).
* The published Phi-4-multimodal-instruct widths (text H 3,072, 24 / 8
  heads, D 128, V 200,064; the conformer's 24 blocks at D 1,024):
  every parameter's shape equals the JAX model's abstract tree, leaf for
  leaf, built on the ``meta`` device (no memory).
"""

import os

import jax
import numpy as np
import pytest
import torch

from automodel_tpu.config.arg_parser import (
    parse_args_and_load_config as jax_config,
)
from automodel_tpu.models import phi4_mm as jp
from automodel_tpu.recipes.vlm.finetune import FinetuneRecipeForVLM as JaxVLM
from automodel_tpu_torch.config.loader import parse_args_and_load_config
from automodel_tpu_torch.models import phi4_mm as tp
from automodel_tpu_torch.models.weights import (
    jax_leaves,
    load_jax_recipe_params,
)
from automodel_tpu_torch.recipes.vlm import finetune
from automodel_tpu_torch.utils.model_utils import jax_named_parameters

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "examples", "vlm_finetune",
                    "tiny_phi4_mm_mock.yaml")
REL = 1e-4
FP32 = ["--model.compute_dtype", "float32",
        "--training.grad_dtype", "float32",
        "--dataloader.prefetch_depth", "0"]
# Phi-4-multimodal-instruct's published text and audio widths
PUBLISHED = dict(
    model_type="phi4_multimodal", vocab_size=200064, hidden_size=3072,
    intermediate_size=8192, num_hidden_layers=32, num_attention_heads=24,
    num_key_value_heads=8, partial_rotary_factor=0.75,
    tie_word_embeddings=True, rope_theta=10000.0,
    max_position_embeddings=131072, original_max_position_embeddings=4096,
    audio_config=dict(hidden_size=1024, intermediate_size=1536,
                      num_blocks=24, num_attention_heads=16, input_size=80,
                      time_reduction=8, nemo_conv_channels=1024,
                      bias_max_distance=500, audio_token_id=200011))


def _one_device_jax_recipe(cfg):
    real = jax.devices
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "devices", lambda *a: real(*a)[:1])
    try:
        return JaxVLM(cfg).setup()
    finally:
        mp.undo()


def test_tiny_yaml_runs_through_the_port_as_the_jax_recipe(tmp_path):
    args = ["--config", YAML, *FP32]
    jr = _one_device_jax_recipe(jax_config(
        args + ["--checkpoint.checkpoint_dir", str(tmp_path / "jck")]))
    jsteps = []
    finalize = jr._finalize_metrics

    def record(pending):
        out = finalize(pending)
        jsteps.append(out)
        return out

    jr._finalize_metrics = record
    jparams = jax.tree.map(np.asarray, jr.params)
    jr.run_train_validation_loop()

    pr = finetune.FinetuneRecipeForVLM(parse_args_and_load_config(
        args + ["--device", "cpu", "--checkpoint.checkpoint_dir",
                str(tmp_path / "pck")])).setup()
    assert type(pr.processor).__name__ == "Phi4MMProcessor"
    assert isinstance(pr.model, tp.Phi4MMForCausalLM)
    load_jax_recipe_params(pr, jparams)
    assert len(pr.dataloader) == len(jr.dataloader)
    trainable = {n for n, p in jax_named_parameters(pr.model)
                 if p.requires_grad}
    assert "language_model.embed_tokens.embedding" not in trainable
    assert "audio_embed.encoder.encoders.self_attn.q_proj.kernel" in trainable
    assert "audio_embed.up_proj_for_speech.kernel" in trainable
    pr.run_train_validation_loop()

    assert [m["step"] for m in pr.history] == list(range(1, 7))
    assert [m["step"] for m in jsteps] == [m["step"] for m in pr.history]
    for k in ("num_label_tokens", "lr"):
        assert [m[k] for m in pr.history] == [m[k] for m in jsteps], k
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([m[k] for m in pr.history],
                                   [m[k] for m in jsteps], rtol=REL,
                                   err_msg=k)


def test_published_widths_match_the_jax_abstract_tree():
    cfg = tp.Phi4MMConfig.from_hf_config(dict(PUBLISHED))
    model = tp.Phi4MMForCausalLM(cfg, device="meta")
    jm = jp.Phi4MMForCausalLM(jp.Phi4MMConfig.from_hf_config(dict(PUBLISHED)))
    flat = {tuple(k.key for k in path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(jm.abstract_params())[0]}
    seen = set()
    for path, target, transposed in jax_leaves(model):
        seen.add(path)
        ts = target if isinstance(target, list) else [target]
        shape = tuple(ts[0].shape[::-1] if transposed else ts[0].shape)
        if isinstance(target, list):
            shape = (len(ts),) + shape
        assert shape == tuple(flat[path]), path
    assert seen == set(flat)
    enc = cfg.audio_config
    assert (enc.head_dim, enc.nemo_final_size, enc.num_buckets) == (64, 10,
                                                                    1000)
    assert model.language_model._rotary_dim() == 96
