"""Quantized compute through the port's models and SFT recipe
(``quantization/fp8.py``, the ``quant`` seam of ``models/llama.py`` and
the MoE families, ``config/loader.py``'s ``fp8`` enums) against the JAX
package on the CPU, fp32, inputs from a seed.

Both packages quantize the same fp32 values to the same codes
(``test_torch_quant.py``), but their fp32 values upstream of a
quantization differ by ulps (other op orders), and a value within an ulp
of a rounding midpoint takes the other code; one such code moves the
products it feeds by one quantization step.  Measured when this file was
written (tiny Llama and tiny Qwen3-MoE, 2 layers, every dtype x recipe):
loss within 1.3e-7 relative, logits within 5.7e-5 relative L2 and the
whole gradient within 1.6e-3 relative L2 (int8 rowwise on Llama; the
cases without a flipped code agree to 1.2e-5).  Over 6 recipe steps the
flips accumulate: float8 Llama loss within 1.3e-4, grad_norm within
9.2e-4; float8 Qwen3-MoE as written (padding rows routed, ROADMAP Queue 3)
loss within 6.9e-4, grad_norm within 5.9e-3.  The limits below are those
measurements with headroom (about 2-3x), each stated where it is used.
"""

import dataclasses
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import automodel_tpu.ops.gmm_kernel as jgk
from automodel_tpu.config.arg_parser import (
    parse_args_and_load_config as jax_config,
)
from automodel_tpu.loss.masked_ce import MaskedCrossEntropy as JaxCE
from automodel_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from automodel_tpu.models.llama import LlamaForCausalLM as JaxLlama
from automodel_tpu.quantization import fp8 as jfp8
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JaxRecipe,
)
from automodel_tpu.training.train_step import _microbatch_loss
from automodel_tpu_torch.config.loader import (
    ConfigNode,
    parse_args_and_load_config,
    validate_config_enums,
)
from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from automodel_tpu_torch.models.weights import (
    jax_leaves,
    load_jax_params,
    load_jax_recipe_params,
)
from automodel_tpu_torch.quantization import fp8
from automodel_tpu_torch.recipes.llm import train_ft
from automodel_tpu_torch.training.train_step import microbatch_loss
from tests.test_torch_moe_model import FAMILIES as MOE_FAMILIES
from tests.test_torch_moe_model import packed_batch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "automodel_tpu_torch", "examples")
LLAMA_YAML = os.path.join(EXAMPLES, "tiny_llama_sft.yaml")
JAX_LLAMA_YAML = os.path.join(REPO, "examples", "llm_finetune",
                              "tiny_llama_mock.yaml")
MOE_YAML = os.path.join(EXAMPLES, "tiny_qwen3_moe_sft.yaml")

LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, rope_theta=10000.0,
             tie_word_embeddings=True)
FAMILIES = {
    "llama": (LLAMA, JaxLlamaConfig, JaxLlama, LlamaConfig,
              LlamaForCausalLM),
    # test_torch_moe_model.py's tiny Qwen3-MoE: 8 experts of 32, top-2,
    # capacity factor 2.0 in groups of 16, the aux loss on
    "qwen3_moe": MOE_FAMILIES["qwen3_moe"],
}
COMBOS = [("float8", "tensorwise"), ("float8", "rowwise"),
          ("int8", "tensorwise"), ("int8", "rowwise")]


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    """JAX's grouped matmuls (and so gmm_quant) run the Pallas kernel in
    interpret mode."""
    monkeypatch.setattr(jgk, "_INTERPRET", True)


def pair(family):
    cfg, jcfg_cls, jcls, cfg_cls, cls = FAMILIES[family]
    jm = jcls(jcfg_cls(**cfg), param_dtype=jnp.float32,
              compute_dtype=jnp.float32, remat=True)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    model = cls(cfg_cls(**cfg), param_dtype=torch.float32,
                compute_dtype=torch.float32, device="cpu")
    load_jax_params(model, params)
    return jm, params, model


def _torch_loss_and_grads(model, batch):
    model.zero_grad(set_to_none=True)
    loss = microbatch_loss(model, MaskedCrossEntropy(),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), [p.grad.clone() for p in model.parameters()]


@pytest.mark.parametrize("dtype,recipe", COMBOS,
                         ids=[f"{d}_{r}" for d, r in COMBOS])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fp8_model_logits_and_grads_match_jax(family, dtype, recipe):
    """``apply_fp8_to_model`` on both sides, the same weights: logits
    within 1e-4 relative L2, the summed CE loss within 1e-5 relative and
    the whole gradient within 5e-3 relative L2 (the module docstring has
    the measurements)."""
    jm, params, model = pair(family)
    jfp8.apply_fp8_to_model(jm, jfp8.FP8Config(enabled=True, dtype=dtype,
                                               recipe_name=recipe))
    fp8.apply_fp8_to_model(model, fp8.FP8Config(enabled=True, dtype=dtype,
                                                recipe_name=recipe))
    assert model.quant.enabled and model.quant.dtype == dtype
    batch = packed_batch(seed=4)
    ref = np.asarray(jm(params, jnp.asarray(batch["input_ids"]),
                        position_ids=jnp.asarray(batch["position_ids"]),
                        segment_ids=jnp.asarray(batch["segment_ids"]))
                     ["logits"])
    with torch.no_grad():
        out = model(torch.from_numpy(batch["input_ids"]),
                    position_ids=torch.from_numpy(batch["position_ids"]),
                    segment_ids=torch.from_numpy(batch["segment_ids"]))
    logits = out["logits"].numpy()
    assert np.linalg.norm(logits - ref) / np.linalg.norm(ref) < 1e-4

    jloss, jgrads = jax.value_and_grad(
        lambda p: _microbatch_loss(jm, JaxCE(), p, {
            k: jnp.asarray(v) for k, v in batch.items()}))(
        jax.tree.map(jnp.asarray, params))
    loss, _ = _torch_loss_and_grads(model, batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    flat = {tuple(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    num = den = 0.0
    for path, target, transposed in jax_leaves(model):
        got = (np.stack([p.grad.numpy() for p in target])
               if isinstance(target, list) else target.grad.numpy())
        if transposed:
            got = np.swapaxes(got, -1, -2)
        num += float(((got - flat[path]) ** 2).sum())
        den += float((flat[path] ** 2).sum())
    assert (num / den) ** 0.5 < 5e-3


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_filter_fqns_covering_every_projection_is_bitwise_unquantized(
        family):
    """A filter matching every dense projection (and the experts) makes
    the quantized model bit-identical to the unquantized one: the filtered
    products fall through to the plain matmul, not a scale-1
    quantization."""
    _, _, model = pair(family)
    batch = packed_batch(seed=5)
    ref = _torch_loss_and_grads(model, batch)
    fp8.apply_fp8_to_model(model, fp8.FP8Config(
        enabled=True, dtype="int8", filter_fqns=["_proj", "experts"]))
    got = _torch_loss_and_grads(model, batch)
    assert got[0] == ref[0]
    for a, b in zip(got[1], ref[1]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    fp8.apply_fp8_to_model(model, fp8.FP8Config(enabled=True, dtype="int8"))
    assert _torch_loss_and_grads(model, batch)[0] != ref[0]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_verify_fp8_conversion_counts_match_jax(family):
    jm, _, model = pair(family)
    for kwargs in (dict(enabled=False), dict(enabled=True),
                   dict(enabled=True, filter_fqns=["o_proj", "experts"])):
        jfp8.apply_fp8_to_model(jm, jfp8.FP8Config(**kwargs))
        fp8.apply_fp8_to_model(model, fp8.FP8Config(**kwargs))
        assert fp8.verify_fp8_conversion(model) == \
            jfp8.verify_fp8_conversion(jm), kwargs


def test_apply_fp8_on_a_quantless_family_warns_and_raises_strict(
        monkeypatch, caplog):
    class NoSeam(nn.Module):
        pass

    with caplog.at_level(logging.WARNING,
                         logger="automodel_tpu_torch.quantization.fp8"):
        fp8.apply_fp8_to_model(NoSeam(), fp8.FP8Config(enabled=True))
    assert any("silently no-op" in r.message for r in caplog.records)
    monkeypatch.setenv("AUTOMODEL_STRICT_CONFIG", "1")
    with pytest.raises(ValueError, match="no quantized-compute seam"):
        fp8.apply_fp8_to_model(NoSeam(), fp8.FP8Config(enabled=True))
    fp8.apply_fp8_to_model(NoSeam(), fp8.FP8Config(enabled=False))
    cfg = fp8.build_fp8_config(ConfigNode({"enabled": True, "dtype": "int8",
                                           "unknown_knob": 1}))
    assert (cfg.enabled, cfg.dtype, cfg.recipe_name) == (True, "int8",
                                                         "tensorwise")
    with pytest.raises(ValueError, match="fp8.recipe_name"):
        fp8.FP8Config(recipe_name="columnwise")


def test_serving_with_quantized_compute_raises():
    """Serving under quantized compute follows JAX instead of raising:
    ``DecodeEngine`` over the fp8 model gives the JAX engine's greedy
    tokens (exact; each step's tensorwise scales span the whole step
    buffer in both engines), and the steps and tokens counted agree."""
    from automodel_tpu.generation import GenerationConfig as JaxGen
    from automodel_tpu.serving import DecodeEngine as JaxEngine
    from automodel_tpu.serving import ServingConfig as JaxServing
    from automodel_tpu_torch.generation import GenerationConfig
    from automodel_tpu_torch.serving import DecodeEngine, ServingConfig

    jm, params, model = pair("llama")
    jfp8.apply_fp8_to_model(jm, jfp8.FP8Config(enabled=True))
    fp8.apply_fp8_to_model(model, fp8.FP8Config(enabled=True))
    prompts = [list(range(3, 3 + n)) for n in (7, 12, 4)]
    kw = dict(max_model_len=64, prefill_chunk=16)
    jeng = JaxEngine(jm, params, JaxServing(**kw),
                     generation=JaxGen(max_new_tokens=5))
    eng = DecodeEngine(model, ServingConfig(**kw), device="cpu",
                       generation=GenerationConfig(max_new_tokens=5))
    for e in (jeng, eng):
        for p in prompts:
            e.submit(p)
    jout = jeng.run()
    assert eng.run() == {r: [int(t) for t in toks]
                         for r, toks in jout.items()}
    for key in ("steps", "tokens_generated", "outcomes"):
        assert eng.stats()[key] == jeng.stats()[key], key


def test_fp8_enums_validated_at_load_and_after_cli_overrides(tmp_path):
    validate_config_enums(ConfigNode(
        {"fp8": {"dtype": "int8", "recipe_name": "rowwise"}}))
    validate_config_enums(ConfigNode(
        {"fp8": {"dtype": "none", "recipe_name": ""}}))
    with pytest.raises(ValueError, match="fp8.dtype"):
        validate_config_enums(ConfigNode({"fp8": {"dtype": "int4"}}))
    with pytest.raises(ValueError, match="fp8.recipe_name"):
        validate_config_enums(ConfigNode(
            {"fp8": {"recipe_name": "blockwise"}}))
    bad = tmp_path / "bad.yaml"
    bad.write_text("fp8:\n  enabled: true\n  dtype: fp4\n")
    with pytest.raises(ValueError, match="fp8.dtype"):
        parse_args_and_load_config(["-c", str(bad)])
    cfg = parse_args_and_load_config(["-c", LLAMA_YAML, "--fp8.enabled",
                                      "true", "--fp8.recipe_name",
                                      "rowwise"])
    assert cfg.get("fp8.recipe_name") == "rowwise"
    with pytest.raises(ValueError, match="fp8.dtype"):
        parse_args_and_load_config(["-c", LLAMA_YAML, "--fp8.dtype", "fp4"])
    with pytest.raises(ValueError, match="fp8.recipe_name"):
        parse_args_and_load_config(["-c", LLAMA_YAML,
                                    "--fp8.recipe_name", "blockwise"])


def _run_recipes(jax_yaml, jax_overrides, port_yaml, overrides):
    """The JAX recipe (one device) and the port's from its initial
    weights, both with ``overrides``; returns both step histories."""
    jcfg = jax_config(["--config", jax_yaml, *jax_overrides, *overrides])
    real = jax.devices
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "devices", lambda *a: real(*a)[:1])
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
    weights = jax.tree.map(np.asarray, jr.params)
    jr.run_train_validation_loop()
    pr = train_ft.TrainFinetuneRecipeForNextTokenPrediction(
        parse_args_and_load_config(["-c", port_yaml, "--device", "cpu",
                                    *overrides])).setup()
    assert dataclasses.asdict(pr.model.quant) == \
        dataclasses.asdict(jr.model.quant)
    load_jax_recipe_params(pr, weights)
    pr.run_train_validation_loop()
    return jsteps, pr.history


RECIPE_CASES = [
    # (name, JAX YAML and its overrides, port YAML, overrides, loss rtol,
    #  grad_norm rtol); measured: 1.3e-4 / 9.2e-4 and 6.9e-4 / 5.9e-3
    ("llama_float8", JAX_LLAMA_YAML,
     ["--checkpoint.enabled", "false", "--dataloader.prefetch_depth", "0",
      "--model.config.torch_dtype", "float32",
      "--model.compute_dtype", "float32"], LLAMA_YAML,
     ["--fp8.enabled", "true", "--fp8.dtype", "float8",
      "--step_scheduler.max_steps", "6"], 5e-4, 3e-3),
    ("qwen3_moe_float8", MOE_YAML, [], MOE_YAML, ["--fp8.enabled", "true"],
     2e-3, 1.5e-2),
]


@pytest.mark.parametrize("jax_yaml,jax_overrides,port_yaml,overrides,"
                         "loss_tol,gn_tol", [c[1:] for c in RECIPE_CASES],
                         ids=[c[0] for c in RECIPE_CASES])
def test_fp8_recipe_follows_jax(jax_yaml, jax_overrides, port_yaml,
                                overrides, loss_tol, gn_tol):
    jsteps, history = _run_recipes(jax_yaml, jax_overrides, port_yaml,
                                   overrides)
    assert [m["step"] for m in history] == list(range(1, 7))
    assert [int(m["num_label_tokens"]) for m in jsteps] == [
        m["num_label_tokens"] for m in history]
    for key, tol in (("loss", loss_tol), ("grad_norm", gn_tol)):
        np.testing.assert_allclose([m[key] for m in history],
                                   [float(m[key]) for m in jsteps],
                                   rtol=tol, err_msg=key)
