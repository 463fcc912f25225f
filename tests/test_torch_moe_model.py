"""The port's MoE model families (``models/mixtral.py``,
``models/qwen3_moe.py``) and the SFT recipe on them, against the JAX
package on the CPU, fp32.

* Tiny Mixtral and tiny Qwen3-MoE (2 layers, hidden 64, 8 experts, top-2,
  capacity factor 2.0 in groups of 16 tokens, so assignments are dropped):
  logits, ``aux_loss``, the summed CE loss with the aux term and every
  parameter's gradient against ``jax.value_and_grad`` of the JAX step's
  ``_microbatch_loss``, weights carried by ``load_jax_params``.  The rows
  are packed samples with no padding tail: a padding row has no key to
  attend, and the two packages state different outputs for it (ROADMAP
  Queue 3), which MoE routing would carry into the capacity queues and the
  aux statistics.  Tolerance: logits 1e-4 relative / 1e-5 absolute, loss
  and aux 1e-5 relative, gradients 1e-4 relative plus 1e-5 of each
  gradient's largest element (fp32, sums in another order).
* The recipe on ``tiny_qwen3_moe_sft.yaml`` against the JAX recipe on the
  same YAML, 6 steps from the same weights: dropless and without the aux
  term the trajectories agree to 1e-4 relative (measured: 1.8e-6 loss,
  3.3e-6 grad_norm); as written (capacity 2.0, aux on) the packed rows'
  padding tails enter both (see above), measured 2.2e-4 (loss) and 1.6e-3
  (grad_norm) at worst, held to 1e-3 and 5e-3.
* The Qwen3-30B-A3B YAML's model block is the published config.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from automodel_tpu.config.arg_parser import (
    parse_args_and_load_config as jax_config,
)
from automodel_tpu.loss.masked_ce import MaskedCrossEntropy as JaxCE
from automodel_tpu.models.mixtral import MixtralConfig as JaxMixtralConfig
from automodel_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
from automodel_tpu.models.qwen3_moe import Qwen3MoeConfig as JaxQwenConfig
from automodel_tpu.models.qwen3_moe import Qwen3MoeForCausalLM as JaxQwen
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JaxRecipe,
)
from automodel_tpu.training.train_step import _microbatch_loss
from automodel_tpu_torch.config.loader import parse_args_and_load_config
from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
from automodel_tpu_torch.models.auto_model import build_model
from automodel_tpu_torch.models.mixtral import (
    MixtralConfig,
    MixtralForCausalLM,
)
from automodel_tpu_torch.models.qwen3_moe import (
    Qwen3MoeConfig,
    Qwen3MoeForCausalLM,
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
EXAMPLES = os.path.join(REPO, "automodel_tpu_torch", "examples")
TINY_YAML = os.path.join(EXAMPLES, "tiny_qwen3_moe_sft.yaml")
QWEN_YAML = os.path.join(EXAMPLES, "qwen3_30b_a3b_sft.yaml")

BASE = dict(vocab_size=128, hidden_size=64, intermediate_size=32,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            rope_theta=10000.0, tie_word_embeddings=False,
            num_experts_per_tok=2, output_router_logits=True,
            router_aux_loss_coef=0.02, moe_capacity_factor=2.0,
            moe_group_size=16)
FAMILIES = {
    "mixtral": (dict(BASE, num_local_experts=8), JaxMixtralConfig,
                JaxMixtral, MixtralConfig, MixtralForCausalLM),
    "qwen3_moe": (dict(BASE, num_experts=8, moe_intermediate_size=32,
                       head_dim=16, norm_topk_prob=True),
                  JaxQwenConfig, JaxQwen, Qwen3MoeConfig,
                  Qwen3MoeForCausalLM),
}


def packed_batch(B=2, S=64, seed=3):
    """Rows of 4 packed samples that fill the row (no padding tail):
    positions restart per sample, the labels are the ids."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 128, (B, S)).astype(np.int32)
    seg = np.zeros((B, S), np.int32)
    pos = np.zeros((B, S), np.int32)
    for b in range(B):
        cuts = [0, *np.sort(rng.choice(np.arange(6, S - 6), 3,
                                       replace=False)), S]
        for i in range(4):
            seg[b, cuts[i]:cuts[i + 1]] = i + 1
            pos[b, cuts[i]:cuts[i + 1]] = np.arange(cuts[i + 1] - cuts[i])
    return {"input_ids": ids, "position_ids": pos, "segment_ids": seg,
            "labels": ids.copy()}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def pair(request):
    cfg, jcfg_cls, jcls, cfg_cls, cls = FAMILIES[request.param]
    jm = jcls(jcfg_cls(**cfg), param_dtype=jnp.float32,
              compute_dtype=jnp.float32, remat=True)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    model = cls(cfg_cls(**cfg), param_dtype=torch.float32,
                compute_dtype=torch.float32, device="cpu")
    load_jax_params(model, params)
    return jm, params, model


def _flat(tree):
    return {tuple(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_weights_round_trip_logits_and_aux_match_jax(pair):
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
    batch = packed_batch()
    ref = jm(params, jnp.asarray(batch["input_ids"]),
             position_ids=jnp.asarray(batch["position_ids"]),
             segment_ids=jnp.asarray(batch["segment_ids"]))
    t = _torch_batch(batch)
    with torch.no_grad():
        out = model(t["input_ids"], position_ids=t["position_ids"],
                    segment_ids=t["segment_ids"])
    np.testing.assert_allclose(out["logits"].numpy(),
                               np.asarray(ref["logits"]), rtol=1e-4,
                               atol=1e-5)
    assert float(out["aux_loss"]) > 0
    np.testing.assert_allclose(float(out["aux_loss"]),
                               float(ref["aux_loss"]), rtol=1e-5)


def test_loss_and_grads_match_jax(pair):
    jm, params, model = pair
    batch = packed_batch(seed=4)
    jloss, jgrads = jax.value_and_grad(
        lambda p: _microbatch_loss(jm, JaxCE(), p, {
            k: jnp.asarray(v) for k, v in batch.items()}))(
        jax.tree.map(jnp.asarray, params))
    model.zero_grad(set_to_none=True)
    loss = microbatch_loss(model, MaskedCrossEntropy(), _torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    flat = _flat(jgrads)
    for path, target, transposed in jax_leaves(model):
        got = (np.stack([p.grad.numpy() for p in target])
               if isinstance(target, list) else target.grad.numpy())
        if transposed:
            got = np.swapaxes(got, -1, -2)
        ref = flat[path]
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=".".join(path))


def test_remat_on_and_off_give_the_same_grads(pair):
    """The routing statistics come back through the checkpointed layers:
    remat on and off give the same loss and gradients, bit for bit."""
    _, _, model = pair
    grads = {}
    for remat in (True, False):
        model.remat = remat
        model.zero_grad(set_to_none=True)
        loss = microbatch_loss(model, MaskedCrossEntropy(),
                               _torch_batch(packed_batch(seed=5)))
        loss.backward()
        grads[remat] = (float(loss.detach()),
                        {n: p.grad.clone() for n, p in
                         model.named_parameters()})
    model.remat = True
    assert grads[True][0] == grads[False][0]
    for name, g in grads[True][1].items():
        torch.testing.assert_close(g, grads[False][1][name], atol=0, rtol=0,
                                   msg=name)


def test_flops_per_token_match_jax(pair):
    jm, _, model = pair
    assert model.flops_per_token() == jm.flops_per_token()
    assert model.attention_flops_per_token(2048) == \
        jm.attention_flops_per_token(2048)


def test_moe_forward_over_the_dense_cache_matches_cache_free(pair):
    """An MoE model serves: its forward over the dense decode cache gives
    the cache-free forward's logits (dropless, so the routing of a row
    does not depend on the step)."""
    _, _, model = pair
    capacity = model.config.moe_capacity_factor
    model.config.moe_capacity_factor = None
    ids = torch.arange(1, 9, dtype=torch.int64).reshape(1, 8)
    try:
        with torch.no_grad():
            want = model(ids)["logits"]
            cache = model.init_kv_cache(1, 8, dtype=torch.float32)
            got = model(ids, kv_cache=cache, cache_index=0)["logits"]
    finally:
        model.config.moe_capacity_factor = capacity
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_serving_an_moe_model_raises():
    """The MoE models that still do not serve through ``DecodeEngine`` are
    DeepSeek's (MLA attention; the JAX engine cannot serve them either):
    here V3, whose refusal is its ``serving_refusal`` (V2's is in
    ``tests/test_torch_deepseek.py``).  Qwen3-MoE and Mixtral serve
    (``tests/test_torch_moe_serving.py``)."""
    from automodel_tpu_torch.models.auto_model import build_model
    from automodel_tpu_torch.serving.engine import DecodeEngine

    mla = build_model({"model_type": "deepseek_v3", "vocab_size": 64,
                       "hidden_size": 32, "intermediate_size": 64,
                       "num_hidden_layers": 1, "num_attention_heads": 2,
                       "num_key_value_heads": 2, "kv_lora_rank": 16,
                       "qk_rope_head_dim": 8, "qk_nope_head_dim": 8,
                       "v_head_dim": 8, "torch_dtype": "float32"},
                      device="cpu")
    with pytest.raises(NotImplementedError, match="DecodeEngine") as err:
        DecodeEngine(mla, device="cpu")
    assert str(err.value) == mla.serving_refusal


def _run_recipes(overrides):
    """The JAX recipe on the tiny YAML (one device) and the port's from its
    initial weights; returns both step histories."""
    jr_cfg = jax_config(["--config", TINY_YAML, *overrides])
    real = jax.devices
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "devices", lambda *a: real(*a)[:1])
    try:
        jr = JaxRecipe(jr_cfg).setup()
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
        parse_args_and_load_config(["-c", TINY_YAML, "--device", "cpu",
                                    *overrides])).setup()
    load_jax_recipe_params(pr, weights)
    pr.run_train_validation_loop()
    return jsteps, pr.history


RECIPE_CASES = [
    # (name, overrides, loss rtol, grad_norm rtol)
    ("dropless_no_aux", ["--model.config.moe_capacity_factor", "null",
                         "--model.config.router_aux_loss_coef", "0.0"],
     1e-4, 1e-4),
    ("as_written", [], 1e-3, 5e-3),
]


@pytest.mark.parametrize("overrides,loss_tol,gn_tol",
                         [c[1:] for c in RECIPE_CASES],
                         ids=[c[0] for c in RECIPE_CASES])
def test_tiny_moe_recipe_follows_jax(overrides, loss_tol, gn_tol):
    jsteps, history = _run_recipes(overrides)
    assert [m["step"] for m in history] == list(range(1, 7))
    assert [int(m["num_label_tokens"]) for m in jsteps] == [
        m["num_label_tokens"] for m in history]
    for key, tol in (("loss", loss_tol), ("grad_norm", gn_tol)):
        np.testing.assert_allclose([m[key] for m in history],
                                   [float(m[key]) for m in jsteps],
                                   rtol=tol, err_msg=key)


def test_tiny_yaml_drops_assignments():
    """``moe_capacity_factor: 2.0`` in groups of 16 drops assignments on the
    tiny YAML's first batch (the capacity path runs)."""
    from automodel_tpu_torch.ops import moe

    pr = train_ft.TrainFinetuneRecipeForNextTokenPrediction(
        parse_args_and_load_config(["-c", TINY_YAML, "--device", "cpu"]))
    pr.setup()
    model, cfg = pr.model, pr.model.config
    b = _torch_batch({k: v for k, v in next(iter(pr.dataloader)).items()
                      if k != "loss_mask"})
    layer = model.layers[0]
    with torch.no_grad():
        h = model._attention_block(
            layer, model.embed_tokens.weight[b["input_ids"]],
            b["position_ids"], b["segment_ids"], None, None)
        _, _, idx, _, _, _ = moe.route(
            layer.post_attention_layernorm(h), layer.mlp.gate.weight.t(),
            num_experts_per_tok=cfg.num_experts_per_tok,
            group_size=cfg.moe_group_size)
    _, C = moe.group_and_capacity(idx.shape[0] * idx.shape[1],
                                  cfg.moe_group_size, cfg.num_experts,
                                  cfg.num_experts_per_tok,
                                  cfg.moe_capacity_factor)
    assert int((moe._assignment_positions(idx, cfg.num_experts) >= C)
               .sum()) > 0


PUBLISHED = {      # Qwen/Qwen3-30B-A3B config.json
    "model_type": "qwen3_moe", "vocab_size": 151936, "hidden_size": 2048,
    "moe_intermediate_size": 768, "num_experts": 128,
    "num_experts_per_tok": 8, "norm_topk_prob": True,
    "num_attention_heads": 32, "num_key_value_heads": 4, "head_dim": 128,
    "rope_theta": 1e6, "rms_norm_eps": 1e-6, "tie_word_embeddings": False,
    "router_aux_loss_coef": 0.001, "decoder_sparse_step": 1,
    "mlp_only_layers": [],
}


def test_qwen3_30b_a3b_yaml_has_the_published_widths():
    with open(QWEN_YAML) as f:
        cfg = yaml.safe_load(f)
    model = cfg["model"]["config"]
    for key, value in PUBLISHED.items():
        assert model[key] == value, key
    assert model["num_hidden_layers"] == 4          # the one cut: 48 -> 4
    assert model["moe_capacity_factor"] is None     # dropless, HF semantics
    assert model["output_router_logits"] is True
    assert cfg["moe"]["dispatch"] == "sorted"
    assert cfg["dataset"]["vocab_size"] <= model["vocab_size"]
    built = Qwen3MoeConfig.from_hf_config(model)
    assert built.qk_norm and built.num_local_experts == 128


def test_build_model_families_and_the_dispatch_knob():
    cfg = parse_args_and_load_config(["-c", TINY_YAML, "--device", "cpu"])
    model = build_model(cfg.model.config, device="cpu")
    assert isinstance(model, Qwen3MoeForCausalLM)
    assert model.config.qk_norm
    mixtral = dict(FAMILIES["mixtral"][0], model_type="mixtral")
    assert isinstance(build_model(mixtral, device="cpu"), MixtralForCausalLM)
    with pytest.raises(NotImplementedError, match="gemma3n"):
        build_model({"model_type": "gemma3n"}, device="cpu")
    recipe = train_ft.TrainFinetuneRecipeForNextTokenPrediction(
        parse_args_and_load_config(["-c", TINY_YAML, "--device", "cpu",
                                    "--moe.dispatch", "onehot"])).setup()
    assert recipe.model.config.moe_dispatch == "onehot"
    with pytest.raises(ValueError, match="moe.dispatch"):
        parse_args_and_load_config(["-c", TINY_YAML, "--moe.dispatch",
                                    "blocktree"])
    dense = os.path.join(EXAMPLES, "tiny_llama_sft.yaml")
    with pytest.raises(ValueError, match="no routed-expert block"):
        train_ft.TrainFinetuneRecipeForNextTokenPrediction(
            parse_args_and_load_config(["-c", dense, "--device", "cpu",
                                        "--moe.dispatch", "sorted"])).setup()
