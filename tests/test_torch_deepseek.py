"""The port's DeepSeek-V2 / V3 families (``models/deepseek_v3.py``,
``models/deepseek_v2.py``), their routers (``ops/moe.py``) and yarn rope
(``ops/rotary.py``), against the JAX package on the CPU, fp32.

* Routers: ``noaux_topk_routing`` (sigmoid scores, a correction bias with
  negative entries, group-limited top-k with masked groups at 0.0,
  ``norm_topk`` on and off, a scaling factor) and
  ``softmax_group_topk_routing`` (``greedy`` and ``group_limited_greedy``)
  on seeded scores: indices equal, weights within 1e-6.
* yarn: ``inv_freq`` and ``attention_scaling`` within 1e-6 of the JAX
  ``rope_parameters`` (DeepSeek-V2-Lite's scaling, the ``rope_type``
  spelling, ``attention_factor``, ``truncate: false``), and the models'
  softmax scale and rope amplitude equal to the JAX models'.
* Tiny V3 (low-rank q, groups of experts, yarn) and V2 (plain q_proj,
  ``group_limited_greedy``, V2-Lite's yarn): every leaf carried by
  ``load_jax_params``; logits and the summed CE loss's gradients against
  ``jax.value_and_grad`` of the JAX step's loss within 2e-5 relative
  (atol 2e-5 of each tensor's largest element: fp32, sums in another
  order) on packed rows with no padding tail (a row with no key to attend
  has different stated outputs in the two packages, ROADMAP Queue 3).
* The recipe on ``tiny_deepseek_v3_sft.yaml`` and a V2 twin (the same
  YAML with ``model_type: deepseek_v2``), dropless, 6 steps from the JAX
  recipe's initial weights: losses within 1e-4 relative of JAX's.
* ``generate()`` over the split dense cache: tokens equal to the JAX
  ``generate`` on ragged prompts.
* HF-format repos written by one package read by the other, both ways,
  the dense / MoE ``layer_offset`` included; a checkpoint without V3's
  correction bias reads it as zeros.
* The refusals: ``DecodeEngine`` on an MLA model, the flash rung at head
  dim 192, LoRA on the MLA projections.
"""

import json
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
from automodel_tpu.generation import generate as jax_generate
from automodel_tpu.generation import GenerationConfig as JaxGenerationConfig
from automodel_tpu.loss.masked_ce import MaskedCrossEntropy as JaxCE
from automodel_tpu.models import hf_io as jhf
from automodel_tpu.models.deepseek_v2 import DeepseekV2Config as JaxV2Config
from automodel_tpu.models.deepseek_v2 import DeepseekV2ForCausalLM as JaxV2
from automodel_tpu.models.deepseek_v3 import DeepseekV3Config as JaxV3Config
from automodel_tpu.models.deepseek_v3 import DeepseekV3ForCausalLM as JaxV3
from automodel_tpu.ops import moe as jmoe
from automodel_tpu.ops import rotary as jrotary
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JaxRecipe,
)
from automodel_tpu.training.train_step import _microbatch_loss
from automodel_tpu_torch.config.loader import parse_args_and_load_config
from automodel_tpu_torch.generation import GenerationConfig, generate
from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
from automodel_tpu_torch.models import hf_io
from automodel_tpu_torch.models.auto_model import build_model
from automodel_tpu_torch.models.deepseek_v2 import (
    DeepseekV2Config,
    DeepseekV2ForCausalLM,
)
from automodel_tpu_torch.models.deepseek_v3 import (
    DeepseekV3Config,
    DeepseekV3ForCausalLM,
)
from automodel_tpu_torch.models.weights import (
    jax_leaves,
    load_jax_params,
    load_jax_recipe_params,
)
from automodel_tpu_torch.ops import moe, rotary
from automodel_tpu_torch.recipes.llm import train_ft
from automodel_tpu_torch.training.train_step import microbatch_loss

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "automodel_tpu_torch", "examples")
TINY_YAML = os.path.join(EXAMPLES, "tiny_deepseek_v3_sft.yaml")
LITE_YAML = os.path.join(EXAMPLES, "deepseek_v2_lite_sft.yaml")
REL = 2e-5

LITE_YARN = {"type": "yarn", "factor": 40,
             "original_max_position_embeddings": 4096, "beta_fast": 32,
             "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707}
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=4, rope_theta=10000.0,
            tie_word_embeddings=False, kv_lora_rank=32, qk_rope_head_dim=8,
            qk_nope_head_dim=16, v_head_dim=16, n_routed_experts=4,
            num_experts_per_tok=2, n_shared_experts=1,
            moe_intermediate_size=32, first_k_dense_replace=1,
            moe_group_size=32, max_position_embeddings=512)
FAMILIES = {
    "v3": (dict(TINY, q_lora_rank=24, n_group=2, topk_group=1,
                routed_scaling_factor=2.5,
                rope_scaling={"rope_type": "yarn", "factor": 4.0,
                              "original_max_position_embeddings": 32,
                              "mscale_all_dim": 1.0}),
           JaxV3Config, JaxV3, DeepseekV3Config, DeepseekV3ForCausalLM),
    "v2": (dict(TINY, q_lora_rank=None, topk_method="group_limited_greedy",
                n_group=2, topk_group=1, norm_topk_prob=False,
                rope_scaling=dict(LITE_YARN, factor=8,
                                  original_max_position_embeddings=32)),
           JaxV2Config, JaxV2, DeepseekV2Config, DeepseekV2ForCausalLM),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {tuple(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def make_pair(family, capacity=2.0, seed=0):
    cfg, jcfg_cls, jcls, cfg_cls, cls = FAMILIES[family]
    cfg = dict(cfg, moe_capacity_factor=capacity)
    jm = jcls(jcfg_cls(**cfg), param_dtype=jnp.float32,
              compute_dtype=jnp.float32, remat=True)
    params = jm.init(jax.random.key(seed))
    leaves, td = jax.tree.flatten(params)
    rng = np.random.default_rng(5)       # perturb: non-degenerate argmax
    params = jax.tree.unflatten(td, [
        np.asarray(l) + 0.05 * rng.normal(size=l.shape).astype(np.float32)
        for l in leaves])
    model = cls(cfg_cls(**cfg), param_dtype=torch.float32,
                compute_dtype=torch.float32, device="cpu")
    load_jax_params(model, params)
    return jm, params, model


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def pair(request):
    return make_pair(request.param)


def packed_batch(B=2, S=64, seed=3):
    """Rows of 4 packed samples that fill the row (no padding tail)."""
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


# ---------------------------------------------------------------------------
# routers and rope
# ---------------------------------------------------------------------------
V3_ROUTES = [
    # (E, k, n_group, topk_group, norm_topk, scaling)
    (8, 2, 1, 1, True, 1.0), (16, 4, 4, 2, True, 2.5),
    (16, 4, 4, 1, False, 1.0), (64, 6, 8, 3, True, 2.5),
]


@pytest.mark.parametrize("case", V3_ROUTES, ids=[str(c) for c in V3_ROUTES])
def test_noaux_router_matches_jax(case):
    E, k, ng, tg, norm, scale = case
    rng = np.random.default_rng(E + k + ng)
    scores = 1 / (1 + np.exp(-rng.normal(size=(3, 37, E)))).astype(
        np.float32)
    bias = (0.6 * rng.normal(size=E) - 0.5).astype(np.float32)
    kw = dict(n_group=ng, topk_group=tg, norm_topk=norm,
              routed_scaling_factor=scale)
    jw, ji = jmoe.noaux_topk_routing(jnp.asarray(scores), jnp.asarray(bias),
                                     k, **kw)
    tw, ti = moe.noaux_topk_routing(torch.from_numpy(scores),
                                    torch.from_numpy(bias), k, **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("method,ng,tg", [("greedy", 1, 1),
                                          ("group_limited_greedy", 4, 2),
                                          ("group_limited_greedy", 8, 1)])
def test_softmax_group_router_matches_jax(method, ng, tg):
    rng = np.random.default_rng(ng * 10 + tg)
    logits = rng.normal(size=(2, 29, 64)).astype(np.float32)
    scores = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    kw = dict(topk_method=method, n_group=ng, topk_group=tg,
              routed_scaling_factor=1.5)
    jw, ji = jmoe.softmax_group_topk_routing(jnp.asarray(scores), 6, **kw)
    tw, ti = moe.softmax_group_topk_routing(torch.from_numpy(scores), 6,
                                            **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6,
                               rtol=1e-6)
    with pytest.raises(NotImplementedError, match="topk_method"):
        moe.softmax_group_topk_routing(torch.from_numpy(scores), 6,
                                       topk_method="noaux_tc")


YARNS = {
    "v2_lite": (64, 10000.0, LITE_YARN, 163840),
    "rope_type_key": (32, 50000.0, {"rope_type": "yarn", "factor": 8.0,
                                    "original_max_position_embeddings": 512},
                      4096),
    "attention_factor": (16, 10000.0, {"rope_type": "yarn", "factor": 4.0,
                                       "attention_factor": 1.3,
                                       "beta_fast": 16, "beta_slow": 2},
                         2048),
    "no_truncate": (64, 10000.0, dict(LITE_YARN, truncate=False), 163840),
}


@pytest.mark.parametrize("name", list(YARNS))
def test_yarn_tables_match_jax(name):
    dim, theta, scaling, max_pos = YARNS[name]
    inv, scale = rotary.rope_tables(dim, theta, scaling,
                                    max_position_embeddings=max_pos)
    jinv, jscale = jrotary.rope_parameters(dim, theta, scaling,
                                           max_position_embeddings=max_pos)
    np.testing.assert_allclose(inv, jinv, rtol=1e-6, atol=0)
    assert abs(scale - jscale) <= 1e-6
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 5, 4, dim)).astype(np.float32)
    k = rng.normal(size=(2, 5, 1, dim)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    jq, jk = jrotary.apply_rope(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(pos), jnp.asarray(jinv),
                                attention_scaling=jscale)
    tq, tk = rotary.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(pos), torch.from_numpy(inv),
                               scale)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)


def test_longrope_still_raises():
    """Longrope, once refused here, is ported: its short and long tables
    and amplitude equal JAX's (an unknown rope type still raises)."""
    scaling = {"rope_type": "longrope", "factor": 8.0,
               "short_factor": [1.0 + 0.1 * i for i in range(16)],
               "long_factor": [1.5 + 0.3 * i for i in range(16)]}
    for seq_len in (1, 4096, 4097):
        kw = dict(max_position_embeddings=32768, seq_len=seq_len)
        got, got_scale = rotary.rope_tables(32, 10000.0, scaling, **kw)
        want, want_scale = jrotary.rope_parameters(32, 10000.0, scaling,
                                                   **kw)
        np.testing.assert_array_equal(got, want)
        assert got_scale == want_scale
    with pytest.raises(NotImplementedError, match="rope_type"):
        rotary.rope_tables(32, 10000.0, {"rope_type": "ntk_blend"})


def test_softmax_scale_and_rope_amplitude_match_jax(pair):
    jm, _, model = pair
    assert model.attn_scale == pytest.approx(jm._attn_scale, rel=1e-7)
    assert model.rope_attention_scaling == pytest.approx(
        jm.rope_attention_scaling, rel=1e-7)
    np.testing.assert_array_equal(model.inv_freq.numpy(),
                                  np.asarray(jm.inv_freq))


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------
def test_load_jax_params_fills_every_leaf(pair):
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
    has_bias = ("layers", "mlp", "gate", "e_score_correction_bias") in flat
    assert has_bias == (not isinstance(model, DeepseekV2ForCausalLM))
    with pytest.raises(KeyError, match="lack"):
        load_jax_params(model, {k: v for k, v in params.items()
                                if k != "dense_layers"})


def test_logits_and_grads_match_jax(pair):
    jm, params, model = pair
    batch = packed_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = jm(params, jb["input_ids"], position_ids=jb["position_ids"],
             segment_ids=jb["segment_ids"])
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        out = model(t["input_ids"], position_ids=t["position_ids"],
                    segment_ids=t["segment_ids"])
    want = np.asarray(ref["logits"])
    np.testing.assert_allclose(out["logits"].numpy(), want, rtol=REL,
                               atol=REL * np.abs(want).max())
    assert "aux_loss" not in out
    jloss, jgrads = jax.value_and_grad(
        lambda p: _microbatch_loss(jm, JaxCE(), p, jb))(
        jax.tree.map(jnp.asarray, params))
    model.zero_grad(set_to_none=True)
    loss = microbatch_loss(model, MaskedCrossEntropy(), t)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=REL)
    flat = _flat(jgrads)
    for path, target, transposed in jax_leaves(model):
        ref = flat[path]
        grads = [p.grad for p in (target if isinstance(target, list)
                                  else [target])]
        if path[-1] == "e_score_correction_bias":
            assert all(g is None for g in grads) and not ref.any()
            continue
        got = np.stack([g.numpy() for g in grads]) if isinstance(
            target, list) else grads[0].numpy()
        if transposed:
            got = np.swapaxes(got, -1, -2)
        np.testing.assert_allclose(got, ref, rtol=REL,
                                   atol=REL * np.abs(ref).max(),
                                   err_msg=".".join(path))


def test_flops_per_token_match_jax(pair):
    jm, _, model = pair
    assert model.flops_per_token() == jm.flops_per_token()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_generate_matches_jax(family):
    jm, params, model = make_pair(family, capacity=None)
    rng = np.random.default_rng(9)
    ids = rng.integers(1, 127, (3, 9)).astype(np.int32)
    lens = np.array([9, 5, 2], np.int32)
    cfg = dict(max_new_tokens=7)
    want = jax_generate(jm, params, ids, prompt_lens=lens,
                        config=JaxGenerationConfig(**cfg))
    got = generate(model, ids, prompt_lens=lens,
                   config=GenerationConfig(**cfg))
    np.testing.assert_array_equal(got, np.asarray(want))
    cache = model.init_kv_cache(2, 16)
    assert sorted(cache) == ["dense_layers", "layers"]
    assert cache["layers"]["k"].shape == (2, 2, 16, 4, 24)


# ---------------------------------------------------------------------------
# HF-format repos across the packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_hf_repos_cross_the_packages_both_ways(family, tmp_path):
    jm, params, model = make_pair(family, seed=4)
    jhf.save_hf_weights(jm, _np(params), str(tmp_path / "jax"))
    fresh = FAMILIES[family][4](FAMILIES[family][3](**FAMILIES[family][0]),
                                param_dtype=torch.float32,
                                compute_dtype=torch.float32, device="cpu")
    hf_io.load_hf_weights(fresh, str(tmp_path / "jax"))
    for (path, a, _), (_, b, _) in zip(jax_leaves(fresh), jax_leaves(model)):
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            torch.testing.assert_close(x, y, rtol=0, atol=0,
                                       msg=".".join(path))
    hf_io.save_hf_weights(model, str(tmp_path / "port"), max_shard_bytes=4096)
    with open(tmp_path / "port" / hf_io.SAFETENSORS_INDEX) as f:
        names = json.load(f)["weight_map"]
    # HF layer 0 is the dense layer, 1 and 2 the MoE ones (layer_offset)
    assert "model.layers.0.mlp.gate_proj.weight" in names
    assert "model.layers.1.mlp.experts.3.down_proj.weight" in names
    assert "model.layers.2.mlp.shared_experts.up_proj.weight" in names
    assert "model.layers.0.mlp.gate.weight" not in names
    assert ("model.layers.1.mlp.gate.e_score_correction_bias" in names) == (
        family == "v3")
    back = jhf.load_hf_weights(jm, str(tmp_path / "port"))
    for a, b in zip(jax.tree.leaves(_np(back)), jax.tree.leaves(_np(params))):
        np.testing.assert_array_equal(a, b)
    with open(tmp_path / "port" / "config.json") as f:
        arch = json.load(f)["architectures"]
    assert arch == [{"v3": "DeepseekV3ForCausalLM",
                     "v2": "DeepseekV2ForCausalLM"}[family]]


def test_a_checkpoint_without_the_correction_bias_reads_zeros(tmp_path):
    _, _, model = make_pair("v3")
    with torch.no_grad():
        for layer in model.layers:
            layer.mlp.gate.e_score_correction_bias.fill_(0.5)
    state = {n: t for n, t in hf_io.hf_state(model).items()
             if not n.endswith("e_score_correction_bias")}
    hf_io.save_hf_weights(model, str(tmp_path), state=state)
    hf_io.load_hf_weights(model, str(tmp_path))
    assert all(not layer.mlp.gate.e_score_correction_bias.any()
               for layer in model.layers)


# ---------------------------------------------------------------------------
# the recipe against the JAX recipe
# ---------------------------------------------------------------------------
def _run_recipes(overrides):
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
    return jsteps, pr.history, pr


TWINS = {
    "v3": [],
    "v2": ["--model.config.model_type", "deepseek_v2",
           "--model.config.topk_method", "greedy",
           "--model.config.norm_topk_prob", "false"],
}


@pytest.mark.parametrize("family", sorted(TWINS))
def test_tiny_recipe_follows_jax(family):
    overrides = ["--model.config.moe_capacity_factor", "null", *TWINS[family]]
    jsteps, history, pr = _run_recipes(overrides)
    assert isinstance(pr.model, (DeepseekV2ForCausalLM if family == "v2"
                                 else DeepseekV3ForCausalLM))
    assert [m["step"] for m in history] == list(range(1, 7))
    assert [int(m["num_label_tokens"]) for m in jsteps] == [
        m["num_label_tokens"] for m in history]
    np.testing.assert_allclose([m["loss"] for m in history],
                               [float(m["loss"]) for m in jsteps],
                               rtol=1e-4, err_msg="loss")
    if family == "v3":
        # the correction bias: no gradient, no decay -- AdamW leaves it
        for layer in pr.model.layers:
            assert not layer.mlp.gate.e_score_correction_bias.any()


# ---------------------------------------------------------------------------
# YAMLs and refusals
# ---------------------------------------------------------------------------
LITE_PUBLISHED = dict(
    vocab_size=102400, hidden_size=2048, intermediate_size=10944,
    num_attention_heads=16, num_key_value_heads=16, q_lora_rank=None,
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128, moe_intermediate_size=1408, n_routed_experts=64,
    num_experts_per_tok=6, n_shared_experts=2, first_k_dense_replace=1,
    topk_method="greedy", n_group=1, topk_group=1, norm_topk_prob=False,
    routed_scaling_factor=1.0, rope_theta=10000.0, rope_scaling=LITE_YARN,
    max_position_embeddings=163840, rms_norm_eps=1e-6,
    tie_word_embeddings=False)


def test_v2_lite_yaml_has_the_published_widths():
    with open(LITE_YAML) as f:
        cfg = yaml.safe_load(f)
    model = cfg["model"]["config"]
    assert model["model_type"] == "deepseek_v2"
    for key, value in LITE_PUBLISHED.items():
        assert model[key] == value, key
    assert model["num_hidden_layers"] == 4         # the one cut: 27 -> 4
    assert model["moe_capacity_factor"] is None    # dropless, as HF
    assert cfg["loss_fn"]["chunk_len"] == 1024
    built = DeepseekV2Config.from_hf_config(model)
    assert built.qk_head_dim == 192 and built.head_dim == 64


def test_v2_lite_yaml_runs_on_the_cpu_at_a_tiny_size():
    over = ["--model.config.vocab_size", "512",
            "--model.config.hidden_size", "64",
            "--model.config.intermediate_size", "96",
            "--model.config.num_hidden_layers", "2",
            "--model.config.num_attention_heads", "2",
            "--model.config.num_key_value_heads", "2",
            "--model.config.kv_lora_rank", "16",
            "--model.config.qk_nope_head_dim", "16",
            "--model.config.qk_rope_head_dim", "8",
            "--model.config.v_head_dim", "16",
            "--model.config.moe_intermediate_size", "32",
            "--model.config.n_routed_experts", "8",
            "--dataset.vocab_size", "512", "--dataset.num_sentences", "32",
            "--dataset.mean_len", "100", "--dataset.std_len", "20",
            "--dataset.max_sentence_len", "255",
            "--packed_sequence.packed_sequence_size", "256",
            "--step_scheduler.global_batch_size", "2",
            "--step_scheduler.local_batch_size", "2",
            "--step_scheduler.max_steps", "2"]
    pr = train_ft.TrainFinetuneRecipeForNextTokenPrediction(
        parse_args_and_load_config(["-c", LITE_YAML, "--device", "cpu",
                                    *over])).setup()
    pr.run_train_validation_loop()
    assert len(pr.history) == 2
    assert all(np.isfinite(m["loss"]) for m in pr.history)


def test_the_refusals():
    from automodel_tpu_torch.ops.attention import attention
    from automodel_tpu_torch.peft.lora import PeftConfig, build_lora
    from automodel_tpu_torch.serving.engine import DecodeEngine

    _, _, model = make_pair("v2")
    with pytest.raises(NotImplementedError, match="generate"):
        DecodeEngine(model, device="cpu")
    q = torch.zeros(1, 128, 2, 192)
    with pytest.raises(NotImplementedError, match="Queue 2 C item 7"):
        attention(q, q, q, impl="flash")
    with pytest.raises(NotImplementedError, match="MLA"):
        build_lora(model, PeftConfig(target_modules=["*_proj"], dim=4))
    with pytest.raises(NotImplementedError, match="MLA"):
        model(torch.zeros(1, 4, dtype=torch.int64), adapters=[{}])
    v3 = build_model(dict(FAMILIES["v3"][0], model_type="deepseek_v3",
                          torch_dtype="float32"), device="cpu")
    assert isinstance(v3, DeepseekV3ForCausalLM)
    assert not any(l.mlp.gate.e_score_correction_bias.any()
                   for l in v3.layers)
