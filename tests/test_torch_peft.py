"""The port's LoRA (``automodel_tpu_torch/peft``) against the JAX package's
on the CPU, fp32, on a tiny Llama (2 layers, hidden 64) and the tiny MoE
families of ``test_torch_moe_model.py``: the matcher's cases, the matched
module sets, identity at init, merge = bypass, forward logits and adapter
gradients of both strategies from the same numbers, LoRA over quantized
compute, dropout's statistics, the HF-PEFT adapter files read across the
packages and the errors JAX raises.

Tolerances: logits and adapter gradients within 1e-5 relative L2 (fp32 on
both sides, sums in another order: measured at most 2.8e-6, the worst an
adapter gradient of the merge path), the summed loss within 1e-6
relative.  LoRA over int8 quantized compute holds the JAX
model's limits of ``test_torch_fp8_model.py`` (logits 1e-4, gradients
5e-3).  Dropout masks come from different generators, so dropout is held
in statistics: the kept share within 4 standard deviations of the keep
rate, kept values scaled by 1 / keep exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import automodel_tpu.ops.gmm_kernel as jgk
from automodel_tpu.loss.masked_ce import MaskedCrossEntropy as JaxCE
from automodel_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from automodel_tpu.models.llama import LlamaForCausalLM as JaxLlama
from automodel_tpu.peft import lora as jlora
from automodel_tpu.peft.module_matcher import ModuleMatcher as JaxMatcher
from automodel_tpu.peft.module_matcher import wildcard_match as jax_wildcard
from automodel_tpu.quantization import fp8 as jfp8
from automodel_tpu.training.train_step import _microbatch_loss
from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from automodel_tpu_torch.models.llama import _dropout
from automodel_tpu_torch.models.weights import jax_leaves, load_jax_params
from automodel_tpu_torch.peft import lora
from automodel_tpu_torch.peft.module_matcher import (
    ModuleMatcher,
    wildcard_match,
)
from automodel_tpu_torch.quantization import fp8
from automodel_tpu_torch.training.train_step import microbatch_loss
from tests.test_torch_moe_model import FAMILIES as MOE_FAMILIES
from tests.test_torch_moe_model import packed_batch

torch.set_num_threads(1)

LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, rope_theta=10000.0,
             tie_word_embeddings=True)
FAMILIES = {"llama": (LLAMA, JaxLlamaConfig, JaxLlama, LlamaConfig,
                      LlamaForCausalLM), **MOE_FAMILIES}
REL = 1e-5


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    """JAX's grouped matmuls (the MoE experts) run the Pallas kernel in
    interpret mode."""
    monkeypatch.setattr(jgk, "_INTERPRET", True)


def models(family="llama", **overrides):
    cfg, jcfg_cls, jcls, cfg_cls, cls = FAMILIES[family]
    cfg = dict(cfg, **overrides)
    jm = jcls(jcfg_cls(**cfg), param_dtype=jnp.float32,
              compute_dtype=jnp.float32, remat=True)
    model = cls(cfg_cls(**cfg), param_dtype=torch.float32,
                compute_dtype=torch.float32, device="cpu")
    return jm, model


def lora_pair(family="llama", seed=0, **peft):
    """The JAX LoRA model and params (adapters perturbed away from B = 0)
    and the port's on the same numbers."""
    jm, model = models(family)
    jw = jlora.LoRAModel(jm, jlora.PeftConfig(**peft))
    params = jax.tree.map(np.asarray, jw.init(jax.random.key(seed)))
    rng = np.random.default_rng(seed + 10)
    params["lora"] = jax.tree.map(
        lambda x: (x + 0.05 * rng.standard_normal(x.shape)).astype(x.dtype),
        params["lora"])
    pw = lora.LoRAModel(model, lora.PeftConfig(**peft), seed=seed)
    load_jax_params(pw, params)
    return jw, params, pw


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# -- matcher ---------------------------------------------------------------
WILDCARD = [("*_proj", "q_proj"),
            ("layers.*.q_proj", "layers.self_attn.q_proj"),
            ("q_proj", "o_proj"), ("*", "anything.at.all"),
            ("layers.mlp.*", "layers.self_attn.q_proj"), ("a.b", "aXb")]
MATCHER = [
    (dict(target_modules=["q_proj", "v_proj"]), "layers.self_attn.q_proj"),
    (dict(target_modules=["q_proj", "v_proj"]), "layers.self_attn.k_proj"),
    (dict(match_all_linear=True, exclude_modules=["*down_proj"]),
     "layers.mlp.gate_proj"),
    (dict(match_all_linear=True, exclude_modules=["*down_proj"]),
     "layers.mlp.down_proj"),
    (dict(exclude_modules=["o_proj"]), "layers.self_attn.o_proj"),
    (dict(exclude_modules=["o_proj"]), "layers.mlp.up_proj"),
    (dict(target_modules=["layers.mlp.*"], exclude_modules=["*up_proj"]),
     "layers.mlp.up_proj"),
    (dict(), "lm_head"),
]


@pytest.mark.parametrize(
    "kind,case", [("wildcard", c) for c in WILDCARD]
    + [("matcher", c) for c in MATCHER],
    ids=[f"wildcard{i}" for i in range(len(WILDCARD))]
    + [f"matcher{i}" for i in range(len(MATCHER))])
def test_matcher_cases_agree_with_jax(kind, case):
    """The JAX ``test_peft.py`` patterns and precedence (match_all_linear >
    target_modules > all-but-excluded), answered alike."""
    if kind == "wildcard":
        pattern, name = case
        assert wildcard_match(pattern, name) == jax_wildcard(pattern, name)
    else:
        kwargs, name = case
        assert ModuleMatcher(**kwargs).match(name) == \
            JaxMatcher(**kwargs).match(name)


TARGETS = [dict(target_modules=["*_proj"]), dict(match_all_linear=True),
           dict(target_modules=["q_proj", "v_proj"]),
           dict(target_modules=[], exclude_modules=["*o_proj", "gate"]),
           dict(target_modules=["layers.mlp.*"])]


@pytest.mark.parametrize("targets", TARGETS,
                         ids=[f"t{i}" for i in range(len(TARGETS))])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_matched_module_set_equals_jax(family, targets):
    jm, model = models(family)
    cfg = dict(targets, dim=4)
    want = set(jlora.match_targets(jm, jlora.PeftConfig(**cfg)))
    assert set(lora.match_targets(model, lora.PeftConfig(**cfg))) == want


@pytest.mark.parametrize("family", sorted(MOE_FAMILIES))
def test_moe_expert_targets_are_refused_as_in_jax(family):
    """``*_proj`` reaches Qwen3-MoE's expert stacks ``[L, E, in, out]``,
    which no adapter fits: JAX fails building the adapters, the port
    refuses the same config; attention targets work on both (Mixtral's
    experts are ``w1``/``w2``/``w3``, so ``*_proj`` is attention only
    there)."""
    jm, model = models(family)
    cfg = dict(target_modules=["*_proj"], dim=4)
    experts = any("experts" in m for m in jlora.match_targets(
        jm, jlora.PeftConfig(**cfg)))
    assert experts == (family == "qwen3_moe")
    if experts:
        with pytest.raises(ValueError):
            jlora.LoRAModel(jm, jlora.PeftConfig(**cfg)).init(
                jax.random.key(0))
        with pytest.raises(ValueError, match="expert"):
            lora.LoRAModel(model, lora.PeftConfig(**cfg))
    else:
        assert set(lora.LoRAModel(model, lora.PeftConfig(**cfg)).targets) \
            == {f"layers.self_attn.{p}_proj" for p in "qkvo"}


def test_moe_router_target_is_not_ported():
    _, model = models("mixtral")
    with pytest.raises(NotImplementedError, match="router|gate"):
        lora.LoRAModel(model, lora.PeftConfig(target_modules=["gate"]))


# -- forward ---------------------------------------------------------------
def test_identity_at_init_and_init_distribution():
    """B = 0: the wrapped model's logits equal the base's bit for bit; A is
    xavier-uniform within +-sqrt(6 / in) (gaussian: N(0, 1) / sqrt(r)), as
    JAX draws it; the trainable count is JAX's."""
    jm, model = models()
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 128, (2, 16)).astype(np.int64))
    with torch.no_grad():
        base = model(ids)["logits"]
        for init in ("xavier", "gaussian"):
            w = lora.LoRAModel(model, lora.PeftConfig(dim=4, lora_A_init=init))
            assert torch.equal(w(ids)["logits"], base)
            for mod_path in w.targets:
                ad = w.adapter(mod_path)
                a = torch.stack(list(ad.A))
                assert all(bool((b == 0).all()) for b in ad.B)
                if init == "xavier":
                    limit = np.sqrt(6.0 / a.shape[1])
                    assert float(a.abs().max()) <= limit
                    assert float(a.abs().max()) > 0.9 * limit
                else:
                    assert abs(float(a.std()) - 0.5) < 0.1
            jw = jlora.LoRAModel(jm, jlora.PeftConfig(dim=4))
            assert w.num_trainable_params == jw.num_trainable_params
            model = w.base_model


@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_merge_equals_bypass(family):
    kw = dict(target_modules=["q_proj", "v_proj", "o_proj"]
              if family != "llama" else ["*_proj"], dim=4, alpha=16)
    _, _, pw = lora_pair(family, **kw)
    batch = packed_batch(seed=2)
    ids = torch.from_numpy(batch["input_ids"])
    seg = torch.from_numpy(batch["segment_ids"])
    with torch.no_grad():
        assert not pw.bypass
        merged = pw(ids, segment_ids=seg)["logits"].numpy()
        pw.bypass = True
        bypass = pw(ids, segment_ids=seg)["logits"].numpy()
    assert rel_l2(bypass, merged) < REL


def _adapter_grads_match(jw, params, pw, batch):
    """Loss, logits and adapter gradients of both packages."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits = np.asarray(jw(jax.tree.map(jnp.asarray, params),
                            jb["input_ids"], position_ids=jb["position_ids"],
                            segment_ids=jb["segment_ids"])["logits"])
    jloss, jgrads = jax.value_and_grad(
        lambda lo: _microbatch_loss(jw, JaxCE(), {
            "base": jax.tree.map(jnp.asarray, params["base"]),
            "lora": lo}, jb))(jax.tree.map(jnp.asarray, params["lora"]))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits = pw(tb["input_ids"], position_ids=tb["position_ids"],
                    segment_ids=tb["segment_ids"])["logits"].numpy()
    assert rel_l2(logits, jlogits) < REL
    pw.zero_grad(set_to_none=True)
    loss = microbatch_loss(pw, MaskedCrossEntropy(), tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    assert all(p.grad is None for p in pw.base_model.parameters())
    for mod_path in pw.targets:
        ad = pw.adapter(mod_path)
        for part, ps in (("A", ad.A), ("B", ad.B)):
            got = np.stack([p.grad.numpy() for p in ps])
            want = np.asarray(jgrads[mod_path][part])
            assert rel_l2(got, want) < REL, (mod_path, part)


@pytest.mark.parametrize("strategy", ["merge", "bypass"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_lora_logits_and_adapter_grads_match_jax(family, strategy):
    targets = (["*_proj"] if family == "llama"
               else ["q_proj", "k_proj", "v_proj", "o_proj"])
    jw, params, pw = lora_pair(
        family, target_modules=targets, dim=4, alpha=16,
        use_rank_r_bypass=strategy == "bypass")
    assert pw.bypass == jw._bypass == (strategy == "bypass")
    _adapter_grads_match(jw, params, pw, packed_batch(seed=4))


def test_lora_over_quantized_compute_matches_jax():
    """fp8 (int8 tensorwise here) applied before LoRA, as the recipe does:
    the base product through qdot, the adapter delta plain, on both
    sides."""
    jm, model = models()
    jfp8.apply_fp8_to_model(jm, jfp8.FP8Config(enabled=True, dtype="int8"))
    fp8.apply_fp8_to_model(model, fp8.FP8Config(enabled=True, dtype="int8"))
    kw = dict(target_modules=["*_proj"], dim=4, alpha=16)
    for bypass in (False, True):
        jw = jlora.LoRAModel(jm, jlora.PeftConfig(use_rank_r_bypass=bypass,
                                                  **kw))
        params = jax.tree.map(np.asarray, jw.init(jax.random.key(1)))
        params["lora"] = jax.tree.map(lambda x: x + np.float32(0.03),
                                      params["lora"])
        pw = lora.LoRAModel(model, lora.PeftConfig(
            use_rank_r_bypass=bypass, **kw))
        load_jax_params(pw, params)
        assert pw.quant.enabled
        batch = packed_batch(seed=6)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        jlogits = np.asarray(jw(jax.tree.map(jnp.asarray, params),
                                jb["input_ids"],
                                segment_ids=jb["segment_ids"],
                                position_ids=jb["position_ids"])["logits"])
        with torch.no_grad():
            logits = pw(tb["input_ids"], segment_ids=tb["segment_ids"],
                        position_ids=tb["position_ids"])["logits"].numpy()
        assert rel_l2(logits, jlogits) < 1e-4
        jgrads = jax.grad(lambda lo: _microbatch_loss(jw, JaxCE(), {
            "base": jax.tree.map(jnp.asarray, params["base"]),
            "lora": lo}, jb))(jax.tree.map(jnp.asarray, params["lora"]))
        pw.zero_grad(set_to_none=True)
        microbatch_loss(pw, MaskedCrossEntropy(), tb).backward()
        num = den = 0.0
        for mod_path in pw.targets:
            ad = pw.adapter(mod_path)
            for part, ps in (("A", ad.A), ("B", ad.B)):
                got = np.stack([p.grad.numpy() for p in ps])
                want = np.asarray(jgrads[mod_path][part])
                num += float(((got - want) ** 2).sum())
                den += float((want ** 2).sum())
        assert (num / den) ** 0.5 < 5e-3
        model = pw.base_model


# -- dropout ---------------------------------------------------------------
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_statistics_match_jax(rate):
    """Keep share and inverted scale of the port's masks against
    ``jax.random.bernoulli``'s as the JAX layer applies them; deterministic
    from the seed and name."""
    n = 200_000
    keep = 1.0 - rate
    ones = torch.ones(n)
    got = _dropout(ones, rate, 123, "self_attn.q_proj")
    m = jax.random.bernoulli(jax.random.key(3), keep, (n,))
    want = np.asarray(jnp.where(m, jnp.ones(n) / keep, 0.0))
    sigma = np.sqrt(keep * (1 - keep) / n)
    for out in (got.numpy(), want):
        kept = out != 0
        assert abs(kept.mean() - keep) < 4 * sigma
        np.testing.assert_array_equal(out[kept], np.float32(1.0 / keep))
    assert torch.equal(got, _dropout(ones, rate, 123, "self_attn.q_proj"))
    assert not torch.equal(got, _dropout(ones, rate, 123, "mlp.up_proj"))
    assert not torch.equal(got, _dropout(ones, rate, 124, "self_attn.q_proj"))


@pytest.mark.parametrize("position", ["pre", "post"])
def test_dropout_trains_only_and_repeats_per_step(position):
    """In training the forward differs from eval and repeats for the same
    (step, microbatch); eval (or no grad) is the dropout-free bypass, which
    equals JAX's forward without a dropout rng."""
    jw, params, pw = lora_pair(dim=4, alpha=16, dropout=0.3,
                               dropout_position=position)
    assert pw.bypass and jw._bypass
    batch = packed_batch(seed=1)
    ids = torch.from_numpy(batch["input_ids"])
    jlogits = np.asarray(jw(jax.tree.map(jnp.asarray, params),
                            jnp.asarray(batch["input_ids"]))["logits"])
    with torch.no_grad():
        off = pw(ids)["logits"]
    assert rel_l2(off.numpy(), jlogits) < REL
    runs = []
    for step in (1, 1, 2):
        pw.set_dropout_step(step)
        runs.append(pw(ids)["logits"].detach())
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], off)
    pw.eval()
    pw.set_dropout_step(1)
    assert torch.equal(pw(ids)["logits"].detach(), off)


def test_dropout_mask_is_the_same_under_remat():
    """The layer recomputed in the backward draws the same masks: the
    gradient with remat equals the gradient without."""
    _, _, pw = lora_pair(dim=4, alpha=16, dropout=0.5)
    tb = {k: torch.from_numpy(v) for k, v in packed_batch(seed=7).items()}
    grads = []
    for remat in (True, False):
        pw.base_model.remat = remat
        pw.set_dropout_step(3)
        pw.zero_grad(set_to_none=True)
        microbatch_loss(pw, MaskedCrossEntropy(), tb).backward()
        grads.append([p.grad.clone() for p in pw.adapters.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# -- errors ----------------------------------------------------------------
ERRORS = {
    "dropout_without_bypass": dict(dropout=0.1, use_rank_r_bypass=False),
    "quantize_nf4": dict(quantize_base="nf4"),
    "quantize_without_bypass": dict(quantize_base="int8",
                                    use_rank_r_bypass=False),
    "no_match": dict(target_modules=["nothing_here"]),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_errors_raised_as_in_jax(name):
    jm, model = models()
    with pytest.raises(ValueError) as jerr:
        jlora.LoRAModel(jm, jlora.PeftConfig(**ERRORS[name]))
    with pytest.raises(ValueError) as err:
        lora.LoRAModel(model, lora.PeftConfig(**ERRORS[name]))
    assert str(err.value).split(" ")[0] == str(jerr.value).split(" ")[0]
    # a failed construction leaves the base untouched
    assert all(p.requires_grad for p in model.parameters())
    assert not any(b.dtype == torch.int8 for b in model.buffers())


def test_bad_dropout_position_raises_as_in_jax():
    with pytest.raises(ValueError, match="dropout_position"):
        jlora.PeftConfig(dropout_position="middle")
    with pytest.raises(ValueError, match="dropout_position"):
        lora.PeftConfig(dropout_position="middle")


def test_peft_config_fields_and_defaults_are_jax():
    import dataclasses

    def fields(cls):
        return {f.name: (f.default if f.default is not dataclasses.MISSING
                         else f.default_factory())
                for f in dataclasses.fields(cls)}

    assert fields(lora.PeftConfig) == fields(jlora.PeftConfig)
    assert lora.PeftConfig(dim=8, alpha=16).scale == 2.0


# -- adapter files ---------------------------------------------------------
@pytest.mark.parametrize("family", ["llama", "qwen3_moe"])
def test_adapters_saved_by_the_port_load_in_jax_and_back(tmp_path, family):
    kw = dict(target_modules=["q_proj", "v_proj", "down_proj"]
              if family == "llama" else ["q_proj", "v_proj"], dim=4,
              alpha=16)
    jw, params, pw = lora_pair(family, seed=2, **kw)
    lora.save_adapters(pw, str(tmp_path / "port"))
    fresh = jw.init(jax.random.key(9))
    back = jlora.load_adapters(jw, fresh, str(tmp_path / "port"))
    for mod_path in pw.targets:
        for part in ("A", "B"):
            np.testing.assert_array_equal(
                np.asarray(back["lora"][mod_path][part]),
                params["lora"][mod_path][part])
    assert json.load(open(tmp_path / "port" / "adapter_config.json")) == \
        _jax_adapter_config(jw, params, tmp_path / "jax")
    # and the JAX files into a fresh port model
    _, model = models(family)
    other = lora.LoRAModel(model, lora.PeftConfig(**kw), seed=7)
    lora.load_adapters(other, str(tmp_path / "jax"))
    for mod_path in pw.targets:
        for a, b in zip(other.adapter(mod_path).parameters(),
                        pw.adapter(mod_path).parameters()):
            assert torch.equal(a, b)


def _jax_adapter_config(jw, params, out_dir):
    jlora.save_adapters(jw, params, str(out_dir))
    return json.load(open(os.path.join(out_dir, "adapter_config.json")))


def test_adapter_file_keys_and_layout_are_hf_peft(tmp_path):
    """``base_model.model.model.layers.{i}.<module>.lora_{A,B}.weight`` in
    torch's (out, in) layout, fp32, the JAX writer's key set."""
    from automodel_tpu_torch.models.hf_io import read_safetensors

    jw, params, pw = lora_pair(target_modules=["q_proj", "up_proj"], dim=4)
    lora.save_adapters(pw, str(tmp_path / "port"))
    jlora.save_adapters(jw, params, str(tmp_path / "jax"))
    got = read_safetensors(str(tmp_path / "port" / lora.ADAPTER_FILE))
    want = read_safetensors(str(tmp_path / "jax" / lora.ADAPTER_FILE))
    assert sorted(got) == sorted(want)
    assert "base_model.model.model.layers.1.mlp.up_proj.lora_B.weight" in got
    for k in got:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    assert tuple(got["base_model.model.model.layers.0.self_attn.q_proj."
                     "lora_A.weight"].shape) == (4, 64)


def test_jax_leaves_of_the_wrapper_cover_the_jax_peft_tree():
    jw, params, pw = lora_pair(dim=4)
    flat = {tuple(k.key for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    assert {path for path, _, _ in jax_leaves(pw)} == flat
