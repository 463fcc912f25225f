"""The Llama class's other families in the port against the JAX package,
fp32 on the CPU at a tiny size (2 layers, hidden 64, 4 / 2 heads of 16,
vocab 256), from the same perturbed JAX parameters: Qwen2 (``attention_bias``
on q / k / v), Qwen3 dense (``qk_norm``) and Mistral (a uniform sliding
window of 5 keys over rows of 16):

* logits and the gradient of every parameter, the biases' included;
* greedy tokens of a biased model through both decode engines;
* LoRA over the biased projections (the bias a frozen base tensor, JAX's
  ``"bias": "none"``): the trainable count, logits of the merge and
  bypass strategies and the adapters' gradients;
* an int8 QLoRA base read from an HF directory
  (``load_quantized_hf_base``): codes, scales and biases bit for bit
  JAX's.

Tolerances: logits and gradients within 1e-5 relative L2 over each tensor
(fp32, sums in another order, as ``test_torch_peft.py``); greedy tokens
and int8 codes exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.loss.masked_ce import MaskedCrossEntropy as JaxCE
from automodel_tpu.models import auto_model as jauto
from automodel_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from automodel_tpu.models.llama import LlamaForCausalLM as JaxLlama
from automodel_tpu.peft import lora as jlora
from automodel_tpu.quantization import weight_only as jwo
from automodel_tpu.training.train_step import _microbatch_loss
from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
from automodel_tpu_torch.models import auto_model, hf_io
from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from automodel_tpu_torch.models.weights import jax_leaves, load_jax_params
from automodel_tpu_torch.peft import lora
from automodel_tpu_torch.quantization import weight_only
from automodel_tpu_torch.training.train_step import microbatch_loss
from tests.test_torch_peft import _adapter_grads_match
from tests.test_torch_moe_model import packed_batch
from tests.torch_serving_pair import make_engine, seeded_prompts

torch.set_num_threads(1)

REL = 1e-5
SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-6,
             rope_theta=1000000.0, max_position_embeddings=512,
             tie_word_embeddings=True)
FAMILIES = {
    "qwen2": dict(SMALL, model_type="qwen2", attention_bias=True,
                  use_sliding_window=False),
    "qwen3": dict(SMALL, model_type="qwen3", qk_norm=True,
                  use_sliding_window=False),
    "mistral": dict(SMALL, model_type="mistral", sliding_window=5,
                    tie_word_embeddings=False),
}


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def family_pair(family, seed=0):
    """The JAX model and its perturbed params, the port's model on them."""
    cfg = FAMILIES[family]
    jm = JaxLlama(JaxLlamaConfig(**cfg), param_dtype=jnp.float32,
                  compute_dtype=jnp.float32, remat=False)
    params = jm.init(jax.random.key(seed))
    leaves, td = jax.tree.flatten(params)
    rng = np.random.default_rng(seed + 5)
    params = jax.tree.unflatten(td, [
        np.asarray(l) + 0.05 * rng.normal(size=l.shape).astype(np.float32)
        for l in leaves])
    model = LlamaForCausalLM(LlamaConfig(**cfg), param_dtype=torch.float32,
                             compute_dtype=torch.float32, device="cpu")
    load_jax_params(model, params)
    return jm, params, model


def _flat(tree):
    return {tuple(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_and_every_gradient_match_jax(family):
    jm, params, model = family_pair(family)
    batch = packed_batch(B=2, S=16, seed=7)
    batch["segment_ids"] = np.ones_like(batch["segment_ids"])   # one row
    batch["position_ids"] = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits = np.asarray(jm(params, jb["input_ids"],
                            position_ids=jb["position_ids"])["logits"])
    jloss, jgrads = jax.value_and_grad(
        lambda p: _microbatch_loss(jm, JaxCE(), p, jb))(
        jax.tree.map(jnp.asarray, params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits = model(tb["input_ids"],
                       position_ids=tb["position_ids"])["logits"].numpy()
    assert rel_l2(logits, jlogits) < REL
    loss = microbatch_loss(model, MaskedCrossEntropy(), tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    flat = _flat(jgrads)
    seen = set()
    for path, target, transposed in jax_leaves(model):
        got = (np.stack([p.grad.numpy() for p in target])
               if isinstance(target, list) else target.grad.numpy())
        if transposed:
            got = np.swapaxes(got, -1, -2)
        assert rel_l2(got, flat[path]) < REL, path
        seen.add(path)
    assert seen == set(flat)
    if family == "qwen2":
        assert {p for p in seen if p[-1] == "bias"} == {
            ("layers", "self_attn", q, "bias")
            for q in ("q_proj", "k_proj", "v_proj")}


def test_greedy_tokens_of_a_biased_model_match_the_jax_engine():
    jm, params, model = family_pair("qwen2", seed=1)
    models = (jm, params, model)
    prompts = seeded_prompts(3, (5, 11, 17, 8))
    tokens = {}
    for kind in ("jax", "port"):
        eng = make_engine(kind, models)
        rids = [eng.submit(p) for p in prompts]
        eng.run()
        tokens[kind] = [list(eng.requests[r].out_tokens) for r in rids]
    assert tokens["port"] == tokens["jax"]
    assert all(len(t) == 8 for t in tokens["port"])


def lora_pair_biased(strategy, seed=0):
    jm, _, model = family_pair("qwen2", seed=seed)
    peft = dict(match_all_linear=True, dim=4, alpha=16,
                use_rank_r_bypass=strategy == "bypass")
    jw = jlora.LoRAModel(jm, jlora.PeftConfig(**peft))
    params = jax.tree.map(np.asarray, jw.init(jax.random.key(seed)))
    rng = np.random.default_rng(seed + 10)
    params = jax.tree.map(
        lambda x: (x + 0.05 * rng.standard_normal(x.shape)).astype(x.dtype)
        if x.dtype != np.int8 else x, params)
    pw = lora.LoRAModel(model, lora.PeftConfig(**peft), seed=seed)
    load_jax_params(pw, params)
    return jw, params, pw


@pytest.mark.parametrize("strategy", ["merge", "bypass"])
def test_lora_over_biased_projections_matches_jax(strategy):
    jw, params, pw = lora_pair_biased(strategy)
    assert pw.num_trainable_params == jw.num_trainable_params
    assert pw.num_trainable_params == sum(
        p.numel() for p in pw.parameters() if p.requires_grad)
    biases = [l.q_proj.bias for l in pw.base_model.layers]
    assert all(b is not None and not b.requires_grad for b in biases)
    assert float(biases[0].abs().max()) > 0.0
    _adapter_grads_match(jw, params, pw, packed_batch(seed=4))


def test_quantized_hf_base_matches_jax_bit_for_bit(tmp_path):
    _, _, model = family_pair("qwen2", seed=2)
    hf_io.save_hf_weights(model, str(tmp_path))
    jm = jauto.AutoModelForCausalLM.from_pretrained(
        str(tmp_path), weight_only_quant="int8")
    jparams = _flat(jwo.load_quantized_hf_base(jm, str(tmp_path)))
    base = auto_model.AutoModelForCausalLM.from_pretrained(
        str(tmp_path), device="cpu", seed=9)
    weight_only.quantize_base_params(base)
    weight_only.load_quantized_hf_base(base, str(tmp_path))
    assert weight_only.is_quantized(base)
    def host(t):     # bf16 widened to fp32 (exact) on both sides
        t = t.detach()
        return (t.float() if t.is_floating_point() else t).numpy()

    checked = 0
    for path, target, transposed in jax_leaves(base):
        got = (np.stack([host(p) for p in target])
               if isinstance(target, list) else host(target))
        if transposed:
            got = np.swapaxes(got, -1, -2)
        want = jparams[path]
        assert (got.dtype == np.int8) == (want.dtype == np.int8), path
        if want.dtype != np.int8:
            want = want.astype(np.float32)
        np.testing.assert_array_equal(got, want, err_msg=str(path))
        checked += path[-1] in ("scale", "bias") or got.dtype == np.int8
    assert checked == 7 + 7 + 3       # codes, scales, q / k / v biases
    dense = auto_model.AutoModelForCausalLM.from_pretrained(
        str(tmp_path), device="cpu", seed=9)
    with pytest.raises(ValueError, match="int8 base"):
        weight_only.load_quantized_hf_base(dense, str(tmp_path))
