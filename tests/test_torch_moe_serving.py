"""MoE models through the port's decode engine and ``generate()``, against
the JAX package on the CPU, fp32.

The JAX engine serves an MoE model through the inherited Llama forward:
the routed block runs on every row of the step, inactive slots included.
The port does the same, so under capacity routing a token's drops depend
on the step's batch in both, and the two must still agree token for
token.

* The port's ``DecodeEngine`` against the JAX engine on a tiny Qwen3-MoE
  and a tiny Mixtral (2 layers, hidden 64, 8 experts, top-2), dropless
  and under capacity routing (factor 2.0 in groups of 16 tokens):
  every request's tokens equal (``tests/torch_serving_pair.py``'s
  harness), the paged pool all free after.
* Prefix caching (with a copy-on-write fork) and n-gram speculation on
  the tiny Qwen3-MoE, dropless: tokens equal to the JAX engine's and to
  the same engine with the feature off.
* ``generate()`` over the dense cache: tokens equal to the JAX
  ``generate`` (ragged prompts, dropless; equal-length prompts under
  capacity routing, where pad rows would enter the capacity queues with
  the two packages' different values for rows with no key, ROADMAP
  Queue 3).
* The engine's first step logits against the JAX model's forward on the
  same prompt: within 2e-5 relative to the logits' range (fp32, sums in
  another order).

Weights are the JAX ``init`` from a fixed key, perturbed with numpy noise
(so the argmax is not degenerate), carried by ``load_jax_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.generation import generate as jax_generate
from automodel_tpu.generation import GenerationConfig as JaxGenerationConfig
from automodel_tpu.models.mixtral import MixtralConfig as JaxMixtralConfig
from automodel_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
from automodel_tpu.models.qwen3_moe import Qwen3MoeConfig as JaxQwenConfig
from automodel_tpu.models.qwen3_moe import Qwen3MoeForCausalLM as JaxQwen
from automodel_tpu_torch.generation import GenerationConfig, generate
from automodel_tpu_torch.models.mixtral import (
    MixtralConfig,
    MixtralForCausalLM,
)
from automodel_tpu_torch.models.qwen3_moe import (
    Qwen3MoeConfig,
    Qwen3MoeForCausalLM,
)
from automodel_tpu_torch.models.weights import load_jax_params
from tests.torch_serving_pair import (
    assert_same,
    make_engine,
    run_both,
    seeded_prompts,
    submit_all,
)

torch.set_num_threads(1)

BASE = dict(vocab_size=256, hidden_size=64, intermediate_size=32,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            rope_theta=10000.0, tie_word_embeddings=False,
            num_experts_per_tok=2, moe_group_size=16)
FAMILIES = {
    "mixtral": (dict(BASE, num_local_experts=8), JaxMixtralConfig,
                JaxMixtral, MixtralConfig, MixtralForCausalLM),
    "qwen3_moe": (dict(BASE, num_experts=8, moe_intermediate_size=32,
                       head_dim=16, norm_topk_prob=True),
                  JaxQwenConfig, JaxQwen, Qwen3MoeConfig,
                  Qwen3MoeForCausalLM),
}
ROUTING = {"dropless": None, "capacity": 2.0}
LOGITS_REL = 2e-5


def moe_models(family: str, capacity):
    """``(jax model, params, port model)`` of one tiny MoE family."""
    cfg, jcfg_cls, jcls, cfg_cls, cls = FAMILIES[family]
    cfg = dict(cfg, moe_capacity_factor=capacity)
    jm = jcls(jcfg_cls(**cfg), param_dtype=jnp.float32,
              compute_dtype=jnp.float32, remat=False)
    params = jm.init(jax.random.key(0))
    leaves, td = jax.tree.flatten(params)
    rng = np.random.default_rng(5)       # perturb: non-degenerate argmax
    params = jax.tree.unflatten(td, [
        np.asarray(l) + 0.05 * rng.normal(size=l.shape).astype(np.float32)
        for l in leaves])
    model = cls(cfg_cls(**cfg), param_dtype=torch.float32,
                compute_dtype=torch.float32, device="cpu")
    load_jax_params(model, params)
    return jm, params, model


@pytest.fixture(scope="module")
def qwen_dropless():
    return moe_models("qwen3_moe", None)


def _mixed_lengths(eng, clock):
    submit_all(eng, seeded_prompts(11, [5, 19, 9, 30, 3]))
    eng.run()
    return eng.allocator.all_free


@pytest.mark.parametrize("routing", list(ROUTING))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_moe_engine_token_identical_to_jax(family, routing):
    models = moe_models(family, ROUTING[routing])
    res = run_both(models, _mixed_lengths)
    teng = assert_same(res)
    assert res[1][1] is True                       # the pool all free
    assert teng.stats()["outcomes"] == {"finished": 5}
    assert teng.gmm_launches == 0                  # CPU: the plain version


def _shared_prefix(eng, clock):
    shared = seeded_prompts(3, [16])[0]
    tails = seeded_prompts(4, [3, 5, 2])
    submit_all(eng, [shared + t for t in tails] + [shared, shared])
    eng.run()
    return eng.allocator.all_free


def _periodic(eng, clock):
    motif = seeded_prompts(6, [4])[0]
    submit_all(eng, [(motif * 4)[:14], (motif * 3)[:11]]
               + seeded_prompts(7, [9]))
    eng.run()
    return eng.allocator.all_free


@pytest.mark.parametrize("feature", ["prefix_cache", "speculative"])
def test_moe_serving_features_token_identical(qwen_dropless, feature):
    """Prefix caching (a copy-on-write fork included) and n-gram
    speculation on a tiny MoE: tokens equal to the JAX engine's and to the
    port's engine with the feature off."""
    scenario, kw = {
        "prefix_cache": (_shared_prefix, dict(prefix_caching="on")),
        "speculative": (_periodic, dict(speculative="ngram")),
    }[feature]
    res = run_both(qwen_dropless, scenario, **kw)
    assert_same(res)
    assert res[1][1] is True
    stats = res[1][2]
    if feature == "prefix_cache":
        assert stats["prefill_tokens_saved"] > 0
        assert stats["prefix_cache"]["cow_forks"] > 0
    else:
        assert stats["speculative"]["tokens_proposed"] > 0
    off = make_engine("port", qwen_dropless)
    scenario(off, None)
    assert {r: o[2] for r, o in res[1][0].items()} == \
        {r: list(q.out_tokens) for r, q in off.requests.items()}


@pytest.mark.parametrize("routing", list(ROUTING))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_moe_generate_matches_jax(family, routing):
    jm, params, model = moe_models(family, ROUTING[routing])
    rng = np.random.default_rng(8)
    ids = rng.integers(1, 255, (3, 10)).astype(np.int32)
    lens = (np.array([10, 6, 3], np.int32) if routing == "dropless"
            else None)
    cfg = dict(max_new_tokens=6)
    want = jax_generate(jm, params, ids, prompt_lens=lens,
                        config=JaxGenerationConfig(**cfg))
    got = generate(model, ids, prompt_lens=lens,
                   config=GenerationConfig(**cfg))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_moe_engine_first_step_logits_match_jax(family):
    jm, params, model = moe_models(family, None)
    prompt = seeded_prompts(12, [7])[0]
    eng = make_engine("port", (jm, params, model))
    eng.submit(prompt)
    eng.step()                     # the whole prompt fits one prefill chunk
    got = eng.last_logits[0].numpy()
    ref = np.asarray(jm(params, jnp.asarray([prompt], jnp.int32))[
        "logits"])[0, -1]
    span = float(ref.max() - ref.min())
    assert np.abs(got - ref).max() <= LOGITS_REL * span
