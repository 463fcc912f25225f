"""Quantized serving in the port against the JAX package: fp8 / int8
compute with a paged or dense cache (Llama, Qwen3-MoE, DeepSeek), and a
weight-only int8 base built from a config, a checkpoint and a serve YAML.

Tolerances (fp32 compute on both sides, the same numpy weights):

* fp8 logits with a cache: relative L2 below 1e-4, the bound of
  ``tests/test_torch_fp8_model.py`` (both packages quantize the same
  activations; their fp32 products sum in another order, which can move a
  code at a rounding midpoint).  Measured (largest over the cases): 3.0e-7
  on the paged step, 4.1e-7 on the dense cache, 2.5e-7 on Qwen3-MoE's
  first step and 4.1e-7 on DeepSeek's prefill.
* greedy tokens (engine, ``generate()``, the serve tools): exact.
* int8 codes and scales of a weight-only base: bit for bit.

The JAX grouped matmuls (gmm_quant for the fp8 experts) run the Pallas
kernel in interpret mode, as the JAX package's own tests run it.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import automodel_tpu.ops.gmm_kernel as jgk
from automodel_tpu.generation import GenerationConfig as JaxGenerationConfig
from automodel_tpu.generation import generate as jax_generate
from automodel_tpu.models import auto_model as jauto
from automodel_tpu.models import hf_io as jhf
from automodel_tpu.quantization import fp8 as jfp8
from automodel_tpu.quantization.weight_only import (
    quantize_kernel as jax_quantize_kernel,
)
from automodel_tpu.serving.engine import _paged_step as jax_paged_step
from automodel_tpu_torch.config.loader import load_yaml_config
from automodel_tpu_torch.generation import GenerationConfig, generate
from automodel_tpu_torch.models import auto_model
from automodel_tpu_torch.models.weights import load_jax_params
from automodel_tpu_torch.quantization import fp8
from automodel_tpu_torch.quantization.weight_only import (
    QUANTIZED_MODULES,
    Int8Linear,
    is_quantized,
)
from automodel_tpu_torch.serving.engine import _paged_step
from automodel_tpu_torch.serving.kv_cache import PagedKVView
from automodel_tpu_torch.tools import serve as serve_tool
from tests.test_torch_deepseek import make_pair as deepseek_pair
from tests.test_torch_llama import _jax_model, _port_model, _step_inputs
from tests.test_torch_moe_serving import moe_models
from tests.torch_serving_pair import (
    assert_same,
    run_both,
    seeded_prompts,
    submit_all,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SERVE_YAML = os.path.join(REPO, "examples", "serve",
                              "tiny_llama_serve.yaml")
COMBOS = [("float8", "tensorwise"), ("float8", "rowwise"),
          ("int8", "tensorwise")]
IDS = [f"{d}_{r}" for d, r in COMBOS]
REL_L2 = 1e-4
LLAMA_HF = dict(model_type="llama", vocab_size=128, hidden_size=64,
                intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2,
                rope_theta=10000.0, tie_word_embeddings=False,
                torch_dtype="float32")


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setattr(jgk, "_INTERPRET", True)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def quantize_both(jm, model, dtype="float8", recipe="tensorwise",
                  filter_fqns=()):
    kw = dict(enabled=True, dtype=dtype, recipe_name=recipe,
              filter_fqns=list(filter_fqns))
    jfp8.apply_fp8_to_model(jm, jfp8.FP8Config(**kw))
    fp8.apply_fp8_to_model(model, fp8.FP8Config(**kw))


def llama_pair(dtype="float8", recipe="tensorwise"):
    jm, params = _jax_model(tied=True)
    model = _port_model(params, tied=True)
    quantize_both(jm, model, dtype, recipe)
    return jm, params, model


# ---------------------------------------------------------------------------
# fp8 compute with a cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,recipe", COMBOS, ids=IDS)
def test_fp8_paged_step_matches_jax(dtype, recipe):
    """One engine step (a prefill chunk and a decode row) through the
    paged cache with quantized projections: greedy equal, last logits
    within ``REL_L2``, the written pools within 1e-5."""
    jm, params, model = llama_pair(dtype, recipe)
    pools, ids, pos, slots, tables, ctx, last = _step_inputs(False)
    zeros = jnp.zeros((ids.shape[0],), jnp.int32)
    g_ref, last_ref, pools_ref = jax_paged_step(
        jm, 16, False, False, False, params,
        {n: jnp.asarray(p) for n, p in pools.items()},
        jnp.asarray(ids, jnp.int32), jnp.asarray(pos),
        jnp.asarray(slots, jnp.int32), jnp.asarray(tables),
        jnp.asarray(ctx), jnp.asarray(last, jnp.int32), zeros, zeros)
    tpools = {n: torch.from_numpy(p.copy()) for n, p in pools.items()}
    view = PagedKVView(tpools, torch.from_numpy(tables),
                       torch.from_numpy(slots), torch.from_numpy(ctx),
                       torch.from_numpy(pos), block_size=16, quantized=False)
    with torch.no_grad():
        greedy, last_logits = _paged_step(model, view, torch.from_numpy(ids),
                                          torch.from_numpy(last))
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(g_ref))
    assert rel_l2(last_logits.numpy(), last_ref) < REL_L2
    for name, p in tpools.items():
        np.testing.assert_allclose(p.numpy(), np.asarray(pools_ref[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype,recipe", COMBOS, ids=IDS)
def test_fp8_dense_cache_logits_match_jax(dtype, recipe):
    """The dense cache of ``generate()``: a left-padded prefill and three
    decode steps, logits within ``REL_L2`` of JAX's at every step."""
    jm, params, model = llama_pair(dtype, recipe)
    rng = np.random.default_rng(3)
    B, S, T = 2, 8, 3
    ids = rng.integers(1, 255, (B, S + T)).astype(np.int32)
    shift = np.asarray([0, 3])
    mask = np.arange(S + T)[None, :] >= shift[:, None]
    pos = np.maximum(np.arange(S)[None, :] - shift[:, None], 0)
    jcache = jm.init_kv_cache(B, S + T)
    tcache = model.init_kv_cache(B, S + T)
    jout = jm(params, jnp.asarray(ids[:, :S]), position_ids=jnp.asarray(
        pos, jnp.int32), attention_mask=jnp.asarray(mask),
        kv_cache=jcache, cache_index=jnp.int32(0))
    with torch.no_grad():
        tout = model(torch.from_numpy(ids[:, :S]).long(),
                     position_ids=torch.from_numpy(pos),
                     attention_mask=torch.from_numpy(mask),
                     kv_cache=tcache, cache_index=0)
    assert rel_l2(tout["logits"].numpy(), jout["logits"]) < REL_L2
    jcache = jout["kv_cache"]
    for t in range(T):
        p = (S - shift + t)[:, None].astype(np.int32)
        jout = jm(params, jnp.asarray(ids[:, S + t:S + t + 1]),
                  position_ids=jnp.asarray(p),
                  attention_mask=jnp.asarray(mask), kv_cache=jcache,
                  cache_index=S + t)
        jcache = jout["kv_cache"]
        with torch.no_grad():
            tout = model(torch.from_numpy(ids[:, S + t:S + t + 1]).long(),
                         position_ids=torch.from_numpy(p).long(),
                         attention_mask=torch.from_numpy(mask),
                         kv_cache=tcache, cache_index=S + t)
        assert rel_l2(tout["logits"].numpy(), jout["logits"]) < REL_L2, t


def _served(eng, clock):
    submit_all(eng, seeded_prompts(11, [5, 19, 9, 30, 3]))
    eng.run()
    return eng.allocator.all_free


@pytest.mark.parametrize("dtype,recipe", COMBOS, ids=IDS)
def test_fp8_engine_and_generate_tokens_match_jax(dtype, recipe):
    """``DecodeEngine`` (mixed prompt lengths, chunked prefill) and
    ``generate()`` under quantized compute: greedy tokens and the engines'
    common stats equal to JAX's."""
    jm, params, model = llama_pair(dtype, recipe)
    res = run_both((jm, params, model), _served)
    assert_same(res)
    assert res[1][1] is True
    ids = np.random.default_rng(8).integers(1, 255, (3, 10)).astype(np.int32)
    lens = np.array([10, 6, 3], np.int32)
    want = jax_generate(jm, params, ids, prompt_lens=lens,
                        config=JaxGenerationConfig(max_new_tokens=6))
    got = generate(model, ids, prompt_lens=lens,
                   config=GenerationConfig(max_new_tokens=6))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("dtype", ["float8", "int8"])
def test_fp8_qwen3_moe_engine_matches_jax(dtype):
    """Qwen3-MoE with quantized attention projections and experts (the
    sorted path through gmm_quant's plain version): the engine's first
    step logits within ``REL_L2`` of JAX's forward, and the served tokens
    and stats equal to the JAX engine's; the onehot oracle never
    quantizes, in either package."""
    jm, params, model = moe_models("qwen3_moe", None)
    quantize_both(jm, model, dtype)
    res = run_both((jm, params, model), _served)
    teng = assert_same(res)
    assert res[1][1] is True and teng.gmm_launches == 0
    prompt = seeded_prompts(12, [7])[0]
    ref = np.asarray(jm(params, jnp.asarray([prompt], jnp.int32))[
        "logits"])[0, -1]
    with torch.no_grad():
        got = model(torch.tensor([prompt]))["logits"][0, -1].numpy()
    assert rel_l2(got, ref) < REL_L2
    # only the experts quantized: the onehot dispatch stays bitwise bf16
    jm2, params2, model2 = moe_models("qwen3_moe", None)
    jm2.config.moe_dispatch = "onehot"
    model2.config.moe_dispatch = "onehot"
    with torch.no_grad():
        plain = model2(torch.tensor([prompt]))["logits"]
        jplain = np.asarray(jm2(params2, jnp.asarray([prompt]))["logits"])
        quantize_both(jm2, model2, dtype, filter_fqns=["self_attn"])
        assert torch.equal(model2(torch.tensor([prompt]))["logits"], plain)
    np.testing.assert_array_equal(
        np.asarray(jm2(params2, jnp.asarray([prompt]))["logits"]), jplain)


@pytest.mark.parametrize("family", ["v2", "v3"])
def test_fp8_deepseek_dense_cache_matches_jax(family):
    """DeepSeek with quantized experts (the projections stay plain, as the
    JAX family's ``proj``) decodes over its dense cache: ``generate()``
    tokens equal, the prefill logits within ``REL_L2``."""
    jm, params, model = deepseek_pair(family, capacity=None)
    quantize_both(jm, model)
    rng = np.random.default_rng(9)
    ids = rng.integers(1, 127, (3, 9)).astype(np.int32)
    lens = np.array([9, 5, 2], np.int32)
    want = jax_generate(jm, params, ids, prompt_lens=lens,
                        config=JaxGenerationConfig(max_new_tokens=7))
    got = generate(model, ids, prompt_lens=lens,
                   config=GenerationConfig(max_new_tokens=7))
    np.testing.assert_array_equal(got, np.asarray(want))
    cache = jm.init_kv_cache(3, 16)
    jout = jm(params, jnp.asarray(ids), kv_cache=cache,
              cache_index=jnp.int32(0))
    with torch.no_grad():
        tout = model(torch.from_numpy(ids).long(),
                     kv_cache=model.init_kv_cache(3, 16), cache_index=0)
    assert rel_l2(tout["logits"].numpy(), jout["logits"]) < REL_L2


# ---------------------------------------------------------------------------
# the weight-only int8 base
# ---------------------------------------------------------------------------
def _codes(model):
    """``{(proj, layer): (codes [in, out], scale [1, out])}`` of an int8
    base in the JAX layout."""
    out = {}
    for i, layer in enumerate(model.layers):
        for _, proj in QUANTIZED_MODULES:
            q = getattr(layer, proj)
            assert isinstance(q, Int8Linear)
            out[(proj, i)] = (q.weight.numpy().T, q.scale.numpy().T)
    return out


def _jax_codes(tree):
    out = {}
    for mod, proj in QUANTIZED_MODULES:
        node = tree["layers"][mod][proj]
        for i in range(node["kernel"].shape[0]):
            out[(proj, i)] = (np.asarray(node["kernel"][i]),
                              np.asarray(node["scale"][i]))
    return out


def _assert_same_codes(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key][0], want[key][0], str(key))
        np.testing.assert_array_equal(got[key][1], want[key][1], str(key))


@pytest.mark.parametrize("entry", ["from_config", "build_model"])
def test_int8_base_from_a_config_is_jax_quantization_bit_for_bit(entry):
    """``weight_only_quant="int8"`` through ``from_config`` and
    ``build_model`` (it raised ``TypeError`` before): an int8 base whose
    codes and scales are, bit for bit, JAX's ``quantize_kernel`` of the
    dense weights the same seed draws."""
    build = (auto_model.AutoModelForCausalLM.from_config
             if entry == "from_config" else
             lambda c, **kw: auto_model.build_model(config=c, **kw))
    q = build(LLAMA_HF, seed=4, device="cpu", weight_only_quant="int8")
    dense = build(LLAMA_HF, seed=4, device="cpu")
    assert is_quantized(q) and not is_quantized(dense)
    assert q.weight_only_quant == "int8"
    want = {}
    for i, layer in enumerate(dense.layers):
        for _, proj in QUANTIZED_MODULES:
            w = getattr(layer, proj).weight.detach().numpy().T
            c, s = jax_quantize_kernel(jnp.asarray(w))
            want[(proj, i)] = (np.asarray(c), np.asarray(s))
    _assert_same_codes(_codes(q), want)
    assert torch.equal(q.embed_tokens.weight, dense.embed_tokens.weight)
    with pytest.raises(ValueError, match="weight_only_quant"):
        build(LLAMA_HF, device="cpu", weight_only_quant="int4")


def test_int8_base_from_pretrained_matches_jax(tmp_path):
    """An HF checkpoint (written by the JAX package) read by both
    packages' ``from_pretrained(..., load_weights=True,
    weight_only_quant="int8")``: the port streams it through
    ``load_quantized_hf_base`` into the same codes and scales, bit for
    bit, and the same dense embeddings and head."""
    jm = jauto.AutoModelForCausalLM.from_config(dict(LLAMA_HF))
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(2)))
    jhf.save_hf_weights(jm, params, str(tmp_path))
    jq = jauto.AutoModelForCausalLM.from_pretrained(
        str(tmp_path), load_weights=True, weight_only_quant="int8")
    tq = auto_model.AutoModelForCausalLM.from_pretrained(
        str(tmp_path), load_weights=True, weight_only_quant="int8",
        device="cpu")
    _assert_same_codes(_codes(tq), _jax_codes(jax.tree.map(np.asarray,
                                                           jq.params)))
    np.testing.assert_array_equal(
        tq.lm_head.weight.detach().numpy().T,
        np.asarray(jq.params["lm_head"]["kernel"]))


def _int8_yaml(tmp_path, src):
    text = open(src).read()
    assert "  _target_: automodel_tpu.models.auto_model.build_model\n" in text
    text = text.replace(
        "  _target_: automodel_tpu.models.auto_model.build_model\n",
        "  _target_: automodel_tpu.models.auto_model.build_model\n"
        "  weight_only_quant: int8\n", 1)
    path = tmp_path / "int8_serve.yaml"
    path.write_text(text)
    return str(path)


@pytest.fixture
def jax_serve_tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_serve_tool_under_test", os.path.join(REPO, "tools", "serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_int8_base_serve_yaml_through_both_serve_tools(tmp_path, capsys,
                                                       monkeypatch,
                                                       jax_serve_tool):
    """The JAX tiny serve YAML with ``model.weight_only_quant: int8``: the
    JAX tool serves an int8 base (its init quantizes), the port's tool the
    same YAML with that base's params carried across: every request
    FINISHED, the same tokens request by request, the same outcomes."""
    import automodel_tpu.serving as jserving

    path = _int8_yaml(tmp_path, JAX_SERVE_YAML)
    argv = ["-c", path, "--requests", "4", "--max-new", "6"]
    engines = []

    class Recording(jserving.DecodeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    monkeypatch.setattr(jserving, "DecodeEngine", Recording)
    assert jax_serve_tool.main(argv) == 0
    jreport = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (jeng,) = engines
    assert jeng.params["layers"]["self_attn"]["q_proj"]["kernel"].dtype == \
        jnp.int8

    from automodel_tpu.config.loader import load_yaml_config as jload

    jmodel = jload(path).model.instantiate()
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    model = load_yaml_config(path).model.instantiate(device="cpu")
    assert is_quantized(model)
    load_jax_params(model, params)
    out = serve_tool.serve(argv + ["--device", "cpu"], model=model)
    capsys.readouterr()
    assert out["rc"] == 0
    assert out["report"]["outcomes"] == jreport["outcomes"] == \
        {"finished": 5}
    assert {r: list(q.out_tokens) for r, q in out["engine"].requests.items()} \
        == {r: [int(t) for t in q.out_tokens]
            for r, q in jeng.requests.items()}


def test_int8_base_update_params_and_fleet_admission_as_jax():
    """An int8 base's weight sync: ``DecodeEngine.update_params`` with a
    JAX int8 tree (codes, scales) gives the JAX engine's tokens after the
    same sync (exact), and a fleet admission carries the int8 buffers
    from the live peer bit for bit (the port's own state_dict path)."""
    from automodel_tpu.generation import GenerationConfig as JaxGen
    from automodel_tpu.models.llama import LlamaConfig as JaxConfig
    from automodel_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from automodel_tpu.serving import DecodeEngine as JaxEngine
    from automodel_tpu.serving import ServingConfig as JaxServing
    from automodel_tpu_torch.checkpoint import replication as trep
    from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from automodel_tpu_torch.serving import (
        DecodeEngine,
        FleetRouter,
        ServingConfig,
    )
    from automodel_tpu_torch.utils import fault_injection as tfi

    cfg = {k: v for k, v in LLAMA_HF.items()
           if k not in ("model_type", "torch_dtype")}
    jm = JaxLlama(JaxConfig(**cfg), param_dtype=jnp.float32,
                  compute_dtype=jnp.float32, remat=False,
                  weight_only_quant="int8")
    first, second = (jax.tree.map(np.asarray, jm.init(jax.random.key(k)))
                     for k in (1, 2))
    model = LlamaForCausalLM(LlamaConfig(**cfg), param_dtype=torch.float32,
                             compute_dtype=torch.float32, device="cpu",
                             weight_only_quant="int8")
    load_jax_params(model, first)
    kw = dict(max_model_len=64, prefill_chunk=8, kv_block_size=8)
    prompts = seeded_prompts(13, [6, 11, 3], vocab=127)
    jeng = JaxEngine(jm, first, JaxServing(**kw),
                     generation=JaxGen(max_new_tokens=6))
    eng = DecodeEngine(model, ServingConfig(**kw), device="cpu",
                       generation=GenerationConfig(max_new_tokens=6))
    for e in (jeng, eng):
        e.update_params(second)
        for p in prompts:
            e.submit(p)
    want = {r: [int(t) for t in toks] for r, toks in jeng.run().items()}
    assert eng.run() == want
    q = model.layers[1].down_proj
    np.testing.assert_array_equal(
        q.weight.numpy().T,
        second["layers"]["mlp"]["down_proj"]["kernel"][1])

    fleet = FleetRouter(model, ServingConfig(**kw, replicas=2,
                                             fleet_probation_polls=1),
                        generation=GenerationConfig(max_new_tokens=6),
                        device="cpu")
    tfi.configure_faults("fleet_replica_loss:1")
    try:
        fleet.poll_health(step=0)
    finally:
        tfi.reset_faults()
    fleet.note_return(1)
    fleet.poll_health(step=1)
    assert fleet.readmissions == 1
    peer, new = (trep.serialize_tree(r.engine.model.state_dict())
                 for r in fleet.replicas)
    assert {k: v[0] for k, v in new.items()} == \
        {k: v[0] for k, v in peer.items()}
    assert is_quantized(fleet.replicas[1].engine.model)
    fleet.teardown()


def test_fp8_filter_fqns_while_serving_as_jax():
    """``filter_fqns`` keeps the named projections in the compute dtype
    while serving, in both packages: the engines' tokens equal JAX's with
    the MLP filtered out, and the projection count the port quantizes
    drops to the attention's four."""
    from automodel_tpu_torch.ops import quant as tquant

    jm, params = _jax_model(tied=True)
    model = _port_model(params, tied=True)
    quantize_both(jm, model, filter_fqns=["mlp"])
    seen = []
    real = tquant.qdot

    def counting(x, w, *a, **kw):
        seen.append(tuple(w.shape))
        return real(x, w, *a, **kw)

    tquant.qdot = counting
    try:
        res = run_both((jm, params, model), _served)
    finally:
        tquant.qdot = real
    assert_same(res)
    steps = res[1][2]["steps"]
    assert len(seen) == 4 * model.config.num_hidden_layers * steps
