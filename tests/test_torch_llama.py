"""The port's Llama (ops, weights, dense forward, one paged step) against
the JAX package's, in float32 at a small size (2 layers, hidden 64, 4/2
heads, vocab 256) on the same numpy parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from automodel_tpu.models.llama import LlamaForCausalLM as JaxLlama
from automodel_tpu.ops import norms as jnorms
from automodel_tpu.ops import rotary as jrotary
from automodel_tpu.serving.engine import _paged_step as jax_paged_step
from automodel_tpu.serving.kv_cache import PagedKVView as JaxPagedKVView
from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from automodel_tpu_torch.models.weights import jax_leaves, load_jax_params
from automodel_tpu_torch.ops import norms, rotary
from automodel_tpu_torch.serving.engine import _paged_step
from automodel_tpu_torch.serving.kv_cache import PagedKVView

torch.set_num_threads(1)

LLAMA3_ROPE = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0,
               "original_max_position_embeddings": 32}
SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, rope_theta=10000.0,
             rope_scaling=LLAMA3_ROPE, max_position_embeddings=128)
LOGITS_RTOL = 1e-4     # fp32 on both sides; matmul summation order differs


def _jax_model(tied: bool):
    jm = JaxLlama(JaxLlamaConfig(**SMALL, tie_word_embeddings=tied),
                  param_dtype=jnp.float32, compute_dtype=jnp.float32,
                  remat=False)
    params = jm.init(jax.random.key(0))
    leaves, td = jax.tree.flatten(params)
    rng = np.random.default_rng(5)       # perturb: non-degenerate argmax
    params = jax.tree.unflatten(td, [
        np.asarray(l) + 0.05 * rng.normal(size=l.shape).astype(np.float32)
        for l in leaves])
    return jm, params


def _port_model(params, tied: bool):
    m = LlamaForCausalLM(LlamaConfig(**SMALL, tie_word_embeddings=tied),
                         param_dtype=torch.float32,
                         compute_dtype=torch.float32, device="cpu")
    load_jax_params(m, params)
    return m


@pytest.fixture(scope="module", params=[True, False], ids=["tied", "untied"])
def pair(request):
    jm, params = _jax_model(request.param)
    return jm, params, _port_model(params, request.param)


def test_load_jax_params_round_trips_every_leaf(pair):
    _, params, model = pair
    flat = {tuple(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    seen = set()
    for path, target, transposed in jax_leaves(model):
        arr = flat[path]
        seen.add(path)
        got = (np.stack([p.detach().numpy() for p in target])
               if isinstance(target, list) else target.detach().numpy())
        if transposed:
            got = np.swapaxes(got, -1, -2)
        np.testing.assert_array_equal(got, arr, err_msg=".".join(path))
    assert seen == set(flat)


def test_load_jax_params_rejects_unknown_keys(pair):
    _, params, model = pair
    bad = dict(params, extra={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(model, bad)


def test_dense_logits_match_jax(pair):
    jm, params, model = pair
    ids = np.random.default_rng(2).integers(0, 256, (2, 12))
    ref = np.asarray(jm(params, jnp.asarray(ids, jnp.int32))["logits"])
    with torch.no_grad():
        out = model(torch.from_numpy(ids))["logits"].numpy()
    np.testing.assert_allclose(out, ref, rtol=LOGITS_RTOL, atol=1e-5)


@pytest.mark.parametrize("scaling", [None, {"rope_type": "linear",
                                            "factor": 4.0}, LLAMA3_ROPE],
                         ids=["default", "linear", "llama3"])
def test_rope_matches_jax(scaling):
    inv = rotary.rope_parameters(16, 10000.0, scaling)
    jinv, jatt = jrotary.rope_parameters(16, 10000.0, scaling)
    np.testing.assert_array_equal(inv, jinv)
    assert jatt == 1.0
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 5, 2, 16)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 5)).astype(np.int32)
    jq, jk = jrotary.apply_rope(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(pos), jnp.asarray(jinv))
    tq, tk = rotary.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(pos), torch.from_numpy(inv))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    ref = np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    out = norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def _step_inputs(quantized: bool):
    """A mixed step over pools holding earlier history: row 0 prefills 8
    tokens at positions 16..23, row 1 decodes one token at 20 (7 pads)."""
    rng = np.random.default_rng(11)
    L, NB, BS, Hk, D, W = 2, 6, 16, 2, 16, 8
    shape = (L, NB, BS, Hk, D)
    if quantized:
        pools = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                 "v": rng.integers(-127, 128, shape).astype(np.int8),
                 "k_scale": rng.uniform(0.005, 0.02, shape[:-1]).astype(
                     np.float32),
                 "v_scale": rng.uniform(0.005, 0.02, shape[:-1]).astype(
                     np.float32)}
    else:
        pools = {"k": rng.normal(size=shape).astype(np.float32),
                 "v": rng.normal(size=shape).astype(np.float32)}
    tables = np.asarray([[1, 2], [3, 4]], np.int32)
    ids = np.zeros((2, W), np.int64)
    ids[0] = rng.integers(1, 256, W)
    ids[1, 0] = 7
    pos = np.asarray([np.arange(16, 24), np.full(W, 20)], np.int32)
    slots = np.tile(np.arange(W) % BS, (2, 1)).astype(np.int64)
    slots[0] = 2 * BS + np.arange(W)               # block 2, slots 0..7
    slots[1, 0] = 4 * BS + 4                        # block 4, slot 4
    ctx = np.asarray([24, 21], np.int32)
    last = np.asarray([W - 1, 0], np.int64)
    return pools, ids, pos, slots, tables, ctx, last


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_paged_step_matches_jax(pair, quantized):
    jm, params, model = pair
    pools, ids, pos, slots, tables, ctx, last = _step_inputs(quantized)
    B = ids.shape[0]
    zeros = jnp.zeros((B,), jnp.int32)
    g_ref, last_ref, pools_ref = jax_paged_step(
        jm, 16, quantized, False, False, params,
        {n: jnp.asarray(p) for n, p in pools.items()},
        jnp.asarray(ids, jnp.int32), jnp.asarray(pos), jnp.asarray(
            slots, jnp.int32), jnp.asarray(tables), jnp.asarray(ctx),
        jnp.asarray(last, jnp.int32), zeros, zeros)
    tpools = {n: torch.from_numpy(p.copy()) for n, p in pools.items()}
    view = PagedKVView(tpools, torch.from_numpy(tables),
                       torch.from_numpy(slots), torch.from_numpy(ctx),
                       torch.from_numpy(pos), block_size=16,
                       quantized=quantized)
    greedy, last_logits = _paged_step(model, view, torch.from_numpy(ids),
                                      torch.from_numpy(last))
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(g_ref))
    np.testing.assert_allclose(last_logits.numpy(), np.asarray(last_ref),
                               rtol=LOGITS_RTOL, atol=1e-5)
    for name, p in tpools.items():
        ref = np.asarray(pools_ref[name])
        if p.dtype == torch.int8:
            # k/v come from fp32 matmuls summed in another order: a value on
            # a rounding edge may land one int8 code away
            diff = np.abs(p.numpy().astype(np.int32) - ref.astype(np.int32))
            assert diff.max() <= 1 and (diff == 0).mean() > 0.99, name
        else:
            np.testing.assert_allclose(p.numpy(), ref, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
