"""The port's dense ``generate()`` and eval scorer against the JAX
package's, on the same float32 weights: tokens equal to JAX's
``generate()`` (ragged prompts, eos, one token), the dense cached decode
equal to the full forward, the engine's ``generate()`` equal to the dense
one, a ``LoRAModel`` generating with a cache (merged weights) equal to
JAX's generate over its merged params, and ``greedy_continuation_score``
/ ``eval_config_dataset`` equal to JAX's by both routes on local rows."""

import jax
import numpy as np
import pytest
import torch

from automodel_tpu.generation import GenerationConfig as JaxGenerationConfig
from automodel_tpu.generation import generate as jax_generate
from automodel_tpu.peft.lora import LoRAModel as JaxLoRAModel
from automodel_tpu.peft.lora import PeftConfig as JaxPeftConfig
from automodel_tpu.serving import eval as jeval
from automodel_tpu_torch.generation import GenerationConfig, generate
from automodel_tpu_torch.generation.generate import left_align
from automodel_tpu_torch.models.weights import load_jax_params
from automodel_tpu_torch.peft.lora import LoRAModel, PeftConfig
from automodel_tpu_torch.serving import eval as teval
from tests.torch_serving_pair import build_models, make_engine

LENS = [9, 6, 13, 5]


@pytest.fixture(scope="module")
def models():
    return build_models()


def _batch(seed=1, lens=LENS):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lens), max(lens)), np.int64)
    for b, n in enumerate(lens):
        ids[b, :n] = rng.integers(1, 255, n)
    return ids, np.asarray(lens)


GEN_CASES = {
    "greedy": dict(max_new_tokens=8),
    "eos": dict(max_new_tokens=10, eos_token_id=None),    # set per run
    "one_token": dict(max_new_tokens=1),
    "pad_7": dict(max_new_tokens=6, pad_token_id=7),
}


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generate_equals_jax(models, case):
    jm, params, tm = models
    ids, lens = _batch()
    kw = dict(GEN_CASES[case])
    if case == "eos":
        # the token the first row emits third: rows stop there
        first = jax_generate(jm, params, ids, prompt_lens=lens,
                             config=JaxGenerationConfig(max_new_tokens=3))
        kw["eos_token_id"] = int(first[0, 2])
    want = jax_generate(jm, params, ids, prompt_lens=lens,
                        config=JaxGenerationConfig(**kw))
    got = generate(tm, ids, lens, GenerationConfig(**kw))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.dtype == np.int32
    if case == "eos":
        assert (got == kw.get("pad_token_id", 0)).any()


def test_left_align():
    ids = torch.tensor([[1, 2, 3, 0], [4, 5, 0, 0]])
    out = left_align(ids, torch.tensor([3, 2]), 9)
    assert out.tolist() == [[9, 1, 2, 3], [9, 9, 4, 5]]


@torch.inference_mode()
def test_dense_cached_decode_equals_full_forward(models):
    tm = models[2]
    ids = torch.from_numpy(_batch(3, [12, 12])[0])
    full = tm(ids)["logits"]
    cache = tm.init_kv_cache(2, 16)
    out = tm(ids[:, :8], kv_cache=cache, cache_index=0)
    torch.testing.assert_close(out["logits"], full[:, :8], rtol=1e-5,
                               atol=1e-5)
    assert out["kv_cache"] is cache
    for t in range(8, 12):
        step = tm(ids[:, t:t + 1], kv_cache=cache, cache_index=t)
        torch.testing.assert_close(step["logits"][:, 0], full[:, t],
                                   rtol=1e-5, atol=1e-5)
    assert bool((cache["k"][:, :, 12:] == 0).all())
    with pytest.raises(ValueError, match="cache_index"):
        tm(ids[:, :1], kv_cache=cache)


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_engine_generate_equals_dense(models, kv):
    ids, lens = _batch(2)
    cfg = GenerationConfig(max_new_tokens=8)
    dense = generate(models[2], ids, lens, cfg)
    eng = make_engine("port", models, kv_cache_dtype=kv)
    got = eng.generate(ids, lens, cfg)
    if kv == "auto":
        np.testing.assert_array_equal(got, dense)
    else:       # int8 KV: the same tokens on most positions
        assert np.mean(got == dense) > 0.5
    assert eng.allocator.all_free


def test_lora_model_generates_with_a_cache(models):
    """The lifted serving raise: a LoRAModel decodes over a cache with its
    merged weights, equal to JAX's generate over the merged params."""
    jm, params, tm = models
    jlm = JaxLoRAModel(jm, JaxPeftConfig(dim=8, alpha=16))
    rng = np.random.default_rng(4)
    lora = {k: {"A": (0.3 * rng.standard_normal(v["A"].shape)
                      ).astype(np.float32),
                "B": (0.3 * rng.standard_normal(v["B"].shape)
                      ).astype(np.float32)}
            for k, v in jlm.init_lora(jax.random.key(0)).items()}
    merged = jlm.merge_params({"base": params, "lora": lora})
    ids, lens = _batch(5)
    want = jax_generate(jm, merged, ids, prompt_lens=lens,
                        config=JaxGenerationConfig(max_new_tokens=6))
    lm = LoRAModel(tm, PeftConfig(dim=8, alpha=16))
    load_jax_params(lm, {"base": params, "lora": lora})
    got = generate(lm, ids, lens, GenerationConfig(max_new_tokens=6))
    np.testing.assert_array_equal(got, np.asarray(want))
    base = generate(tm, ids, lens, GenerationConfig(max_new_tokens=6))
    assert not np.array_equal(got, base)
    eng = make_engine("port", models, model=lm, max_new=6)
    np.testing.assert_array_equal(eng.generate(ids, lens), got)


def _rows():
    rng = np.random.default_rng(8)
    rows = []
    for n, cut in ((12, 6), (9, 4), (14, 10), (7, 3)):
        ids = rng.integers(1, 255, n).tolist()
        labels = [-100] * (cut - 1) + ids[cut:] + [-100]
        rows.append({"input_ids": ids, "labels": labels})
    rows.append({"input_ids": rng.integers(1, 255, 10).tolist()})
    rows.append({"input_ids": [5]})            # too short: skipped
    return rows


def test_split_prompt_target_equals_jax():
    for row in _rows():
        for frac in (0.3, 0.5):
            assert teval.split_prompt_target(row, prompt_frac=frac) == \
                jeval.split_prompt_target(row, prompt_frac=frac)


@pytest.mark.parametrize("via", ["engine", "generate"])
def test_greedy_continuation_score_equals_jax(models, via):
    jm, params, tm = models
    rows = teval.rows_from_dataset(_rows())
    got = teval.greedy_continuation_score(tm, rows, via=via, device="cpu")
    want = jeval.greedy_continuation_score(jm, params, rows, via=via)
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    for k in ("score", "exact_match", "rows", "via"):
        assert got[k] == want[k], k


def test_eval_config_dataset_both_routes(models):
    jm, params, tm = models
    cfg = {"validation_dataset": _rows()}
    by = {via: teval.eval_config_dataset(cfg, tm, via=via, limit=5,
                                         device="cpu")
          for via in ("engine", "generate")}
    assert by["engine"]["score"] == by["generate"]["score"]
    want = jeval.eval_config_dataset(cfg, jm, params, via="engine", limit=5)
    assert by["engine"]["score"] == want["score"]
    assert by["engine"]["rows"] == want["rows"] == 5
    with pytest.raises(ValueError, match="via"):
        teval.greedy_continuation_score(tm, teval.rows_from_dataset(
            _rows()), via="beam", device="cpu")
    with pytest.raises(ValueError, match="section"):
        teval.eval_config_dataset({}, tm, device="cpu")
