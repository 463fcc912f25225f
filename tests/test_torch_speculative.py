"""n-gram speculative decoding in the port against the JAX package: the
proposer and the acceptance rule on seeded sequences, the config
normalisation, then the engines on the same float32 weights -- spec-on
tokens identical to spec-off and to the JAX engine's (also under int8 KV,
preemption and the prefix cache), equal ``accept_rate`` and
``tokens_per_step``, speculation off under ``do_sample``, and the
``spec_draft`` / ``spec_verify`` drills."""

import logging

import numpy as np
import pytest

from automodel_tpu.serving import speculative as jspec
from automodel_tpu_torch.serving import speculative as tspec
from tests.torch_serving_pair import (
    assert_same,
    build_models,
    make_engine,
    run_both,
    seeded_prompts,
    submit_all,
)

MAX_NEW = 16


@pytest.fixture(scope="module")
def models():
    return build_models()


def _periodic_prompts(n=4, length=12, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        motif = rng.integers(1, 255, 3 + i % 2).tolist()
        out.append((motif * length)[:length])
    return out


@pytest.mark.parametrize("seed", range(8))
def test_propose_ngram_matches_jax(seed):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 6, int(rng.integers(0, 40))).tolist()
    for k in range(0, 6):
        for n_max, n_min in ((3, 1), (2, 2), (1, 1)):
            assert tspec.propose_ngram(seq, k, max_ngram=n_max,
                                       min_ngram=n_min) == \
                jspec.propose_ngram(seq, k, max_ngram=n_max,
                                    min_ngram=n_min)
    assert tspec.NgramProposer()(seq, 4) == jspec.NgramProposer()(seq, 4)


@pytest.mark.parametrize("seed", range(6))
def test_longest_accepted_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(50):
        d = rng.integers(0, 3, int(rng.integers(0, 6))).tolist()
        g = rng.integers(0, 3, len(d) + 1).tolist()
        assert tspec.longest_accepted(d, g) == jspec.longest_accepted(d, g)


@pytest.mark.parametrize("value,want", [
    (None, None), ("null", None), (True, "ngram"), (False, "off"),
    ("ngram", "ngram"), ("off", "off")])
def test_speculative_normalize_and_validate(value, want):
    got = tspec.validate_speculative(tspec.normalize_speculative(value))
    assert got == want == jspec.validate_speculative(
        jspec.normalize_speculative(value))


def test_speculative_bad_mode_and_proposer_registry():
    for mod in (tspec, jspec):
        with pytest.raises(ValueError, match="serving.speculative"):
            mod.validate_speculative("eagle")
        assert mod.build_proposer("off") is None
        assert mod.build_proposer(None) is None
    assert isinstance(tspec.build_proposer("ngram"), tspec.NgramProposer)


def _spec_run(eng, clock):
    submit_all(eng, _periodic_prompts() + seeded_prompts(5, [9, 7]))
    eng.run()
    return eng.allocator.all_free


RUNS = {
    "periodic": {},
    "int8_kv": dict(kv_cache_dtype="int8"),
    "preemption": dict(num_kv_blocks=12),
    "prefix_cache": dict(prefix_caching="on"),
    "spec_k2": dict(spec_k=2),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_spec_tokens_identical_to_jax_and_spec_off(models, name):
    kw = {"speculative": "ngram", **RUNS[name]}
    res = run_both(models, _spec_run, max_new=MAX_NEW, **kw)
    assert_same(res)
    stats = res[1][2]
    assert res[1][1] is True
    assert stats["speculative"]["tokens_proposed"] > 0
    # pure-decode steps run at the verify width, prefill ones at the chunk
    assert stats["step_widths"] == sorted({8, kw.get("spec_k", 4) + 1})
    off = make_engine("port", models, max_new=MAX_NEW,
                      **{k: v for k, v in kw.items()
                         if k not in ("speculative", "spec_k")})
    _spec_run(off, None)
    assert {r: o[2] for r, o in res[1][0].items()} == \
        {r: list(q.out_tokens) for r, q in off.requests.items()}
    if name == "periodic":
        # the periodic prompts make the model repeat itself: drafts land
        assert stats["accept_rate"] > 0
        assert stats["tokens_per_step"] > off.stats()["tokens_per_step"]
    if name == "preemption":
        assert stats["preemptions"] > 0


def test_spec_disabled_under_do_sample(models, caplog):
    with caplog.at_level(logging.WARNING):
        eng = make_engine("port", models, speculative="ngram",
                          generation=dict(do_sample=True, top_k=1))
    assert eng.spec_mode == "off"
    assert "greedy-only" in caplog.text
    submit_all(eng, _periodic_prompts(2))
    eng.run()
    assert eng.stats()["speculative"]["tokens_proposed"] == 0
    assert eng.stats()["step_widths"] == [1, 8]


@pytest.mark.fault
@pytest.mark.parametrize("point", ["spec_draft:2", "spec_verify:1",
                                   "spec_draft:1,spec_verify:3"])
def test_spec_drills_stay_token_identical(models, point):
    res = run_both(models, _spec_run, fault=point, max_new=MAX_NEW,
                   speculative="ngram")
    assert_same(res)
    clean = run_both(models, _spec_run, max_new=MAX_NEW, speculative="ngram")
    assert {r: o[2] for r, o in res[1][0].items()} == \
        {r: o[2] for r, o in clean[1][0].items()}
    spec = res[1][2]["speculative"]
    if "spec_draft" in point:
        assert spec["draft_faults"] == 1
    if "spec_verify" in point:
        assert spec["verify_failures"] == 1
