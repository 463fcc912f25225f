"""Multi-tenant LoRA serving in the port against the JAX package: the
grouped adapter delta (``ops/lora_gmm.py``) against the JAX one within
1e-5 relative, empty groups included; the slab geometry and the load
digest; then the engines on the same float32 weights and adapters -- a
mixed batch token-identical to the JAX engine's and to merged
single-adapter port engines (a ``LoRAModel`` serving with a cache), alone
and composed with prefix caching, speculation, int8 KV and preemption;
base-only traffic identical to a plain engine; prefix reuse within a
tenant and never across; ``tenant_quota`` defers and never rejects; the
``adapter_load`` / ``adapter_swap`` drills."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.ops.lora_gmm import multi_lora_delta as jax_delta
from automodel_tpu.peft.lora import PeftConfig as JaxPeftConfig
from automodel_tpu.peft.lora import adapter_slab_shapes as jax_slab_shapes
from automodel_tpu.utils import fault_injection as jfi
from automodel_tpu_torch.models.weights import load_jax_params
from automodel_tpu_torch.ops.lora_gmm import (
    lora_routing,
    multi_lora_delta,
    multi_lora_delta_reference,
)
from automodel_tpu_torch.peft.lora import LoRAModel, PeftConfig
from automodel_tpu_torch.peft.lora import adapter_slab_shapes
from automodel_tpu_torch.serving import AdapterLoadError
from automodel_tpu_torch.serving.adapters import tree_digest
from automodel_tpu_torch.utils import fault_injection as tfi
from tests.torch_serving_pair import (
    assert_same,
    build_models,
    make_engine,
    run_both,
    seeded_prompts,
)

RANK, ALPHA = 8, 16
LENS = [9, 6, 13, 5]
MIXED_IDS = [1, 2, 0, 1]        # two tenants and base in one batch


@pytest.fixture(scope="module")
def models():
    return build_models()


@pytest.fixture(scope="module")
def trees(models):
    """Two trained-shaped adapter trees (nonzero B) in the JAX layout."""
    jm = models[0]
    shapes = jax_slab_shapes(jm, JaxPeftConfig(dim=RANK), 1)
    out = {}
    for slot, seed in ((1, 11), (2, 13)):
        rng = np.random.default_rng(seed)
        out[slot] = {
            path: {"A": (0.3 * rng.standard_normal((a[0],) + a[2:])
                         ).astype(np.float32),
                   "B": (0.3 * rng.standard_normal((b[0],) + b[2:])
                         ).astype(np.float32)}
            for path, (a, b) in shapes.items()}
    return out


@pytest.fixture(scope="module")
def prompts():
    return seeded_prompts(1, LENS)


def _load(eng, trees, slots=(1, 2)):
    for slot in slots:
        eng.load_adapter(slot, trees[slot], name=f"tenant-{slot}",
                         scale=ALPHA / RANK)
    return eng


def _mixed(trees, prompts, ids=MIXED_IDS):
    def scenario(eng, clock):
        _load(eng, trees)
        rids = [eng.submit(p, adapter_id=a) for p, a in zip(prompts, ids)]
        eng.run()
        return ([list(eng.requests[r].out_tokens) for r in rids],
                eng.allocator.all_free)
    return scenario


# ---------------------------------------------------------------------------
# the grouped delta
# ---------------------------------------------------------------------------
DELTA_CASES = {
    "mixed": [2, 0, 1, 2, 0],
    "empty_groups": [3, 3, 0, 3, 3],       # slots 1, 2 and 4 idle
    "all_base": [0, 0, 0, 0, 0],
    "one_tenant": [4, 4, 4, 4, 4],
}


@pytest.mark.parametrize("case", list(DELTA_CASES))
def test_multi_lora_delta_matches_jax(case):
    rng = np.random.default_rng(len(case))
    B, S, fin, r, fout, E = 5, 3, 16, 8, 24, 5
    x = rng.standard_normal((B, S, fin)).astype(np.float32)
    a = rng.standard_normal((E, fin, r)).astype(np.float32)
    b = rng.standard_normal((E, r, fout)).astype(np.float32)
    a[0] = 0.0
    b[0] = 0.0
    ids = np.asarray(DELTA_CASES[case], np.int32)
    got = multi_lora_delta(torch.from_numpy(x), torch.from_numpy(a),
                           torch.from_numpy(b), torch.from_numpy(ids))
    want = np.asarray(jax_delta(jnp.asarray(x), jnp.asarray(a),
                                jnp.asarray(b), jnp.asarray(ids)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    ref = multi_lora_delta_reference(torch.from_numpy(x), torch.from_numpy(a),
                                     torch.from_numpy(b),
                                     torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()) + 1e-30)
    for row in np.nonzero(ids == 0)[0]:
        assert bool((got[row] == 0).all())        # slot 0: exactly zero


def test_lora_routing_sorts_rows_by_adapter():
    ids = torch.tensor([2, 0, 1, 2])
    rt = lora_routing(ids, 3, 4)
    rows = ids.repeat_interleave(3)
    assert rows[rt.order].tolist() == sorted(rows.tolist())
    assert torch.equal(rt.order[rt.inv], torch.arange(12))
    assert rt.group_sizes.tolist() == [3, 3, 6, 0]
    assert rt.group_sizes.dtype == torch.int32


@pytest.mark.parametrize("targets", [["*_proj"], ["*q_proj", "*v_proj"]])
def test_adapter_slab_shapes_match_jax(models, targets):
    jm, _, tm = models
    got = adapter_slab_shapes(tm, PeftConfig(dim=RANK,
                                             target_modules=targets), 3)
    want = jax_slab_shapes(jm, JaxPeftConfig(dim=RANK,
                                             target_modules=targets), 3)
    assert got == want


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------
COMPOSED = {
    "plain": {},
    "prefix_cache": dict(prefix_caching="on"),
    "speculative": dict(speculative="ngram", spec_k=2),
    "int8_kv": dict(kv_cache_dtype="int8"),
    "preemption": dict(num_kv_blocks=9),
    "all_composed": dict(prefix_caching="on", speculative="ngram",
                         kv_cache_dtype="int8"),
}


@pytest.fixture(scope="module")
def merged_oracle(models, trees, prompts):
    """Each (row, adapter) alone through a single-adapter port engine over
    a ``LoRAModel`` serving merged weights (base: the plain engine)."""
    jm, params, tm = models
    out = {}
    for aid in sorted(set(MIXED_IDS)):
        model = tm
        if aid:
            model = LoRAModel(tm, PeftConfig(dim=RANK, alpha=ALPHA))
            load_jax_params(model, {"base": params, "lora": trees[aid]})
        for b, p in enumerate(prompts):
            eng = make_engine("port", models, model=model, max_num_seqs=1)
            rid = eng.submit(p)
            eng.run()
            out[(b, aid)] = list(eng.requests[rid].out_tokens)
    return out


@pytest.mark.parametrize("name", list(COMPOSED))
def test_mixed_batch_identical_to_jax_and_merged(models, trees, prompts,
                                                 merged_oracle, name):
    res = run_both(models, _mixed(trees, prompts), max_adapters=2,
                   adapter_rank=RANK, **COMPOSED[name])
    teng = assert_same(res)
    outs, all_free = res[1][1]
    assert all_free
    for b, (aid, got) in enumerate(zip(MIXED_IDS, outs)):
        if name != "int8_kv" and name != "all_composed":
            assert got == merged_oracle[(b, aid)], (b, aid)
    layers = teng.model.config.num_hidden_layers
    # two grouped products per adapted projection and layer, every step
    assert teng.stats()["gmm_launches"] == 0      # CPU: the plain version
    assert len(teng._slab_adapters) == layers
    pt = res[1][2]["multi_tenant"]["per_tenant"]
    assert pt[1]["finished"] == 2 and pt[2]["finished"] == 1


def test_merged_oracle_is_not_the_base(merged_oracle):
    assert merged_oracle[(0, 1)] != merged_oracle[(0, 0)]


def test_base_only_traffic_identical_to_plain_engine(models, trees, prompts):
    plain = make_engine("port", models)
    mt = _load(make_engine("port", models, max_adapters=2,
                           adapter_rank=RANK), trees)
    for eng in (plain, mt):
        for p in prompts:
            eng.submit(p)
        eng.run()
    assert [r.out_tokens for r in plain.requests.values()] == \
        [r.out_tokens for r in mt.requests.values()]


def test_prefix_reuse_within_a_tenant_and_never_across(models, trees):
    shared = seeded_prompts(7, [16])[0]

    def scenario(eng, clock):
        _load(eng, trees)
        out = []
        for aid in (1, 1, 2, 0):
            rid = eng.submit(shared + [5, 6], adapter_id=aid)
            eng.run()
            out.append((aid, eng.stats()["prefill_tokens_saved"],
                        list(eng.requests[rid].out_tokens)))
        return out

    res = run_both(models, scenario, max_adapters=2, adapter_rank=RANK,
                   prefix_caching="on")
    assert_same(res)
    (_, s1, t1), (_, s2, t2), (_, s3, t3), (_, s4, _) = res[1][1]
    assert s1 == 0 and s2 == 16         # the tenant's own second request
    assert s3 == s2 and s4 == s2        # other tenants and base: cold
    assert t1 == t2 and t1 != t3


def test_tenant_quota_defers_and_never_rejects(models, trees, prompts):
    def scenario(eng, clock):
        _load(eng, trees)
        for p in prompts + prompts:
            eng.submit(p, adapter_id=1)
        eng.submit(prompts[0], adapter_id=2)
        eng.run()
        return eng.allocator.all_free

    res = run_both(models, scenario, max_adapters=2, adapter_rank=RANK,
                   tenant_quota=2)
    assert_same(res)
    mt = res[1][2]["multi_tenant"]
    assert mt["quota_deferrals"] > 0 and mt["tenant_quota"] == 2
    assert res[1][2]["outcomes"] == {"finished": 9}


def test_load_digest_equals_jax_and_registry(models, trees):
    res = run_both(models, lambda eng, clock: _load(eng, trees) and None,
                   max_adapters=2, adapter_rank=RANK)
    assert_same(res)
    jslots = res[0][3].adapter_slots.loaded_slots()
    tslots = res[1][3].adapter_slots.loaded_slots()
    assert tslots == jslots
    assert tslots[1]["digest"] == tree_digest(trees[1])


def test_submit_to_empty_slot_and_remove(models, trees, prompts):
    eng = make_engine("port", models, max_adapters=2, adapter_rank=RANK)
    with pytest.raises(ValueError, match="empty slot"):
        eng.submit(prompts[0], adapter_id=1)
    eng.update_params(adapter_slot=1, adapters=trees[1], adapter_scale=2.0)
    rid = eng.submit(prompts[0], adapter_id=1)
    eng.run()
    assert eng.requests[rid].finished
    eng.remove_adapter(1)
    assert all(bool((s["B"][:, 1] == 0).all())
               for s in eng.adapter_slots.slabs.values())
    with pytest.raises(ValueError, match="empty slot"):
        eng.submit(prompts[0], adapter_id=1)
    with pytest.raises(AdapterLoadError, match="out of range"):
        eng.load_adapter(3, trees[1])
    bad = {k: v for k, v in trees[1].items() if "q_proj" not in k}
    with pytest.raises(AdapterLoadError, match="targets"):
        eng.load_adapter(1, bad)
    plain = make_engine("port", models)
    with pytest.raises(ValueError, match="max_adapters"):
        plain.load_adapter(1, trees[1])


@pytest.mark.fault
@pytest.mark.parametrize("point", ["adapter_load", "adapter_swap"])
def test_adapter_drills_keep_slabs_and_in_flight_rows(models, trees,
                                                      prompts, point):
    """A failed load leaves the slot empty; a failed swap mid-batch leaves
    the old adapter serving and every in-flight row finishes
    token-identically."""
    def scenario(eng, clock):
        _load(eng, trees, slots=(1,) if point == "adapter_load" else (1, 2))
        before = {p: {k: np.asarray(v) for k, v in s.items()}
                  for p, s in eng.adapter_slots.slabs.items()}
        rids = [eng.submit(p, adapter_id=a)
                for p, a in zip(prompts, [1, 0, 1, 0])]
        eng.step()
        eng.step()
        slot = 2 if point == "adapter_load" else 1
        raised = False
        try:
            eng.load_adapter(slot, trees[2], scale=ALPHA / RANK)
        except Exception as e:            # typed in both packages
            raised = type(e).__name__ == "AdapterLoadError"
        eng.run()
        after = {p: {k: np.asarray(v) for k, v in s.items()}
                 for p, s in eng.adapter_slots.slabs.items()}
        same = all(np.array_equal(before[p][k], after[p][k])
                   for p in before for k in before[p])
        return ([list(eng.requests[r].out_tokens) for r in rids], raised,
                same, eng.adapter_slots.stats()["load_failures"])

    res = run_both(models, scenario, fault=f"{point}:2"
                   if point == "adapter_load" else f"{point}:1",
                   max_adapters=2, adapter_rank=RANK)
    assert_same(res)
    outs, raised, same, failures = res[1][1]
    assert raised and same and failures == 1
    clean = make_engine("port", models, max_adapters=2, adapter_rank=RANK)
    _load(clean, trees, slots=(1,))
    rids = [clean.submit(p, adapter_id=a)
            for p, a in zip(prompts, [1, 0, 1, 0])]
    clean.run()
    assert outs == [list(clean.requests[r].out_tokens) for r in rids]
    assert jfi.fault_counts() == {} and tfi.fault_counts() == {}
