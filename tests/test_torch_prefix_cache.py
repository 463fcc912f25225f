"""Prefix caching with copy-on-write in the port against the JAX package:
the refcounted allocator and the PrefixIndex (chain keys equal string for
string, the warm LRU), then the engines on the same float32 weights --
greedy tokens identical to the JAX engine's with the cache on (a mixed
batch sharing a prefix, a warm rerun, preemption pressure, int8 KV,
identical prompts forking) and to the cache-off run, with equal
``prefill_tokens_saved``, ``cache_hit_rate`` and ``cow_forks`` -- and the
``kv_prefix_lookup`` / ``kv_cow_fork`` / ``serve_watchdog_stall`` drills."""

import numpy as np
import pytest
import torch

from automodel_tpu.serving.kv_cache import BlockAllocator as JaxAllocator
from automodel_tpu.serving.kv_cache import PrefixIndex as JaxPrefixIndex
from automodel_tpu_torch.serving.kv_cache import (
    BlockAllocator,
    PrefixIndex,
    cow_copy_blocks,
    init_paged_pools,
)
from tests.torch_serving_pair import (
    assert_same,
    build_models,
    make_engine,
    run_both,
    seeded_prompts,
    submit_all,
)


@pytest.fixture(scope="module")
def models():
    return build_models()


def _shared_prefix_prompts(n, prefix=16, tail=3, seed=3):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 255, prefix).tolist()
    return [shared + rng.integers(1, 255, tail).tolist() for _ in range(n)]


# ---------------------------------------------------------------------------
# allocator and index against the JAX ones
# ---------------------------------------------------------------------------
def _lifecycle(alloc_cls, index_cls):
    """A fixed sequence of allocator / index operations; returns what each
    step observed."""
    a = alloc_cls(10)
    idx = index_cls(a, block_size=4, lru_blocks=2)
    seen = []
    t1 = a.allocate(3)
    keys = idx.chain_keys(list(range(1, 13)), adapter_id=0)
    p = None
    for i, b in enumerate(t1):
        p = idx.commit(p, list(range(1 + 4 * i, 5 + 4 * i)), b)
    seen.append((list(t1), [a.ref_count(b) for b in t1], idx.cached_blocks))
    chain = idx.acquire(keys)                    # a second holder
    seen.append((chain, [a.ref_count(b) for b in t1], a.free_blocks))
    a.free(t1)
    seen.append(([a.ref_count(b) for b in t1], a.free_blocks, a.all_free))
    a.free(chain)                                # last holder: warm LRU
    seen.append((a.free_blocks, a.all_free, idx.cached_blocks,
                 idx.evictions))
    again = idx.acquire(keys[:2])                # revive warm blocks
    seen.append((again, [a.ref_count(b) for b in again], idx.hits,
                 idx.lookups))
    a.free(again)
    grab = a.allocate(8)                         # forces LRU evictions
    seen.append((sorted(grab), idx.evictions, idx.cached_blocks))
    a.free(grab)
    with pytest.raises(ValueError, match="double free"):
        a.free(grab[:1])
    idx.flush()
    seen.append((a.all_free, idx.cached_blocks, a.peak_used))
    return seen


def test_allocator_and_index_lifecycle_match_jax():
    assert _lifecycle(BlockAllocator, PrefixIndex) == \
        _lifecycle(JaxAllocator, JaxPrefixIndex)


@pytest.mark.parametrize("adapter_id", [0, 1, 7])
@pytest.mark.parametrize("n_tokens", [3, 8, 21, 64])
def test_chain_keys_equal_jax_string_for_string(adapter_id, n_tokens):
    toks = np.random.default_rng(n_tokens).integers(0, 128256,
                                                    n_tokens).tolist()
    got = PrefixIndex(BlockAllocator(4), block_size=8).chain_keys(
        toks, adapter_id)
    want = JaxPrefixIndex(JaxAllocator(4), block_size=8).chain_keys(
        toks, adapter_id)
    assert got == want and len(got) == n_tokens // 8


def test_chain_keys_are_rooted_per_tenant():
    idx = PrefixIndex(BlockAllocator(4), block_size=4)
    toks = list(range(8))
    assert idx.chain_keys(toks, 0) != idx.chain_keys(toks, 1)
    assert idx.chain_keys(toks, 1) != idx.chain_keys(toks, 2)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_cow_copy_blocks_copies_every_plane(quantized):
    pools = init_paged_pools(num_layers=2, num_kv_heads=2, head_dim=4,
                             num_blocks=6, block_size=4,
                             cache_dtype=torch.float32, quantized=quantized,
                             device="cpu")
    g = torch.Generator().manual_seed(0)
    for p in pools.values():
        p.copy_(torch.randint(-100, 100, p.shape, generator=g).to(p.dtype))
    before = {n: p.clone() for n, p in pools.items()}
    cow_copy_blocks(pools, torch.tensor([2, 0, 0]), torch.tensor([5, 0, 0]))
    for n, p in pools.items():
        assert torch.equal(p[:, 5], before[n][:, 2])
        assert torch.equal(p[:, :5], before[n][:, :5])
    assert set(pools) == ({"k", "v", "k_scale", "v_scale"} if quantized
                          else {"k", "v"})


# ---------------------------------------------------------------------------
# engines: token identity with the JAX engine and with the cache off
# ---------------------------------------------------------------------------
def _mixed(eng, clock):
    submit_all(eng, _shared_prefix_prompts(4) + seeded_prompts(9, [7, 11]))
    eng.run()
    return eng.allocator.all_free


def _warm_rerun(eng, clock):
    prompts = _shared_prefix_prompts(3)
    submit_all(eng, prompts)
    eng.run()
    submit_all(eng, prompts)      # every block of the prefix is warm now
    eng.run()
    return eng.allocator.all_free


def _identical(eng, clock):
    # identical prompts of whole blocks: the later ones defer, then fork
    p = seeded_prompts(4, [16])[0]
    submit_all(eng, [p] * 4)
    eng.run()
    return eng.allocator.all_free


SCENARIOS = {
    "mixed_batch": (_mixed, {}),
    "warm_rerun": (_warm_rerun, {}),
    "preemption": (_mixed, dict(num_kv_blocks=9)),
    "int8_kv": (_mixed, dict(kv_cache_dtype="int8")),
    "identical_fork": (_identical, {}),
    "lru_bounded": (_warm_rerun, dict(prefix_lru_blocks=1)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_prefix_cache_token_identical_to_jax_and_cache_off(models, name):
    scenario, kw = SCENARIOS[name]
    res = run_both(models, scenario, prefix_caching="on", **kw)
    teng = assert_same(res)
    stats = res[1][2]
    assert res[1][1] is True                      # allocator all_free
    off = make_engine("port", models, **kw)
    scenario(off, None)
    assert {r: o[2] for r, o in res[1][0].items()} == \
        {r: list(q.out_tokens) for r, q in off.requests.items()}
    assert stats["prefill_tokens_saved"] > 0
    if name == "identical_fork":
        assert stats["prefix_cache"]["cow_forks"] > 0
        assert stats["prefix_cache"]["deferrals"] > 0
    if name == "preemption":
        assert stats["preemptions"] > 0
    assert teng.prefix_index.cached_blocks > 0


# ---------------------------------------------------------------------------
# drills
# ---------------------------------------------------------------------------
@pytest.mark.fault
@pytest.mark.parametrize("point", ["kv_prefix_lookup:1", "kv_cow_fork:1",
                                   "kv_prefix_lookup:2,kv_cow_fork:2"])
def test_prefix_drills_degrade_to_cold_prefill(models, point):
    res = run_both(models, _identical, fault=point, prefix_caching="on")
    assert_same(res)
    clean = run_both(models, _identical, prefix_caching="on")
    assert {r: o[2] for r, o in res[1][0].items()} == \
        {r: o[2] for r, o in clean[1][0].items()}
    if "kv_cow_fork" in point:
        assert res[1][2]["prefix_cache"]["cow_fork_failures"] >= 1
    assert res[1][1] is True


@pytest.mark.fault
def test_watchdog_stall_flushes_the_index_token_identical(models):
    def scenario(eng, clock):
        submit_all(eng, _shared_prefix_prompts(4))
        eng.run()
        return (eng.allocator.all_free,
                eng.prefix_index.cached_blocks)

    res = run_both(models, scenario, fault="serve_watchdog_stall:3",
                   prefix_caching="on", watchdog_s=5.0)
    assert_same(res)
    assert res[1][2]["watchdog_recoveries"] == 1
    clean = run_both(models, scenario, prefix_caching="on")
    assert {r: o[2] for r, o in res[1][0].items()} == \
        {r: o[2] for r, o in clean[1][0].items()}
