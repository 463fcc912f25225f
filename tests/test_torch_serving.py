"""The port's serving path against the JAX package's: the same scheduler
plans for the same submissions, and token-identical greedy output from the
two decode engines on the same (float32) parameters -- a mixed-length
batch, a pool small enough to force preemption, and int8 KV.  Plus the
config contract (left-out knobs raise, no silent CPU), the allocator and
sampler, and the serve CLI on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from automodel_tpu.generation import GenerationConfig as JaxGenerationConfig
from automodel_tpu.serving import BlockAllocator as JaxBlockAllocator
from automodel_tpu.serving import DecodeEngine as JaxDecodeEngine
from automodel_tpu.serving import Request as JaxRequest
from automodel_tpu.serving import Scheduler as JaxScheduler
from automodel_tpu.serving import ServingConfig as JaxServingConfig
from automodel_tpu_torch.config.loader import load_yaml_config
from automodel_tpu_torch.generation import GenerationConfig, sample_logits
from automodel_tpu_torch.serving import (
    BlockAllocator,
    DecodeEngine,
    OutOfBlocks,
    Request,
    Scheduler,
    ServingConfig,
    build_serving_config,
)
from tests.test_torch_llama import _jax_model, _port_model

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENS = [9, 6, 13, 5]
MAX_NEW = 8


# ---------------------------------------------------------------------------
# scheduler: the same StepPlan sequence
# ---------------------------------------------------------------------------
def _plan_key(plan):
    if plan is None:
        return None
    return (plan.step_width, [
        (i, w.req.rid, list(w.tokens), w.start_pos, w.samples_next,
         list(w.req.blocks)) for i, w in enumerate(plan.rows)
        if w is not None])


def _drive_scheduler(sched_cls, alloc_cls, req_cls, num_blocks, arrivals):
    """Step a scheduler to completion with a deterministic token rule;
    ``arrivals`` maps step index -> prompts submitted before that step."""
    sched = sched_cls(alloc_cls(num_blocks), max_num_seqs=3,
                      prefill_chunk=4, block_size=4, max_model_len=40)
    plans, rid, step = [], 0, 0
    while step in arrivals or sched.has_work():
        for prompt in arrivals.get(step, []):
            sched.add(req_cls(rid=rid, prompt=list(prompt),
                              max_new_tokens=6 + rid % 3))
            rid += 1
        plan = sched.schedule()
        plans.append(_plan_key(plan))
        if plan is not None:
            sampled = {w.req.slot: (w.req.rid * 7 + len(w.req.out_tokens))
                       % 50 + 2 for w in plan.active if w.samples_next}
            sched.finish_step(plan, sampled)
        step += 1
        assert step < 500
    return plans, sched.preemptions


@pytest.mark.parametrize("num_blocks", [64, 9], ids=["roomy", "preempting"])
def test_scheduler_plans_match_jax(num_blocks):
    rng = np.random.default_rng(4)
    arrivals = {0: [rng.integers(1, 99, n) for n in (9, 3, 14, 6)],
                5: [rng.integers(1, 99, n) for n in (11, 2)]}
    port, port_pre = _drive_scheduler(Scheduler, BlockAllocator, Request,
                                      num_blocks, arrivals)
    ref, ref_pre = _drive_scheduler(JaxScheduler, JaxBlockAllocator,
                                    JaxRequest, num_blocks, arrivals)
    assert port == ref
    assert port_pre == ref_pre
    assert (port_pre > 0) == (num_blocks == 9)


# ---------------------------------------------------------------------------
# engines: token-identical greedy output
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    jm, params = _jax_model(tied=True)
    return jm, params, _port_model(params, tied=True)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(1, 255, n) for n in LENS]


ENGINE_RUNS = {
    "mixed_batch": dict(),
    "preemption": dict(num_kv_blocks=7),
    "int8_kv": dict(kv_cache_dtype="int8"),
}


@pytest.mark.parametrize("run", list(ENGINE_RUNS), ids=list(ENGINE_RUNS))
def test_engine_token_identical_to_jax(models, prompts, run):
    jm, params, model = models
    kw = dict(kv_block_size=8, max_num_seqs=4, max_model_len=64,
              prefill_chunk=8, **ENGINE_RUNS[run])
    jeng = JaxDecodeEngine(jm, params, JaxServingConfig(**kw),
                           generation=JaxGenerationConfig(
                               max_new_tokens=MAX_NEW))
    teng = DecodeEngine(model, ServingConfig(**kw),
                        generation=GenerationConfig(max_new_tokens=MAX_NEW),
                        device="cpu")
    for p in prompts:
        jeng.submit(p)
        teng.submit(p)
    ref = jeng.run()
    out = teng.run()
    assert out == ref
    assert all(len(t) == MAX_NEW for t in out.values())
    stats, jstats = teng.stats(), jeng.stats()
    assert stats["preemptions"] == jstats["preemptions"]
    assert (stats["preemptions"] > 0) == (run == "preemption")
    assert stats["outcomes"] == {"finished": len(prompts)}
    assert stats["kernel_launches"] == 0          # CPU: the plain version
    assert teng.allocator.all_free


def test_engine_host_sampling_path(models, prompts):
    """``do_sample`` rows sample host-side from the step's last logits: with
    top_k=1 that is the greedy chain again; with a wide top_k the tokens
    come from the engine's seeded generator (same seed, same tokens)."""
    model = models[2]
    kw = dict(kv_block_size=8, max_num_seqs=4, max_model_len=64,
              prefill_chunk=8)

    def run(gen, seed=0):
        eng = DecodeEngine(model, ServingConfig(**kw), generation=gen,
                           device="cpu", sample_seed=seed)
        for p in prompts:
            eng.submit(p)
        return eng.run()

    greedy = run(GenerationConfig(max_new_tokens=MAX_NEW))
    assert run(GenerationConfig(max_new_tokens=MAX_NEW, do_sample=True,
                                top_k=1)) == greedy
    wide = GenerationConfig(max_new_tokens=MAX_NEW, do_sample=True,
                            temperature=2.0, top_k=50)
    assert run(wide, seed=1) == run(wide, seed=1)
    assert run(wide, seed=1) != greedy


# ---------------------------------------------------------------------------
# config contract
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("knob,value", [
    ("prefix_caching", "maybe"), ("speculative", "eagle"),
    ("max_adapters", 0), ("replicas", 0), ("watchdog_s", -5.0)])
def test_left_out_knobs_raise(knob, value):
    """The ported knobs raise on a bad value, naming the knob, where the
    JAX validation raises too.  Null is the default either way."""
    with pytest.raises(ValueError, match=knob):
        build_serving_config({knob: value})
    with pytest.raises(ValueError, match=knob):
        JaxServingConfig(**{knob: value})
    assert build_serving_config({knob: None}) == ServingConfig()


def test_jax_serving_yaml_loads_unchanged():
    """The JAX package's serving YAML builds the port's model (target
    remap) and a serving config; a scheduler policy outside fcfs / sjf
    raises, naming the key."""
    cfg = load_yaml_config(os.path.join(
        REPO, "examples", "serve", "tiny_llama_serve.yaml"))
    scfg = build_serving_config(cfg)
    assert (scfg.max_num_seqs, scfg.prefill_chunk) == (8, 32)
    model = cfg.model.instantiate(device="cpu")
    assert type(model).__module__ == "automodel_tpu_torch.models.llama"
    assert model.param_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="scheduler_policy"):
        build_serving_config({"scheduler_policy": "lifo"})


def test_engine_without_device_needs_a_card(models):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(models[2])


# ---------------------------------------------------------------------------
# allocator + sampler
# ---------------------------------------------------------------------------
def test_block_allocator_contract():
    a = BlockAllocator(4)
    got = a.allocate(3)
    assert sorted(got) == [1, 2, 3] and 0 not in got
    with pytest.raises(OutOfBlocks):
        a.allocate(1)
    assert a.failed_allocs == 1 and a.peak_used == 3
    a.free(got[:1])
    with pytest.raises(ValueError, match="double free"):
        a.free(got[:1])
    with pytest.raises(ValueError, match="unknown"):
        a.free([0])
    a.free(got[1:])
    assert a.all_free


def test_sample_logits():
    logits = torch.tensor([[0.1, 3.0, 0.2, 2.9], [5.0, 0.0, 0.0, 4.0]])
    assert sample_logits(logits, GenerationConfig()).tolist() == [1, 0]
    gen = torch.Generator().manual_seed(0)
    for cfg in (GenerationConfig(do_sample=True, top_k=1),
                GenerationConfig(do_sample=True, top_p=1e-3)):
        assert sample_logits(logits, cfg, gen).tolist() == [1, 0]
    two = GenerationConfig(do_sample=True, top_k=2)
    draws = {tuple(sample_logits(logits, two, gen).tolist())
             for _ in range(32)}
    assert all(d[0] in (1, 3) and d[1] in (0, 3) for d in draws)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------
def test_serve_cli_on_cpu_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m", "automodel_tpu_torch.tools.serve", "-c",
         "automodel_tpu_torch/examples/tiny_llama_serve.yaml", "--device",
         "cpu", "--requests", "4"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["not_finished"] == 0
    assert report["outcomes"] == {"finished": 5}       # + the warm-up
    assert report["device"] == "cpu" and report["decode_tok_s"] > 0
