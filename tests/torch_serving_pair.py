"""Shared harness of the serving-feature tests: the same scenario driven
through the JAX package's decode engine and the port's, on the same
float32 weights (``tests/test_torch_llama.py``'s tiny Llama), a virtual
clock each, and the same fault spec armed in each package's registry."""

import numpy as np
import torch

from automodel_tpu.generation import GenerationConfig as JaxGenerationConfig
from automodel_tpu.serving import DecodeEngine as JaxDecodeEngine
from automodel_tpu.serving import ServingConfig as JaxServingConfig
from automodel_tpu.utils import fault_injection as jfi
from automodel_tpu_torch.generation import GenerationConfig
from automodel_tpu_torch.serving import DecodeEngine, ServingConfig
from automodel_tpu_torch.utils import fault_injection as tfi
from tests.test_torch_llama import _jax_model, _port_model

torch.set_num_threads(1)

MAX_NEW = 8
BASE_CFG = dict(kv_block_size=8, max_num_seqs=4, max_model_len=64,
                prefill_chunk=8)

# stats both engines report with the same meaning
COMMON_STATS = (
    "prefill_tokens_saved", "cache_hit_rate", "prefix_cache",
    "spec_tokens_accepted", "accept_rate", "tokens_per_step", "speculative",
    "multi_tenant", "steps", "decode_steps", "mixed_steps",
    "tokens_generated", "preemptions", "admissions", "aborts", "expired",
    "rejected", "pinned", "watchdog_recoveries", "kv_blocks_peak",
    "kv_blocks_free", "failed_allocs", "outcomes")


class VirtualClock:
    """A deterministic clock: time moves only when a test advances it."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def build_models():
    jm, params = _jax_model(tied=True)
    return jm, params, _port_model(params, tied=True)


def make_engine(kind, models, clock=None, max_new=MAX_NEW, generation=None,
                model=None, **kw):
    """A JAX (``kind="jax"``) or port engine over the shared weights;
    ``kw`` overrides :data:`BASE_CFG`."""
    jm, params, tm = models
    cfg = {**BASE_CFG, **kw}
    gen = dict(max_new_tokens=max_new, **(generation or {}))
    clock = clock or VirtualClock()
    if kind == "jax":
        return JaxDecodeEngine(jm, params, JaxServingConfig(**cfg),
                               generation=JaxGenerationConfig(**gen),
                               clock=clock)
    return DecodeEngine(model if model is not None else tm,
                        ServingConfig(**cfg),
                        generation=GenerationConfig(**gen), device="cpu",
                        clock=clock)


def outcome(eng):
    """rid -> (state, finish reason, generated tokens)."""
    return {rid: (r.state.value, r.finish_reason, list(r.out_tokens))
            for rid, r in eng.requests.items()}


def run_both(models, scenario, fault=None, **kw):
    """Run ``scenario(engine, clock)`` on a fresh JAX engine and a fresh
    port engine (``fault`` armed in each package for its run); returns
    ``[(outcome, scenario's value, stats, engine), ...]`` JAX first."""
    out = []
    for kind, fi in (("jax", jfi), ("port", tfi)):
        fi.configure_faults(fault)
        try:
            clock = VirtualClock()
            eng = make_engine(kind, models, clock=clock, **kw)
            extra = scenario(eng, clock)
            out.append((outcome(eng), extra, eng.stats(), eng))
        finally:
            fi.reset_faults()
    return out


def assert_same(results, stats=COMMON_STATS):
    """The two runs of :func:`run_both` agree: every request's outcome and
    tokens, the scenario's value, and the common stats."""
    (jo, jx, js, _), (to, tx, ts, teng) = results
    assert to == jo
    assert tx == jx
    for key in stats:
        assert ts[key] == js[key], key
    assert ts["kernel_launches"] == 0          # CPU: the plain version
    return teng


def submit_all(eng, prompts, **kw):
    return [eng.submit(p, **kw) for p in prompts]


def seeded_prompts(seed, lens, vocab=255):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lens]
