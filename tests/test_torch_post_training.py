"""The port's post-training layer against the JAX package's, in float32 on
the CPU at a tiny size (2 layers, hidden 32, 4 / 2 heads, vocab 64), the
same numpy weights on both sides (``models/weights.py::load_jax_params``):

* ``make_sequence_batch``: the same arrays and the same refusals;
* per-token logprobs against the JAX ``completion_logprobs`` and a dense
  log-softmax of the full logits, right-padded rows included (held within
  the tolerance, not bit for bit), and the kernel route's plain version
  (``lse_and_pick``) against the JAX chunk loop with per-row cotangents;
* group-normalized advantages, the GRPO and DPO objectives: values and
  gradients;
* three GRPO and three DPO optimizer steps on injected batches: metrics
  and parameters;
* the weight handoff (``update_params`` copies, guards, and keeps the
  engine's copy its own), greedy rollouts token for token against the JAX
  worker and the port's ``generate()``, sampled rollouts reproducible
  under a seed;
* the three rollout fault points, ``RolloutConfig`` validation, the enums
  at load and after CLI overrides, and the mock preference pairs.

Tolerances: 1e-5 relative (atol 1e-5 on values of order 1-10) for
logprobs, objectives and their gradients (fp32 on both sides, sums taken
in another order: measured below 3e-6); 1e-4 relative for the optimizer
steps' metrics and parameters, parameters with an absolute floor of 1e-5,
a hundredth of one update at lr 1e-3 (Adam divides by sqrt(nu), so where a
gradient element is near 0 its normalized update follows the last bits: at
lr 1e-2 one element of one matrix came out 1.3e-5 apart after three GRPO
steps, a thousandth of an update).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from automodel_tpu.datasets.llm import mock as jmock
from automodel_tpu.generation import GenerationConfig as JaxGenerationConfig
from automodel_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from automodel_tpu.models.llama import LlamaForCausalLM as JaxLlama
from automodel_tpu.optim import build_optimizer as jax_build_optimizer
from automodel_tpu.post_training import logprobs as jlp
from automodel_tpu.post_training import losses as jlosses
from automodel_tpu.post_training import rollout as jrollout
from automodel_tpu.post_training import steps as jsteps
from automodel_tpu.serving.engine import DecodeEngine as JaxDecodeEngine
from automodel_tpu.serving.engine import ServingConfig as JaxServingConfig
from automodel_tpu.utils import fault_injection as jfi
from automodel_tpu_torch.config.loader import (
    load_yaml_config,
    parse_args_and_load_config,
)
from automodel_tpu_torch.datasets.llm import mock as tmock
from automodel_tpu_torch.generation import GenerationConfig, generate
from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from automodel_tpu_torch.models.weights import load_jax_params
from automodel_tpu_torch.optim.builder import build_optimizer
from automodel_tpu_torch.post_training import logprobs as tlp
from automodel_tpu_torch.post_training import losses as tlosses
from automodel_tpu_torch.post_training import rollout as trollout
from automodel_tpu_torch.post_training import steps as tsteps
from automodel_tpu_torch.serving.engine import DecodeEngine, ServingConfig
from automodel_tpu_torch.utils import fault_injection as tfi
from automodel_tpu_torch.utils.model_utils import jax_named_parameters

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRPO_YAML = os.path.join(ROOT, "examples", "rl", "tiny_llama_grpo_mock.yaml")
SMALL = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, rope_theta=10000.0,
             tie_word_embeddings=True, max_position_embeddings=128)
RTOL = ATOL = 1e-5
STEP_RTOL = 1e-4
# a hundredth of one Adam update at STEP_LR: where a gradient element is
# near 0, Adam's normalized update mu / sqrt(nu) follows its rounding
STEP_LR = 1e-3
PARAM_ATOL = 1e-5
IGNORE = tlp.IGNORE_INDEX


@pytest.fixture(scope="module")
def models():
    jm = JaxLlama(JaxLlamaConfig(**SMALL), param_dtype=jnp.float32,
                  compute_dtype=jnp.float32, remat=False)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    return jm, params, _port(params)


def _port(params):
    m = LlamaForCausalLM(LlamaConfig(**SMALL), param_dtype=torch.float32,
                         compute_dtype=torch.float32, device="cpu")
    load_jax_params(m, params)
    return m


def _sequences(seed=3, lens=(9, 6, 12, 10), plens=(4, 3, 5, 4)):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, 63, n)] for n in lens], \
        list(plens)


def _t(batch):
    return tlp.batch_to_device(batch, "cpu")


# ---------------------------------------------------------------------------
# make_sequence_batch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pad_to", [None, 16])
def test_make_sequence_batch_equals_jax(pad_to):
    seqs, plens = _sequences()
    want = jlp.make_sequence_batch(seqs, plens, pad_id=7, pad_to=pad_to)
    got = tlp.make_sequence_batch(seqs, plens, pad_id=7, pad_to=pad_to)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    for b, (s, p) in enumerate(zip(seqs, plens)):
        assert (got["labels"][b] != IGNORE).sum() == len(s) - p


REFUSALS = {
    "exceeds_pad_to": (([[1, 2, 3, 4]], [2]), dict(pad_to=3)),
    "prompt_len_too_long": (([[1, 2]], [3]), {}),
    "prompt_len_zero": (([[1, 2]], [0]), {}),
    "no_sequences": (([], []), {}),
    "length_mismatch": (([[1, 2]], [1, 1]), {}),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_make_sequence_batch_refusals_equal_jax(case):
    args, kw = REFUSALS[case]
    with pytest.raises(ValueError) as want:
        jlp.make_sequence_batch(*args, **kw)
    with pytest.raises(ValueError) as got:
        tlp.make_sequence_batch(*args, **kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# logprobs
# ---------------------------------------------------------------------------
def _dense_logprobs(model, batch):
    """The full logits' log-softmax at every label (an independent
    oracle: no post-training code)."""
    with torch.no_grad():
        logits = model(batch["input_ids"],
                       position_ids=batch["position_ids"])["logits"]
    logsm = torch.log_softmax(logits.float(), -1)
    lab = batch["labels"].long()
    picked = logsm.gather(-1, lab.clamp(min=0)[..., None])[..., 0]
    return torch.where(lab == IGNORE, torch.zeros_like(picked), picked)


@pytest.mark.parametrize("pad_to", [None, 24], ids=["tight", "padded"])
def test_logprobs_match_jax_and_dense(models, pad_to):
    jm, params, tm = models
    seqs, plens = _sequences()
    batch = tlp.make_sequence_batch(seqs, plens, pad_to=pad_to)
    want = np.asarray(jlp.completion_logprobs(jm, params, batch))
    got = tlp.build_logprob_fn()(tm, batch)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(),
                               _dense_logprobs(tm, _t(batch)).numpy(),
                               rtol=RTOL, atol=ATOL)
    assert np.all(got.numpy()[batch["labels"] == IGNORE] == 0.0)


def test_padded_rows_within_tolerance_of_tight_rows(models):
    """Right padding leaves every valid position's value as it is (causal
    attention, ignored pad labels); held within the tolerance (the JAX
    bit-for-bit version of this test is a known red on the CPU)."""
    tm = models[2]
    seqs, plens = _sequences()
    fn = tlp.build_logprob_fn()
    tight = fn(tm, tlp.make_sequence_batch(seqs, plens)).numpy()
    wide = fn(tm, tlp.make_sequence_batch(seqs, plens, pad_to=24)).numpy()
    S = tight.shape[1]
    np.testing.assert_allclose(wide[:, :S], tight, rtol=RTOL, atol=ATOL)
    assert np.all(wide[:, S:] == 0.0)


def test_kernel_route_plain_version_equals_chunk_loop_with_row_cotangents():
    """The port's ``token_nll`` on CPU tensors (the plain version of the
    linear-CE kernels' route: ``lse_and_pick`` with its hand-written
    backward) against the JAX chunk loop (``token_nll`` without a mesh,
    chunks of 4 positions under ``jax.checkpoint``): the same values and,
    under cotangents that differ on every row and are 0 on ignored rows
    (GRPO's), the same gradients of the hidden states and the head (the
    JAX ones by ``jax.vjp``)."""
    rng = np.random.default_rng(0)
    B, S, H, V = 3, 10, 16, 40
    h = rng.normal(size=(B, S, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[:, :4] = IGNORE
    labels[1, 7:] = IGNORE
    cot = rng.normal(size=(B, S)).astype(np.float32)
    want, vjp = jax.vjp(
        lambda hh, ww: jlp.token_nll(hh, ww, jnp.asarray(labels),
                                     chunk_len=4), h, w)
    want_dh, want_dw = vjp(jnp.asarray(cot))
    hh = torch.from_numpy(h).requires_grad_()
    ww = torch.from_numpy(w).requires_grad_()
    nll = tlp.token_nll(hh, ww, torch.from_numpy(labels))
    (nll * torch.from_numpy(cot)).sum().backward()
    for got, ref in ((nll.detach(), want), (hh.grad, want_dh),
                     (ww.grad, want_dw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)
    assert torch.all(nll.detach()[torch.from_numpy(labels) == IGNORE] == 0)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def test_group_normalized_advantages_equal_jax():
    r = np.asarray([1.0, 3.0, -2.0, -2.0, 5.0, 1.0], np.float32)
    want = np.asarray(jlosses.group_normalized_advantages(r, 2))
    got = tlosses.group_normalized_advantages(r, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # identical rewards in a group: exactly zero advantages
    flat = tlosses.group_normalized_advantages(np.full(4, 2.0, np.float32), 4)
    assert torch.all(flat == 0.0)
    with pytest.raises(ValueError, match="divisible"):
        tlosses.group_normalized_advantages(np.zeros(5, np.float32), 2)


def _grpo_inputs(seed=1, B=4, S=7):
    rng = np.random.default_rng(seed)
    lp = rng.normal(-2.0, 0.5, (B, S)).astype(np.float32)
    # behaviour and reference a few tenths away: ratios past the clip
    beh = (lp + rng.normal(0, 0.3, (B, S))).astype(np.float32)
    ref = (lp + rng.normal(0, 0.3, (B, S))).astype(np.float32)
    adv = rng.normal(0, 1, B).astype(np.float32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    return lp, beh, ref, adv, mask


@pytest.mark.parametrize("kl_coef", [0.0, 0.05])
def test_grpo_objective_values_and_grads_equal_jax(kl_coef):
    lp, beh, ref, adv, mask = _grpo_inputs()

    def jax_obj(p):
        return jlosses.grpo_token_objective(p, beh, ref, adv, mask,
                                            kl_coef=kl_coef, clip_eps=0.2)

    (jloss, jaux), jgrad = jax.value_and_grad(jax_obj, has_aux=True)(
        jnp.asarray(lp))
    p = torch.from_numpy(lp).requires_grad_()
    loss, aux = tlosses.grpo_token_objective(
        p, torch.from_numpy(beh), torch.from_numpy(ref),
        torch.from_numpy(adv), torch.from_numpy(mask), kl_coef=kl_coef,
        clip_eps=0.2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL,
                               atol=ATOL)
    for k in ("pg_sum", "kl_sum", "ratio_sum"):
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), rtol=RTOL,
                               atol=ATOL)
    if kl_coef:
        assert float(aux["kl_sum"]) > 0.0
    else:
        assert float(aux["kl_sum"]) == 0.0


def test_dpo_losses_values_and_grads_equal_jax():
    rng = np.random.default_rng(4)
    pc, pr, rc, rr = (rng.normal(-20, 3, 5).astype(np.float32)
                      for _ in range(4))

    def jax_obj(c, r):
        losses, margins = jlosses.dpo_losses(c, r, rc, rr, beta=0.3)
        return jnp.mean(losses), margins

    (jloss, jm), (jgc, jgr) = jax.value_and_grad(
        jax_obj, argnums=(0, 1), has_aux=True)(jnp.asarray(pc),
                                               jnp.asarray(pr))
    c, r = (torch.from_numpy(x).requires_grad_() for x in (pc, pr))
    losses, margins = tlosses.dpo_losses(c, r, torch.from_numpy(rc),
                                         torch.from_numpy(rr), beta=0.3)
    losses.mean().backward()
    np.testing.assert_allclose(float(losses.mean()), float(jloss),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(margins.detach().numpy(), np.asarray(jm),
                               rtol=RTOL, atol=ATOL)
    for got, want in ((c.grad, jgc), (r.grad, jgr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    z = torch.zeros(3)
    l0, m0 = tlosses.dpo_losses(z, z, z, z, beta=0.1)
    assert torch.allclose(l0, torch.full((3,), float(np.log(2.0))))
    assert torch.all(m0 == 0.0)


# ---------------------------------------------------------------------------
# three optimizer steps on injected batches
# ---------------------------------------------------------------------------
def _grpo_batches(n=3, B=4, S=14):
    out = []
    for i in range(n):
        rng = np.random.default_rng(10 + i)
        seqs = [[int(t) for t in rng.integers(2, 63, int(L))]
                for L in rng.integers(8, S + 1, B)]
        plens = [int(rng.integers(2, 6)) for _ in range(B)]
        b = jlp.make_sequence_batch(seqs, plens, pad_to=S)
        b["advantages"] = rng.normal(0, 1, B).astype(np.float32)
        b["ref_logps"] = np.where(
            b["labels"] != IGNORE,
            rng.normal(-4.0, 0.3, (B, S)), 0.0).astype(np.float32)
        out.append(b)
    return out


def _dpo_batches(n=3, B=4, S=14):
    out = []
    for i in range(n):
        rng = np.random.default_rng(20 + i)
        prompts = [[int(t) for t in rng.integers(2, 63, 4)]
                   for _ in range(B)]
        b = {}
        for half, lo, hi in (("chosen", 2, 30), ("rejected", 31, 63)):
            comps = [[int(t) for t in rng.integers(lo, hi, int(L))]
                     for L in rng.integers(3, S - 4, B)]
            sb = jlp.make_sequence_batch([p + c for p, c in
                                          zip(prompts, comps)],
                                         [4] * B, pad_to=S)
            b.update({f"{half}_{k}": v for k, v in sb.items()})
            b[f"ref_{half}_logp"] = rng.normal(-30, 2, B).astype(np.float32)
        out.append(b)
    return out


STEP_CASES = {
    "grpo": (_grpo_batches, dict(kl_coef=0.05, clip_eps=0.2),
             jsteps.build_grpo_step, tsteps.build_grpo_step),
    "dpo": (_dpo_batches, dict(beta=0.3),
            jsteps.build_dpo_step, tsteps.build_dpo_step),
}


@pytest.mark.parametrize("algo", list(STEP_CASES))
def test_three_steps_equal_jax(models, algo):
    jm, params, _ = models
    make, kw, jbuild, tbuild = STEP_CASES[algo]
    batches = make()
    fns = jbuild(jm, jax_build_optimizer(name="adam", lr=STEP_LR), **kw)
    p = jax.tree.map(jnp.array, params)
    opt = fns.init_opt_state(p)
    want = []
    for b in batches:
        p, opt, m = fns.step(p, opt, b)
        want.append(fns.unpack_metrics(m))
    tm = _port(params)
    tfns = tbuild(tm, build_optimizer(jax_named_parameters(tm), name="adam",
                                      lr=STEP_LR), **kw)
    got = [tfns.unpack_metrics(tfns.step(b)) for b in batches]
    assert tuple(got[0]) == tfns.packed_keys == fns.packed_keys
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=STEP_RTOL,
                                       atol=1e-6, err_msg=k)
    # the parameters after three updates
    mirror = _port(jax.tree.map(np.asarray, p))
    for (name, a), b in zip(tm.named_parameters(), mirror.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=STEP_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# weight handoff and rollouts
# ---------------------------------------------------------------------------
def _rc(**kw):
    base = dict(group_size=2, rollout_batch_size=3, max_new_tokens=6,
                max_prompt_len=8, eos_token_id=1, reward_target_len=3)
    return trollout.RolloutConfig(**{**base, **kw})


def _serving(rc):
    return dict(kv_block_size=8, max_num_seqs=8,
                max_model_len=rc.sequence_length + 2, prefill_chunk=8)


def _engine(model, rc, do_sample=True, seed=5):
    return DecodeEngine(
        model, ServingConfig(**_serving(rc)),
        generation=GenerationConfig(
            max_new_tokens=rc.max_new_tokens, do_sample=do_sample,
            temperature=1.0, eos_token_id=rc.eos_token_id),
        device="cpu", sample_seed=seed)


def _prompts(seed=2, n=3):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, 63, 5)] for _ in range(n)]


def test_update_params_copies_and_guards(models):
    params = models[1]
    policy = _port(params)
    eng = _engine(_port(params), _rc())
    new = {k: v * 1.5 for k, v in policy.state_dict().items()}
    eng.update_params(new)
    assert eng.weight_syncs == 1
    own = eng.model.state_dict()
    assert all(torch.equal(own[k], v) for k, v in new.items())
    # the engine's copy is its own: later changes of the trainer's tensors
    # do not reach it before the next sync
    with torch.no_grad():
        for v in new.values():
            v.add_(1.0)
    assert not any(torch.equal(own[k], v) for k, v in new.items())
    bad_shape = {k: v[..., :1] for k, v in policy.state_dict().items()}
    with pytest.raises(ValueError, match="engine's"):
        eng.update_params(bad_shape)
    bad_dtype = {k: v.double() for k, v in policy.state_dict().items()}
    with pytest.raises(ValueError, match="engine's"):
        eng.update_params(bad_dtype)
    with pytest.raises(ValueError, match="keys do not match"):
        eng.update_params({"nope": torch.zeros(3)})
    assert eng.weight_syncs == 1


def test_sync_forgets_the_prefix_cache_of_the_old_weights(models):
    """With prefix caching on, the engine's cached prompt blocks hold k/v
    computed under the weights of their rollout; after ``update_params``
    a rollout of the same prompts must run the new weights, so the sync
    forgets the index: the rollout equals a fresh engine's on the new
    weights (the JAX engine keeps its index across a sync)."""
    params = models[1]
    rc = _rc(max_prompt_len=16, group_size=2)
    sc = ServingConfig(**_serving(rc), prefix_caching="on")
    gen = GenerationConfig(max_new_tokens=rc.max_new_tokens,
                           do_sample=False, eos_token_id=rc.eos_token_id)
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(2, 63, 12)] for _ in range(3)]

    def weights(seed):
        # matrices of std 0.5: greedy tokens that follow the weights (the
        # small init repeats the last prompt token whatever they are)
        m = _port(params)
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in m.parameters():
                if p.dim() > 1:
                    p.copy_(torch.randn(p.shape, generator=g) * 0.5)
        return m

    def fresh(seed):
        return trollout.RolloutWorker(DecodeEngine(
            weights(seed), sc, generation=gen, device="cpu"),
            rc).generate(prompts).completions

    worker = trollout.RolloutWorker(
        DecodeEngine(weights(0), sc, generation=gen, device="cpu"), rc)
    worker.generate(prompts, params=weights(0))    # caches the prompts
    got = worker.generate(prompts, params=weights(1))
    assert got.stats["prefill_tokens_saved"] > 0   # the group forks
    assert fresh(1) != fresh(0)
    assert got.completions == fresh(1)


def test_greedy_rollouts_equal_jax_worker_and_generate(models):
    """Temperature 0: the port's worker, the JAX worker (same weights, JAX
    engine) and the port's dense ``generate()`` give the same tokens."""
    jm, params, _ = models
    rc = _rc(temperature=0.0, eos_token_id=None)
    jrc = jrollout.RolloutConfig(**{
        k: getattr(rc, k) for k in ("group_size", "rollout_batch_size",
                                    "max_new_tokens", "max_prompt_len",
                                    "eos_token_id", "reward_target_len")},
        temperature=0.0)
    prompts = _prompts()
    jeng = JaxDecodeEngine(
        jm, params, JaxServingConfig(**_serving(rc)),
        generation=JaxGenerationConfig(max_new_tokens=rc.max_new_tokens),
        sample_seed=5)
    want = jrollout.RolloutWorker(jeng, jrc).generate(prompts)
    tm = _port(params)
    got = trollout.RolloutWorker(_engine(tm, rc, do_sample=False),
                                 rc).generate(prompts,
                                              params=tm.state_dict())
    assert got.completions == want.completions
    assert got.prompts == want.prompts
    ids = np.zeros((len(prompts), 5), np.int64)
    for b, p in enumerate(prompts):
        ids[b] = p
    dense = generate(tm, ids, config=GenerationConfig(
        max_new_tokens=rc.max_new_tokens))
    assert [list(r) for r in dense] == got.completions[::rc.group_size]


def test_sampled_rollouts_grouped_and_seeded(models):
    params = models[1]
    rc = _rc()
    prompts = _prompts()
    runs = []
    for _ in range(2):
        eng = _engine(_port(params), rc)
        runs.append(trollout.RolloutWorker(eng, rc).generate(prompts))
        assert eng.allocator.all_free
    rb = runs[0]
    assert runs[1].completions == rb.completions
    assert len(rb.completions) == rc.completions_per_rollout
    assert rb.prompts[0] == rb.prompts[1] == prompts[0]    # G contiguous
    assert all(1 <= len(c) <= rc.max_new_tokens for c in rb.completions)
    rewards = trollout.compute_rewards(rb, rc)
    want = [-abs(len(c) - 3) for c in rb.completions]
    np.testing.assert_array_equal(rewards, np.asarray(want, np.float32))
    other = trollout.RolloutWorker(_engine(_port(params), rc, seed=6),
                                   rc).generate(prompts)
    assert other.completions != rb.completions


def _fault_weight_sync(params, rc, worker, eng, prompts):
    before = {k: v.clone() for k, v in eng.model.state_dict().items()}
    new = {k: v * 2.0 for k, v in before.items()}
    with pytest.raises(trollout.RolloutError, match="weight sync"):
        worker.generate(prompts, params=new)
    assert eng.weight_syncs == 0
    assert all(torch.equal(eng.model.state_dict()[k], v)
               for k, v in before.items())
    rb = worker.generate(prompts, params=new)           # fired once
    assert len(rb.completions) == rc.completions_per_rollout
    assert eng.weight_syncs == 1


def _fault_engine_step(params, rc, worker, eng, prompts):
    with pytest.raises(trollout.RolloutError, match="aborted"):
        worker.generate(prompts)
    assert eng.allocator.all_free
    assert worker.failed_rollouts == 1
    rb = worker.generate(prompts)
    assert len(rb.completions) == rc.completions_per_rollout
    assert eng.allocator.all_free


def _fault_reward(params, rc, worker, eng, prompts):
    tfi.reset_faults()
    rb = worker.generate(prompts)
    tfi.configure_faults("reward_fn:1")
    with pytest.raises(trollout.RolloutError, match="reward"):
        trollout.compute_rewards(rb, rc)
    assert rb.rewards is None
    assert trollout.compute_rewards(rb, rc).shape == (
        rc.completions_per_rollout,)


FAULTS = {"rollout_weight_sync:1": _fault_weight_sync,
          "rollout_engine_step:3": _fault_engine_step,
          "reward_fn:1": _fault_reward}


@pytest.mark.parametrize("spec", list(FAULTS))
def test_rollout_fault_points(models, spec):
    """Each drilled point surfaces a typed ``RolloutError``, leaves the
    engine's weights, blocks and the training state as they were, and the
    next rollout is clean (the JAX contract)."""
    params = models[1]
    rc = _rc()
    eng = _engine(_port(params), rc)
    worker = trollout.RolloutWorker(eng, rc)
    tfi.configure_faults(spec)
    try:
        FAULTS[spec](params, rc, worker, eng, _prompts())
    finally:
        tfi.reset_faults()


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
CONFIG_REFUSALS = {
    "group_size": dict(group_size=0),
    "max_new_tokens": dict(max_new_tokens=True),
    "kl_coef": dict(kl_coef=-0.1),
    "seed": dict(seed=1.5),
    "reward_source": dict(reward_source="vibes"),
    "callable_without_fn": dict(reward_source="callable"),
}


@pytest.mark.parametrize("case", list(CONFIG_REFUSALS))
def test_rollout_config_refusals_equal_jax(case):
    kw = CONFIG_REFUSALS[case]
    with pytest.raises(ValueError) as want:
        jrollout.RolloutConfig(**kw)
    with pytest.raises(ValueError) as got:
        trollout.RolloutConfig(**kw)
    assert str(got.value) == str(want.value)


def test_rollout_config_defaults_and_builder():
    rc = trollout.RolloutConfig(kl_coef="null", reward_source="none")
    assert rc.kl_coef is None and rc.reward_source == "length_target"
    assert trollout.RolloutConfig().sequence_length == 32 + 16
    built = trollout.build_rollout_config(
        {"group_size": 2, "beta": 0.3, "reward_source": "callable",
         "reward_fn": "automodel_tpu.datasets.llm.mock.make_vocab"})
    assert built.group_size == 2 and built.reward_fn is tmock.make_vocab
    with pytest.raises(ValueError, match="unknown rl config key"):
        trollout.build_rollout_config({"group_sise": 4})
    assert trollout.REWARD_SOURCES == jrollout.REWARD_SOURCES
    assert tlosses.PT_ALGORITHMS == jlosses.PT_ALGORITHMS


@pytest.mark.parametrize("field,value", [
    ("post_training.algorithm", "ppo"), ("rl.reward_source", "vibes")])
def test_enums_validated_at_load_and_after_cli_overrides(tmp_path, field,
                                                          value):
    section, key = field.split(".")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump({section: {key: value}}))
    with pytest.raises(ValueError, match=field.replace(".", r"\.")):
        load_yaml_config(str(path))
    with pytest.raises(ValueError, match=field.replace(".", r"\.")):
        parse_args_and_load_config(["-c", GRPO_YAML, f"--{field}", value])
    # null spellings mean the default
    path.write_text(yaml.safe_dump({section: {key: "null"}}))
    load_yaml_config(str(path))


def test_preference_pairs_equal_jax():
    kw = dict(num_pairs=12, prompt_len=5, mean_len=6.0, std_len=2.0,
              vocab_size=50, max_completion_len=7, seed=3)
    assert (tmock.build_preference_pairs_dataset(**kw)
            == jmock.build_preference_pairs_dataset(**kw))


def test_fault_points_registered():
    for name in ("rollout_weight_sync", "rollout_engine_step", "reward_fn"):
        assert name in tfi.KNOWN_FAULT_POINTS
        assert name in jfi.KNOWN_FAULT_POINTS
