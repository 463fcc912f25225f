"""The port's train step + AdamW + lr schedule against the JAX package's
``build_train_step`` + ``build_optimizer`` + ``OptimizerParamScheduler``:
a 10-step fp32 trajectory of ``loss`` and ``grad_norm`` from the same
weights on the same packed mock batches, with grad accumulation A = 2,
weight decay 0.01 and the tiny YAML's warmup + cosine schedule.

Tolerance: both sides run fp32, but sums are taken in another order and
Adam's first steps move each weight by about lr * sign(g), so a rounding
difference in a gradient near zero can flip a step.  The trajectories
agreed to 2e-6 relative when this test was written; it allows 1e-4 (a
wrong normalisation, decay or schedule moves them by > 1e-2 from the first
step on).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.loss.masked_ce import MaskedCrossEntropy as JaxCE
from automodel_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from automodel_tpu.models.llama import LlamaForCausalLM as JaxLlama
from automodel_tpu.optim.builder import build_optimizer as jax_optimizer
from automodel_tpu.optim.builder import set_hyperparams as jax_set_hp
from automodel_tpu.optim.scheduler import OptimizerParamScheduler as JaxSched
from automodel_tpu.training.train_step import build_train_step
from automodel_tpu_torch.datasets.llm.mock import build_unpacked_dataset
from automodel_tpu_torch.datasets.llm.packed_sequence import PackedSequence
from automodel_tpu_torch.datasets.utils import default_collater
from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from automodel_tpu_torch.models.weights import load_jax_params
from automodel_tpu_torch.optim.builder import build_optimizer, set_hyperparams
from automodel_tpu_torch.optim.scheduler import OptimizerParamScheduler
from automodel_tpu_torch.training.train_step import (
    TrainStep,
    stack_microbatches,
    to_device_batch,
)

torch.set_num_threads(1)

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, rope_theta=10000.0,
            tie_word_embeddings=True)
STEPS, A, B = 10, 2, 2
OPT = dict(lr=3e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
SCHED = dict(init_lr=0.0, max_lr=3e-3, min_lr=0.0, lr_warmup_steps=2,
             lr_decay_steps=12, lr_decay_style="cosine", start_wd=0.01,
             end_wd=0.01)
REL = 1e-4


def _groups():
    """STEPS groups of A collated [B, 64] packs of the tiny YAML's data."""
    packs = PackedSequence(build_unpacked_dataset(
        num_sentences=256, vocab_size=128, mean_len=24, seed=5),
        packed_sequence_size=64).pack()
    it = iter(range(len(packs)))
    return [[default_collater([dict(packs[next(it)]) for _ in range(B)])
             for _ in range(A)] for _ in range(STEPS)]


@pytest.fixture(scope="module")
def trajectories():
    groups = _groups()
    jm = JaxLlama(JaxLlamaConfig(**TINY), param_dtype=jnp.float32,
                  compute_dtype=jnp.float32)
    params = jm.init(jax.random.key(1))
    np_params = jax.tree.map(np.asarray, params)

    fns = build_train_step(jm, jax_optimizer(name="adamw", **OPT),
                           loss_fn=JaxCE())
    opt_state = fns.init_opt_state(params)
    sched = JaxSched(**SCHED)
    ref = []
    for group in groups:
        sched.step(1)
        opt_state = jax_set_hp(opt_state, lr=sched.current_lr,
                               wd=sched.current_wd)
        batch = {k: jnp.asarray(v)
                 for k, v in stack_microbatches(group).items()}
        params, opt_state, m = fns.train_step(params, opt_state, batch)
        ref.append((float(m["loss"]), float(m["grad_norm"]),
                    int(m["num_label_tokens"])))

    model = LlamaForCausalLM(LlamaConfig(**TINY), param_dtype=torch.float32,
                             compute_dtype=torch.float32, device="cpu")
    load_jax_params(model, np_params)
    opt = build_optimizer(model.named_parameters(), name="adamw",
                          grad_dtype=torch.float32, **OPT)
    step = TrainStep(model, opt, MaskedCrossEntropy(),
                     grad_dtype=torch.float32)
    sched = OptimizerParamScheduler(**SCHED)
    got = []
    for group in groups:
        sched.step(1)
        set_hyperparams(opt, lr=sched.current_lr, wd=sched.current_wd)
        m = step.train_step(to_device_batch(group, "cpu"))
        got.append((m["loss"], m["grad_norm"], m["num_label_tokens"]))
    return np.asarray(got), np.asarray(ref)


def test_loss_trajectory_matches_jax(trajectories):
    got, ref = trajectories
    np.testing.assert_array_equal(got[:, 2], ref[:, 2])
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=REL)
    assert ref[-1, 0] < ref[0, 0] - 0.3        # it trains


def test_grad_norm_trajectory_matches_jax(trajectories):
    got, ref = trajectories
    np.testing.assert_allclose(got[:, 1], ref[:, 1], rtol=REL)


DTYPE_CASES = [
    # (id, grad_dtype, mu_dtype): bf16 params throughout
    ("fp32_grads_mu_unset", "float32", None),      # the JAX tiny YAML's
    ("bf16_grads_fp32_mu", "bfloat16", "float32"),
    ("bf16_grads_bf16_mu", "bfloat16", "bfloat16"),   # the bench YAML's
]


@pytest.mark.parametrize("case", DTYPE_CASES, ids=[c[0] for c in DTYPE_CASES])
def test_dtype_combinations_follow_jax(case):
    """bf16 params with each ``grad_dtype`` / ``mu_dtype`` combination run
    (the first two raised before the port accumulated in ``grad_dtype``
    and kept optax's moments), from the same weights on the same two
    microbatches as the JAX step: the first step's loss and grad_norm
    within 1e-4 (bf16 forward and backward, sums in another order:
    measured within 3e-5), and the optimizer state in optax's dtypes
    (``mu`` in ``mu_dtype``, fp32 when unset; ``nu`` fp32)."""
    _, gdt, mdt = case
    group = _groups()[0]
    jm = JaxLlama(JaxLlamaConfig(**TINY), param_dtype=jnp.bfloat16,
                  compute_dtype=jnp.bfloat16)
    params = jm.init(jax.random.key(1))
    np_params = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)),
                             params)
    fns = build_train_step(
        jm, jax_optimizer(name="adamw", mu_dtype=None if mdt is None
                          else jnp.dtype(mdt), **OPT),
        loss_fn=JaxCE(), grad_dtype=jnp.dtype(gdt))
    opt_state = jax_set_hp(fns.init_opt_state(params), lr=1e-3, wd=0.01)
    batch = {k: jnp.asarray(v) for k, v in stack_microbatches(group).items()}
    _, opt_state, ref = fns.train_step(params, opt_state, batch)

    model = LlamaForCausalLM(LlamaConfig(**TINY), param_dtype=torch.bfloat16,
                             compute_dtype=torch.bfloat16, device="cpu")
    load_jax_params(model, np_params)
    opt = build_optimizer(model.named_parameters(), name="adamw",
                          grad_dtype=gdt, mu_dtype=mdt, **OPT)
    set_hyperparams(opt, lr=1e-3, wd=0.01)
    step = TrainStep(model, opt, MaskedCrossEntropy(),
                     grad_dtype=getattr(torch, gdt))
    got = step.train_step(to_device_batch(group, "cpu"))
    assert got["num_label_tokens"] == int(ref["num_label_tokens"])
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], float(ref[key]), rtol=1e-4,
                                   err_msg=key)
    adam = opt_state.inner_state[0]
    jmu, jnu = jax.tree.leaves(adam.mu)[0], jax.tree.leaves(adam.nu)[0]
    for p in model.parameters():
        st = opt.state[p]
        assert st["mu"].dtype == getattr(torch, mdt or "float32")
        assert str(st["mu"].dtype).endswith(str(jmu.dtype))
        assert st["nu"].dtype == torch.float32
        assert str(st["nu"].dtype).endswith(str(jnu.dtype))
        assert p.grad is None            # the quotients were consumed
