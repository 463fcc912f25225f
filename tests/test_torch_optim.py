"""The port's optimizer step (``optim/builder.py::OptaxAdam``) against the
JAX package's optax chain (``automodel_tpu.optim.builder.build_optimizer``
+ ``optax.apply_updates``, jitted as the JAX train step runs it) on the
same fp32 gradient quotients ``g.astype(grad_dtype) / token_count``, over
five steps of a changing learning rate and weight decay, for the bench
YAML's dtypes (bf16 params, ``grad_dtype`` and ``mu_dtype`` bf16), the JAX
tiny YAML's (bf16 params, fp32 ``grad_dtype``, ``mu_dtype`` unset), bf16
params with bf16 gradients and ``mu_dtype`` unset, and fp32.

Checked after every step: the parameters, ``mu`` and ``nu`` and their
dtypes -- ``mu`` in ``mu_dtype`` (fp32 when unset: the fp32 quotients
promote it), ``nu`` in fp32 -- with a no-decay leaf
(``e_score_correction_bias``) beside the decayed ones.

Tolerance.  The port computes what XLA compiles from the chain: the same
fp32 operations in the same order, the bias correction folded into one
division, the multiply-adds of the moments, the decay and the update
fused (one rounding each; ``torch.addcmul`` is a fused multiply-add, as
LLVM contracts XLA's), the power ``b^n`` rounded once from its exact
value.  ``mu`` and ``nu`` are held bit for bit.  The parameters are held
bit for bit on at least 99 % of the elements of each step and, on the rest, within
one ulp of their dtype per step taken (a step's one-ulp difference is
carried into the next): LLVM does not contract the last multiply-add of
every element of every fusion the same way (measured: 2 of 960 fp32
elements one ulp apart after the first step, at most 2 ulps after five).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from automodel_tpu.optim.builder import build_optimizer as jax_optimizer
from automodel_tpu.optim.builder import set_hyperparams as jax_set_hp
from automodel_tpu_torch.optim.builder import build_optimizer, set_hyperparams

jax.config.update("jax_platforms", "cpu")

DTYPES = [
    # (id, param dtype, grad_dtype, mu_dtype)
    ("bench_bf16", "bfloat16", "bfloat16", "bfloat16"),
    ("jax_tiny_yaml", "bfloat16", "float32", None),
    ("bf16_grads_mu_unset", "bfloat16", "bfloat16", None),
    ("fp32", "float32", "float32", None),
]
SHAPES = {("layers", "w"): (24, 40), ("layers", "e_score_correction_bias"): (40,),
          ("norm", "weight"): (24,)}
STEPS = 5
DENOM = 37.0


def _tree(leaves):
    out = {}
    for (a, b), v in leaves.items():
        out.setdefault(a, {})[b] = v
    return out


@functools.partial(jax.jit, static_argnums=(0, 1))
def _jax_step(tx, grad_dtype, params, state, g, denom):
    """The JAX train step's update, compiled as there.  ``denom`` is
    traced, as the token count is in the train step (a constant divisor
    would be folded into a reciprocal multiply)."""
    q = jax.tree.map(lambda x: x.astype(grad_dtype) / denom, g)
    u, state = tx.update(q, state, params)
    return optax.apply_updates(params, u), state


def _run(name, pdt, gdt, mdt, wd=0.1):
    rng = np.random.default_rng(0)
    p0 = {k: (rng.normal(size=s) * 0.02).astype(np.float32)
          for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 1e-3 * (i + 1)).astype(np.float32)
              for k, s in SHAPES.items()} for i in range(STEPS)]
    lrs = [3e-3 * (i + 1) / STEPS for i in range(STEPS)]
    wds = [wd * (1 + 0.5 * i) for i in range(STEPS)]

    # JAX: the recipe's order (set the hyperparameters, then the step)
    jp, jg = jnp.dtype(pdt), jnp.dtype(gdt)
    # each side gets its own copies: the port updates in place, and a JAX
    # array made from numpy may share the buffer (read asynchronously)
    params = _tree({k: jnp.array(v, jp) for k, v in p0.items()})
    tx = jax_optimizer(name=name, lr=lrs[0], weight_decay=wd,
                       mu_dtype=None if mdt is None else jnp.dtype(mdt))
    state = tx.init(jax.tree.map(lambda p: p.astype(jg), params))

    # port
    tp = getattr(torch, pdt)
    named = [(".".join(k), torch.nn.Parameter(torch.tensor(v, dtype=tp)))
             for k, v in p0.items()]
    opt = build_optimizer(named, name=name, lr=lrs[0], weight_decay=wd,
                          mu_dtype=mdt, grad_dtype=gdt)
    out = []
    for i in range(STEPS):
        state = jax_set_hp(state, lr=lrs[i], wd=wds[i])
        params, state = _jax_step(tx, jg, params, state, _tree(
            {k: jnp.array(v) for k, v in grads[i].items()}),
            jnp.float32(DENOM))
        set_hyperparams(opt, lr=lrs[i], wd=wds[i])
        for (key, p), k in zip(named, p0):
            q = torch.tensor(grads[i][k]).to(getattr(torch, gdt))
            opt.update(p, q.to(torch.float32).div_(torch.tensor(DENOM)))
        adam = state.inner_state[0]
        port = [(key, p.detach().clone(), opt.state[p]["step"],
                 opt.state[p]["mu"].clone(), opt.state[p]["nu"].clone())
                for key, p in named]
        out.append((params, adam.mu, adam.nu, port))
    return out, named, opt


def _np32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulps(got: torch.Tensor, want: np.ndarray) -> np.ndarray:
    """Distance in ulps of ``got``'s dtype between ``got`` and ``want``
    (exact in that dtype); same-sign values here."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[got.dtype]
    w = torch.from_numpy(np.array(want)).to(got.dtype)
    return (got.view(ints).long() - w.view(ints).long()).abs().numpy()


@pytest.mark.parametrize("name", ["adamw", "adam"])
@pytest.mark.parametrize("case", DTYPES, ids=[d[0] for d in DTYPES])
def test_step_keeps_optax_dtypes_and_values_bitwise(case, name):
    _, pdt, gdt, mdt = case
    steps, _, _ = _run(name, pdt, gdt, mdt)
    for i, (params, mu, nu, port) in enumerate(steps):
        ulps = []
        for (key, p, count, m, v), (a, b) in zip(port, SHAPES):
            assert count == i + 1
            assert str(p.dtype).endswith(str(params[a][b].dtype))
            assert str(m.dtype).endswith(str(mu[a][b].dtype))
            assert str(v.dtype).endswith(str(nu[a][b].dtype))
            assert v.dtype == torch.float32
            assert m.dtype == getattr(torch, mdt or "float32")
            for what, got, want in (("mu", m, mu[a][b]),
                                    ("nu", v, nu[a][b])):
                np.testing.assert_array_equal(
                    got.float().numpy(), _np32(want),
                    err_msg=f"step {i + 1} {key} {what}")
            ulps.append(_ulps(p, _np32(params[a][b])).ravel())
        ulps = np.concatenate(ulps)
        assert ulps.max() <= i + 1, (i + 1, int(ulps.max()))
        assert (ulps == 0).mean() >= 0.99, (i + 1, (ulps == 0).mean())


def test_adam_drops_weight_decay_as_jax_does():
    """``torch.optim.Adam`` with a weight decay runs (the JAX package's adam
    chain has no decay) and equals Adam without one."""
    _, with_wd, opt = _run("adam", "float32", "float32", None, wd=0.5)
    _, without, _ = _run("adam", "float32", "float32", None, wd=0.0)
    for (_, p), (_, q) in zip(with_wd, without):
        assert torch.equal(p, q)
    assert all(g["wd_mult"] == 0.0 for g in opt.param_groups)


def test_state_dict_round_trip_keeps_dtypes():
    """``load_state_dict`` restores ``nu`` in fp32 beside bf16 params
    (torch's own load would cast it to the parameter's dtype)."""
    _, named, opt = _run("adamw", "bfloat16", "bfloat16", "bfloat16")
    sd = opt.state_dict()
    fresh = [(k, torch.nn.Parameter(p.detach().clone())) for k, p in named]
    opt2 = build_optimizer(fresh, name="adamw", mu_dtype="bfloat16",
                           grad_dtype="bfloat16")
    opt2.load_state_dict(sd)
    for (_, p), (_, q) in zip(named, fresh):
        for key in ("mu", "nu"):
            a, b = opt.state[p][key], opt2.state[q][key]
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert opt2.state[q]["step"] == opt.state[p]["step"]
