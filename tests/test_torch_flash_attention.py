"""The port's flash rung (``ops/flash_attention.py`` -> its plain versions on
CPU tensors) against the JAX package's ``flash_attention_bshd``, whose
upstream Pallas MHA flash kernel runs here in Pallas interpret mode
(``pltpu.force_tpu_interpret_mode``), forward and ``jax.vjp`` backward.

Both follow the upstream kernel's segment rule (segment 0 attends segment
0), so out, dq, dk and dv are compared on **every** row, padding rows
included.  A tiny GQA Llama with ``attn_impl="flash"`` is held against the
JAX model with its attention dispatch steered to the flash rung (as
``tests/unit_tests/test_attention_dispatch.py`` steers it), logits and
gradients on all rows.

Tolerance: fp32 on both sides; the kernel sums blockwise with an online
softmax where the port takes one dense softmax, so the results agree to a
few fp32 ulps of each tensor's scale (measured over the cases below: at
most 8.3e-7 absolute for out, 1.5e-6 for dq, dk and dv, whose elements
reach 4 to 12).  The limit is 1e-5
absolute plus 1e-5 relative; a wrong mask or formula moves them by O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from automodel_tpu.ops import flash_attention as jfa
from automodel_tpu_torch.ops import flash_attention as tfa
from automodel_tpu_torch.ops.attention import attention

torch.set_num_threads(1)
TOL = 1e-5

CASES = [
    # (name, S, D, Hq, Hk, causal, layout): layout is "none", "packed"
    # (3 samples and a padding tail in segment 0) or "mask" (a padding
    # attention_mask, folded into segment 0)
    dict(name="mha_causal_s128_d32", S=128, D=32, Hq=2, Hk=2, causal=True,
         layout="none"),
    dict(name="gqa2_causal_packed_s256_d64", S=256, D=64, Hq=4, Hk=2,
         causal=True, layout="packed"),
    dict(name="gqa4_causal_mask_s128_d32", S=128, D=32, Hq=4, Hk=1,
         causal=True, layout="mask"),
    dict(name="mha_full_packed_s128_d64", S=128, D=64, Hq=2, Hk=2,
         causal=False, layout="packed"),
    dict(name="gqa2_full_s256_d32", S=256, D=32, Hq=4, Hk=2, causal=False,
         layout="none"),
    dict(name="gqa4_causal_packed_s128_d64", S=128, D=64, Hq=4, Hk=1,
         causal=True, layout="packed"),
    dict(name="gqa2_full_mask_s128_d64", S=128, D=64, Hq=4, Hk=2,
         causal=False, layout="mask"),
    dict(name="gqa4_full_packed_s256_d32", S=256, D=32, Hq=8, Hk=2,
         causal=False, layout="packed"),
]


def make_inputs(case, B=2, seed=0):
    """numpy q, k, v, dout, segment ids (or None), padding mask (or None)."""
    S, D, Hq, Hk = case["S"], case["D"], case["Hq"], case["Hk"]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hk, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hk, D)).astype(np.float32)
    dout = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    seg = mask = None
    if case["layout"] == "packed":
        seg = np.zeros((B, S), np.int32)
        for b in range(B):
            cuts = np.sort(rng.choice(np.arange(4, S - 20), 3, replace=False))
            for i, (lo, hi) in enumerate(zip([0, *cuts[:2]], cuts)):
                seg[b, lo:hi] = i + 1
    elif case["layout"] == "mask":
        mask = np.ones((B, S), np.int32)
        mask[0, -9:] = 0
        mask[B - 1, -70:] = 0
    return q, k, v, dout, seg, mask


def jax_flash(q, k, v, dout, seg, mask, causal):
    """out, dq, dk, dv of the JAX rung, the Pallas kernel interpreted."""
    kw = dict(causal=causal,
              segment_ids=None if seg is None else jnp.asarray(seg),
              attention_mask=None if mask is None else jnp.asarray(mask))
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(
            lambda q, k, v: jfa.flash_attention_bshd(q, k, v, **kw), q, k, v)
        grads = vjp(jnp.asarray(dout))
    return [np.asarray(x) for x in (out, *grads)]


def torch_flash(q, k, v, dout, seg, mask, causal):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention_bshd(
        qt, kt, vt, causal=causal,
        segment_ids=None if seg is None else torch.from_numpy(seg),
        attention_mask=None if mask is None else torch.from_numpy(mask))
    out.backward(torch.from_numpy(dout))
    return [x.detach().numpy() for x in (out, qt.grad, kt.grad, vt.grad)]


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_flash_rung_matches_the_jax_kernel_on_every_row(case):
    q, k, v, dout, seg, mask = make_inputs(case)
    launches = (tfa.fwd_launches, tfa.bwd_launches)
    got = torch_flash(q, k, v, dout, seg, mask, case["causal"])
    assert (tfa.fwd_launches, tfa.bwd_launches) == launches  # CPU: plain
    want = jax_flash(q, k, v, dout, seg, mask, case["causal"])
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)
    if case["layout"] != "none":     # padding rows are live: nonzero output
        pad = (seg == 0) if seg is not None else (mask == 0)
        assert np.abs(got[0][pad]).sum(-1).min() > 0


def test_flash_rung_refuses_cap_window_and_short_rows():
    q = torch.zeros(1, 128, 2, 32)
    with pytest.raises(NotImplementedError, match="soft cap"):
        attention(q, q, q, logits_soft_cap=30.0, impl="flash")
    with pytest.raises(NotImplementedError, match="window"):
        attention(q, q, q, local_window_size=16, impl="flash")
    with pytest.raises(NotImplementedError, match="soft cap"):
        tfa.flash_attention_bshd(q, q, q, logits_soft_cap=30.0)
    with pytest.raises(ValueError, match="multiple of 128"):
        tfa.flash_attention_bshd(q[:, :100], q[:, :100], q[:, :100])
    assert tfa.flash_attention_available(2048, 2048, 64)
    assert not tfa.flash_attention_available(2048, 2048, 32)
    assert not tfa.flash_attention_available(1000, 1000, 64)
    assert not tfa.flash_attention_available(256, 128, 64)


# ---------------------------------------------------------------------------
# a tiny Llama through the flash rung
# ---------------------------------------------------------------------------
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, rope_theta=10000.0,
            tie_word_embeddings=True)


def test_llama_with_the_flash_rung_matches_jax(monkeypatch):
    from automodel_tpu.models.llama import LlamaConfig as JaxConfig
    from automodel_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from automodel_tpu.ops import splash_attention as jsa
    from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from automodel_tpu_torch.models.weights import jax_leaves, load_jax_params

    calls = []
    flash_impl = jfa.flash_attention_bshd
    monkeypatch.setattr(jsa, "splash_attention_available", lambda *a: False)
    monkeypatch.setattr(jfa, "flash_attention_available", lambda *a: True)
    monkeypatch.setattr(jfa, "flash_attention_bshd",
                        lambda *a, **kw: calls.append(1) or flash_impl(*a,
                                                                       **kw))
    B, S = 2, 128
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 128, (B, S)).astype(np.int32)
    seg = np.zeros((B, S), np.int32)
    pos = np.zeros((B, S), np.int32)
    for b, cuts in enumerate(([0, 50, 100], [0, 70, 110])):
        for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
            seg[b, lo:hi] = i + 1
            pos[b, lo:hi] = np.arange(hi - lo)
    cot = rng.normal(size=(B, S, 128)).astype(np.float32)

    jm = JaxLlama(JaxConfig(**TINY), param_dtype=jnp.float32,
                  compute_dtype=jnp.float32, remat=False)
    params = jm.init(jax.random.key(4))

    def logits_of(p):
        return jm(p, jnp.asarray(ids), position_ids=jnp.asarray(pos),
                  segment_ids=jnp.asarray(seg))["logits"]

    with pltpu.force_tpu_interpret_mode():
        jlogits, vjp = jax.vjp(logits_of, params)
        (jgrads,) = vjp(jnp.asarray(cot))
    assert calls, "the JAX model did not reach the flash rung"

    model = LlamaForCausalLM(LlamaConfig(**TINY), param_dtype=torch.float32,
                             compute_dtype=torch.float32, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    out = model(torch.from_numpy(ids), position_ids=torch.from_numpy(pos),
                segment_ids=torch.from_numpy(seg), attn_impl="flash")
    out["logits"].backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out["logits"].detach().numpy(),
                               np.asarray(jlogits), atol=1e-4, rtol=1e-4)
    flat = {}

    def walk(tree, prefix=()):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, prefix + (key,))
            else:
                flat[prefix + (key,)] = np.asarray(val)

    walk(jgrads)
    for path, target, transposed in jax_leaves(model):
        targets = target if isinstance(target, list) else [target]
        want = flat[path] if isinstance(target, list) else [flat[path]]
        for p, w in zip(targets, want):
            g = p.grad.numpy()
            np.testing.assert_allclose(g, w.T if transposed else w,
                                       atol=1e-4, rtol=1e-3,
                                       err_msg=".".join(path))
