"""The port's weight-only int8 base (``quantization/weight_only.py``, the
QLoRA role) against the JAX package's on the CPU, fp32, tiny Llama: the
int8 codes and scales bit for bit (in the model, from numpy, and through
the streaming HF read), the dequantized export, and the QLoRA forward and
adapter gradients from the same numbers (within 1e-5 relative L2: fp32 on
both sides, the dequantize and products summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.loss.masked_ce import MaskedCrossEntropy as JaxCE
from automodel_tpu.models.hf_io import save_hf_weights as jax_save_hf
from automodel_tpu.peft import lora as jlora
from automodel_tpu.quantization import weight_only as jwo
from automodel_tpu.training.train_step import _microbatch_loss
from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
from automodel_tpu_torch.models import hf_io
from automodel_tpu_torch.models.weights import jax_leaves, load_jax_params
from automodel_tpu_torch.peft import lora
from automodel_tpu_torch.quantization import weight_only as wo
from automodel_tpu_torch.training.train_step import microbatch_loss
from tests.test_torch_moe_model import packed_batch
from tests.test_torch_peft import models, rel_l2

torch.set_num_threads(1)


def dense_pair(seed=0):
    """The JAX model with its dense params (numpy) and the port's model on
    them."""
    jm, model = models()
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    load_jax_params(model, params)
    return jm, params, model


def _flat(tree):
    return {tuple(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(model):
    """``{JAX path: numpy array in the JAX layout}`` of the port's model."""
    out = {}
    for path, target, transposed in jax_leaves(model):
        got = (np.stack([t.detach().numpy() for t in target])
               if isinstance(target, list) else target.detach().numpy())
        out[path] = np.swapaxes(got, -1, -2) if transposed else got
    return out


def test_int8_codes_and_scales_are_bit_identical_to_jax():
    """Every leaf of the quantized tree, codes and scales included, equals
    JAX's ``quantize_base_params`` on the same dense weights."""
    _, params, model = dense_pair(1)
    wo.quantize_base_params(model)
    want = _flat(jwo.quantize_base_params(params))
    got = _port_leaves(model)
    assert set(got) == set(want)
    for path, arr in want.items():
        assert got[path].dtype == arr.dtype, path
        np.testing.assert_array_equal(got[path], arr, err_msg=str(path))
    q = model.layers[0].q_proj
    assert isinstance(q, wo.Int8Linear)
    assert not any(isinstance(t, torch.nn.Parameter) for t in q.buffers())
    assert q.weight.dtype == torch.int8 and q.scale.dtype == torch.float32


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_quantize_kernel_np_and_torch_equal_jax(scale):
    """Both host quantizers on the HF ``(out, in)`` layout against JAX's on
    ``[in, out]``, with an all-zero channel (the 1e-12 floor) and values at
    rounding midpoints."""
    rng = np.random.default_rng(int(scale * 10))
    w = (rng.standard_normal((48, 40)) * scale).astype(np.float32)
    w[3] = 0.0
    w[5, :4] = np.float32(127.0) * np.float32(scale) * np.array(
        [1, 0.5 / 127, 1.5 / 127, -2.5 / 127], np.float32)
    jq, js = jwo.quantize_kernel_np(w.T)
    q, s = wo.quantize_kernel_np(w)
    tq, ts = wo.quantize_kernel(torch.from_numpy(w))
    np.testing.assert_array_equal(q, jq.T)
    np.testing.assert_array_equal(s, js.T)
    np.testing.assert_array_equal(tq.numpy(), jq.T)
    np.testing.assert_array_equal(ts.numpy(), js.T)
    jq2, js2 = jwo.quantize_kernel(jnp.asarray(w.T))
    np.testing.assert_array_equal(q, np.asarray(jq2).T)
    np.testing.assert_array_equal(s, np.asarray(js2).T)


def test_dequantized_export_equals_jax():
    _, params, model = dense_pair(2)
    wo.quantize_base_params(model)
    wo.dequantize_base_params(model, dtype=torch.float32)
    want = _flat(jwo.dequantize_base_params(
        jwo.quantize_base_params(params), dtype=jnp.float32))
    got = _port_leaves(model)
    for path, arr in want.items():
        np.testing.assert_array_equal(got[path], arr, err_msg=str(path))
    assert isinstance(model.layers[1].down_proj, torch.nn.Linear)


def test_streaming_read_quantizes_on_the_host(tmp_path, monkeypatch):
    """An HF repo (written by JAX, and by the port) streamed into the int8
    base equals quantizing the dense weights, bit for bit; the dense
    projections are never assigned to the model (the dense quantizer is
    poisoned)."""
    jm, params, model = dense_pair(3)
    jax_save_hf(jm, jax.tree.map(jnp.asarray, params), str(tmp_path / "jax"))
    hf_io.save_hf_weights(model, str(tmp_path / "port"))
    want = _flat(jwo.quantize_base_params(params))
    for src in ("jax", "port"):
        _, target = models()
        wo.quantize_base_params(target)

        def poisoned(*a, **k):
            raise AssertionError("the dense projections reached the model")

        monkeypatch.setattr(wo.Int8Linear, "from_linear", poisoned)
        hf_io.load_quantized_hf_base(target, str(tmp_path / src))
        monkeypatch.undo()
        got = _port_leaves(target)
        for path, arr in want.items():
            np.testing.assert_array_equal(got[path], arr, err_msg=str(path))
    with pytest.raises(NotImplementedError, match="dequantize"):
        hf_io.save_hf_weights(target, str(tmp_path / "int8"))


@pytest.mark.parametrize("targets", [["*_proj"], ["q_proj", "v_proj"]],
                         ids=["all_proj", "qv"])
def test_qlora_forward_and_adapter_grads_match_jax(targets):
    """``quantize_base: int8`` on both sides (the bypass forced by it), the
    JAX QLoRA params (int8 base, perturbed adapters) loaded into the port:
    logits, loss and adapter gradients."""
    jm, model = models()
    cfg = dict(target_modules=targets, dim=4, alpha=16, quantize_base="int8")
    jw = jlora.LoRAModel(jm, jlora.PeftConfig(**cfg))
    params = jax.tree.map(np.asarray, jw.init(jax.random.key(4)))
    rng = np.random.default_rng(4)
    params["lora"] = jax.tree.map(
        lambda x: (x + 0.05 * rng.standard_normal(x.shape)).astype(x.dtype),
        params["lora"])
    assert params["base"]["layers"]["mlp"]["up_proj"]["kernel"].dtype == \
        np.int8
    pw = lora.LoRAModel(model, lora.PeftConfig(**cfg))
    assert pw.bypass and wo.is_quantized(pw.base_model)
    load_jax_params(pw, params)
    batch = packed_batch(seed=8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlogits = np.asarray(jw(jax.tree.map(jnp.asarray, params),
                            jb["input_ids"], position_ids=jb["position_ids"],
                            segment_ids=jb["segment_ids"])["logits"])
    with torch.no_grad():
        logits = pw(tb["input_ids"], position_ids=tb["position_ids"],
                    segment_ids=tb["segment_ids"])["logits"].numpy()
    assert rel_l2(logits, jlogits) < 1e-5
    jloss, jgrads = jax.value_and_grad(lambda lo: _microbatch_loss(
        jw, JaxCE(), {"base": jax.tree.map(jnp.asarray, params["base"]),
                      "lora": lo}, jb))(
        jax.tree.map(jnp.asarray, params["lora"]))
    loss = microbatch_loss(pw, MaskedCrossEntropy(), tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    for mod_path in pw.targets:
        ad = pw.adapter(mod_path)
        for part, ps in (("A", ad.A), ("B", ad.B)):
            got = np.stack([p.grad.numpy() for p in ps])
            assert rel_l2(got, np.asarray(jgrads[mod_path][part])) < 1e-5
    assert all(b.grad is None for b in pw.base_model.buffers())


def test_int8_base_costs_one_byte_a_weight():
    """The seven projections' codes are int8 and the dense weights are
    gone: the base shrinks by the projections' 3 bytes per weight (fp32)
    less one fp32 scale per output channel."""
    _, model = models()
    proj = sum(getattr(l, p).weight.numel() for l in model.layers
               for _, p in wo.QUANTIZED_MODULES)
    chans = sum(getattr(l, p).weight.shape[0] for l in model.layers
                for _, p in wo.QUANTIZED_MODULES)

    def nbytes(m):
        return sum(t.numel() * t.element_size()
                   for t in list(m.parameters()) + list(m.buffers()))

    before = nbytes(model)
    wo.quantize_base_params(model)
    assert before - nbytes(model) == 3 * proj - 4 * chans
    assert wo.is_quantized(model)
