"""``AutoModelForCausalLM.from_pretrained`` and ``build_model(name_or_path=
...)`` of the port against the JAX package's on HF directories written
here (nothing is downloaded): Llama, Qwen2 (q / k / v biases), Qwen3
dense (qk-norm), Mistral (a uniform sliding window) and a DeepSeek-V3
mock, each ``config.json`` in the published form (the Qwen defaults that
HF's config classes supply are left out, as the published files leave
them out), random float32 weights from a seed.  Both packages load the
same directory and give the same logits; an HF-cache snapshot resolves
through ``refs/main``; an id that resolves to nothing raises
``FileNotFoundError`` in both; Qwen2.5's published window fields build.

Tolerance: logits within 1e-4 relative, 1e-5 absolute (float32 on both
sides, sums taken in another order), as ``test_torch_llama.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import automodel_tpu.ops.gmm_kernel as jgk
from automodel_tpu.models import auto_model as jauto
from automodel_tpu_torch.models import auto_model, hf_io
from automodel_tpu_torch.models.weights import jax_leaves
from tests.torch_hf_fixtures import hf_cache_snapshot

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-6,
            rope_theta=1000000.0, max_position_embeddings=512,
            tie_word_embeddings=True, torch_dtype="float32")
# the published config.json of each family, at tiny widths: the keys HF
# writes, no port- or JAX-only field
HF_CONFIGS = {
    "llama": dict(TINY, model_type="llama", rope_theta=500000.0,
                  architectures=["LlamaForCausalLM"]),
    "qwen2": dict(TINY, model_type="qwen2", sliding_window=4096,
                  use_sliding_window=False, max_window_layers=21,
                  architectures=["Qwen2ForCausalLM"]),
    "qwen3": dict(TINY, model_type="qwen3", attention_bias=False,
                  sliding_window=None, use_sliding_window=False,
                  max_window_layers=2, architectures=["Qwen3ForCausalLM"]),
    "mistral": dict(TINY, model_type="mistral", sliding_window=5,
                    tie_word_embeddings=False,
                    architectures=["MistralForCausalLM"]),
    "deepseek_v3": dict(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
        rope_theta=10000.0, tie_word_embeddings=False, kv_lora_rank=32,
        q_lora_rank=24, qk_rope_head_dim=8, qk_nope_head_dim=16,
        v_head_dim=16, n_routed_experts=4, num_experts_per_tok=2,
        n_shared_experts=1, moe_intermediate_size=32,
        first_k_dense_replace=1, n_group=2, topk_group=1,
        routed_scaling_factor=2.5, max_position_embeddings=512,
        model_type="deepseek_v3", torch_dtype="float32",
        architectures=["DeepseekV3ForCausalLM"]),
}


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    """The JAX MoE experts run their Pallas kernel in interpret mode."""
    monkeypatch.setattr(jgk, "_INTERPRET", True)


def write_hf_dir(path, hf_cfg, seed=0):
    """An HF directory: random float32 weights from ``seed`` (biases and
    norms perturbed away from their zeros and ones) written by the port,
    then ``config.json`` replaced by the published-form ``hf_cfg``."""
    model = auto_model.AutoModelForCausalLM.from_config(
        hf_cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("bias", "norm.weight")):
                p.add_(torch.from_numpy(
                    0.1 * rng.standard_normal(p.shape).astype(np.float32)))
    hf_io.save_hf_weights(model, str(path))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f)
    return model


def jax_logits(path, ids):
    jm = jauto.AutoModelForCausalLM.from_pretrained(
        str(path), load_weights=True, compute_dtype=jnp.float32,
        remat=False)
    return np.asarray(jm(jm.params, jnp.asarray(ids, jnp.int32))["logits"])


@pytest.mark.parametrize("family", sorted(HF_CONFIGS))
def test_from_pretrained_logits_match_jax(tmp_path, family):
    hf_cfg = HF_CONFIGS[family]
    written = write_hf_dir(tmp_path, hf_cfg)
    model = auto_model.AutoModelForCausalLM.from_pretrained(
        str(tmp_path), load_weights=True, device="cpu",
        compute_dtype=torch.float32, remat=False)
    assert model.checkpoint_dir == str(tmp_path)
    assert model.param_dtype == torch.float32
    for (_, want, _), (_, got, _) in zip(jax_leaves(written),
                                         jax_leaves(model)):
        for a, b in zip(want if isinstance(want, list) else [want],
                        got if isinstance(got, list) else [got]):
            assert torch.equal(a, b)
    ids = np.random.default_rng(2).integers(0, hf_cfg["vocab_size"],
                                            (2, 12))
    with torch.no_grad():
        got = model(torch.from_numpy(ids))["logits"].numpy()
    np.testing.assert_allclose(got, jax_logits(tmp_path, ids), rtol=RTOL,
                               atol=ATOL)


def test_published_qwen_configs_get_hf_defaults(tmp_path):
    """A Qwen3 ``config.json`` has no ``qk_norm`` and a Qwen2 one often
    no ``attention_bias``: both packages fill HF's defaults."""
    from automodel_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from automodel_tpu_torch.models.llama import LlamaConfig

    for cfg in (HF_CONFIGS["qwen3"], HF_CONFIGS["qwen2"]):
        port, jx = (LlamaConfig.from_hf_config(cfg),
                    JaxLlamaConfig.from_hf_config(cfg))
        assert (port.qk_norm, port.attention_bias, port.use_sliding_window) \
            == (jx.qk_norm, jx.attention_bias, jx.use_sliding_window)
    assert LlamaConfig.from_hf_config(HF_CONFIGS["qwen3"]).qk_norm
    assert LlamaConfig.from_hf_config(HF_CONFIGS["qwen2"]).attention_bias
    model = auto_model.build_model(config=HF_CONFIGS["qwen3"], device="cpu")
    assert hasattr(model.layers[0], "q_norm")
    assert model.layers[0].q_proj.bias is None


def test_hf_home_snapshot_resolves_through_refs_main(tmp_path, monkeypatch):
    src = tmp_path / "src"
    write_hf_dir(src, HF_CONFIGS["qwen2"])
    hf_home = str(tmp_path / "hf")
    # a later-sorting snapshot that refs/main does not name
    hf_cache_snapshot(hf_home, "Qwen/Qwen2.5-tiny", str(src), rev="ffff")
    os.remove(os.path.join(hf_home, "hub", "models--Qwen--Qwen2.5-tiny",
                           "refs", "main"))
    snap = hf_cache_snapshot(hf_home, "Qwen/Qwen2.5-tiny", str(src),
                             rev="0123abcd")
    monkeypatch.setenv("HF_HOME", hf_home)
    assert auto_model.resolve_checkpoint_dir("Qwen/Qwen2.5-tiny") == snap
    assert jauto.resolve_checkpoint_dir("Qwen/Qwen2.5-tiny") == snap
    model = auto_model.build_model(name_or_path="Qwen/Qwen2.5-tiny",
                                   device="cpu", seed=3)
    assert model.checkpoint_dir == snap
    assert model.config.model_type == "qwen2" and model.config.attention_bias
    # without refs/main the last snapshot by name, as in JAX
    os.remove(os.path.join(hf_home, "hub", "models--Qwen--Qwen2.5-tiny",
                           "refs", "main"))
    assert auto_model.resolve_checkpoint_dir("Qwen/Qwen2.5-tiny") == \
        jauto.resolve_checkpoint_dir("Qwen/Qwen2.5-tiny")


def test_unresolvable_id_raises_file_not_found(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="Cannot resolve"):
        jauto.AutoModelForCausalLM.from_pretrained("nobody/nothing")
    with pytest.raises(FileNotFoundError, match="Cannot resolve"):
        auto_model.AutoModelForCausalLM.from_pretrained("nobody/nothing",
                                                        device="cpu")
    with pytest.raises(FileNotFoundError):
        auto_model.build_model(name_or_path="nobody/nothing", device="cpu")
    with pytest.raises(ValueError, match="name_or_path or config"):
        auto_model.build_model(device="cpu")


QWEN25_1P5B = dict(  # Qwen/Qwen2.5-1.5B-Instruct's window fields, 28 layers
    model_type="qwen2", hidden_size=32, intermediate_size=64,
    num_hidden_layers=28, num_attention_heads=4, num_key_value_heads=2,
    vocab_size=64, sliding_window=32768, use_sliding_window=False,
    max_window_layers=21, tie_word_embeddings=True, torch_dtype="bfloat16")


def test_qwen2_5_window_fields_build_without_a_window():
    from automodel_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from automodel_tpu.models.llama import LlamaForCausalLM as JaxLlama

    model = auto_model.build_model(config=QWEN25_1P5B, device="cpu")
    jm = JaxLlama(JaxLlamaConfig.from_hf_config(QWEN25_1P5B))
    assert model.sliding_window is None and jm._sliding_window is None
    assert model.config.attention_bias
    # the same fields with the window on would mix sliding and full layers
    mixed = dict(QWEN25_1P5B, use_sliding_window=True)
    with pytest.raises(NotImplementedError, match="max_window_layers"):
        auto_model.build_model(config=mixed, device="cpu")
    with pytest.raises(NotImplementedError, match="max_window_layers"):
        JaxLlama(JaxLlamaConfig.from_hf_config(mixed))


def test_biases_round_trip_through_save_and_load(tmp_path):
    written = write_hf_dir(tmp_path / "a", HF_CONFIGS["qwen2"], seed=4)
    names = {n for n, _, _ in hf_io.hf_tensors(written)}
    assert {f"model.layers.{i}.self_attn.{p}.bias" for i in range(2)
            for p in ("q_proj", "k_proj", "v_proj")} <= names
    loaded = auto_model.AutoModelForCausalLM.from_pretrained(
        str(tmp_path / "a"), load_weights=True, device="cpu")
    hf_io.save_hf_weights(loaded, str(tmp_path / "b"))
    again = hf_io.read_safetensors(str(tmp_path / "b" / "model.safetensors"))
    first = hf_io.read_safetensors(str(tmp_path / "a" / "model.safetensors"))
    assert sorted(again) == sorted(first)
    assert all(torch.equal(again[n], first[n]) for n in first)
    with open(tmp_path / "b" / "config.json") as f:
        saved = json.load(f)
    assert saved["architectures"] == ["Qwen2ForCausalLM"]
    assert saved["attention_bias"] is True


def test_qwen2_serve_yaml_serves_the_snapshot_it_names(tmp_path, monkeypatch,
                                                       capsys):
    """``qwen2_5_1p5b_serve.yaml`` as written through the port's serve
    tool, its repo id resolved to a tiny Qwen2 snapshot (``build_model(
    name_or_path=...)``; the tool draws the weights from its seed, as the
    JAX tool does)."""
    from automodel_tpu_torch.tools import serve as serve_tool

    src = tmp_path / "src"
    write_hf_dir(src, HF_CONFIGS["qwen2"])
    hf_home = str(tmp_path / "hf")
    snap = hf_cache_snapshot(hf_home, "Qwen/Qwen2.5-1.5B-Instruct",
                             str(src))
    monkeypatch.setenv("HF_HOME", hf_home)
    yaml = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "automodel_tpu_torch", "examples",
        "qwen2_5_1p5b_serve.yaml")
    built = []
    real = auto_model.AutoModelForCausalLM.from_pretrained

    def spy(*args, **kwargs):
        built.append(real(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(auto_model.AutoModelForCausalLM, "from_pretrained",
                        staticmethod(spy))
    rc = serve_tool.main(["--config", yaml, "--device", "cpu", "--requests",
                          "3", "--max-new", "3"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and report["not_finished"] == 0
    assert [m.checkpoint_dir for m in built] == [snap]
    assert built[0].config.attention_bias
