"""The port's checkpoints (``checkpoint/checkpointing.py``,
``models/hf_io.py``, ``recipes/base_recipe.py``) against the JAX
package's, on the CPU.

* Each package reads the other's files: the JAX ``save_hf_weights`` of
  seeded params loads into the port (same weights, equal logits); a port
  checkpoint passes the JAX ``verify_manifest`` and ``find_latest_checkpoint``
  and loads through the JAX ``load_hf_weights``; the port's safetensors
  bytes open in the ``safetensors`` package, and the port reads its files.
* Crash safety: a ``.tmp`` staging directory and a manifest-less one are
  ignored by discovery; a truncated or altered file fails
  ``verify_manifest`` with the directory's name; ``keep_last_k`` keeps the
  newest and the resume source; an asynchronous save's failure surfaces at
  the next join and commits nothing.
* Resume: a tiny recipe run 2N steps equals one run N steps, stopped, and
  resumed for N more -- loss and grad_norm bitwise, with the synchronous
  loader and with the async input pipeline.

Weights are compared exactly (safetensors stores the bytes); logits of
the JAX and the port's model from the same weights to 1e-5 (fp32, sums in
another order).
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.checkpoint import checkpointing as jck
from automodel_tpu.models import hf_io as jhf
from automodel_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from automodel_tpu.models.llama import LlamaForCausalLM as JaxLlama
from automodel_tpu_torch.checkpoint import checkpointing as ck
from automodel_tpu_torch.config.loader import parse_args_and_load_config
from automodel_tpu_torch.models import hf_io
from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from automodel_tpu_torch.models.weights import jax_leaves
from automodel_tpu_torch.recipes import base_recipe
from automodel_tpu_torch.recipes.llm import train_ft

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_YAML = os.path.join(REPO, "automodel_tpu_torch", "examples",
                         "tiny_llama_sft.yaml")
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, rope_theta=10000.0,
            tie_word_embeddings=False)
MOE_BASE = dict(vocab_size=96, hidden_size=32, intermediate_size=16,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, rope_theta=10000.0,
                tie_word_embeddings=False, num_experts_per_tok=2)
MOE = {"mixtral": dict(MOE_BASE, num_local_experts=4),
       "qwen3_moe": dict(MOE_BASE, num_experts=4, moe_intermediate_size=16,
                         head_dim=8)}


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


def _assert_params_equal(model, tree):
    """Every port parameter equals its leaf of the JAX tree (numpy)."""
    flat = {}

    def walk(t, prefix=()):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat[prefix + (k,)] = v

    walk(tree)
    for path, target, transposed in jax_leaves(model):
        targets = target if isinstance(target, list) else [target]
        leaves = flat[path] if isinstance(target, list) else [flat[path]]
        for p, leaf in zip(targets, leaves):
            np.testing.assert_array_equal(
                p.detach().float().numpy(), leaf.T if transposed else leaf,
                err_msg=".".join(path))


def test_port_loads_jax_safetensors_with_equal_logits(tmp_path):
    jm = JaxLlama(JaxLlamaConfig(**TINY), param_dtype=jnp.float32,
                  compute_dtype=jnp.float32)
    params = jm.init(jax.random.key(0))
    jhf.save_hf_weights(jm, params, str(tmp_path))
    model = LlamaForCausalLM(LlamaConfig(**TINY), param_dtype=torch.float32,
                             compute_dtype=torch.float32, device="cpu")
    hf_io.load_hf_weights(model, str(tmp_path))
    _assert_params_equal(model, _np(params))
    ids = np.random.default_rng(1).integers(0, 128, (2, 32)).astype(np.int32)
    want = np.asarray(jm(params, jnp.asarray(ids))["logits"])
    with torch.no_grad():
        got = model(torch.from_numpy(ids))["logits"].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("family", sorted(MOE))
def test_moe_experts_split_and_join_as_in_jax(tmp_path, family):
    """Mixtral and Qwen3-MoE: the JAX writer's per-expert tensors load into
    the port's expert stacks, and the port's sharded writer gives the JAX
    reader the same tensors back."""
    from automodel_tpu.models import mixtral as jmix
    from automodel_tpu.models import qwen3_moe as jq
    from automodel_tpu_torch.models.mixtral import (
        MixtralConfig,
        MixtralForCausalLM,
    )
    from automodel_tpu_torch.models.qwen3_moe import (
        Qwen3MoeConfig,
        Qwen3MoeForCausalLM,
    )

    classes = {
        "mixtral": (jmix.MixtralConfig, jmix.MixtralForCausalLM,
                    MixtralConfig, MixtralForCausalLM),
        "qwen3_moe": (jq.Qwen3MoeConfig, jq.Qwen3MoeForCausalLM,
                      Qwen3MoeConfig, Qwen3MoeForCausalLM)}
    jcfg, jcls, cfg, cls = classes[family]
    jm = jcls(jcfg(**MOE[family]), param_dtype=jnp.float32,
              compute_dtype=jnp.float32)
    params = jm.init(jax.random.key(2))
    jhf.save_hf_weights(jm, params, str(tmp_path / "jax"))
    model = cls(cfg(**MOE[family]), param_dtype=torch.float32,
                compute_dtype=torch.float32, device="cpu")
    hf_io.load_hf_weights(model, str(tmp_path / "jax"))
    _assert_params_equal(model, _np(params))
    hf_io.save_hf_weights(model, str(tmp_path / "port"), max_shard_bytes=4096)
    with open(tmp_path / "port" / hf_io.SAFETENSORS_INDEX) as f:
        assert len(set(json.load(f)["weight_map"].values())) > 1
    back = jhf.load_hf_weights(jm, str(tmp_path / "port"))
    for a, b in zip(jax.tree.leaves(_np(back)), jax.tree.leaves(_np(params))):
        np.testing.assert_array_equal(a, b)


def test_safetensors_bytes_read_by_the_package(tmp_path):
    from safetensors.torch import load_file, save_file

    rng = np.random.default_rng(0)
    tensors = {"a.bf16": torch.from_numpy(rng.normal(size=(3, 5)).astype(
                   np.float32)).to(torch.bfloat16),
               "b.f32": torch.from_numpy(rng.normal(size=(7,)).astype(
                   np.float32)),
               "c.i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
               "d.empty": torch.zeros(0, 4)}
    hf_io.write_safetensors(str(tmp_path / "port.safetensors"), tensors,
                            metadata={"format": "pt"})
    got = load_file(str(tmp_path / "port.safetensors"))
    assert set(got) == set(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    save_file(tensors, str(tmp_path / "pkg.safetensors"))
    back = hf_io.read_safetensors(str(tmp_path / "pkg.safetensors"))
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k


def _recipe(ckpt_dir, *extra):
    cfg = parse_args_and_load_config(
        ["-c", PORT_YAML, "--device", "cpu", "--checkpoint.enabled", "true",
         "--checkpoint.checkpoint_dir", str(ckpt_dir), *extra])
    return train_ft.TrainFinetuneRecipeForNextTokenPrediction(cfg).setup()


def test_port_checkpoint_is_read_and_verified_by_jax(tmp_path):
    r = _recipe(tmp_path, "--step_scheduler.max_steps", "2")
    r.run_train_validation_loop()
    path = jck.find_latest_checkpoint(str(tmp_path))
    assert path == ck.find_latest_checkpoint(str(tmp_path))
    assert os.path.basename(path) == "epoch_0_step_2"
    manifest = jck.verify_manifest(path)
    assert manifest["step"] == 2 and manifest == ck.verify_manifest(path)
    cfg = dict(TINY, tie_word_embeddings=True)
    jm = JaxLlama(JaxLlamaConfig(**cfg), param_dtype=jnp.float32,
                  compute_dtype=jnp.float32)
    loaded = jhf.load_hf_weights(jm, os.path.join(path, "model"))
    _assert_params_equal(r.model, _np(loaded))
    from safetensors import safe_open

    with safe_open(os.path.join(path, "model", "model.safetensors"),
                   "pt") as f:
        assert torch.equal(f.get_tensor("model.norm.weight"),
                           r.model.norm.weight.detach())


def test_discovery_ignores_staging_and_uncommitted_dirs(tmp_path):
    r = _recipe(tmp_path, "--step_scheduler.max_steps", "1")
    r.run_train_validation_loop()
    good = os.path.join(tmp_path, "epoch_0_step_1")
    shutil.copytree(good, os.path.join(tmp_path, "epoch_0_step_9.tmp"))
    os.makedirs(os.path.join(tmp_path, "epoch_0_step_8"))   # no manifest
    for find in (ck.find_latest_checkpoint, jck.find_latest_checkpoint):
        assert find(str(tmp_path)) == good
    with pytest.raises(ck.CheckpointIntegrityError, match="staging"):
        ck.verify_manifest(os.path.join(tmp_path, "epoch_0_step_9.tmp"))
    with pytest.raises(ck.CheckpointIntegrityError, match="never"):
        ck.verify_manifest(os.path.join(tmp_path, "epoch_0_step_8"))


@pytest.mark.parametrize("damage", ["truncate_weights", "alter_state"])
def test_damaged_checkpoint_fails_verification_by_name(tmp_path, damage):
    r = _recipe(tmp_path, "--step_scheduler.max_steps", "1")
    r.run_train_validation_loop()
    path = os.path.join(tmp_path, "epoch_0_step_1")
    if damage == "truncate_weights":
        target = os.path.join(path, "model", "model.safetensors")
        with open(target, "r+b") as f:
            f.truncate(os.path.getsize(target) // 2)
        match = "model/model.safetensors is"
    else:
        target = os.path.join(path, "rng.pt")
        with open(target, "r+b") as f:
            f.seek(100)
            byte = f.read(1)
            f.seek(100)
            f.write(bytes([byte[0] ^ 0xFF]))
        match = "rng.pt fails its sha256"
    for verify, err in ((ck.verify_manifest, ck.CheckpointIntegrityError),
                        (jck.verify_manifest, jck.CheckpointIntegrityError)):
        with pytest.raises(err, match=f"epoch_0_step_1.*{match}"):
            verify(path)
    # resume refuses it before touching any state
    r2 = train_ft.TrainFinetuneRecipeForNextTokenPrediction(
        parse_args_and_load_config(
            ["-c", PORT_YAML, "--device", "cpu", "--checkpoint.enabled",
             "true", "--checkpoint.checkpoint_dir", str(tmp_path)]))
    with pytest.raises(ck.CheckpointIntegrityError, match="epoch_0_step_1"):
        r2.setup()


def test_keep_last_k_keeps_the_newest_and_the_resume_source(tmp_path):
    r = _recipe(tmp_path, "--step_scheduler.max_steps", "2",
                "--step_scheduler.ckpt_every_steps", "1")
    r.run_train_validation_loop()
    assert [s for _, s, _ in ck.list_committed_checkpoints(str(tmp_path))] \
        == [1, 2]
    r = _recipe(tmp_path, "--step_scheduler.max_steps", "5",
                "--step_scheduler.ckpt_every_steps", "1",
                "--checkpoint.keep_last_k", "1",
                "--checkpoint.restore_from",
                os.path.join(tmp_path, "epoch_0_step_1"))
    assert r.step_scheduler.step == 1
    r.run_train_validation_loop()
    # step 2 was outranked; step 1 is the resume source and stays
    assert [s for _, s, _ in ck.list_committed_checkpoints(str(tmp_path))] \
        == [1, 5]


def test_async_failure_surfaces_at_the_next_join(tmp_path, monkeypatch):
    r = _recipe(tmp_path, "--step_scheduler.max_steps", "1")
    assert r.checkpoint_config.async_save

    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(base_recipe, "save_hf_weights", broken)
    r.save_checkpoint(0, 1)               # returns: the commit is pending
    with pytest.raises(ck.CheckpointSaveError, match="epoch_0_step_1") as e:
        r.join_pending_save()
    assert isinstance(e.value.__cause__, OSError)
    assert ck.find_latest_checkpoint(str(tmp_path)) is None
    assert os.path.isdir(os.path.join(tmp_path, "epoch_0_step_1.tmp"))
    assert r.join_pending_save() is None          # nothing left in flight


N = 3


@pytest.mark.parametrize("depth", [0, 2], ids=["sync_loader", "prefetch2"])
def test_resume_equals_an_uninterrupted_run_bitwise(tmp_path, depth):
    common = ["--dataloader.prefetch_depth", str(depth),
              "--step_scheduler.ckpt_every_steps", "50"]
    full = _recipe(tmp_path / "full", "--step_scheduler.max_steps",
                   str(2 * N), *common)
    full.run_train_validation_loop()
    first = _recipe(tmp_path / "cut", "--step_scheduler.max_steps", str(N),
                    *common)
    first.run_train_validation_loop()
    second = _recipe(tmp_path / "cut", "--step_scheduler.max_steps",
                     str(2 * N), *common)
    assert second.step_scheduler.step == N
    # the restored state is the saved state, bit for bit
    for name, want in first.model.state_dict().items():
        assert torch.equal(second.model.state_dict()[name], want), name
    saved = first.optimizer.state_dict()["state"]
    got = second.optimizer.state_dict()["state"]
    assert saved.keys() == got.keys()
    for i in saved:
        assert saved[i]["step"] == got[i]["step"] == N
        for key in ("mu", "nu"):
            assert got[i][key].dtype == saved[i][key].dtype
            assert torch.equal(got[i][key], saved[i][key])
    assert second.lr_scheduler.state_dict() == first.lr_scheduler.state_dict()
    assert second.dataloader.state_dict() == first.dataloader.state_dict()
    second.run_train_validation_loop()
    assert [m["step"] for m in second.history] == list(range(N + 1,
                                                             2 * N + 1))
    for key in ("loss", "grad_norm", "num_label_tokens", "lr"):
        assert [m[key] for m in second.history] == \
            [m[key] for m in full.history[N:]], key
