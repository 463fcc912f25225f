"""The port's SFT recipe over a mesh of 4 gloo ranks on the CPU, on the
JAX package's ``examples/llm_finetune/tiny_llama_mock.yaml`` as written
(with ``distributed.*`` overrides; fp32, checkpointing off, 5 steps), from
the JAX recipe's initial weights: dp 2 x tp 2 with sequence parallelism,
dp 2 x cp 2 (the zig-zag ring), dp_replicate 2 x dp_shard 2 (HSDP),
dcn_dp 2 x dp_shard 2, and cp 2 x tp 2 with sequence parallelism (the
ring under sharded heads).  Each mesh's loss, grad_norm, token counts and
learning rates per step are held against the JAX recipe on one device
(equal in exact arithmetic: a step sums the same 16 rows).  The
validation loss at step 5 is held against the JAX recipe on one device
with the mesh's global microbatch (``local_batch_size`` = dp): the loader
reads the validation set in global microbatches of ``local_batch_size x
dp`` rows and drops a last partial one, as the JAX recipe on a mesh
does.

Tolerance: 2e-5 relative.  On one process the port follows the JAX
recipe to about 2e-6 over 10 steps; the mesh sums each
microbatch's loss and gradients over the ranks (FSDP's reduce-scatter,
the tp all-reduces, the ring's lse merge) in another order, about 1e-7 a
step here.

Checkpoints: saved at dp 2 x tp 2 and resumed on one process, and saved
on one process and resumed at dp 2 x tp 2: parameters and optimizer
state equal bit for bit; the JAX package's checkpoint reader finds,
verifies and loads what the mesh wrote.  The refusals under a mesh
(pipeline, expert parallelism with a MoE model, quantized compute, an
int8 base, PEFT) raise ``NotImplementedError`` citing their ROADMAP item.
The nanoGPT pretraining YAML (a tiny GPT-2) at dp 4 follows one process
within the same tolerance.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from automodel_tpu.checkpoint import checkpointing as jck
from automodel_tpu.config.arg_parser import (
    parse_args_and_load_config as jax_config,
)
from automodel_tpu.models import hf_io as jhf
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JaxRecipe,
)
from tests.torch_dist import run_ranks
from automodel_tpu_torch.datasets.llm.nanogpt_dataset import write_shard
from tests.torch_dist_workers import (
    JAX_YAML,
    MOE_YAML,
    _recipe,
    _setup_with_weights,
    full_state,
    pretrain_recipe,
    recipe_suite,
)

torch.set_num_threads(1)

REL = 2e-5
STEPS = 5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {
    "dp2xtp2_sp": ["--distributed.tp_size", "2",
                   "--distributed.sequence_parallel", "true"],
    "dp2xcp2_zigzag": ["--distributed.cp_size", "2"],
    "hsdp_rep2xshard2": ["--distributed.dp_replicate_size", "2"],
    "dcn2xshard2": ["--distributed.dcn_dp_size", "2"],
    "cp2xtp2_sp_zigzag": ["--distributed.cp_size", "2",
                          "--distributed.tp_size", "2",
                          "--distributed.sequence_parallel", "true"],
}
SAVE_MESH = ["--distributed.tp_size", "2"]
REFUSALS = {
    "pp": (JAX_YAML, ["--distributed.pp_size", "2"]),
    "moe_ep": (MOE_YAML, ["--distributed.expert_parallel", "true"]),
    "fp8": (JAX_YAML, ["--fp8.enabled", "true"]),
    "int8_base": (JAX_YAML, ["--model.weight_only_quant", "int8"]),
    "peft": (JAX_YAML, ["--peft.dim", "8"]),
}
REFUSAL_ITEM = {"pp": "item 12", "moe_ep": "item 9", "fp8": "item 9",
                "int8_base": "item 9", "peft": "item 9"}


DP = {"dp2xtp2_sp": 2, "dp2xcp2_zigzag": 2, "hsdp_rep2xshard2": 4,
      "dcn2xshard2": 4, "cp2xtp2_sp_zigzag": 1}


def _jax_run(local_bs):
    """The JAX recipe on one device: (step metrics, validation losses,
    initial weights)."""
    jcfg = jax_config(["--config", JAX_YAML,
                       "--checkpoint.enabled", "false",
                       "--dataloader.prefetch_depth", "0",
                       "--model.config.torch_dtype", "float32",
                       "--model.compute_dtype", "float32",
                       "--step_scheduler.max_steps", str(STEPS),
                       "--step_scheduler.local_batch_size", str(local_bs)])
    real = jax.devices
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "devices", lambda *a: real(*a)[:1])    # one device
    try:
        jr = JaxRecipe(jcfg).setup()
    finally:
        mp.undo()
    jsteps, jvals = [], []
    finalize, validate = jr._finalize_metrics, jr._run_validation_epoch

    def record_step(pending):
        out = finalize(pending)
        jsteps.append(out)
        return out

    def record_val():
        out = validate()
        jvals.append((jr.step_scheduler.step, out))
        return out

    jr._finalize_metrics = record_step
    jr._run_validation_epoch = record_val
    weights = jax.tree.map(np.asarray, jr.params)
    jr.run_train_validation_loop()
    return jsteps, jvals, weights


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX recipe's trajectories and initial weights, a one-process
    port save, and the 4-rank suite."""
    jsteps, jvals, weights = _jax_run(1)
    jval_dp = {dp: _jax_run(dp)[1] for dp in sorted(set(DP.values()))
               if dp > 1}
    jval_dp[1] = jvals
    tmp = tmp_path_factory.mktemp("dist_recipe")
    one_dir, mesh_dir = str(tmp / "one"), str(tmp / "mesh")
    one = _recipe(["--step_scheduler.max_steps", "2",
                   "--step_scheduler.ckpt_every_steps", "2",
                   "--checkpoint.enabled", "true",
                   "--checkpoint.checkpoint_dir", one_dir])
    _setup_with_weights(one, weights)
    one.run_train_validation_loop()
    one.join_pending_save()
    one_state = full_state(one)
    rng = np.random.default_rng(0)
    for i in range(2):
        write_shard(str(tmp / f"train_{i:06d}.bin"),
                    rng.integers(0, 512, 20000))
    shards = str(tmp / "train_*.bin")
    spec = dict(meshes=MESHES, steps=STEPS, weights=weights,
                save_mesh=SAVE_MESH, save_dir=mesh_dir, resume_dir=one_dir,
                refusals=REFUSALS, shards=shards)
    ranks = run_ranks(recipe_suite, 4, tmp, spec, timeout=420)
    # resume the mesh's checkpoint on one process
    back = _recipe(["--step_scheduler.max_steps", "4",
                    "--checkpoint.enabled", "true",
                    "--checkpoint.checkpoint_dir", mesh_dir])
    back.setup()
    return dict(jsteps=jsteps, jvals=jvals, jval_dp=jval_dp, ranks=ranks,
                one=one_state, pretrain_one=pretrain_recipe(shards),
                back=full_state(back), mesh_dir=mesh_dir)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_trajectory_matches_jax_one_device(runs, mesh):
    jsteps = runs["jsteps"]
    assert len(jsteps) == STEPS
    for rank in range(4):
        got = runs["ranks"][rank]["runs"][mesh]
        hist = got["history"]
        assert [m["step"] for m in hist] == [m["step"] for m in jsteps]
        for key in ("num_label_tokens", "lr"):
            assert [m[key] for m in hist] == [m[key] for m in jsteps], key
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose([m[key] for m in hist],
                                       [m[key] for m in jsteps], rtol=REL,
                                       err_msg=f"{mesh} rank {rank} {key}")
        jvals = runs["jval_dp"][DP[mesh]]
        assert [s for s, _ in got["val"]] == [s for s, _ in jvals] == [5]
        np.testing.assert_allclose([v for _, v in got["val"]],
                                   [v for _, v in jvals], rtol=REL,
                                   err_msg=f"{mesh} validation")


def _same_state(a, b):
    pa, oa = a
    pb, ob = b
    assert sorted(pa) == sorted(pb)
    for n in pa:
        assert pa[n].dtype == pb[n].dtype and torch.equal(pa[n], pb[n]), n
    assert sorted(oa["state"]) == sorted(ob["state"])
    for i, sa in oa["state"].items():
        sb = ob["state"][i]
        assert sorted(sa) == sorted(sb)
        for k, v in sa.items():
            if torch.is_tensor(v):
                assert v.dtype == sb[k].dtype and torch.equal(
                    v.cpu(), sb[k].cpu()), (i, k)
            else:
                assert v == sb[k], (i, k)


def test_mesh_checkpoint_resumes_on_one_process_bitwise(runs):
    _same_state(runs["back"], runs["ranks"][0]["saved"])


def test_one_process_checkpoint_resumes_on_the_mesh_bitwise(runs):
    _same_state(runs["ranks"][0]["resumed"], runs["one"])


def test_jax_reader_accepts_the_mesh_checkpoint(runs):
    from automodel_tpu.models.llama import LlamaConfig as JC
    from automodel_tpu.models.llama import LlamaForCausalLM as JL

    path = jck.find_latest_checkpoint(runs["mesh_dir"])
    assert path is not None and path.endswith("epoch_0_step_2")
    jck.verify_manifest(path)
    spec = importlib.util.spec_from_file_location(
        "verify_checkpoint", os.path.join(REPO, "tools",
                                          "verify_checkpoint.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool._verify_one(path, True)
    jm = JL(JC(vocab_size=128, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, rope_theta=10000.0,
               tie_word_embeddings=True))
    loaded = jhf.load_hf_weights(jm, os.path.join(path, "model"))
    emb = np.asarray(loaded["embed_tokens"]["embedding"])
    saved = runs["ranks"][0]["saved"][0]["embed_tokens.weight"]
    np.testing.assert_array_equal(emb, saved.numpy())


def test_pretrain_over_dp4_follows_one_process(runs):
    """The nanoGPT YAML (a tiny GPT-2, fp32) at dp 4 against one process:
    the ranks of a host read the same windows (the dataset splits by
    host, as JAX by process) and the loader hands each its rows, so the
    steps sum the same 32 rows."""
    one = runs["pretrain_one"]
    for rank in range(4):
        got = runs["ranks"][rank]["pretrain"]
        assert [m["num_label_tokens"] for m in got] == [
            m["num_label_tokens"] for m in one]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose([m[key] for m in got],
                                       [m[key] for m in one], rtol=REL,
                                       err_msg=key)


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_under_a_mesh(runs, name):
    for rank in range(4):
        got = runs["ranks"][rank]["refusals"][name]
        assert got is not None, f"{name} set up under a mesh"
        kind, msg = got
        assert kind == "NotImplementedError", (kind, msg)
        assert REFUSAL_ITEM[name] in msg, msg
