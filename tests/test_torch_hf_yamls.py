"""The JAX package's own HF fine-tuning YAMLs through the port's recipe on
the CPU, against the JAX recipe on the same YAML: ``qwen3_0p6b_hellaswag``,
``llama3_2_1b_hellaswag``, ``llama3_2_1b_hellaswag_peft`` (the base loaded
from the directory, then LoRA) and ``llama3_2_1b_squad``.

Nothing is downloaded.  A tiny model of each YAML's family (2 layers,
hidden 64, vocab 512, float32) is written as the ``HF_HOME`` snapshot of
the repo id the YAML names, so ``pretrained_model_name_or_path`` resolves
as written in both packages; the dataset rows are made from a seed in
HellaSwag's / SQuAD's schema and the tokenizer is
``tests/torch_hf_fixtures.py``'s byte tokenizer, handed to both recipes
through ``tokenizer._target_``.  The JAX recipe reads the rows through a
stand-in ``datasets.load_dataset`` that serves them for the YAML's repo
id; the port's recipe reads the same rows from local jsonl files given in
place of the repo ids.  Other overrides, the same on both sides: float32
compute and gradients, 4 steps, the checkpoint directory, and (JAX) one
device, a synchronous loader.

The port loads the weights itself (its model equals the JAX recipe's
loaded params bit for bit; under PEFT the base, then the JAX recipe's
adapters are copied in, since the two draw them from different
generators).  Tolerance: the recipe tests' (``test_torch_train_recipe.py``):
loss and grad_norm within 1e-4 relative over the 4 steps, label-token
counts and learning rates exact.
"""

import os

import jax
import numpy as np
import pytest
import torch

from automodel_tpu.config.arg_parser import (
    parse_args_and_load_config as jax_config,
)
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JaxRecipe,
)
from automodel_tpu_torch.config.loader import parse_args_and_load_config
from automodel_tpu_torch.models import auto_model, hf_io
from automodel_tpu_torch.models.weights import jax_leaves, load_jax_params
from automodel_tpu_torch.recipes.llm import train_ft
from tests.torch_hf_fixtures import (
    ByteTokenizer,
    hellaswag_rows,
    hf_cache_snapshot,
    jax_side_datasets,
    squad_rows,
    write_jsonl,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "llm_finetune")
REL = 1e-4
STEPS = 4
TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-6,
            max_position_embeddings=2048, tie_word_embeddings=True,
            torch_dtype="float32")
MODELS = {
    "Qwen/Qwen3-0.6B": dict(TINY, model_type="qwen3", rope_theta=1000000.0,
                            use_sliding_window=False,
                            architectures=["Qwen3ForCausalLM"]),
    "meta-llama/Llama-3.2-1B": dict(
        TINY, model_type="llama", rope_theta=500000.0,
        rope_scaling={"rope_type": "llama3", "factor": 32.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 8192},
        architectures=["LlamaForCausalLM"]),
}
# YAML -> (its repo id, its dataset, the dataset keys naming the source)
YAMLS = {
    "qwen3_0p6b_hellaswag": ("qwen3", "Qwen/Qwen3-0.6B", "hellaswag",
                             "path_or_dataset"),
    "llama3_2_1b_hellaswag": ("llama3_2", "meta-llama/Llama-3.2-1B",
                              "hellaswag", "path_or_dataset"),
    "llama3_2_1b_hellaswag_peft": ("llama3_2", "meta-llama/Llama-3.2-1B",
                                   "hellaswag", "path_or_dataset"),
    "llama3_2_1b_squad": ("llama3_2", "meta-llama/Llama-3.2-1B", "squad",
                          "dataset_name"),
}


def _write_model(hf_home, repo_id):
    model = auto_model.AutoModelForCausalLM.from_config(
        MODELS[repo_id], seed=7, device="cpu")
    src = os.path.join(hf_home, "src", repo_id.replace("/", "--"))
    hf_io.save_hf_weights(model, src)
    return hf_cache_snapshot(hf_home, repo_id, src)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {tuple(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", sorted(YAMLS))
def test_yaml_runs_through_the_port_as_the_jax_recipe(tmp_path, monkeypatch,
                                                      name):
    family, repo_id, kind, key = YAMLS[name]
    yaml_path = os.path.join(EXAMPLES, family, f"{name}.yaml")
    hf_home = str(tmp_path / "hf")
    _write_model(hf_home, repo_id)
    monkeypatch.setenv("HF_HOME", hf_home)
    make = hellaswag_rows if kind == "hellaswag" else squad_rows
    rows = {"train": make(4 * 32 + 8, seed=11),
            "validation": make(72, seed=12)}
    jax_side_datasets(monkeypatch, rows)
    files = {s: write_jsonl(str(tmp_path / f"{s}.jsonl"), r)
             for s, r in rows.items()}
    common = ["--step_scheduler.max_steps", str(STEPS),
              "--model.compute_dtype", "float32",
              "--training.grad_dtype", "float32"]

    jcfg = jax_config(["--config", yaml_path, *common,
                       "--checkpoint.checkpoint_dir", str(tmp_path / "jck"),
                       "--dataloader.prefetch_depth", "0"])
    jcfg.set_by_dotted("tokenizer._target_", ByteTokenizer)
    real = jax.devices
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "devices", lambda *a: real(*a)[:1])    # one device
    try:
        jr = JaxRecipe(jcfg).setup()
    finally:
        mp.undo()
    jsteps = []
    finalize = jr._finalize_metrics

    def record(pending):
        out = finalize(pending)
        jsteps.append(out)
        return out

    jr._finalize_metrics = record
    jparams = _np_tree(jr.params)
    jr.run_train_validation_loop()

    sources = [f"--dataset.{key}", files["train"]]
    if jcfg.get("validation_dataset") is not None:
        sources += [f"--validation_dataset.{key}", files["validation"]]
    pcfg = parse_args_and_load_config(
        ["-c", yaml_path, "--device", "cpu", *common,
         "--checkpoint.checkpoint_dir", str(tmp_path / "pck"), *sources])
    pcfg.set_by_dotted("tokenizer._target_", ByteTokenizer)
    pr = train_ft.TrainFinetuneRecipeForNextTokenPrediction(pcfg).setup()
    assert isinstance(pr.tokenizer, ByteTokenizer)
    peft = pr.peft_config is not None
    # the port loaded the directory's weights itself: the JAX recipe's
    # loaded params (its base under PEFT), bit for bit
    flat = _flat(jparams["base"] if peft else jparams)
    base = pr.model.base_model if peft else pr.model
    for path, target, transposed in jax_leaves(base):
        got = (np.stack([p.detach().numpy() for p in target])
               if isinstance(target, list) else target.detach().numpy())
        if transposed:
            got = np.swapaxes(got, -1, -2)
        np.testing.assert_array_equal(got, flat[path], err_msg=str(path))
    if peft:
        load_jax_params(pr.model, jparams)    # the JAX recipe's adapters
        pr.optimizer.state.clear()
    assert len(pr.dataloader) == len(jr.dataloader)
    pr.run_train_validation_loop()

    assert [m["step"] for m in pr.history] == list(range(1, STEPS + 1))
    assert [m["step"] for m in jsteps] == [m["step"] for m in pr.history]
    for k in ("num_label_tokens", "lr"):
        assert [m[k] for m in pr.history] == [m[k] for m in jsteps], k
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([m[k] for m in pr.history],
                                   [m[k] for m in jsteps], rtol=REL,
                                   err_msg=k)
    assert all(np.isfinite(m["loss"]) for m in pr.history)


def test_tokenizer_falls_back_to_none_without_transformers(tmp_path,
                                                           monkeypatch,
                                                           caplog):
    """No ``tokenizer:`` section and no ``transformers``: a warning and
    None, as the JAX recipe gives (the port's card machine has no such
    package)."""
    import sys

    monkeypatch.setitem(sys.modules, "transformers", None)
    model = auto_model.AutoModelForCausalLM.from_config(
        MODELS["Qwen/Qwen3-0.6B"], device="cpu")
    model.checkpoint_dir = str(tmp_path)
    cfg = parse_args_and_load_config(
        ["-c", os.path.join(EXAMPLES, "qwen3", "qwen3_0p6b_hellaswag.yaml")])
    assert train_ft.build_tokenizer(cfg, model) is None
    assert "No tokenizer found" in caplog.text
    model.checkpoint_dir = None
    assert train_ft.build_tokenizer(cfg, model) is None
