"""The PyTorch port stands alone: no file of ``automodel_tpu_torch/`` nor
``chip_smoke.py`` imports JAX or the JAX package (the flash rung, the
checkpoint and HF-safetensors modules, the optimizer step, the DeepSeek
families, ``from_pretrained``, the HellaSwag / SQuAD datasets, the Gemma
and vision models, the VLM datasets and the VLM recipe, the
post-training modules and the GRPO / DPO recipes, GPT-2, the
classifier, Granite / OLMo-2 / StarCoder-2 / Phi-3, the pretraining
entry, Qwen2.5-VL and its M-RoPE position ids, Gemma-3n, the serving
fleet and its live-params transport among them),
importing every module loads no JAX, and the kernel build directory is
ignored by git."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "automodel_tpu_torch")


def _forbidden(name: str) -> bool:
    return (name in ("jax", "jaxlib", "automodel_tpu")
            or name.startswith(("jax.", "jaxlib.", "automodel_tpu.")))


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_jax_or_jax_package_imports():
    bad = []
    sources = list(_port_sources())
    assert len(sources) > 10
    rel = {os.path.relpath(p, PORT) for p in sources}
    for new in ("models/gemma3.py", "models/gemma2.py", "models/vision.py",
                "models/vlm.py", "datasets/vlm/collate_fns.py",
                "datasets/vlm/datasets.py", "datasets/vlm/mock.py",
                "datasets/vlm/utils.py", "recipes/vlm/finetune.py",
                "post_training/__init__.py", "post_training/base.py",
                "post_training/eval_watch.py", "post_training/logprobs.py",
                "post_training/losses.py", "post_training/rollout.py",
                "post_training/steps.py", "recipes/llm/train_grpo.py",
                "recipes/llm/train_dpo.py", "models/gpt2.py",
                "models/granite.py", "models/olmo2.py",
                "models/starcoder2.py", "models/phi3.py",
                "models/sequence_classification.py",
                "examples/pretrain.py", "models/qwen2_5_vl.py",
                "datasets/vlm/qwen_rope.py", "models/gemma3n.py",
                "models/phi4_mm.py", "examples/vlm_generate.py",
                "serving/fleet.py", "utils/elastic.py",
                "checkpoint/replication.py"):
        assert new in rel, new
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "attr", getattr(node.func, "id",
                                                         None))
                  in ("import_module", "__import__") and node.args
                  and isinstance(node.args[0], ast.Constant)):
                names = [node.args[0].value]
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_engine_import_loads_no_jax():
    """Importing every module of the port (the engine, the serve CLI, the
    SFT recipe and all they use) loads no JAX."""
    mods = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".")
        .removesuffix(".__init__")
        for p in _port_sources() if p.startswith(PORT + os.sep))
    for mod in ("recipes.llm.train_ft", "ops.gmm_kernel", "ops.moe",
                "models.mixtral", "models.qwen3_moe", "ops.quant",
                "ops.qdot_kernel", "ops.gmm_quant_kernel",
                "quantization.fp8", "ops.flash_attention",
                "checkpoint.checkpointing", "models.hf_io",
                "optim.builder", "recipes.base_recipe",
                "models.deepseek_v3", "models.deepseek_v2", "ops.rotary",
                "generation.generate", "serving.engine",
                "models.auto_model", "datasets.llm.hellaswag",
                "datasets.llm.squad", "datasets.utils",
                "quantization.weight_only", "models.gpt2",
                "models.sequence_classification", "models.phi3",
                "examples.pretrain", "models.qwen2_5_vl",
                "datasets.vlm.qwen_rope", "serving.fleet",
                "utils.elastic", "checkpoint.replication"):
        assert "automodel_tpu_torch." + mod in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'automodel_tpu' or "
            "m.startswith('automodel_tpu.')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_kernel_build_dir_is_gitignored():
    from automodel_tpu_torch.ops.kernel_lib import build

    rel = os.path.relpath(build.BUILD_DIR, REPO).replace(os.sep, "/")
    with open(os.path.join(REPO, ".gitignore")) as f:
        lines = {ln.strip().rstrip("/") for ln in f}
    assert rel in lines
