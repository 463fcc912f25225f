"""The LLM SFT recipe (counterpart: ``automodel_tpu/recipes/llm/train_ft.py``).

Same YAML schema and the same ``setup()`` + ``run_train_validation_loop()``
surface as the JAX recipe: ``step_scheduler``, ``rng``, ``model``,
``loss_fn``, ``dataset``, ``packed_sequence``, ``dataloader``,
``validation_dataset`` / ``validation_dataloader``, ``optimizer``,
``lr_scheduler``, ``training``, ``compile``, ``kernels``, ``moe``
(``moe.dispatch``: ``sorted`` | ``onehot`` for the MoE families, an error
on a dense model), ``fp8`` (quantized compute: ``enabled``, ``dtype``
``float8`` | ``int8``, ``recipe_name`` ``tensorwise`` | ``rowwise``,
``filter_fqns``; applied by ``quantization/fp8.py::apply_fp8_to_model``
as in the JAX recipe, so every dense projection runs through the ``qdot``
kernel and the MoE experts through ``gmm_quant`` on the card), plus a
top-level
``device`` (default ``cuda``; the recipe raises without a card unless
``device: cpu``), ``profiling`` and ``wandb``.  The hot loop is eager
PyTorch (``training/train_step.py``): stack the microbatches, move them to
the device, one forward/backward per microbatch, one optimizer step, then
log ``loss``, ``grad_norm``, ``lr``, tokens/s and the peak device memory.

The loop is the JAX recipe's: no step ends in a device sync.  A step's
metrics come back packed in one device tensor, are copied to pinned host
memory behind an event, and are read after the next step is dispatched
(``_finalize_metrics``), so they are logged, checked for NaN and appended
to ``history`` one step late; ``flush_metrics`` drains the pending step
before validation, a checkpoint and the loop's end.  With the async input
pipeline (``prefetch_depth > 0``) the loop also stages batch N+1 onto the
card on a copy stream while step N runs (``_pull_staged``), commits the
loader's resume snapshot when a group is dispatched and holds the step
scheduler at the dispatched step during the bookkeeping; ``prefetch_depth:
0`` keeps the synchronous epoch (stage, then dispatch).

The losses are the JAX package's: ``MaskedCrossEntropy`` (default),
``ChunkedCrossEntropy`` and ``FusedLinearCrossEntropy`` (the bench YAML's;
on the card its LM head and CE run through the hand-written linear-CE
kernels, and no ``[T, V]`` logits tensor exists).  The model families are
``models/auto_model.py``'s: Llama, and the MoE families Mixtral and
Qwen3-MoE, whose expert FFNs run through the grouped-matmul kernels on the
card and whose load-balancing loss the train step folds into each
microbatch's loss.

``dataloader.prefetch_depth > 0`` (2 when the YAML does not say, as in
JAX) wraps the training loader in the async input pipeline
(``datasets/prefetch.py``): a producer thread reads and collates the next
batches while the card runs; host-to-device copies stay on the training
thread, on the copy stream.

``profiling`` (``training/timers.py``; the section's presence turns it
on): ``data_wait``, ``data_staging`` / ``data_staging_overlap``,
``dispatch`` (or ``step_e2e`` with ``barrier: true``) and the checkpoint
timers, logged every ``log_interval`` steps as a ``time (ms)`` line with
``ckpt_stall_fraction`` and ``input_idle_fraction``; with ``trace_dir`` a
``torch.profiler`` window over the steps ``[trace_start_step,
trace_stop_step)`` written as a Chrome trace.  ``wandb`` is optional: the
section's keys go to ``wandb.init``, and without the package a warning is
logged and training goes on.  SIGTERM and SIGINT (the first ^C) take a
checkpoint at the next step boundary and return with ``preempted`` set.

``peft`` (LoRA / QLoRA: ``peft/lora.py``), ``freeze_config``
(``utils/model_utils.py``) and ``max_grad_norm`` (default None: no clip)
are read in the JAX recipe's order: the fp8 wrap, then LoRA (the base
frozen, the adapters drawn from the rng's LoRA stream), then the freeze
mask combined with LoRA's by AND, then the optimizer: a custom
``_target_`` (not ``torch.optim.*``) is called with the mask and refused
over an int8 base; otherwise ``max_grad_norm`` becomes ``grad_clip_norm``
and ``param_groups`` resolve against the JAX paths of the trainable
parameters.  The train step then trains the ``requires_grad`` parameters
only.  Under PEFT a checkpoint holds the adapters, in the HF-PEFT format.

``model`` may be ``AutoModelForCausalLM.from_pretrained`` over a local HF
directory or cache snapshot (``models/auto_model.py``): after PEFT has
wrapped the model the recipe fills it from that directory, the base alone
under PEFT (an int8 base quantized on the host as it is read), as the JAX
recipe does.  ``tokenizer`` (its ``_target_``, else ``transformers``'
``AutoTokenizer`` from the checkpoint directory where the package is
installed) is handed to every dataset whose target takes a ``tokenizer``
(HellaSwag, SQuAD).

``compile`` is accepted and does nothing: the port runs eagerly and has no
compiled program to cache (logged once; nothing is ``torch.compile``d).
``kernels.autotune: off`` (or absent) means the kernels' hand-chosen
tiles; ``on`` / ``force`` raise.

``checkpoint`` (on unless ``enabled: false``, as in JAX): saves at
``step_scheduler.ckpt_every_steps``, at the end of an epoch and at
``max_steps``, crash-safe and by default asynchronous, and resumes at
set-up from ``restore_from`` or the newest committed checkpoint of
``checkpoint_dir`` (``recipes/base_recipe.py``); the model is written as
consolidated HF safetensors, the only ``model_save_format`` ported.  With
checkpointing off nothing is saved and nothing resumed.

``distributed`` (the JAX ``MeshManager`` section) trains over a device
mesh when the run is launched with ``torchrun --nproc-per-node N``
(``distributed/init.py``: NCCL on ``cuda``, gloo with ``--device cpu``):
the mesh and the parallel plan are built as in JAX (``distributed/
mesh.py``, ``distributed/shardings.py``: FSDP2 / HSDP / ``dcn_dp`` for
every text family, tensor and sequence parallelism and the ring of
context parallelism for the Llama decoder class, the cp layout resolved by
``_apply_cp_layout_policy``), each rank reads its rows of every global
microbatch (``local_batch_size x dp_size`` rows) and the train step
reduces over the mesh.  Pipeline parallelism, expert parallelism with a
MoE model, quantized compute (fp8 / an int8 base) and PEFT under a mesh
raise, each citing its ROADMAP item.

Left out of this slice, each raising ``NotImplementedError`` when its
knob is set (ROADMAP Queue 1 names where each lands): other checkpoint
formats, pipeline parallelism, kernel autotuning, the host-offload remat
policies, elastic recovery and the SLURM / k8s launchers.

    python -m automodel_tpu_torch.recipes.llm.train_ft \\
        -c automodel_tpu_torch/examples/tiny_llama_sft.yaml --device cpu
"""

from __future__ import annotations

import inspect
import logging
import signal
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from automodel_tpu_torch.checkpoint.checkpointing import (
    build_checkpoint_config,
)
from automodel_tpu_torch.config.loader import (
    ConfigNode,
    parse_args_and_load_config,
    resolve_target,
)
from automodel_tpu_torch.datasets.dataloader import StatefulDataLoader
from automodel_tpu_torch.distributed.init import initialize_distributed
from automodel_tpu_torch.distributed.mesh import MeshManager
from automodel_tpu_torch.distributed.shardings import (
    build_parallel_plan,
    process_batch_rows,
)
from automodel_tpu_torch.datasets.llm.packed_sequence import PackedSequence
from automodel_tpu_torch.datasets.prefetch import wrap_prefetch
from automodel_tpu_torch.loss.masked_ce import MaskedCrossEntropy
from automodel_tpu_torch.models.hf_io import load_hf_weights
from automodel_tpu_torch.models.llama import as_dtype
from automodel_tpu_torch.ops.moe import (
    normalize_moe_dispatch,
    validate_moe_dispatch,
)
from automodel_tpu_torch.optim.builder import build_optimizer, set_hyperparams
from automodel_tpu_torch.optim.scheduler import OptimizerParamScheduler
from automodel_tpu_torch.peft.lora import PeftConfig, build_lora
from automodel_tpu_torch.quantization.fp8 import (
    apply_fp8_to_model,
    build_fp8_config,
)
from automodel_tpu_torch.quantization.weight_only import (
    is_quantized,
    load_quantized_hf_base,
)
from automodel_tpu_torch.recipes.base_recipe import BaseRecipe
from automodel_tpu_torch.training.rng import StatefulRNG
from automodel_tpu_torch.training.step_scheduler import StepScheduler
from automodel_tpu_torch.training.timers import (
    Timers,
    Trace,
    build_profiling_config,
    ckpt_stall_fraction,
    input_idle_fraction,
)
from automodel_tpu_torch.training.train_step import (
    MetricsCopy,
    TrainStep,
    stage_batch,
    to_device_batch,
    unpack_metrics,
    use_staged,
)
from automodel_tpu_torch.training.utils import count_tokens
from automodel_tpu_torch.utils.device import resolve_device
from automodel_tpu_torch.utils.safe_import import safe_import
from automodel_tpu_torch.utils.sig_utils import (
    DistributedSignalHandler,
    get_signal_name,
)
from automodel_tpu_torch.utils.model_utils import (
    apply_parameter_freezing,
    jax_named_parameters,
    print_trainable_parameters,
)

logger = logging.getLogger(__name__)

_MODEL_INIT_STREAM = 0      # rng stream of the weight init
_LORA_INIT_STREAM = 1       # rng stream of the adapters and their dropout

# Top-level sections the port reads; ``dist_env`` is accepted and unused
# (one process).  Any other section raises.
_SECTIONS = {
    "step_scheduler", "dist_env", "rng", "model", "checkpoint",
    "distributed", "loss_fn", "dataset", "packed_sequence", "dataloader",
    "validation_dataset", "validation_dataloader", "optimizer",
    "lr_scheduler", "training", "device", "compile", "kernels", "moe",
    "fp8", "peft", "freeze_config", "max_grad_norm", "profiling", "wandb",
    "tokenizer",
}
_LATER = {
    "checkpoint_format": "Orbax / non-consolidated checkpoints (ROADMAP "
                         "Queue 1 item 7)",
    "pipeline": "pipeline parallelism (ROADMAP Queue 1 item 12)",
    "distributed": "multi-GPU post-training and VLM recipes (ROADMAP "
                   "Queue 1 item 9, second half)",
    "mesh_quant": "quantized compute under a mesh: its tensorwise scales "
                  "are the global amax (ROADMAP Queue 1 item 9, second half)",
    "mesh_ep": "expert parallelism (ROADMAP Queue 1 item 9, second half)",
    "mesh_peft": "PEFT under a mesh (ROADMAP Queue 1 item 9, second half)",
    "autotune": "kernel block-size autotuning (ROADMAP Queue 1 item 3; "
                "the kernels run their hand-chosen tiles)",
    "elastic": "elastic recovery (ROADMAP Queue 1 item 12)",
    "slurm": "the SLURM launcher (ROADMAP Queue 1 item 12)",
    "k8s": "the k8s launcher (ROADMAP Queue 1 item 12)",
}


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with {_LATER[what]}")


def check_ported(cfg: ConfigNode, sections=frozenset(),
                 allow_mesh: bool = False) -> None:
    """Raise ``NotImplementedError`` on any knob this slice does not port,
    instead of training without it (``sections``: a recipe's own, beside
    ``_SECTIONS``; ``allow_mesh``: the recipe trains over a mesh)."""
    for name in sorted(set(cfg.to_dict()) - _SECTIONS - set(sections)):
        node = cfg.get(name)
        if isinstance(node, ConfigNode) and node.get("enabled") is False:
            continue                      # e.g. ``fp8: {enabled: false}``
        if name in _LATER:
            raise _later(name)
        raise NotImplementedError(
            f"config section {name!r} is not ported by the PyTorch port's "
            f"SFT recipe (it reads {sorted(_SECTIONS)})")
    ck = build_checkpoint_config(cfg.get("checkpoint"))
    # under PEFT a checkpoint holds the adapters alone, whatever the
    # format knobs say (as in JAX)
    if (ck.enabled and not isinstance(cfg.get("peft"), ConfigNode)
            and (ck.model_save_format != "safetensors"
                 or not ck.save_consolidated)):
        raise _later("checkpoint_format")
    pp = cfg.get("distributed.pp_size")
    if pp not in (None, 1) and not (isinstance(pp, str) and pp.lower() in (
            "none", "null", "")):
        raise _later("pipeline")
    if not allow_mesh:
        for axis in ("dp_size", "dp_replicate_size", "dcn_dp_size",
                     "tp_size", "cp_size"):
            if cfg.get(f"distributed.{axis}") not in (None, 1):
                raise _later("distributed")
        if cfg.get("distributed.sequence_parallel"):
            raise _later("distributed")
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and \
                dist.get_world_size() > 1:
            raise _later("distributed")
    # YAML 1.1 reads ``off`` / ``on`` as booleans
    if cfg.get("kernels.autotune") not in (None, False, "off", "none"):
        raise _later("autotune")


def build_tokenizer(cfg: ConfigNode, model) -> Optional[Any]:
    """The ``tokenizer:`` section's ``_target_`` instantiated; without one,
    ``transformers.AutoTokenizer`` from the model's ``checkpoint_dir``
    (a warning and None without the package or the files, as in JAX)."""
    tok_cfg = cfg.get("tokenizer")
    if isinstance(tok_cfg, ConfigNode) and "_target_" in tok_cfg.to_dict():
        return tok_cfg.instantiate()
    ckpt_dir = getattr(model, "checkpoint_dir", None)
    if ckpt_dir is None:
        return None
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(ckpt_dir)
    except Exception as e:       # as JAX: any failure means no tokenizer
        logger.warning("No tokenizer found at %s: %s", ckpt_dir, e)
    return None


def accepts_kwarg(fn, name: str) -> bool:
    """Whether ``fn`` takes a keyword argument ``name`` (by name or
    ``**kwargs``)."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    return name in params or any(
        p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values())


def build_dataset(cfg_ds: ConfigNode, tokenizer=None):
    """Instantiate a dataset section, handing it ``tokenizer`` when there
    is one and the target takes a ``tokenizer`` argument."""
    if cfg_ds.get("_target_") is None:
        raise ValueError("dataset config needs a _target_")
    fn = resolve_target(cfg_ds.get("_target_"))
    if tokenizer is not None and accepts_kwarg(fn, "tokenizer"):
        return cfg_ds.instantiate(tokenizer=tokenizer)
    return cfg_ds.instantiate()


def load_pretrained_weights(model, peft: bool) -> None:
    """Fill ``model`` from its ``checkpoint_dir`` (a ``from_pretrained``
    model) as the JAX recipe does: the dense weights, or under PEFT the
    base (an int8 base quantized on the host as it is read), the adapters
    left as drawn; nothing without a ``checkpoint_dir``."""
    ckpt_dir = getattr(model, "checkpoint_dir", None)
    if ckpt_dir is None:
        return
    base = model.base_model if peft else model
    if is_quantized(base):
        load_quantized_hf_base(base, ckpt_dir)
    else:
        load_hf_weights(base, ckpt_dir)
    logger.info("weights loaded from %s", ckpt_dir)


def build_wandb(cfg: ConfigNode):
    """``wandb.init(**cfg.wandb)``, or None without the section; without
    the package (or when ``init`` fails) a warning and None."""
    wandb_cfg = cfg.get("wandb")
    if wandb_cfg is None:
        return None
    ok, wandb = safe_import("wandb")
    if not ok:
        logger.warning("wandb disabled: %s", wandb)
        return None
    try:
        return wandb.init(**wandb_cfg.to_dict())
    except Exception as e:
        logger.warning("wandb disabled: %s", e)
        return None


def build_dataloader(cfg: ConfigNode, dataset, cfg_key: str,
                     batch_size: int, seed: int, host_rows=None):
    """Dataset (+ packing when ``packed_sequence.packed_sequence_size`` >
    0) -> loader built from ``cfg[cfg_key]``, wrapped in the async input
    pipeline when its ``prefetch_depth`` is > 0; ``host_rows``: the rows
    of each global microbatch this rank reads."""
    size = int(cfg.get("packed_sequence.packed_sequence_size", 0) or 0)
    if size > 0:
        dataset = PackedSequence(
            dataset, packed_sequence_size=size,
            split_across_pack=bool(cfg.get("packed_sequence.split_across_pack",
                                           False))).pack()
    dl_cfg = cfg.get(cfg_key)
    kwargs: Dict[str, Any] = {}
    if isinstance(dl_cfg, ConfigNode):
        kwargs = {k: v for k, v in dl_cfg.to_dict().items()
                  if k not in ("_target_", "prefetch_depth")}
    kwargs.setdefault("batch_size", batch_size)
    kwargs.setdefault("seed", seed)
    if host_rows is not None:
        kwargs["host_rows"] = host_rows
    depth = int((dl_cfg.get("prefetch_depth") if isinstance(dl_cfg, ConfigNode)
                 else 0) or 0)
    target = dl_cfg.get("_target_") if isinstance(dl_cfg, ConfigNode) else None
    cls = resolve_target(target) if target else StatefulDataLoader
    return wrap_prefetch(cls(dataset, **kwargs), depth)


def build_lr_scheduler(cfg_lr: Optional[ConfigNode],
                       opt_cfg: Optional[ConfigNode],
                       total_steps: int) -> OptimizerParamScheduler:
    """Defaults from the optimizer block (``lr``, ``weight_decay``,
    ``min_lr``): constant lr over ``total_steps``; the ``lr_scheduler``
    block's non-null keys override them."""
    opt = opt_cfg.to_dict() if opt_cfg is not None else {}
    lr = float(opt.get("lr", 1e-4))
    wd = float(opt.get("weight_decay", 0.0) or 0.0)
    kwargs = dict(
        init_lr=0.0, max_lr=lr, min_lr=float(opt.get("min_lr", 0.0) or 0.0),
        lr_warmup_steps=0, lr_decay_steps=max(total_steps, 1),
        lr_decay_style="constant", start_wd=wd, end_wd=wd, wd_incr_steps=0,
        wd_incr_style="constant")
    if cfg_lr is not None:
        kwargs.update({k: v for k, v in cfg_lr.to_dict().items()
                       if k != "_target_" and v is not None})
    return OptimizerParamScheduler(**kwargs)


class TrainFinetuneRecipeForNextTokenPrediction(BaseRecipe):
    """``setup()`` then ``run_train_validation_loop()``.  ``history`` holds
    every step's metrics, ``val_history`` every ``(step, val_loss)`` and,
    under ``profiling``, ``timer_log`` every ``time (ms)`` line's values."""

    # ``max_grad_norm`` when the YAML has none (None: no clip; the VLM
    # recipe clips at 1.0)
    _default_max_grad_norm: Optional[float] = None
    # top-level sections this recipe reads beside ``_SECTIONS``
    _sections = frozenset()
    # trains over a mesh (the VLM recipe does not yet)
    _mesh_ok = True
    # batches survive the zig-zag permutation (the JAX recipe's flag)
    _zigzag_cp_safe = True

    def __init__(self, cfg: ConfigNode):
        self.cfg = cfg
        self.history: List[Dict[str, Any]] = []
        self.val_history: List[tuple] = []
        self.timer_log: List[Dict[str, Any]] = []
        self.last_metrics: Optional[Dict[str, Any]] = None
        self.preempted = False
        self._preempt_saved = False
        self._pending_metrics: Optional[Dict[str, Any]] = None
        self._last_ckpt_step = -1
        self._trace: Optional[Trace] = None

    def setup(self):
        cfg = self.cfg
        check_ported(cfg, self._sections, allow_mesh=self._mesh_ok)
        if cfg.get("compile") is not None and \
                cfg.get("compile.enabled", True) is not False:
            logger.info("compile: the port runs eagerly and keeps no "
                        "compiled program to cache; the section does "
                        "nothing here")
        self.device = resolve_device(cfg.get("device"))
        env = cfg.get("dist_env")
        self.dist_info = initialize_distributed(
            device=self.device,
            **(env.to_dict() if isinstance(env, ConfigNode) else {}))
        if self.device.type == "cuda" and self.dist_info.world_size > 1:
            self.device = torch.device("cuda", self.dist_info.local_rank)
        self.timers = Timers(device=self.device)
        self.profiling = build_profiling_config(cfg.get("profiling"))
        # one run's logger: the main rank's
        self.wandb = build_wandb(cfg) if self.dist_info.is_main else None
        # batch N+1's copy to the card runs here while step N computes
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        rng_cfg = cfg.get("rng")
        if isinstance(rng_cfg, ConfigNode) and "_target_" in rng_cfg.to_dict():
            self.rng = rng_cfg.instantiate()
        else:
            self.rng = StatefulRNG(
                seed=int(cfg.get("rng.seed", 42)),
                ranked=bool(cfg.get("rng.ranked", False)))

        dist_cfg = cfg.get("distributed")
        if isinstance(dist_cfg, ConfigNode) and \
                "_target_" in dist_cfg.to_dict():
            self.mesh_manager = dist_cfg.instantiate()
        else:
            self.mesh_manager = MeshManager(
                **(dist_cfg.to_dict() if isinstance(dist_cfg, ConfigNode)
                   else {}))

        self.model = cfg.get("model").instantiate(
            seed=self.rng.seed_for(_MODEL_INIT_STREAM), device=self.device)
        self._apply_cp_layout_policy()
        self._apply_moe_dispatch_policy()
        self._check_mesh_support()

        # FP8/int8 quantized compute (optional)
        fp8_cfg = cfg.get("fp8")
        if fp8_cfg is not None:
            apply_fp8_to_model(self.model, build_fp8_config(fp8_cfg))

        # PEFT (optional): the base frozen, adapters trainable
        self.peft_config = None
        mask = None
        peft_cfg = cfg.get("peft")
        if isinstance(peft_cfg, ConfigNode):
            self.peft_config = (peft_cfg.instantiate()
                                if "_target_" in peft_cfg.to_dict()
                                else PeftConfig(**peft_cfg.to_dict()))
            self.model, mask = build_lora(
                self.model, self.peft_config,
                seed=self.rng.seed_for(_LORA_INIT_STREAM))
        # parameter freezing, combined with PEFT's mask by AND
        freeze_mask = self._build_freeze_mask()
        if freeze_mask is not None:
            mask = freeze_mask if mask is None else {
                k: bool(v) and bool(freeze_mask[k]) for k, v in mask.items()}
        if mask is not None:
            print_trainable_parameters(self.model)
        load_pretrained_weights(self.model, self.peft_config is not None)
        # the parallel plan: tp slices, then FSDP over the data mesh (a
        # no-op on one process without a group)
        plan = build_parallel_plan(self.model, self.mesh_manager)
        plan.apply(self.model)
        self.plan = plan if plan.distributed else None

        loss_cfg = cfg.get("loss_fn")
        self.loss_fn = (loss_cfg.instantiate()
                        if isinstance(loss_cfg, ConfigNode)
                        and "_target_" in loss_cfg.to_dict()
                        else MaskedCrossEntropy())

        grad_dtype = as_dtype(cfg.get("training.grad_dtype") or "float32")
        opt_cfg = cfg.get("optimizer")
        opt_kwargs = {k: v for k, v in
                      (opt_cfg.to_dict() if opt_cfg is not None else {}).items()
                      if k != "_target_"}
        target = opt_cfg.get("_target_") if opt_cfg is not None else None
        named = list(jax_named_parameters(self.model))
        if isinstance(target, str) and not target.startswith("torch.optim"):
            if self.peft_config is not None and self.peft_config.quantize_base:
                raise ValueError(
                    "peft.quantize_base requires the built-in optimizer "
                    "path (trainable-subtree gradients); a custom "
                    "optimizer._target_ would differentiate the int8 base")
            # custom optimizer factories own their masking, as in JAX
            self.optimizer = resolve_target(target)(
                named, mask=mask, grad_dtype=grad_dtype, **opt_kwargs)
        else:
            max_gn = cfg.get("max_grad_norm", self._default_max_grad_norm)
            if max_gn is not None:
                opt_kwargs.setdefault("grad_clip_norm", float(max_gn))
            if isinstance(target, str):
                # ``torch.optim.AdamW`` is taken as a name, as the JAX
                # builder does
                opt_kwargs.setdefault("name",
                                      target.rsplit(".", 1)[-1].lower())
            self.optimizer = build_optimizer(named, grad_dtype=grad_dtype,
                                             **opt_kwargs)
        if self.plan is not None and hasattr(self.optimizer, "param_names"):
            self.optimizer.plan = self.plan
            self.optimizer.param_names = {
                id(p): n for n, p in self.model.named_parameters()}
        self.step_fns = TrainStep(self.model, self.optimizer, self.loss_fn,
                                  grad_dtype=grad_dtype, plan=self.plan)
        self._shard = (self.step_fns.shard_batch
                       if self.plan is not None and self.plan.cp_size > 1
                       else None)
        self._check_for_nan = bool(cfg.get("training.check_for_nan", True))

        ss_kwargs = (cfg.get("step_scheduler").to_dict()
                     if cfg.get("step_scheduler") is not None else {})
        local_bs = int(ss_kwargs.pop("local_batch_size", 1))
        # the loader yields global microbatches of local_bs x dp rows, of
        # which a rank reads those of its data coordinate (JAX's loader)
        dp = self.mesh_manager.dp_size
        self._host_rows = None
        if self.plan is not None and self.mesh_manager.world_size > 1:
            self._host_rows = process_batch_rows(self.mesh_manager,
                                                 local_bs * dp)
        self._setup_data(local_bs * dp)
        self.step_scheduler = StepScheduler(
            local_batch_size=local_bs, dataloader=self.dataloader,
            dp_size=dp, **ss_kwargs)
        total = self._total_optim_steps(ss_kwargs)
        self.lr_scheduler = build_lr_scheduler(cfg.get("lr_scheduler"),
                                               opt_cfg, total)
        self.checkpoint_config = build_checkpoint_config(
            cfg.get("checkpoint"), is_peft=self.peft_config is not None)
        if self.checkpoint_config.enabled:
            self.load_checkpoint()
        return self

    def _build_freeze_mask(self) -> Optional[Dict[str, bool]]:
        """Apply ``freeze_config`` to the model and return its mask (None
        without the section); the VLM recipe freezes the embeddings by
        default."""
        freeze_cfg = self.cfg.get("freeze_config")
        if freeze_cfg is None:
            return None
        return apply_parameter_freezing(self.model, freeze_cfg)

    def _total_optim_steps(self, ss_kwargs: Dict[str, Any]) -> int:
        """The LR schedule's horizon: ``max_steps``, else epochs x steps
        per epoch (1000 for a loader without a length, as in JAX)."""
        if ss_kwargs.get("max_steps"):
            return int(ss_kwargs["max_steps"])
        sched = self.step_scheduler
        try:
            per_epoch = len(self.dataloader) // sched.grad_acc_steps
        except TypeError:               # an iterable dataset
            logger.warning(
                "lr horizon: no max_steps and the dataloader has no length; "
                "defaulting lr_decay_steps to 1000 -- set "
                "step_scheduler.max_steps or lr_scheduler.lr_decay_steps")
            return 1000
        return max(per_epoch * max(sched.num_epochs, 1), 1)

    def _check_mesh_support(self) -> None:
        """The refusals of a mesh larger than 1: pipeline parallelism
        (raised by the mesh manager), expert parallelism with a MoE model,
        quantized compute and PEFT (a recipe that does not train over a
        mesh yet was refused by ``check_ported``)."""
        mm = self.mesh_manager
        if mm.world_size == 1:
            return
        moe = hasattr(getattr(self.model, "config", None), "moe_dispatch")
        if mm.expert_parallel and moe:
            raise _later("mesh_ep")
        fp8 = self.cfg.get("fp8")
        if (isinstance(fp8, ConfigNode) and fp8.get("enabled", True)
                is not False) or getattr(self.model, "weight_only_quant",
                                         None) == "int8" or \
                self.cfg.get("peft.quantize_base"):
            raise _later("mesh_quant")
        if isinstance(self.cfg.get("peft"), ConfigNode):
            raise _later("mesh_peft")

    def _apply_cp_layout_policy(self) -> None:
        """The cp sequence layout, resolved before the plan (the JAX
        recipe's policy): zig-zag by default when cp > 1, dropped back to
        contiguous for a recipe or model whose batches do not survive the
        permutation unless the YAML asked for zig-zag."""
        mm = self.mesh_manager
        if mm.cp_size <= 1:
            return
        from automodel_tpu_torch.ops.zigzag import normalize_cp_layout

        explicit = normalize_cp_layout(
            self.cfg.get("distributed.cp_layout")) is not None
        safe = (self._zigzag_cp_safe
                and getattr(self.model, "zigzag_cp_safe", True))
        if mm.cp_layout == "zigzag" and not safe and not explicit:
            logger.warning(
                "cp=%d: dropping the default zig-zag sequence layout back "
                "to contiguous — %s/%s consumes the token stream in "
                "sequence order (set distributed.cp_layout: zigzag to "
                "force it)", mm.cp_size, type(self).__name__,
                type(self.model).__name__)
            mm.cp_layout = "contiguous"
        if self.dist_info.is_main:
            logger.info("context parallelism: cp=%d, sequence layout %r",
                        mm.cp_size, mm.cp_layout)

    def _apply_moe_dispatch_policy(self) -> None:
        """Thread the top-level ``moe.dispatch`` knob (``sorted`` |
        ``onehot``; checked at config load) into the model config; on a
        model without routed experts it raises instead of doing nothing."""
        dispatch = validate_moe_dispatch(
            normalize_moe_dispatch(self.cfg.get("moe.dispatch")))
        if dispatch is None:
            return
        model_cfg = getattr(self.model, "config", None)
        if not hasattr(model_cfg, "moe_dispatch"):
            raise ValueError(
                f"moe.dispatch={dispatch!r} set but "
                f"{type(self.model).__name__} has no routed-expert block "
                "(no model.config.moe_dispatch): remove the knob or pick an "
                "MoE model family")
        model_cfg.moe_dispatch = dispatch
        logger.info("MoE expert dispatch: %s", dispatch)

    def _setup_data(self, batch_size: int) -> None:
        cfg = self.cfg
        self.tokenizer = build_tokenizer(cfg, self.model)
        dataset = build_dataset(cfg.get("dataset"), self.tokenizer)
        # unpacked rows pad to multiples of 128, and the training input
        # runs the async pipeline two batches deep, unless the YAML says
        # otherwise (the JAX recipe's defaults)
        if (not int(cfg.get("packed_sequence.packed_sequence_size", 0) or 0)
                and cfg.get("dataloader.pad_seq_len_divisible") is None):
            cfg.set_by_dotted("dataloader.pad_seq_len_divisible", 128)
        if cfg.get("dataloader.prefetch_depth") is None:
            cfg.set_by_dotted("dataloader.prefetch_depth", 2)
        rows = getattr(self, "_host_rows", None)
        self.dataloader = build_dataloader(cfg, dataset, "dataloader",
                                           batch_size, self.rng.seed,
                                           host_rows=rows)
        self.val_dataloader = None
        if cfg.get("validation_dataset") is not None:
            val_ds = build_dataset(cfg.get("validation_dataset"),
                                   self.tokenizer)
            if cfg.get("validation_dataloader.pad_seq_len_divisible") is None:
                cfg.set_by_dotted(
                    "validation_dataloader.pad_seq_len_divisible", 128)
            self.val_dataloader = build_dataloader(
                cfg, val_ds, "validation_dataloader", batch_size,
                self.rng.seed, host_rows=rows)

    # -- hot loop ------------------------------------------------------------
    def _check_host_batches(self, batches) -> None:
        """Checks of a group of collated microbatches on the host, before
        they go to the device (none here; the VLM recipe holds the image
        grids against the model's)."""

    def _run_train_optim_step(self, batches) -> Optional[Dict[str, Any]]:
        """Dispatch one optimizer step and return the newest finalized
        metrics without waiting for the card: step N's are read once step
        N+1 has been dispatched (``flush_metrics`` drains the last).  The
        first step after a start or a flush is read at once (one wait).

        A group the async loop staged (``_staged_input``: its device batch
        and the loader's resume snapshot) was copied on the copy stream
        while the previous step ran; its snapshot is committed right after
        dispatch, so a checkpoint holds the state of the last group
        trained on.  Direct callers stage inline."""
        num_tokens, _ = count_tokens(batches)
        prof = self.profiling
        self._profile_trace_window()
        self.lr_scheduler.step(1)
        set_hyperparams(self.optimizer, lr=self.lr_scheduler.current_lr,
                        wd=self.lr_scheduler.current_wd)
        if self.peft_config is not None:
            self.model.set_dropout_step(self.step_scheduler.step)
        staged = self.__dict__.pop("_staged_input", None)
        if staged is None:
            self._check_host_batches(batches)
            with self.timers.record("data_staging"):
                batch = to_device_batch(batches, self.device,
                                        shard=getattr(self, "_shard", None))
            dl_state = None
        else:
            batch, dl_state = staged
            use_staged(batch, self._copy_stream)
        t0 = time.perf_counter()
        if prof.enabled and prof.barrier:
            # measurement mode: the step's latency, overlap given up
            with self.timers.record("step_e2e", barrier=True):
                values = self.step_fns.dispatch(batch)
        else:
            with self.timers.record("dispatch"):
                values = self.step_fns.dispatch(batch)
        if dl_state is not None:
            # this group is consumed: a checkpoint from here on resumes at
            # the group after it
            self.dataloader.commit_state(dl_state)
        pending = {"values": MetricsCopy(values),
                   "step": self.step_scheduler.step,
                   "lr": self.lr_scheduler.current_lr,
                   "num_tokens": num_tokens, "t_dispatch": t0}
        prev, self._pending_metrics = self._pending_metrics, pending
        if prev is not None and not prev.get("reported"):
            # the previous step took until this one's dispatch began
            prev["t_end"] = t0
            self.last_metrics = self._finalize_metrics(prev)
        elif prev is None:
            self.last_metrics = self._finalize_metrics(pending)
            pending["reported"] = True
        return self.last_metrics

    def _finalize_metrics(self, pending) -> Dict[str, Any]:
        """Read a dispatched step's metrics (waiting for its copy only),
        check them for NaN, log them and append them to ``history``.  The
        step's time runs from its dispatch to the next step's, or to now
        when no step follows it."""
        metrics = unpack_metrics(pending["values"].read())
        dt = (pending.get("t_end") or time.perf_counter()) \
            - pending["t_dispatch"]
        if self._check_for_nan and not (np.isfinite(metrics["loss"])
                                        and np.isfinite(metrics["grad_norm"])):
            raise FloatingPointError(
                f"non-finite training signal at step {pending['step']}: "
                f"loss={metrics['loss']}, grad_norm={metrics['grad_norm']} "
                "(set training.check_for_nan: false to continue anyway)")
        out = dict(metrics, lr=pending["lr"], step=pending["step"],
                   tps=pending["num_tokens"] / dt, step_time=dt)
        if self.device.type == "cuda":
            out["peak_memory_gb"] = torch.cuda.max_memory_allocated(
                self.device) / 1024 ** 3
        self.history.append(out)
        logger.info(
            "step %d | loss %.4f | grad_norm %.3f | lr %.2e | tps %.0f | "
            "tokens %d", out["step"], out["loss"], out["grad_norm"],
            out["lr"], out["tps"], out["num_label_tokens"])
        if self.wandb is not None:
            self.wandb.log(out, step=out["step"])
        return out

    def flush_metrics(self) -> Optional[Dict[str, Any]]:
        """Finalize the step in flight (before validation, a checkpoint,
        the epoch's and the loop's end)."""
        pending = self._pending_metrics
        if pending is not None:
            if not pending.get("reported"):
                self.last_metrics = self._finalize_metrics(pending)
            self._pending_metrics = None
        return self.last_metrics

    def _profile_trace_window(self) -> None:
        """A ``torch.profiler`` window over the optimizer steps
        ``[trace_start_step, trace_stop_step)`` into ``trace_dir``."""
        prof = self.profiling
        if not (prof.enabled and prof.trace_dir):
            return
        step = self.step_scheduler.step
        if (self._trace is None
                and prof.trace_start_step <= step < prof.trace_stop_step):
            self._trace = Trace(prof.trace_dir)
        elif self._trace is not None and step >= prof.trace_stop_step:
            self.flush_metrics()       # close on finished device work
            self._stop_trace()

    def _stop_trace(self) -> None:
        if self._trace is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            path = self._trace.stop()
            self._trace = None
            logger.info("profiler trace written to %s", path)

    def _timed_iter(self, iterable):
        """Yield from the step scheduler, timing the wait for each group
        (``data_wait``)."""
        it = iter(iterable)
        while True:
            t = self.timers("data_wait")
            t.start()
            try:
                batches = next(it)
            except StopIteration:
                t.discard()
                return
            t.stop()
            yield batches

    def _run_validation_epoch(self) -> Optional[float]:
        """Token-weighted mean loss over the validation set, summed on the
        device and read once at the end."""
        if self.val_dataloader is None:
            return None
        total = None
        for vb in self.val_dataloader:
            self._check_host_batches([vb])
            m = self.step_fns.eval_dispatch(
                to_device_batch([vb], self.device,
                                shard=getattr(self, "_shard", None))).double()
            wl = torch.stack([m[0] * m[1].clamp(min=1.0), m[1]])
            total = wl if total is None else total + wl
        if total is None:
            return None
        loss, tokens = total.tolist()
        return loss / max(tokens, 1.0)

    def run_train_validation_loop(self):
        """Train to ``max_steps`` (or the last epoch), validating and
        checkpointing on the step scheduler's cadence.  SIGTERM / SIGINT
        take a checkpoint at the next step boundary and return with
        ``preempted`` set; an asynchronous save still in flight is joined
        before this returns."""
        sched = self.step_scheduler
        self.preempted = False
        self._prof_window_t0 = time.perf_counter()
        try:
            with DistributedSignalHandler(
                    (signal.SIGTERM, signal.SIGINT)) as preempt:
                self._train_epochs(sched, preempt)
        except BaseException:
            self._stop_trace()
            self.join_pending_save(raise_error=False)
            raise
        self.join_pending_save()
        if self.preempted:
            logger.warning(
                "preemption (%s) handled at step %d: %s, exiting cleanly",
                get_signal_name(preempt.received_signal or preempt.sig),
                sched.step,
                "checkpoint saved" if self._preempt_saved
                else "checkpointing disabled, nothing saved")
        return self

    def _train_epochs(self, sched, preempt) -> None:
        # the async loop needs the loader's consumed-state contract
        # (datasets/prefetch.py); a bare loader takes the synchronous one
        async_input = hasattr(self.dataloader, "commit_state")
        for epoch in sched.epochs:
            self.dataloader.set_epoch(epoch)
            run_epoch = (self._run_epoch_async if async_input
                         else self._run_epoch_sync)
            if run_epoch(sched, epoch, preempt):
                return
            self.flush_metrics()
            # the epoch's end (a partial last group never yields)
            if (self.checkpoint_config.enabled and sched.is_ckpt_step
                    and self._last_ckpt_step != sched.step):
                self.save_checkpoint(epoch, sched.step)
                self._last_ckpt_step = sched.step
            if sched.finished:
                break
        self._stop_trace()

    def _pull_staged(self, groups):
        """Pull the next group and start its copy to the card (the copy
        stream), while the step before it computes -> ``(batches,
        device_batch, dl_state)`` or None at the end; ``dl_state`` is
        committed only when the group is dispatched."""
        try:
            batches = next(groups)
        except StopIteration:
            return None
        dl_state = self.dataloader.pending_state()
        self._check_host_batches(batches)
        with self.timers.record("data_staging_overlap"):
            device_batch = stage_batch(batches, self.device,
                                       self._copy_stream,
                                       shard=getattr(self, "_shard", None))
        return batches, device_batch, dl_state

    def _run_epoch_async(self, sched, epoch, preempt) -> bool:
        """One epoch with batch N+1 staged while step N runs.  The step's
        cadence flags are read before the lookahead pull (which advances
        ``sched.step``), and the scheduler is held at the dispatched step
        during the bookkeeping, so a checkpoint there saves the step that
        ran; on preemption it stays there.  True when preempted."""
        groups = self._timed_iter(sched)
        try:
            staged = self._pull_staged(groups)
            while staged is not None:
                batches, device_batch, dl_state = staged
                self._staged_input = (device_batch, dl_state)
                self._run_train_optim_step(batches)
                step, is_val, is_ckpt = (sched.step, sched.is_val_step,
                                         sched.is_ckpt_step)
                staged = self._pull_staged(groups)
                # inside this window use step / is_val / is_ckpt, not the
                # scheduler's live properties (one group ahead)
                lookahead_step, sched.step = sched.step, step
                preempted = False
                try:
                    preempted = self._post_step(epoch, step, is_val,
                                                is_ckpt, preempt)
                finally:
                    if not preempted:
                        sched.step = lookahead_step
                if preempted:
                    return True
        finally:
            # unwind scheduler -> loader -> producer thread (the loader
            # rewinds to the last group yielded)
            groups.close()
        return False

    def _run_epoch_sync(self, sched, epoch, preempt) -> bool:
        """One epoch staging each group before its dispatch
        (``prefetch_depth: 0``).  True when preempted."""
        for batches in self._timed_iter(sched):
            self._run_train_optim_step(batches)
            if self._post_step(epoch, sched.step, sched.is_val_step,
                               sched.is_ckpt_step, preempt):
                return True
        return False

    def _post_step(self, epoch, step, is_val, is_ckpt, preempt) -> bool:
        """Bookkeeping after a dispatch: the timers' line, validation,
        checkpointing and the preemption poll (the step's metrics are
        logged when they are read, one step later).  True when a
        preemption was handled."""
        prof = self.profiling
        if prof.enabled and step % prof.log_interval == 0:
            self._log_timers(step)
        if is_val:
            self.flush_metrics()
            val_loss = self._run_validation_epoch()
            if val_loss is not None:
                self.val_history.append((step, val_loss))
                logger.info("step %d | val_loss %.4f", step, val_loss)
                if self.wandb is not None:
                    self.wandb.log({"val_loss": val_loss}, step=step)
        if is_ckpt and self.checkpoint_config.enabled:
            # the NaN guard of the step in flight runs before its weights
            # are saved
            self.flush_metrics()
            self.save_checkpoint(epoch, step)
            self._last_ckpt_step = step
        if preempt is not None and preempt.signals_received():
            self.flush_metrics()
            saved = False
            if (self.checkpoint_config.enabled
                    and self._last_ckpt_step != step):
                # a failed grace-window save leaves only a staging dir:
                # the last committed checkpoint is what a resume finds
                try:
                    self.save_checkpoint(epoch, step)
                    self.join_pending_save()
                    self._last_ckpt_step = step
                    saved = True
                except Exception:
                    logger.exception(
                        "preemption checkpoint at step %d failed; resume "
                        "will use the last committed checkpoint", step)
            else:
                try:
                    self.join_pending_save()
                except Exception:
                    self._last_ckpt_step = -1
                    logger.exception(
                        "in-flight background checkpoint failed during "
                        "preemption handling; resume will use the last "
                        "committed checkpoint")
            self._preempt_saved = saved or self._last_ckpt_step == step
            self.preempted = True
            self._stop_trace()
            return True
        return False

    def _log_timers(self, step: int) -> None:
        """The ``time (ms)`` line: each timer's ms per step over the last
        ``log_interval`` steps, the checkpoint stall's and the input's
        share of the window's wall time."""
        n = self.profiling.log_interval
        elapsed = self.timers.get_elapsed(reset=True, normalizer=n)
        now = time.perf_counter()
        window, self._prof_window_t0 = now - self._prof_window_t0, now
        if not elapsed:
            return
        total = {k: v * n for k, v in elapsed.items()}
        stall = ckpt_stall_fraction(total, window)
        idle = input_idle_fraction(total, window)
        logger.info(
            "step %d | time (ms)%s%s | input_idle_fraction: %.4f", step,
            "".join(f" | {k}: {v * 1e3:.2f}" for k, v in elapsed.items()),
            (f" | ckpt_stall_fraction: {stall:.4f}"
             if "ckpt_stall" in elapsed else ""), idle)
        self.timer_log.append(dict(step=step, window_s=window,
                                   ms_per_step={k: v * 1e3 for k, v in
                                                elapsed.items()},
                                   ckpt_stall_fraction=stall,
                                   input_idle_fraction=idle))
        if self.wandb is not None:
            log = {f"timers/{k}": v for k, v in elapsed.items()}
            log["timers/ckpt_stall_fraction"] = stall
            log["timers/input_idle_fraction"] = idle
            self.wandb.log(log, step=step)


def main(config_path: Optional[str] = None, argv=None):
    """CLI entry: ``-c <yaml>`` plus dotted ``--a.b value`` overrides."""
    logging.basicConfig(level=logging.INFO)
    cfg = parse_args_and_load_config(argv, default_config=config_path)
    recipe = TrainFinetuneRecipeForNextTokenPrediction(cfg)
    recipe.setup()
    recipe.run_train_validation_loop()
    return recipe


if __name__ == "__main__":
    main()
