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
``device: cpu``).  The hot loop is eager PyTorch
(``training/train_step.py``): stack the microbatches, move them to the
device, one forward/backward per microbatch, one optimizer step, then log
``loss``, ``grad_norm``, ``lr``, tokens/s and the peak device memory.

The losses are the JAX package's: ``MaskedCrossEntropy`` (default),
``ChunkedCrossEntropy`` and ``FusedLinearCrossEntropy`` (the bench YAML's;
on the card its LM head and CE run through the hand-written linear-CE
kernels, and no ``[T, V]`` logits tensor exists).  The model families are
``models/auto_model.py``'s: Llama, and the MoE families Mixtral and
Qwen3-MoE, whose expert FFNs run through the grouped-matmul kernels on the
card and whose load-balancing loss the train step folds into each
microbatch's loss.

``dataloader.prefetch_depth > 0`` wraps the loaders in the async input
pipeline (``datasets/prefetch.py``): a producer thread reads and collates
the next batches while the card runs; host-to-device copies stay on the
training thread.  Each step takes the loader's pending resume snapshot
before it runs and commits it when it is done, as the JAX recipe does.

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

Left out of this slice, each raising ``NotImplementedError`` when its
knob is set (ROADMAP Queue 1 names where each lands): other checkpoint
formats and PEFT checkpoints, pipeline / tensor / context / data
parallelism, PEFT, kernel autotuning, remat policies other than
``nothing_saveable``, gradient clipping, freezing, profiling, elastic
recovery and W&B logging.

    python -m automodel_tpu_torch.recipes.llm.train_ft \\
        -c automodel_tpu_torch/examples/tiny_llama_sft.yaml --device cpu
"""

from __future__ import annotations

import logging
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
    translate_target,
)
from automodel_tpu_torch.datasets.dataloader import StatefulDataLoader
from automodel_tpu_torch.datasets.llm.packed_sequence import PackedSequence
from automodel_tpu_torch.datasets.prefetch import wrap_prefetch
from automodel_tpu_torch.loss.masked_ce import IGNORE_INDEX, MaskedCrossEntropy
from automodel_tpu_torch.models.llama import as_dtype
from automodel_tpu_torch.ops.moe import (
    normalize_moe_dispatch,
    validate_moe_dispatch,
)
from automodel_tpu_torch.optim.builder import build_optimizer, set_hyperparams
from automodel_tpu_torch.optim.scheduler import OptimizerParamScheduler
from automodel_tpu_torch.quantization.fp8 import (
    apply_fp8_to_model,
    build_fp8_config,
)
from automodel_tpu_torch.recipes.base_recipe import BaseRecipe
from automodel_tpu_torch.training.rng import StatefulRNG
from automodel_tpu_torch.training.step_scheduler import StepScheduler
from automodel_tpu_torch.training.train_step import TrainStep, to_device_batch
from automodel_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

_MODEL_INIT_STREAM = 0      # rng stream of the weight init

# Top-level sections the port reads; ``dist_env`` is accepted and unused
# (one process).  Any other section raises.
_SECTIONS = {
    "step_scheduler", "dist_env", "rng", "model", "checkpoint",
    "distributed", "loss_fn", "dataset", "packed_sequence", "dataloader",
    "validation_dataset", "validation_dataloader", "optimizer",
    "lr_scheduler", "training", "device", "compile", "kernels", "moe",
    "fp8",
}
_LATER = {
    "checkpoint_format": "Orbax / non-consolidated checkpoints (ROADMAP "
                         "Queue 1 item 7)",
    "peft": "PEFT (ROADMAP Queue 1 item 8)",
    "pipeline": "pipeline parallelism (ROADMAP Queue 1 item 12)",
    "distributed": "multi-GPU (ROADMAP Queue 1 item 9)",
    "autotune": "kernel block-size autotuning (ROADMAP Queue 1 item 3; "
                "the kernels run their hand-chosen tiles)",
}


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with {_LATER[what]}")


def check_ported(cfg: ConfigNode) -> None:
    """Raise ``NotImplementedError`` on any knob this slice does not port,
    instead of training without it."""
    for name in sorted(set(cfg.to_dict()) - _SECTIONS):
        node = cfg.get(name)
        if isinstance(node, ConfigNode) and node.get("enabled") is False:
            continue                      # e.g. ``fp8: {enabled: false}``
        if name in _LATER:
            raise _later(name)
        raise NotImplementedError(
            f"config section {name!r} is not ported by the PyTorch port's "
            f"SFT recipe (it reads {sorted(_SECTIONS)})")
    ck = build_checkpoint_config(cfg.get("checkpoint"))
    if ck.enabled and (ck.model_save_format != "safetensors"
                       or not ck.save_consolidated):
        raise _later("checkpoint_format")
    for axis in ("dp_size", "dp_replicate_size", "dcn_dp_size", "tp_size",
                 "cp_size", "pp_size"):
        if cfg.get(f"distributed.{axis}") not in (None, 1):
            raise _later("distributed")
    if cfg.get("distributed.sequence_parallel"):
        raise _later("distributed")
    # YAML 1.1 reads ``off`` / ``on`` as booleans
    if cfg.get("kernels.autotune") not in (None, False, "off", "none"):
        raise _later("autotune")


def count_tokens(batches: List[Dict[str, np.ndarray]]) -> int:
    """Tokens of the microbatches without each row's tail padding (the
    run of trailing ignore labels)."""
    total = 0
    for b in batches:
        labels = np.asarray(b["labels"])
        tail = np.cumprod(labels[..., ::-1] == IGNORE_INDEX, axis=-1)
        total += labels.size - int(tail.sum())
    return total


def build_dataloader(cfg: ConfigNode, dataset, cfg_key: str,
                     batch_size: int, seed: int):
    """Dataset (+ packing when ``packed_sequence.packed_sequence_size`` >
    0) -> loader built from ``cfg[cfg_key]``, wrapped in the async input
    pipeline when its ``prefetch_depth`` is > 0."""
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
    every step's metrics and ``val_history`` every ``(step, val_loss)``."""

    def __init__(self, cfg: ConfigNode):
        self.cfg = cfg
        self.history: List[Dict[str, Any]] = []
        self.val_history: List[tuple] = []

    def setup(self):
        cfg = self.cfg
        check_ported(cfg)
        if cfg.get("compile") is not None and \
                cfg.get("compile.enabled", True) is not False:
            logger.info("compile: the port runs eagerly and keeps no "
                        "compiled program to cache; the section does "
                        "nothing here")
        self.device = resolve_device(cfg.get("device"))
        rng_cfg = cfg.get("rng")
        if isinstance(rng_cfg, ConfigNode) and "_target_" in rng_cfg.to_dict():
            self.rng = rng_cfg.instantiate()
        else:
            self.rng = StatefulRNG(
                seed=int(cfg.get("rng.seed", 42)),
                ranked=bool(cfg.get("rng.ranked", False)))

        self.model = cfg.get("model").instantiate(
            seed=self.rng.seed_for(_MODEL_INIT_STREAM), device=self.device)
        self._apply_moe_dispatch_policy()

        # FP8/int8 quantized compute (optional)
        fp8_cfg = cfg.get("fp8")
        if fp8_cfg is not None:
            apply_fp8_to_model(self.model, build_fp8_config(fp8_cfg))

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
        if isinstance(target, str):
            # ``torch.optim.AdamW`` is taken as a name, as the JAX builder
            # does
            opt_kwargs.setdefault(
                "name", translate_target(target).rsplit(".", 1)[-1].lower())
        self.optimizer = build_optimizer(self.model.named_parameters(),
                                         grad_dtype=grad_dtype, **opt_kwargs)
        self.step_fns = TrainStep(self.model, self.optimizer, self.loss_fn,
                                  grad_dtype=grad_dtype)
        self._check_for_nan = bool(cfg.get("training.check_for_nan", True))

        ss_kwargs = (cfg.get("step_scheduler").to_dict()
                     if cfg.get("step_scheduler") is not None else {})
        local_bs = int(ss_kwargs.pop("local_batch_size", 1))
        self._setup_data(local_bs)
        self.step_scheduler = StepScheduler(
            local_batch_size=local_bs, dataloader=self.dataloader,
            **ss_kwargs)
        total = (int(ss_kwargs["max_steps"]) if ss_kwargs.get("max_steps")
                 else max(len(self.dataloader)
                          // self.step_scheduler.grad_acc_steps
                          * max(self.step_scheduler.num_epochs, 1), 1))
        self.lr_scheduler = build_lr_scheduler(cfg.get("lr_scheduler"),
                                               opt_cfg, total)
        self.checkpoint_config = build_checkpoint_config(
            cfg.get("checkpoint"))
        if self.checkpoint_config.enabled:
            self.load_checkpoint()
        return self

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
        dataset = cfg.get("dataset").instantiate()
        # unpacked rows pad to multiples of 128, as in the JAX recipe
        if (not int(cfg.get("packed_sequence.packed_sequence_size", 0) or 0)
                and cfg.get("dataloader.pad_seq_len_divisible") is None):
            cfg.set_by_dotted("dataloader.pad_seq_len_divisible", 128)
        self.dataloader = build_dataloader(cfg, dataset, "dataloader",
                                           batch_size, self.rng.seed)
        self.val_dataloader = None
        if cfg.get("validation_dataset") is not None:
            val_ds = cfg.get("validation_dataset").instantiate()
            if cfg.get("validation_dataloader.pad_seq_len_divisible") is None:
                cfg.set_by_dotted(
                    "validation_dataloader.pad_seq_len_divisible", 128)
            self.val_dataloader = build_dataloader(
                cfg, val_ds, "validation_dataloader", batch_size,
                self.rng.seed)

    def _run_train_optim_step(self, batches) -> Dict[str, Any]:
        """One optimizer step over the grad-accumulation group; returns its
        metrics (fetched at the end of the step: one sync)."""
        num_tokens = count_tokens(batches)
        # resume point after this group, committed once its step has run
        dl_state = (self.dataloader.pending_state()
                    if hasattr(self.dataloader, "pending_state") else None)
        self.lr_scheduler.step(1)
        set_hyperparams(self.optimizer, lr=self.lr_scheduler.current_lr,
                        wd=self.lr_scheduler.current_wd)
        t0 = time.perf_counter()
        metrics = self.step_fns.train_step(to_device_batch(batches,
                                                           self.device))
        dt = time.perf_counter() - t0
        if dl_state is not None:
            self.dataloader.commit_state(dl_state)
        if self._check_for_nan and not (np.isfinite(metrics["loss"])
                                        and np.isfinite(metrics["grad_norm"])):
            raise FloatingPointError(
                f"non-finite training signal at step "
                f"{self.step_scheduler.step}: loss={metrics['loss']}, "
                f"grad_norm={metrics['grad_norm']}")
        out = dict(metrics, lr=self.lr_scheduler.current_lr,
                   step=self.step_scheduler.step, tps=num_tokens / dt,
                   step_time=dt)
        if self.device.type == "cuda":
            out["peak_memory_gb"] = torch.cuda.max_memory_allocated(
                self.device) / 1024 ** 3
        self.history.append(out)
        return out

    def _run_validation_epoch(self) -> Optional[float]:
        """Token-weighted mean loss over the validation set."""
        if self.val_dataloader is None:
            return None
        loss_sum = tokens = 0.0
        for vb in self.val_dataloader:
            m = self.step_fns.eval_step(to_device_batch([vb], self.device))
            loss_sum += m["loss"] * max(m["num_label_tokens"], 1)
            tokens += m["num_label_tokens"]
        return loss_sum / max(tokens, 1.0)

    def run_train_validation_loop(self):
        """Train to ``max_steps`` (or the last epoch), validating and
        checkpointing on the step scheduler's cadence; an asynchronous save
        still in flight is joined before this returns."""
        sched = self.step_scheduler
        saving = self.checkpoint_config.enabled
        try:
            for epoch in sched.epochs:
                self.dataloader.set_epoch(epoch)
                for batches in sched:
                    m = self._run_train_optim_step(batches)
                    logger.info(
                        "step %d | loss %.4f | grad_norm %.3f | lr %.2e | "
                        "tps %.0f | tokens %d", m["step"], m["loss"],
                        m["grad_norm"], m["lr"], m["tps"],
                        m["num_label_tokens"])
                    if sched.is_val_step:
                        val_loss = self._run_validation_epoch()
                        if val_loss is not None:
                            self.val_history.append((sched.step, val_loss))
                            logger.info("step %d | val_loss %.4f",
                                        sched.step, val_loss)
                    if saving and sched.is_ckpt_step:
                        self.save_checkpoint(epoch, sched.step)
                        self._last_ckpt_step = sched.step
                # the epoch's end (a partial last group never yields)
                if (saving and sched.is_ckpt_step
                        and getattr(self, "_last_ckpt_step", -1)
                        != sched.step):
                    self.save_checkpoint(epoch, sched.step)
                    self._last_ckpt_step = sched.step
                if sched.finished:
                    break
        except BaseException:
            self.join_pending_save(raise_error=False)
            raise
        self.join_pending_save()
        return self


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
