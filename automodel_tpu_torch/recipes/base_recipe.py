"""Checkpoint save, resume and the asynchronous committer of the recipes
(counterpart: ``automodel_tpu/recipes/base_recipe.py``).

A save writes, into ``epoch_{e}_step_{s}.tmp`` and then commits
(``checkpoint/checkpointing.py``): the model as a consolidated HF
safetensors repo under ``model/``, the optimizer state (``step``, ``mu``,
``nu`` of ``optim/builder.py::OptaxAdam``) and the LR schedule under
``optim/``, one ``<key>.pt`` per tracked host-side object (the RNG, the
step scheduler's position, the training loader's consumed position) and
``config.yaml``; then retention GC, never deleting the checkpoint the run
resumed from.

``checkpoint.async_save`` (the default, as in JAX): the training loop only
waits for a host snapshot -- the HF tensors, the optimizer state and every
state dict copied to the CPU -- and one background thread runs stage,
write, commit and GC from it while training goes on.  At most one save is
in flight: the next save, a resume and the end of the loop join it first,
and a background failure surfaces there as ``CheckpointSaveError``.
``checkpoint.replicate_to_peers`` pushes nothing: the JAX package pushes a
replica only to a peer slice (``dcn_dp_size >= 2``), and the port runs
one process.

With PEFT (``checkpoint.is_peft``, set by the recipe) ``model/`` holds
the adapters only, in the HF-PEFT format (``peft/lora.py::
save_adapters``), as in the JAX package; the optimizer state covers the
adapters alone, and a resume restores the adapters into the base that
set-up rebuilt from the init seed.

``load_checkpoint`` resumes from ``checkpoint.restore_from`` or the newest
committed checkpoint of ``checkpoint_dir``; the manifest is verified
before any state is touched.  ``ckpt_timings`` records each save's loop
stall and background commit time in seconds and its bytes; a recipe with
``timers`` (``training/timers.py``) also times them as ``ckpt_stall`` and
``ckpt_background``.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from automodel_tpu_torch.checkpoint import checkpointing as ckpt
from automodel_tpu_torch.config.loader import dump_yaml_config
from automodel_tpu_torch.models.hf_io import (
    hf_state,
    load_hf_weights,
    save_hf_weights,
)
from automodel_tpu_torch.peft.lora import (
    adapter_state,
    load_adapters,
    save_adapters,
)

logger = logging.getLogger(__name__)

# host-side objects saved as ``<key>.pt`` (the JAX recipe's attribute
# names); validation loaders are not saved, as in JAX
TRACKED_STATE = ("rng", "step_scheduler", "dataloader")


def _to_cpu(obj: Any) -> Any:
    """A deep copy of a (nested) state dict with every tensor on the CPU."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return copy.deepcopy(obj)


def checkpoint_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


class _SaveJob:
    """What one save writes: live objects (inline save) or their host
    snapshot (asynchronous save)."""

    def __init__(self, *, epoch, step, final, cfg, model, model_state,
                 optimizer, scheduler, host_state, config, resumed_from):
        self.epoch, self.step, self.final, self.cfg = epoch, step, final, cfg
        self.model, self.model_state = model, model_state
        self.optimizer, self.scheduler = optimizer, scheduler
        self.host_state = host_state
        self.config = config
        self.resumed_from = resumed_from


class BaseRecipe:
    """Save / resume for a recipe that sets ``checkpoint_config``,
    ``model``, ``optimizer``, ``lr_scheduler`` (None: a constant LR, not
    saved), ``cfg`` and the objects named in ``tracked_state``."""

    _inflight_save: Optional[Dict[str, Any]] = None
    _resumed_from: Optional[str] = None
    lr_scheduler = None
    # attribute names of the host-side objects saved as ``<key>.pt``
    tracked_state = TRACKED_STATE

    def _record_timer(self, name: str):
        timers = getattr(self, "timers", None)
        if timers is None:
            return contextlib.nullcontext()
        return timers.record(name)

    def _is_main(self) -> bool:
        info = getattr(self, "dist_info", None)
        return info is None or info.is_main

    def _barrier(self) -> None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and \
                dist.get_world_size() > 1:
            dist.barrier()

    def _model_state(self):
        """The model's HF tensors on the host: over a mesh gathered from
        the shards (a collective call; ``plan.full_params``)."""
        plan = getattr(self, "plan", None)
        if plan is None:
            return (adapter_state(self.model)
                    if self.checkpoint_config.is_peft
                    else hf_state(self.model))
        with plan.full_params(self.model):
            return hf_state(self.model)

    def _tracked(self) -> List[tuple]:
        return [(k, getattr(self, k)) for k in self.tracked_state
                if getattr(self, k, None) is not None]

    # -- save ---------------------------------------------------------------
    def save_checkpoint(self, epoch: int, step: int) -> str:
        """Save (inline) or snapshot and hand to the committer (async);
        returns the final path the commit lands at.  The time it blocks
        the loop is the ``ckpt_stall`` timer."""
        cfg = self.checkpoint_config
        if not cfg.enabled:
            return ""
        with self._record_timer("ckpt_stall"):
            return self._save_checkpoint(epoch, step, cfg)

    def _save_checkpoint(self, epoch: int, step: int, cfg) -> str:
        t0 = time.perf_counter()
        self.join_pending_save()
        final = os.path.join(cfg.checkpoint_dir,
                             ckpt.checkpoint_dir_name(epoch, step))
        config = copy.deepcopy(self.cfg.to_dict())
        # over a mesh every rank gathers (collectives) and rank 0 writes
        sharded = getattr(self, "plan", None) is not None
        if not cfg.async_save:
            job = _SaveJob(
                epoch=epoch, step=step, final=final, cfg=cfg,
                model=self.model,
                model_state=self._model_state() if sharded else None,
                optimizer=self.optimizer.state_dict(),
                scheduler=self._scheduler_state(),
                host_state=[(k, o.state_dict()) for k, o in self._tracked()],
                config=config, resumed_from=self._resumed_from)
            if self._is_main():
                self._run_commit_protocol(job)
            self._barrier()
            stall = time.perf_counter() - t0
            self._record_save(final, stall, stall)
            return final
        job = _SaveJob(
            epoch=epoch, step=step, final=final, cfg=cfg, model=self.model,
            model_state=self._model_state(),
            optimizer=_to_cpu(self.optimizer.state_dict()),
            scheduler=_to_cpu(self._scheduler_state()),
            host_state=[(k, _to_cpu(o.state_dict()))
                        for k, o in self._tracked()],
            config=config, resumed_from=self._resumed_from)
        if not self._is_main():
            return final
        holder: Dict[str, Any] = {"final": final, "error": None}
        thread = threading.Thread(target=self._commit_in_background,
                                  args=(job, holder),
                                  name="automodel-ckpt-committer",
                                  daemon=False)
        holder["thread"] = thread
        self._inflight_save = holder
        thread.start()
        holder["stall_s"] = time.perf_counter() - t0
        logger.info("checkpoint %s dispatched to the background committer",
                    final)
        return final

    def _scheduler_state(self) -> Optional[Dict[str, Any]]:
        return (None if self.lr_scheduler is None
                else self.lr_scheduler.state_dict())

    def _record_save(self, final: str, stall_s: float,
                     background_s: float) -> None:
        timings = getattr(self, "ckpt_timings", None)
        if timings is None:
            timings = self.ckpt_timings = []
        timings.append({"path": final, "stall_s": stall_s,
                        "background_s": background_s,
                        "bytes": checkpoint_bytes(final)})

    def _commit_in_background(self, job: _SaveJob, holder: Dict) -> None:
        t0 = time.perf_counter()
        try:
            with self._record_timer("ckpt_background"):
                self._run_commit_protocol(job)
        except BaseException as e:          # surfaced at the next join
            holder["error"] = e
            logger.exception("background checkpoint commit of %s failed",
                             job.final)
        holder["background_s"] = time.perf_counter() - t0

    def join_pending_save(self, raise_error: bool = True) -> Optional[str]:
        """Wait for the in-flight background save, if any; its final path.
        Its failure re-raises here as ``CheckpointSaveError`` (logged
        instead with ``raise_error=False``)."""
        holder = self._inflight_save
        if holder is None:
            return None
        holder["thread"].join()
        self._inflight_save = None
        err = holder.get("error")
        if err is None:
            self._record_save(holder["final"], holder["stall_s"],
                              holder["background_s"])
            return holder["final"]
        if not raise_error:
            logger.error("suppressing background checkpoint failure of %s: "
                         "%s", holder["final"], err)
            return None
        if isinstance(err, ckpt.CheckpointSaveError):
            raise err
        raise ckpt.CheckpointSaveError(
            f"asynchronous checkpoint commit of {holder['final']} failed in "
            "the background committer") from err

    def _run_commit_protocol(self, job: _SaveJob) -> str:
        cfg = job.cfg
        path = ckpt.prepare_staging(job.final, cfg)
        try:
            if cfg.is_peft:
                save_adapters(job.model, os.path.join(path, "model"),
                              state=job.model_state)
            else:
                save_hf_weights(job.model, os.path.join(path, "model"),
                                state=job.model_state)
            optim = os.path.join(path, "optim")
            os.makedirs(optim, exist_ok=True)
            ckpt.save_stateful(optim, "optimizer", job.optimizer, cfg)
            if job.scheduler is not None:
                ckpt.save_stateful(optim, "lr_scheduler", job.scheduler, cfg)
            for key, sd in job.host_state:
                ckpt.save_stateful(path, key, sd, cfg)

            ckpt.retry_io(dump_yaml_config, job.config,
                          os.path.join(path, "config.yaml"),
                          retries=cfg.io_retries,
                          backoff=cfg.io_retry_backoff, desc="config.yaml")
        except Exception as e:
            raise ckpt.CheckpointSaveError(
                f"aborting commit of {job.final}: checkpoint writes failed; "
                f"staging left at {path} for inspection") from e
        ckpt.commit_checkpoint(path, job.final, epoch=job.epoch,
                               step=job.step, config=cfg)
        deleted = ckpt.gc_checkpoints(
            cfg.checkpoint_dir, keep_last_k=cfg.keep_last_k,
            keep_every_n_steps=cfg.keep_every_n_steps,
            protect=(job.resumed_from,), config=cfg)
        if deleted:
            logger.info("checkpoint GC removed %s",
                        ", ".join(os.path.basename(d) for d in deleted))
        logger.info("committed checkpoint %s", job.final)
        return job.final

    # -- load ---------------------------------------------------------------
    def load_checkpoint(self, restore_from: Optional[str] = None
                        ) -> Optional[str]:
        """Resume from ``restore_from``, ``checkpoint.restore_from`` or the
        newest committed checkpoint; None when there is none.  A corrupt
        or uncommitted directory raises ``CheckpointIntegrityError``
        before any state is touched."""
        self.join_pending_save()
        self._barrier()
        cfg = self.checkpoint_config
        restore_from = restore_from or cfg.restore_from
        path = restore_from or ckpt.find_latest_checkpoint(cfg.checkpoint_dir)
        if path is None:
            return None
        if not os.path.isdir(path):
            raise FileNotFoundError(
                f"checkpoint.restore_from={restore_from!r} does not exist")
        ckpt.verify_manifest(path)
        plan = getattr(self, "plan", None)
        if cfg.is_peft:
            load_adapters(self.model, os.path.join(path, "model"))
        elif plan is not None:
            with plan.full_params(self.model, load=True):
                load_hf_weights(self.model, os.path.join(path, "model"))
        else:
            load_hf_weights(self.model, os.path.join(path, "model"))
        optim = os.path.join(path, "optim")
        ckpt.load_stateful(optim, "optimizer", self.optimizer, cfg,
                           map_location=self.device)
        if self.lr_scheduler is not None:
            ckpt.load_stateful(optim, "lr_scheduler", self.lr_scheduler, cfg)
        for key, obj in self._tracked():
            if ckpt.has_stateful(path, key):
                ckpt.load_stateful(path, key, obj, cfg)
        self._resumed_from = os.path.abspath(path)
        logger.info("restored checkpoint %s", path)
        return path
