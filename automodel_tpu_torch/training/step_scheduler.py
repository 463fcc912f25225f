"""Step scheduler: groups dataloader batches into grad-accumulation
windows (counterpart: ``automodel_tpu/training/step_scheduler.py``).

``grad_acc_steps = global_batch_size / (local_batch_size * dp_size)``;
iteration yields lists of microbatches, one list per optimizer step (a
last partial group is dropped); ``max_steps`` ends the run; validation
runs every ``val_every_steps``; a checkpoint is due every
``ckpt_every_steps``, at the end of an epoch and at ``max_steps``
(:attr:`is_ckpt_step`).  ``state_dict`` carries the step and epoch.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Optional


class StepScheduler:
    def __init__(
        self,
        grad_acc_steps: Optional[int] = None,
        ckpt_every_steps: int = 100,
        dataloader: Optional[Any] = None,
        val_every_steps: Optional[int] = None,
        num_epochs: int = 1,
        max_steps: Optional[int] = None,
        global_batch_size: Optional[int] = None,
        local_batch_size: Optional[int] = None,
        dp_size: int = 1,
    ) -> None:
        if grad_acc_steps is None:
            if global_batch_size is None or local_batch_size is None:
                grad_acc_steps = 1
            else:
                denom = local_batch_size * max(dp_size, 1)
                if global_batch_size % denom:
                    raise ValueError(
                        f"global_batch_size {global_batch_size} not divisible "
                        f"by local_batch_size*dp_size {denom}")
                grad_acc_steps = global_batch_size // denom
        self.grad_acc_steps = max(int(grad_acc_steps), 1)
        self.ckpt_every_steps = ckpt_every_steps
        self.val_every_steps = val_every_steps
        self.num_epochs = num_epochs
        self.max_steps = max_steps
        self.dataloader = dataloader
        self.step = 0          # optimizer steps taken
        self.epoch = 0
        self._epoch_exhausted = False

    @property
    def epochs(self) -> Iterator[int]:
        for e in range(self.epoch, self.num_epochs):
            if self.finished:
                return
            self.epoch = e
            yield e

    def __iter__(self) -> Iterator[List[Any]]:
        """Optimizer steps of the current epoch, each a list of
        ``grad_acc_steps`` microbatches."""
        if self.dataloader is None:
            raise RuntimeError("StepScheduler has no dataloader")
        if self.finished:
            return
        self._epoch_exhausted = False
        group: List[Any] = []
        for batch in self.dataloader:
            group.append(batch)
            if len(group) == self.grad_acc_steps:
                self.step += 1
                yield group
                group = []
                if self.finished:
                    return
        self._epoch_exhausted = True

    @property
    def is_ckpt_step(self) -> bool:
        if self.ckpt_every_steps and self.step % self.ckpt_every_steps == 0:
            return True
        return self._epoch_exhausted or self.finished

    def state_dict(self) -> dict:
        return {"step": self.step, "epoch": self.epoch}

    def load_state_dict(self, sd: dict) -> None:
        self.step = sd["step"]
        self.epoch = sd["epoch"]

    @property
    def is_val_step(self) -> bool:
        return bool(self.val_every_steps) and (
            self.step % self.val_every_steps == 0)

    @property
    def finished(self) -> bool:
        return self.max_steps is not None and self.step >= self.max_steps
