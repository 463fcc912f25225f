"""Learning-rate and weight-decay schedule (counterpart:
``automodel_tpu/optim/scheduler.py::OptimizerParamScheduler``).

Host-side math over the optimizer-step count: warmup, then constant,
linear, cosine, inverse-square-root or WSD decay; weight decay constant or
ramped.  Read :attr:`current_lr` / :attr:`current_wd` after :meth:`step`
and set them on the optimizer (``optim.builder.set_hyperparams``).
``state_dict`` / ``load_state_dict`` carry every field and the step count
through a checkpoint; the checkpoint's values win, as by default in JAX.
"""

from __future__ import annotations

import math
from typing import Optional


class OptimizerParamScheduler:
    def __init__(
        self,
        optimizer=None,  # accepted for YAML signature parity; unused
        init_lr: float = 0.0,
        max_lr: float = 1e-4,
        min_lr: float = 0.0,
        lr_warmup_steps: int = 0,
        lr_decay_steps: int = 1,
        lr_decay_style: str = "constant",
        start_wd: float = 0.0,
        end_wd: float = 0.0,
        wd_incr_steps: int = 0,
        wd_incr_style: str = "constant",
        wsd_decay_steps: Optional[int] = None,
        lr_wsd_decay_style: Optional[str] = None,
    ) -> None:
        self.init_lr = init_lr
        self.max_lr = float(max_lr)
        self.min_lr = min_lr
        self.lr_warmup_steps = lr_warmup_steps
        self.lr_decay_steps = lr_decay_steps
        self.lr_decay_style = lr_decay_style
        self.wsd_decay_steps = wsd_decay_steps
        self.lr_wsd_decay_style = lr_wsd_decay_style
        self.start_wd = start_wd
        self.end_wd = end_wd
        self.wd_incr_steps = wd_incr_steps
        self.wd_incr_style = wd_incr_style
        if not 0.0 <= self.min_lr <= self.max_lr or self.init_lr > self.max_lr:
            raise ValueError("need 0 <= min_lr <= max_lr and init_lr <= max_lr")
        if self.lr_decay_steps <= 0 or \
                self.lr_warmup_steps >= self.lr_decay_steps:
            raise ValueError("need 0 <= lr_warmup_steps < lr_decay_steps")
        if self.lr_decay_style == "WSD" and self.wsd_decay_steps is None:
            raise ValueError("WSD decay needs wsd_decay_steps")
        if not 0.0 <= self.start_wd <= self.end_wd:
            raise ValueError("need 0 <= start_wd <= end_wd")
        self.num_steps = 0
        self.step(0)

    def get_wd(self) -> float:
        if self.wd_incr_steps <= 0 or self.num_steps > self.wd_incr_steps:
            return self.end_wd
        if self.wd_incr_style == "constant":
            return self.end_wd
        incr_ratio = float(self.num_steps) / float(self.wd_incr_steps)
        delta_wd = self.end_wd - self.start_wd
        if self.wd_incr_style == "linear":
            coeff = incr_ratio
        elif self.wd_incr_style == "cosine":
            coeff = 0.5 * (math.cos(math.pi * (1 - incr_ratio)) + 1.0)
        else:
            raise ValueError(f"{self.wd_incr_style} weight decay increment "
                             "style is not supported.")
        return self.start_wd + coeff * delta_wd

    def get_lr(self) -> float:
        max_lr, min_lr = self.max_lr, self.min_lr
        if self.lr_warmup_steps > 0 and self.num_steps <= self.lr_warmup_steps:
            return self.init_lr + (
                (max_lr - self.init_lr) * float(self.num_steps)
                / float(self.lr_warmup_steps))
        if self.lr_decay_style == "constant":
            return max_lr
        if self.num_steps > self.lr_decay_steps:
            return min_lr
        if self.lr_decay_style == "inverse-square-root":
            warmup_steps = max(self.lr_warmup_steps, 1)
            num_steps = max(self.num_steps, 1)
            return max(min_lr, max_lr * warmup_steps ** 0.5 / num_steps ** 0.5)
        num_steps_ = self.num_steps - self.lr_warmup_steps
        decay_steps_ = self.lr_decay_steps - self.lr_warmup_steps
        decay_ratio = float(num_steps_) / float(decay_steps_)
        delta_lr = max_lr - min_lr
        if self.lr_decay_style == "linear":
            coeff = 1.0 - decay_ratio
        elif self.lr_decay_style == "cosine":
            coeff = 0.5 * (math.cos(math.pi * decay_ratio) + 1.0)
        elif self.lr_decay_style == "WSD":
            anneal_start = self.lr_decay_steps - self.wsd_decay_steps
            if self.num_steps <= anneal_start:
                coeff = 1.0
            else:
                r = float(self.num_steps - anneal_start) / float(
                    self.wsd_decay_steps)
                style = self.lr_wsd_decay_style
                if style == "linear":
                    coeff = 1.0 - r
                elif style == "cosine":
                    coeff = 0.5 * (math.cos(math.pi * r) + 1.0)
                elif style == "exponential":
                    coeff = (2.0 * math.pow(0.5, r)) - 1.0
                elif style == "minus_sqrt":
                    coeff = 1.0 - math.sqrt(r)
                else:
                    raise ValueError(
                        f"{style} WSD decay style is not supported.")
        else:
            raise ValueError(
                f"{self.lr_decay_style} decay style is not supported.")
        return min_lr + coeff * delta_lr

    def step(self, increment: int = 1) -> None:
        self.num_steps += increment
        self.current_wd = self.get_wd()
        self.current_lr = self.get_lr()

    _FIELDS = ("init_lr", "max_lr", "min_lr", "lr_warmup_steps",
               "lr_decay_steps", "lr_decay_style", "wsd_decay_steps",
               "lr_wsd_decay_style", "start_wd", "end_wd", "wd_incr_steps",
               "wd_incr_style", "num_steps")

    def state_dict(self) -> dict:
        return {a: getattr(self, a) for a in self._FIELDS}

    def load_state_dict(self, sd: dict) -> None:
        for a in self._FIELDS:
            setattr(self, a, sd[a])
        self.step(0)
