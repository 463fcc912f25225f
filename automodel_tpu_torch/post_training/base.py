"""The post-training recipe base: rollouts and training on one card
(counterpart: ``automodel_tpu/post_training/base.py``).

:class:`PostTrainingRecipeBase` owns what GRPO and DPO share: the model
and optimizer, the frozen reference policy, the decode engine and its
rollout worker, the logprob pass, the RL state that goes through the
checkpoint (async saves included) and the online-eval hook.  The
algorithm recipes (``recipes/llm/train_grpo.py`` / ``train_dpo.py``) add
their step builder and their data path.

Three models can live on the card, each holding its own weights:

* ``model``, the policy being trained (the YAML's ``param_dtype``,
  fp32 masters at the 1B YAMLs);
* ``ref_model``, a frozen copy of the policy as set-up left it (before a
  resume, so a resumed run keeps the first run's reference), made only
  when the algorithm needs one (GRPO with ``rl.kl_coef`` null does not);
* the engine's model, a copy in the trainer's dtype, as the JAX engine
  keeps its own buffers: each rollout first copies the policy's
  ``state_dict`` into it (``DecodeEngine.update_params``), so a rollout
  runs the weights of the last step and a later change to the policy
  reaches the engine only at the next sync.  DPO builds no engine.

Not wired, as in JAX (a config with the section fails here): ``peft``,
``fp8``, ``pipeline`` and ``freeze_config``.  A ``distributed`` size above
1 raises ``NotImplementedError`` (multi-GPU, ROADMAP Queue 1 item 9), as
the SFT recipe does.  The learning rate is constant.
"""

from __future__ import annotations

import copy
import logging
import time
from typing import Any, Dict, List, Optional

from automodel_tpu_torch.checkpoint.checkpointing import (
    build_checkpoint_config,
)
from automodel_tpu_torch.config.loader import ConfigNode
from automodel_tpu_torch.generation.generate import GenerationConfig
from automodel_tpu_torch.optim.builder import build_optimizer
from automodel_tpu_torch.post_training.logprobs import build_logprob_fn
from automodel_tpu_torch.post_training.rollout import (
    RolloutError,
    RolloutWorker,
    build_rollout_config,
)
from automodel_tpu_torch.recipes.base_recipe import BaseRecipe
from automodel_tpu_torch.recipes.llm.train_ft import (
    check_ported,
    load_pretrained_weights,
)
from automodel_tpu_torch.serving.engine import (
    DecodeEngine,
    build_serving_config,
)
from automodel_tpu_torch.serving.kv_cache import normalize_null_spelling
from automodel_tpu_torch.training.rng import StatefulRNG
from automodel_tpu_torch.training.timers import Timers
from automodel_tpu_torch.utils.device import resolve_device
from automodel_tpu_torch.utils.model_utils import jax_named_parameters

logger = logging.getLogger(__name__)

_UNSUPPORTED_SECTIONS = ("peft", "fp8", "pipeline", "freeze_config")
# top-level sections the post-training recipes read beside the SFT ones
_SECTIONS = frozenset({"post_training", "rl", "serving", "online_eval"})
_MODEL_INIT_STREAM = 0      # rng stream of the weight init (the SFT one)
# the wall split of one step (``{name}_ms`` in the metrics)
STEP_TIMERS = ("rollout", "logprob", "train")


class RLState:
    """Post-training host state that must survive a resume exactly (reward
    EMA, rollout and step counters, the data cursor): a
    ``state_dict`` / ``load_state_dict`` object, saved as ``rl_state.pt``
    with the checkpoint."""

    def __init__(self, ema_beta: float = 0.9):
        self.step = 0                 # optimizer steps taken
        self.rollouts = 0             # successful rollouts
        self.failed_rollouts = 0      # typed RolloutError skips
        self.data_cursor = 0          # prompt / pair stream position
        self.tokens_generated = 0     # completion tokens across rollouts
        self.reward_ema: Optional[float] = None
        self.reward_last: Optional[float] = None
        self.ema_beta = float(ema_beta)

    def note_rollout(self, mean_reward: float, tokens: int) -> None:
        self.rollouts += 1
        self.tokens_generated += int(tokens)
        self.reward_last = float(mean_reward)
        if self.reward_ema is None:
            self.reward_ema = float(mean_reward)
        else:
            self.reward_ema = (self.ema_beta * self.reward_ema
                               + (1.0 - self.ema_beta) * float(mean_reward))

    def state_dict(self) -> Dict[str, Any]:
        return {
            "step": self.step,
            "rollouts": self.rollouts,
            "failed_rollouts": self.failed_rollouts,
            "data_cursor": self.data_cursor,
            "tokens_generated": self.tokens_generated,
            "reward_ema": self.reward_ema,
            "reward_last": self.reward_last,
            "ema_beta": self.ema_beta,
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        for k, v in sd.items():
            setattr(self, k, v)


class PostTrainingRecipeBase(BaseRecipe):
    """``setup()`` then ``run_post_training_loop()``."""

    # the YAML's post_training.algorithm must name this recipe's
    algorithm: str = ""
    # offline algorithms (DPO) build no engine and no KV pools
    uses_engine: bool = True
    tracked_state = ("rng", "rl_state")

    def __init__(self, cfg: ConfigNode):
        self.cfg = cfg
        self.history: List[Dict[str, float]] = []   # every step's metrics
        self.eval_watcher = None
        self._last_ckpt_step = -1

    # -- setup -------------------------------------------------------------
    def setup(self):
        cfg = self.cfg
        for section in _UNSUPPORTED_SECTIONS:
            if cfg.get(section) is not None:
                raise ValueError(
                    f"post-training recipes do not support the "
                    f"{section!r} config section yet (see docs/guides/"
                    "post_training.md, 'Scope'); remove it")
        algo = normalize_null_spelling(cfg.get("post_training.algorithm"))
        if algo is not None and algo != self.algorithm:
            raise ValueError(
                f"post_training.algorithm={algo!r} does not match this "
                f"recipe ({type(self).__name__} runs {self.algorithm!r})")
        check_ported(cfg, _SECTIONS)
        self.device = resolve_device(cfg.get("device"))
        self.rng = StatefulRNG(seed=int(cfg.get("rng.seed", 42)),
                               ranked=bool(cfg.get("rng.ranked", False)))
        self.model = cfg.get("model").instantiate(
            seed=self.rng.seed_for(_MODEL_INIT_STREAM), device=self.device)
        load_pretrained_weights(self.model, peft=False)

        # rollout and loop knobs (the enums also checked at load)
        self.rollout_config = build_rollout_config(cfg.get("rl"))
        pt = cfg.get("post_training")
        self.max_steps = int(pt.get("max_steps", 20)) if pt else 20
        self.ckpt_every_steps = int(
            pt.get("ckpt_every_steps", 0) or 0) if pt else 0
        self.log_every_steps = int(pt.get("log_every_steps", 1)) if pt else 1
        self.max_consecutive_failures = int(
            pt.get("max_consecutive_failures", 3)) if pt else 3

        # optimizer (a constant learning rate, as in JAX)
        opt_cfg = cfg.get("optimizer")
        opt_kwargs = {k: v for k, v in
                      (opt_cfg.to_dict() if opt_cfg else {}).items()
                      if k != "_target_"}
        target = opt_cfg.get("_target_") if opt_cfg is not None else None
        if isinstance(target, str):
            opt_kwargs.setdefault("name", target.rsplit(".", 1)[-1].lower())
        max_gn = cfg.get("max_grad_norm")
        if max_gn is not None:
            opt_kwargs.setdefault("grad_clip_norm", float(max_gn))
        self.optimizer = build_optimizer(jax_named_parameters(self.model),
                                         **opt_kwargs)
        self.step_fns = self._build_step_fns()
        self.logprob_fn = build_logprob_fn()

        # the frozen reference: the policy as set-up left it (copied
        # before a resume, so a resumed run keeps the same reference)
        self.ref_model = (self._frozen_copy(self.model)
                          if self._needs_reference() else None)

        rc = self.rollout_config
        self.engine = None
        self.rollout_worker = None
        if self.uses_engine:
            self.serving_config = build_serving_config(cfg.get("serving"))
            gen = GenerationConfig(
                max_new_tokens=rc.max_new_tokens,
                do_sample=rc.temperature > 0,
                temperature=max(rc.temperature, 1e-6),
                top_k=rc.top_k, top_p=rc.top_p,
                eos_token_id=rc.eos_token_id, pad_token_id=rc.pad_token_id)
            self.engine = DecodeEngine(
                self._frozen_copy(self.model), self.serving_config,
                generation=gen, device=self.device,
                sample_seed=(rc.seed if rc.seed is not None
                             else self.rng.seed))
            self.rollout_worker = RolloutWorker(self.engine, rc)

        self.rl_state = RLState()
        self.timers = Timers(device=self.device)
        self.checkpoint_config = build_checkpoint_config(cfg.get("checkpoint"))
        self._setup_data()
        self._setup_online_eval()
        if self.checkpoint_config.enabled:
            # params, optimizer state and rl_state
            self.load_checkpoint()
        return self

    @staticmethod
    def _frozen_copy(model):
        out = copy.deepcopy(model)
        out.requires_grad_(False)
        return out

    def _needs_reference(self) -> bool:
        raise NotImplementedError

    def _build_step_fns(self):
        raise NotImplementedError

    def _setup_data(self) -> None:
        raise NotImplementedError

    def _setup_online_eval(self) -> None:
        """The optional ``online_eval:`` hook: a background
        :class:`~automodel_tpu_torch.post_training.eval_watch.
        CheckpointEvalWatcher` scoring committed checkpoints on a copy of
        the model; the loop only drains its results for logging."""
        oe = self.cfg.get("online_eval")
        if oe is None or not bool(oe.get("enabled", True)):
            return
        if not self.checkpoint_config.enabled:
            logger.warning(
                "online_eval: requires checkpointing (the watcher scores "
                "COMMITTED checkpoints); disabled for this run")
            return
        from automodel_tpu_torch.post_training.eval_watch import (
            CheckpointEvalWatcher,
            rows_from_eval_config,
        )

        rows = rows_from_eval_config(
            self.cfg, section=str(oe.get("dataset_section",
                                         "validation_dataset")),
            limit=int(oe.get("limit", 8)))
        self.eval_watcher = CheckpointEvalWatcher(
            self._frozen_copy(self.model),
            self.checkpoint_config.checkpoint_dir, rows,
            via=str(oe.get("via", "engine")),
            max_new_tokens=(int(oe.get("max_new_tokens"))
                            if oe.get("max_new_tokens") else None),
            device=self.device,
            poll_interval_s=float(oe.get("poll_interval_s", 10.0)))
        self.eval_watcher.start()

    # -- shared loop plumbing ----------------------------------------------
    def _maybe_checkpoint(self, step: int, final: bool = False) -> None:
        if not self.checkpoint_config.enabled:
            return
        due = self.ckpt_every_steps and step % self.ckpt_every_steps == 0
        if final and self._last_ckpt_step == step:
            return
        if due or final:
            self.save_checkpoint(0, step)
            self._last_ckpt_step = step

    def _drain_eval_results(self) -> List[Dict[str, Any]]:
        if self.eval_watcher is None:
            return []
        return self.eval_watcher.drain_results()

    def _log_metrics(self, step: int, metrics: Dict[str, float]) -> None:
        if step % self.log_every_steps:
            return
        body = " | ".join(f"{k} {v:.4f}" for k, v in metrics.items())
        logger.info("step %d | %s", step, body)
        for res in self._drain_eval_results():
            logger.info("step %d | online eval of ckpt step %d: "
                        "eval/score %.4f", step, res["step"],
                        res["eval/score"])

    def _split_ms(self) -> Dict[str, float]:
        """This step's rollout / logprob / train wall milliseconds (the
        timers are read and reset every step)."""
        return {f"{k}_ms": v * 1e3 for k, v in self.timers.get_elapsed(
            list(STEP_TIMERS), reset=True).items()}

    def teardown(self, raise_error: bool = True) -> None:
        """Join the in-flight async save first (the watcher's final poll
        sees committed checkpoints only), then stop the watcher after one
        last poll."""
        self.join_pending_save(raise_error=raise_error)
        if self.eval_watcher is not None:
            try:
                self.eval_watcher.stop(final_poll=True)
            except Exception:
                logger.warning("online-eval final poll failed",
                               exc_info=True)

    # -- the loop (subclasses implement one optimizer step) ----------------
    def run_post_training_loop(self):
        state = self.rl_state
        consecutive_failures = 0
        try:
            while state.step < self.max_steps:
                step = state.step + 1
                t0 = time.perf_counter()
                try:
                    metrics = self._one_step(step)
                except RolloutError as e:
                    state.failed_rollouts += 1
                    consecutive_failures += 1
                    logger.warning(
                        "step %d rollout failed (%d consecutive): %s — "
                        "training state untouched, retrying with the next "
                        "rollout", step, consecutive_failures, e)
                    if consecutive_failures >= self.max_consecutive_failures:
                        raise RuntimeError(
                            f"{consecutive_failures} consecutive rollout "
                            "failures — aborting (raise post_training."
                            "max_consecutive_failures to tolerate more)"
                        ) from e
                    continue
                consecutive_failures = 0
                state.step = step
                metrics["step_time"] = time.perf_counter() - t0
                self.history.append(metrics)
                self._log_metrics(step, metrics)
                self._maybe_checkpoint(step)
            self._maybe_checkpoint(state.step, final=True)
        except BaseException:
            self.teardown(raise_error=False)
            raise
        self.teardown()
        return self

    def _one_step(self, step: int) -> Dict[str, float]:
        raise NotImplementedError
