"""The GRPO post-training recipe: rollout, advantage, policy gradient on
one card (counterpart: ``automodel_tpu/recipes/llm/train_grpo.py``).

    python -m automodel_tpu_torch.recipes.llm.train_grpo -c <yaml> \
        [--device cpu]

Each optimizer step is one GRPO cycle:

1. **weight handoff** -- the policy's ``state_dict`` is copied into the
   decode engine's own model (``DecodeEngine.update_params``; drilled
   fault point ``rollout_weight_sync``);
2. **rollout** -- ``rollout_batch_size`` prompts x ``group_size``
   completions through the continuous-batching engine (paged decode,
   kernel 1 on the card; ``rollout_engine_step`` drilled);
3. **reward and advantage** -- ``rl.reward_source`` scores each completion
   (``reward_fn`` drilled), advantages are group-normalized;
4. **logprobs** -- the frozen reference gets one pass without a gradient
   (skipped when ``rl.kl_coef`` is null); the behaviour terms are the
   policy's own logprobs of the training pass, detached;
5. **policy gradient** -- the GRPO step (clipped PG + k3 KL) and the
   update.

The schema is the JAX recipe's (``examples/rl/tiny_llama_grpo_mock.yaml``
runs as written): ``model`` / ``distributed`` / ``optimizer`` /
``checkpoint`` / ``dataset`` (the prompt source), ``post_training:``,
``rl:``, ``serving:``, ``online_eval:``, plus the port's top-level
``device`` (default ``cuda``).  Each step's metrics add the wall split
``rollout_ms`` / ``logprob_ms`` / ``train_ms`` (each timed to a device
barrier), ``rollout_tok_s`` and ``sync_ms``.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

from automodel_tpu_torch.config.loader import parse_args_and_load_config
from automodel_tpu_torch.post_training.base import PostTrainingRecipeBase
from automodel_tpu_torch.post_training.logprobs import (
    batch_to_device,
    make_sequence_batch,
)
from automodel_tpu_torch.post_training.losses import (
    group_normalized_advantages,
)
from automodel_tpu_torch.post_training.rollout import compute_rewards
from automodel_tpu_torch.post_training.steps import build_grpo_step

logger = logging.getLogger(__name__)


class GRPORecipeForCausalLM(PostTrainingRecipeBase):
    algorithm = "grpo"

    def _needs_reference(self) -> bool:
        return self.rollout_config.kl_coef is not None

    def _build_step_fns(self):
        rc = self.rollout_config
        return build_grpo_step(self.model, self.optimizer,
                               kl_coef=float(rc.kl_coef or 0.0),
                               clip_eps=rc.clip_eps)

    # -- prompt source -----------------------------------------------------
    def _setup_data(self) -> None:
        """Prompts from a plain dataset: each row's leading tokens, at most
        ``rl.max_prompt_len`` and half the row.  The cursor lives in RL
        state, so a resume continues the same prompt stream."""
        ds_cfg = self.cfg.get("dataset")
        if ds_cfg is None:
            raise ValueError("GRPO needs a dataset: section (the prompt "
                             "source)")
        dataset = ds_cfg.instantiate()
        rc = self.rollout_config
        self._prompts: List[List[int]] = []
        for row in dataset:
            ids = [int(t) for t in row["input_ids"]]
            cut = min(rc.max_prompt_len, max(1, len(ids) // 2))
            if ids[:cut]:
                self._prompts.append(ids[:cut])
        if len(self._prompts) < rc.rollout_batch_size:
            raise ValueError(
                f"dataset yields {len(self._prompts)} usable prompts < "
                f"rl.rollout_batch_size={rc.rollout_batch_size}")

    def _next_prompts(self) -> List[List[int]]:
        rc = self.rollout_config
        cursor = self.rl_state.data_cursor
        out = [self._prompts[(cursor + i) % len(self._prompts)]
               for i in range(rc.rollout_batch_size)]
        self.rl_state.data_cursor = cursor + rc.rollout_batch_size
        return out

    # -- one GRPO cycle ----------------------------------------------------
    def _one_step(self, step: int) -> Dict[str, float]:
        rc = self.rollout_config
        with self.timers.record("rollout", barrier=True):
            rb = self.rollout_worker.generate(self._next_prompts(),
                                              params=self.model.state_dict())
            compute_rewards(rb, rc)
        batch = batch_to_device(make_sequence_batch(
            rb.sequences, rb.prompt_lens, pad_id=rc.pad_token_id,
            pad_to=rc.sequence_length), self.device)
        if self.ref_model is not None:
            with self.timers.record("logprob", barrier=True):
                # only the frozen reference needs a pass of its own; the
                # behaviour terms come from the training pass itself
                batch["ref_logps"] = self.logprob_fn(self.ref_model, batch)
        batch["advantages"] = group_normalized_advantages(
            rb.rewards, rc.group_size).to(self.device)
        with self.timers.record("train", barrier=True):
            metrics = self.step_fns.unpack_metrics(self.step_fns.step(batch))
        mean_reward = float(np.mean(rb.rewards))
        self.rl_state.note_rollout(mean_reward, rb.stats["tokens"])
        metrics.update({
            "reward_mean": mean_reward,
            "reward_ema": float(self.rl_state.reward_ema),
            "rollout_tok_s": rb.stats["tokens_per_s"],
            "sync_ms": rb.stats["sync_s"] * 1e3,
            **self._split_ms(),
        })
        return metrics


def main(config_path: Optional[str] = None, argv=None):
    """CLI entry: ``-c <yaml>`` plus dotted ``--a.b value`` overrides."""
    logging.basicConfig(level=logging.INFO)
    cfg = parse_args_and_load_config(argv, default_config=config_path)
    recipe = GRPORecipeForCausalLM(cfg)
    recipe.setup()
    recipe.run_post_training_loop()
    return recipe


if __name__ == "__main__":
    main()
