"""The DPO post-training recipe: offline preference pairs on the GRPO
recipe's logprob machinery (counterpart:
``automodel_tpu/recipes/llm/train_dpo.py``).

    python -m automodel_tpu_torch.recipes.llm.train_dpo -c <yaml> \
        [--device cpu]

No rollouts, no rewards, no engine: a dataset of ``(prompt, chosen,
rejected)`` rows (``prompt_ids`` / ``chosen_ids`` / ``rejected_ids``, as
``datasets/llm/mock.py::build_preference_pairs_dataset`` makes them)
drives ``-log sigmoid(beta ((pi_c - ref_c) - (pi_r - ref_r)))`` over
sequence logprob sums.  The reference sums come from one pass of the
frozen reference per half and step, without a gradient; the DPO step
differentiates the policy's.  ``rl.rollout_batch_size`` is the pairs per
step, ``rl.beta`` the temperature (null: 0.1).  Each step's metrics add
``logprob_ms`` / ``train_ms`` (each timed to a device barrier).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from automodel_tpu_torch.config.loader import parse_args_and_load_config
from automodel_tpu_torch.post_training.base import PostTrainingRecipeBase
from automodel_tpu_torch.post_training.logprobs import (
    batch_to_device,
    make_sequence_batch,
)
from automodel_tpu_torch.post_training.steps import build_dpo_step, pair_half
from automodel_tpu_torch.serving.kv_cache import normalize_null_spelling

logger = logging.getLogger(__name__)

DEFAULT_DPO_BETA = 0.1


class DPORecipeForCausalLM(PostTrainingRecipeBase):
    algorithm = "dpo"
    uses_engine = False   # offline: no rollouts, no KV pools

    def _needs_reference(self) -> bool:
        return True   # the DPO loss is defined against the reference

    def _build_step_fns(self):
        beta = normalize_null_spelling(self.cfg.get("rl.beta"))
        self.beta = float(beta) if beta is not None else DEFAULT_DPO_BETA
        return build_dpo_step(self.model, self.optimizer, beta=self.beta)

    # -- pairs source ------------------------------------------------------
    def _setup_data(self) -> None:
        ds_cfg = self.cfg.get("dataset")
        if ds_cfg is None:
            raise ValueError("DPO needs a dataset: section of preference "
                             "pairs (prompt_ids/chosen_ids/rejected_ids)")
        dataset = ds_cfg.instantiate()
        rc = self.rollout_config
        self._pairs = []
        for row in dataset:
            if not all(k in row for k in
                       ("prompt_ids", "chosen_ids", "rejected_ids")):
                raise ValueError(
                    "DPO dataset rows must carry prompt_ids/chosen_ids/"
                    f"rejected_ids; got keys {sorted(row)}")
            p = [int(t) for t in row["prompt_ids"]][: rc.max_prompt_len]
            c = [int(t) for t in row["chosen_ids"]][: rc.max_new_tokens]
            r = [int(t) for t in row["rejected_ids"]][: rc.max_new_tokens]
            if p and c and r:
                self._pairs.append((p, c, r))
        if len(self._pairs) < rc.rollout_batch_size:
            raise ValueError(
                f"dataset yields {len(self._pairs)} usable pairs < "
                f"rl.rollout_batch_size={rc.rollout_batch_size}")

    def _next_pairs(self):
        rc = self.rollout_config
        cursor = self.rl_state.data_cursor
        out = [self._pairs[(cursor + i) % len(self._pairs)]
               for i in range(rc.rollout_batch_size)]
        self.rl_state.data_cursor = cursor + rc.rollout_batch_size
        return out

    def _pair_batch(self, pairs) -> Dict[str, np.ndarray]:
        rc = self.rollout_config
        S = rc.sequence_length
        prompt_lens = [len(p) for p, _, _ in pairs]
        out = {}
        for half, seqs in (("chosen", [p + c for p, c, _ in pairs]),
                           ("rejected", [p + r for p, _, r in pairs])):
            b = make_sequence_batch(seqs, prompt_lens,
                                    pad_id=rc.pad_token_id, pad_to=S)
            out.update({f"{half}_{k}": v for k, v in b.items()})
        return out

    # -- one DPO step ------------------------------------------------------
    def _one_step(self, step: int) -> Dict[str, float]:
        batch = batch_to_device(self._pair_batch(self._next_pairs()),
                                self.device)
        with self.timers.record("logprob", barrier=True):
            for half in ("chosen", "rejected"):
                batch[f"ref_{half}_logp"] = self.logprob_fn(
                    self.ref_model, pair_half(batch, half)).sum(dim=-1)
        with self.timers.record("train", barrier=True):
            metrics = self.step_fns.unpack_metrics(self.step_fns.step(batch))
        self.rl_state.rollouts += 1   # one pair batch consumed
        metrics.update(self._split_ms())
        return metrics


def main(config_path: Optional[str] = None, argv=None):
    """CLI entry: ``-c <yaml>`` plus dotted ``--a.b value`` overrides."""
    logging.basicConfig(level=logging.INFO)
    cfg = parse_args_and_load_config(argv, default_config=config_path)
    recipe = DPORecipeForCausalLM(cfg)
    recipe.setup()
    recipe.run_post_training_loop()
    return recipe


if __name__ == "__main__":
    main()
