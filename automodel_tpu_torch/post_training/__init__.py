"""Post-training on the decode engine and the train step (counterpart:
``automodel_tpu/post_training``).

    post_training/
      logprobs.py   per-token logprobs from the train forward and the
                    linear-CE kernels (no [B, S, V] logits)
      losses.py     GRPO (group-normalized advantages, clipped PG + k3 KL)
                    and DPO objectives
      steps.py      the GRPO / DPO optimizer steps on the train step's
                    update
      rollout.py    grouped completions from the decode engine, synced to
                    the live weights before each rollout; rewards
      base.py       the shared recipe base and the RL state that goes
                    through the checkpoint
      eval_watch.py scores each committed checkpoint through
                    ``serving/eval.py``

The recipes are ``recipes/llm/train_grpo.py`` and ``train_dpo.py``.
"""

from automodel_tpu_torch.post_training.logprobs import (   # noqa: F401
    build_logprob_fn,
    completion_logprobs,
    make_sequence_batch,
)
from automodel_tpu_torch.post_training.losses import (     # noqa: F401
    PT_ALGORITHMS,
    dpo_losses,
    group_normalized_advantages,
    grpo_token_objective,
)
