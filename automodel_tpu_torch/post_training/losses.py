"""GRPO and DPO objectives as plain tensor functions (counterpart:
``automodel_tpu/post_training/losses.py``).

GRPO: per prompt, ``G`` sampled completions form one group; a
completion's advantage is its reward normalized within the group,
``(r_i - mean_G) / (std_G + eps)`` (population std, as ``jnp.std``).  The
policy term is the PPO-style clipped ratio against the behaviour logprobs
(the policy at rollout time), plus an optional KL penalty to the frozen
reference with the k3 estimator ``exp(ref - pi) - (ref - pi) - 1``.

DPO: ``-log sigmoid(beta ((pi_c - ref_c) - (pi_r - ref_r)))`` over
sequence logprob sums.

Both take per-token logprobs from ``post_training/logprobs.py`` and return
masked **sums**; the caller divides by its token count, as every loss of
the framework does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

# The ``post_training.algorithm`` config domain (validated by
# ``config/loader.py::validate_config_enums``).
PT_ALGORITHMS = ("grpo", "dpo")

# A group whose rewards are all equal carries no signal: the epsilon keeps
# its advantages at exactly 0 instead of amplifying rounding noise.
ADVANTAGE_EPS = 1e-4


def group_normalized_advantages(rewards, group_size: int,
                                eps: float = ADVANTAGE_EPS) -> torch.Tensor:
    """``[N]`` rewards (groups contiguous: completion ``i`` of prompt ``p``
    at ``p * G + i``) -> ``[N]`` fp32 group-normalized advantages."""
    r = torch.as_tensor(rewards, dtype=torch.float32)
    if r.ndim != 1:
        raise ValueError(f"rewards must be [N], got shape {tuple(r.shape)}")
    if r.shape[0] % group_size:
        raise ValueError(
            f"rewards length {r.shape[0]} is not divisible by "
            f"group_size={group_size}")
    g = r.reshape(-1, group_size)
    mean = g.mean(dim=1, keepdim=True)
    std = g.std(dim=1, keepdim=True, correction=0)
    return ((g - mean) / (std + eps)).reshape(-1)


def grpo_token_objective(
    policy_logps: torch.Tensor,     # [B, S] live policy (differentiated)
    behavior_logps: torch.Tensor,   # [B, S] rollout-time policy (data)
    ref_logps: torch.Tensor,        # [B, S] frozen reference (data)
    advantages: torch.Tensor,       # [B]
    mask: torch.Tensor,             # [B, S] 1.0 at completion tokens
    *,
    kl_coef: float = 0.0,
    clip_eps: float = 0.2,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Summed GRPO objective over completion tokens: ``(loss_sum, aux)``
    with the masked sums ``pg_sum``, ``kl_sum`` and ``ratio_sum``.  Only
    ``policy_logps`` should carry a gradient."""
    mask = mask.float()
    adv = torch.as_tensor(advantages, dtype=torch.float32,
                          device=policy_logps.device)[:, None]
    ratio = torch.exp(policy_logps - behavior_logps)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv
    pg = -torch.minimum(unclipped, clipped)
    pg_sum = (pg * mask).sum()
    aux = {"pg_sum": pg_sum, "ratio_sum": (ratio * mask).sum()}
    loss_sum = pg_sum
    if kl_coef:
        # k3 estimator of KL(pi || ref): >= 0, zero iff pi == ref
        delta = ref_logps - policy_logps
        kl = torch.exp(delta) - delta - 1.0
        kl_sum = (kl * mask).sum()
        loss_sum = loss_sum + kl_coef * kl_sum
        aux["kl_sum"] = kl_sum
    else:
        aux["kl_sum"] = torch.zeros((), dtype=torch.float32,
                                    device=policy_logps.device)
    return loss_sum, aux


def dpo_losses(
    policy_chosen: torch.Tensor,    # [B] sequence logprob sums (live)
    policy_rejected: torch.Tensor,  # [B]
    ref_chosen: torch.Tensor,       # [B] frozen reference (data)
    ref_rejected: torch.Tensor,     # [B]
    *,
    beta: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pair DPO losses ``[B]`` and implicit reward margins ``[B]``
    (``beta ((pi_c - ref_c) - (pi_r - ref_r))``; positive when the policy
    already prefers the chosen answer)."""
    margins = beta * ((policy_chosen - ref_chosen)
                      - (policy_rejected - ref_rejected))
    return -F.logsigmoid(margins), margins
