"""The rollout layer: grouped sampled completions off the decode engine,
generated from the live training weights (counterpart:
``automodel_tpu/post_training/rollout.py``).

Training owns the weights; before each rollout the worker hands them to
the engine (:class:`~automodel_tpu_torch.serving.engine.DecodeEngine`)
through ``update_params``, which copies the policy's ``state_dict`` into
the engine's own model in place (same shapes and dtypes, checked), then
drives continuous-batched generation: each prompt is submitted
``group_size`` times, and the completions come back grouped as GRPO's
advantage normalizer wants them.  The engine's copy is its own: a later
change to the trainer's tensors reaches it only at the next sync.

The engine samples host-side from a ``torch.Generator`` seeded by the
recipe, so sampled rollouts agree with the JAX worker's (which folds JAX
keys) in distribution, not token for token; greedy rollouts agree token
for token.

Failure containment, the JAX contract at the same three fault points
(``utils/fault_injection.py``):

* ``rollout_weight_sync`` -- the handoff fails: the engine keeps its
  previous weights, nothing was submitted, a typed :class:`RolloutError`
  surfaces and the next rollout re-syncs;
* ``rollout_engine_step`` -- the drive loop fails mid-generation: every
  in-flight request of the rollout is aborted (``engine.abort``, blocks
  reclaimed at once), training state is untouched;
* ``reward_fn`` -- reward computation fails: the completed rollout is
  discarded (its blocks were freed at finish), typed.

The recipes catch :class:`RolloutError`, skip the rollout and go on.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from automodel_tpu_torch.serving.kv_cache import normalize_null_spelling
from automodel_tpu_torch.utils.fault_injection import (
    InjectedFault,
    fault_point,
)

# The ``rl.reward_source`` config domain (registered in
# ``config/loader.py::validate_config_enums``):
#   length_target — seeded synthetic reward -|len(completion) - target|
#                   (the GRPO e2e acceptance reward: trivially checkable
#                   improvement signal, no model in the loop)
#   callable      — ``rl.reward_fn`` names a python callable
#                   ``(prompt_ids, completion_ids) -> float``
REWARD_SOURCES = ("length_target", "callable")


class RolloutError(RuntimeError):
    """A rollout failed and was cleanly discarded (typed so the recipes
    can skip-and-continue; training state is untouched by contract)."""


@dataclasses.dataclass
class RolloutConfig:
    """The ``rl:`` YAML section's rollout knobs (validated here; the
    enum ``reward_source`` also at config load)."""

    group_size: int = 4            # completions per prompt (GRPO's G)
    rollout_batch_size: int = 4    # prompts per rollout
    max_new_tokens: int = 16
    max_prompt_len: int = 32       # prompts truncate here; pins the static
    #                                train-batch width (see sequence_length)
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    reward_source: str = "length_target"
    reward_target_len: Optional[int] = None   # length_target's target
    reward_fn: Optional[Callable] = None      # reward_source == callable
    kl_coef: Optional[float] = None           # None -> no KL penalty
    clip_eps: float = 0.2
    # engine sampling seed; None -> the recipe's rng.seed (the default —
    # one seed governs the whole run)
    seed: Optional[int] = None

    def __post_init__(self):
        for field in ("group_size", "rollout_batch_size", "max_new_tokens",
                      "max_prompt_len"):
            v = getattr(self, field)
            if isinstance(v, bool) or not isinstance(v, int) or v < 1:
                raise ValueError(
                    f"rl.{field} must be a positive int, got {v!r}")
        self.seed = normalize_null_spelling(self.seed)
        if self.seed is not None and (isinstance(self.seed, bool)
                                      or not isinstance(self.seed, int)):
            raise ValueError(
                f"rl.seed must be an int (or null to inherit rng.seed), "
                f"got {self.seed!r}")
        self.kl_coef = normalize_null_spelling(self.kl_coef)
        if self.kl_coef is not None and (
                isinstance(self.kl_coef, bool)
                or not isinstance(self.kl_coef, (int, float))
                or self.kl_coef <= 0):
            raise ValueError(
                f"rl.kl_coef must be a positive number (or null to "
                f"disable the KL penalty), got {self.kl_coef!r}")
        src = normalize_null_spelling(self.reward_source)
        self.reward_source = src if src is not None else "length_target"
        if self.reward_source not in REWARD_SOURCES:
            raise ValueError(
                f"rl.reward_source must be one of {list(REWARD_SOURCES)} "
                f"(or null for the default), got {self.reward_source!r}")
        if self.reward_source == "callable" and self.reward_fn is None:
            raise ValueError(
                "rl.reward_source=callable needs rl.reward_fn (a python "
                "path resolving to (prompt_ids, completion_ids) -> float)")

    @property
    def sequence_length(self) -> int:
        """The fixed train-batch width every rollout pads to."""
        return self.max_prompt_len + self.max_new_tokens

    @property
    def completions_per_rollout(self) -> int:
        return self.rollout_batch_size * self.group_size


def build_rollout_config(cfg: Any) -> RolloutConfig:
    """``RolloutConfig`` from a loaded YAML's ``rl:`` node (or a plain
    dict / None for the defaults).  ``reward_fn`` strings resolve through
    the config system's target resolver."""
    if cfg is None:
        return RolloutConfig()
    if hasattr(cfg, "to_dict"):
        data = cfg.to_dict()
    else:
        data = dict(cfg)
    # dpo-only knobs ride the same ``rl:`` node; drop them here
    data.pop("beta", None)
    known = {f.name for f in dataclasses.fields(RolloutConfig)}
    unknown = sorted(set(data) - known)
    if unknown:
        raise ValueError(
            f"unknown rl config key(s) {unknown}; known: "
            f"{sorted(known | {'beta'})}")
    fn = data.get("reward_fn")
    if isinstance(fn, str):
        from automodel_tpu_torch.config.loader import resolve_target

        data["reward_fn"] = resolve_target(fn)
    return RolloutConfig(**data)


@dataclasses.dataclass
class RolloutBatch:
    """One rollout's grouped completions (groups CONTIGUOUS: completion
    ``g`` of prompt ``p`` at index ``p * G + g`` — the advantage
    normalizer's layout)."""

    prompts: List[List[int]]        # [N] expanded (each prompt G times)
    completions: List[List[int]]    # [N]
    group_size: int
    rewards: Optional[np.ndarray] = None    # [N] f32, set by the reward fn
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def sequences(self) -> List[List[int]]:
        return [p + c for p, c in zip(self.prompts, self.completions)]

    @property
    def prompt_lens(self) -> List[int]:
        return [len(p) for p in self.prompts]


class RolloutWorker:
    """Drives one :class:`~automodel_tpu_torch.serving.engine.DecodeEngine`
    through weight-synced grouped generation."""

    def __init__(self, engine, config: Optional[RolloutConfig] = None):
        self.engine = engine
        self.config = config or RolloutConfig()
        self.rollouts = 0
        self.failed_rollouts = 0
        self.last_sync_s = 0.0
        self.last_rollout_s = 0.0

    # -- the weight handoff ------------------------------------------------
    def sync_weights(self, params) -> float:
        """Hand the live training weights (the policy's ``state_dict``, or
        the policy model) to the engine; returns the sync's wall seconds,
        its copies finished.  ``rollout_weight_sync`` drilled: a failure
        leaves the engine on its previous weights and surfaces typed."""
        if isinstance(params, torch.nn.Module):
            params = params.state_dict()
        t0 = time.perf_counter()
        try:
            fault_point("rollout_weight_sync")
            self.engine.update_params(params)
            if self.engine.device.type == "cuda":
                torch.cuda.synchronize(self.engine.device)
        except InjectedFault as e:
            raise RolloutError(
                "weight sync into the decode engine failed; the engine "
                "keeps its previous params and the next rollout re-syncs "
                f"cleanly ({e})") from e
        self.last_sync_s = time.perf_counter() - t0
        return self.last_sync_s

    # -- generation --------------------------------------------------------
    def generate(self, prompts: Sequence[Sequence[int]],
                 params=None, adapter_id: int = 0) -> RolloutBatch:
        """``group_size`` sampled completions per prompt.  With ``params``
        the weight handoff runs first (the live-weights contract); the
        engine's sampled stream is deterministic under its seeded
        generator, and group members diverge (each draw advances it).
        ``adapter_id`` rolls the batch out under one tenant's adapter slot
        on a multi-tenant engine (0 = base model)."""
        cfg = self.config
        if params is not None:
            self.sync_weights(params)
        eng = self.engine
        prompts = [[int(t) for t in p][: cfg.max_prompt_len]
                   for p in prompts]
        if any(not p for p in prompts):
            raise ValueError("rollout: empty prompt")
        # group-level fork accounting: with prefix caching on, the G group
        # members hit one prompt's chain, so a group pays ~1 prefill —
        # report the tokens THIS rollout did not recompute
        saved0 = eng.scheduler.prefix_tokens_reused
        spec_prop0 = eng.scheduler.spec_tokens_proposed
        spec_acc0 = eng.scheduler.spec_tokens_accepted
        appended0 = eng.scheduler.tokens_appended
        steps0 = eng.steps_run
        tenant_tokens0 = {tid: d["tokens"]
                          for tid, d in eng.scheduler.per_tenant.items()}
        t0 = time.perf_counter()
        rids: List[int] = []
        try:
            for p in prompts:
                for _ in range(cfg.group_size):
                    rids.append(eng.submit(
                        p, max_new_tokens=cfg.max_new_tokens,
                        eos_token_id=cfg.eos_token_id,
                        adapter_id=adapter_id))
            # a generous stall bound, like engine.run(): a scheduler wedge
            # must become a typed abort, never a hang
            budget = 64 + 8 * sum(
                -(-len(p) // eng.config.prefill_chunk) + cfg.max_new_tokens
                for p in prompts for _ in range(cfg.group_size))
            steps = 0
            while eng.scheduler.has_work():
                # The drilled mid-generation failure: a device-step error /
                # runtime cancellation surfacing in the rollout drive loop.
                fault_point("rollout_engine_step")
                eng.step()
                steps += 1
                if steps > budget:
                    raise RolloutError(
                        f"rollout made no progress within {steps} engine "
                        "steps — scheduler stall")
        except BaseException as e:
            self._abort_inflight(rids)
            self.failed_rollouts += 1
            if isinstance(e, InjectedFault):
                raise RolloutError(
                    "rollout generation failed mid-flight; the in-flight "
                    "requests were aborted (block tables reclaimed), "
                    f"training state is untouched ({e})") from e
            raise
        from automodel_tpu_torch.serving.scheduler import RequestState

        not_finished = [rid for rid in rids
                        if eng.requests[rid].state
                        is not RequestState.FINISHED]
        if not_finished:
            self._abort_inflight(rids)
            self.failed_rollouts += 1
            raise RolloutError(
                f"{len(not_finished)} rollout request(s) did not finish "
                "(shed/expired under the serving robustness layer?) — "
                "rollout engines should run unbounded queues")
        completions = [list(eng.requests[rid].out_tokens) for rid in rids]
        self.last_rollout_s = time.perf_counter() - t0
        self.rollouts += 1
        batch = RolloutBatch(
            prompts=[p for p in prompts for _ in range(cfg.group_size)],
            completions=completions, group_size=cfg.group_size,
            stats={
                "rollout_s": self.last_rollout_s,
                "sync_s": self.last_sync_s,
                "tokens": float(sum(len(c) for c in completions)),
                "tokens_per_s": (sum(len(c) for c in completions)
                                 / max(self.last_rollout_s, 1e-9)),
                "prefill_tokens_saved": float(
                    eng.scheduler.prefix_tokens_reused - saved0),
                "cache_hit_rate": (
                    eng.prefix_index.hits
                    / max(1, eng.prefix_index.lookups)
                    if getattr(eng, "prefix_index", None) is not None
                    else 0.0),
                # speculative decoding, deltas for THIS rollout (greedy
                # recipes only — do_sample rollouts report zeros)
                "spec_tokens_accepted": float(
                    eng.scheduler.spec_tokens_accepted - spec_acc0),
                "accept_rate": (
                    (eng.scheduler.spec_tokens_accepted - spec_acc0)
                    / max(1, eng.scheduler.spec_tokens_proposed
                          - spec_prop0)),
                "tokens_per_step": (
                    (eng.scheduler.tokens_appended - appended0)
                    / max(1, eng.steps_run - steps0)),
                # multi-tenant serving: tokens THIS rollout generated per
                # adapter id (one entry, {adapter_id: tokens}, for the
                # common single-tenant rollout)
                "per_tenant_tokens": {
                    tid: float(d["tokens"] - tenant_tokens0.get(tid, 0))
                    for tid, d in eng.scheduler.per_tenant.items()
                    if d["tokens"] - tenant_tokens0.get(tid, 0)},
            })
        return batch

    def _abort_inflight(self, rids: Sequence[int]) -> None:
        for rid in rids:
            try:
                self.engine.abort(rid)
            except Exception:  # a best-effort reclaim must never mask
                pass           # the propagating rollout failure


# ---------------------------------------------------------------------------
# Rewards
# ---------------------------------------------------------------------------
def compute_rewards(batch: RolloutBatch,
                    config: RolloutConfig) -> np.ndarray:
    """``[N]`` float32 rewards for a rollout batch; sets
    ``batch.rewards``.  The ``reward_fn`` fault point drills an external
    reward service failing: the rollout is discarded typed, training
    untouched."""
    try:
        fault_point("reward_fn")
        if config.reward_source == "length_target":
            target = (config.reward_target_len
                      if config.reward_target_len is not None
                      else max(config.max_new_tokens // 2, 1))
            rewards = np.asarray(
                [-abs(len(c) - target) for c in batch.completions],
                np.float32)
        else:
            rewards = np.asarray(
                [float(config.reward_fn(p, c))
                 for p, c in zip(batch.prompts, batch.completions)],
                np.float32)
    except InjectedFault as e:
        raise RolloutError(
            "reward computation failed; the rollout is discarded (its "
            f"blocks were already freed at finish) ({e})") from e
    if rewards.shape != (len(batch.completions),):
        raise RolloutError(
            f"reward fn produced shape {rewards.shape} for "
            f"{len(batch.completions)} completions")
    if not np.all(np.isfinite(rewards)):
        raise RolloutError("reward fn produced non-finite rewards")
    batch.rewards = rewards
    return rewards
