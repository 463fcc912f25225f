"""The decode engine: continuous batching over the block-paged KV cache
(counterpart: ``automodel_tpu/serving/engine.py``).

Every device step runs at ``[max_num_seqs, W]`` where ``W`` is 1 (pure
decode) or ``prefill_chunk`` (a step carrying prefill work; decode rows
ride along with one valid token).  The scheduler (``serving/scheduler.py``)
plans each step, the engine assembles the step's ids, positions, slot
mapping, block tables and context lengths on the host, and one forward
through the model writes the step's k/v into the paged pools and attends
through the paged-decode kernel (``ops/paged_attention_kernel.py``).

Greedy sampling runs on the device inside the step; the step's ``[B, W]``
argmax is the engine's one host sync.  ``do_sample`` configs sample
host-side from the returned last-token logits with the engine's
``torch.Generator``.

This slice serves ``fcfs`` with chunked prefill, recompute preemption and
a bf16 or int8 KV cache.  Knobs of the JAX engine that it leaves out
(prefix caching, speculation, multi-tenant adapters, the fleet, the
watchdog, deadlines and load shedding) are accepted in a config only as
null/off; anything else raises.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from automodel_tpu_torch.generation.generate import (
    GenerationConfig,
    sample_logits,
)
from automodel_tpu_torch.ops import paged_attention_kernel as _pak
from automodel_tpu_torch.ops.paged_attention import ATTN_IMPLS
from automodel_tpu_torch.serving.kv_cache import (
    DEFAULT_KV_CACHE_DTYPE,
    KV_CACHE_DTYPES,
    BlockAllocator,
    PagedKVView,
    blocks_needed,
    init_paged_pools,
    pool_bytes,
    slot_for,
)
from automodel_tpu_torch.serving.scheduler import Request, Scheduler, StepPlan
from automodel_tpu_torch.utils.device import resolve_device

# ``serving:`` keys of the JAX engine that this slice does not implement:
# each must be absent, null or (where the JAX key is a mode) off / the
# default mode.
_LEFT_OUT = {
    "scheduler_policy": (None, "fcfs"),
    "max_waiting": (None,), "shed_policy": (None, "reject_newest"),
    "prefix_caching": (None, "off", False),
    "prefix_lru_blocks": (None,), "max_preemptions": (None,),
    "sjf_aging_steps": (None,), "watchdog_s": (None,),
    "drain_grace_s": (None,), "speculative": (None, "off", False),
    "spec_k": (None,), "replicas": (None, 1),
    "router_policy": (None, "round_robin"),
    "fleet_probation_polls": (None,), "max_adapters": (None,),
    "adapter_rank": (None,), "tenant_quota": (None,),
}


def _null(v):
    if isinstance(v, str) and v.lower() in ("none", "null", ""):
        return None
    return v


@dataclasses.dataclass
class ServingConfig:
    """The ``serving:`` YAML section."""

    kv_block_size: int = 16
    kv_cache_dtype: Optional[str] = None     # None/"auto" -> compute dtype
    max_num_seqs: int = 8
    max_model_len: int = 1024
    num_kv_blocks: Optional[int] = None      # None -> full residency + null
    prefill_chunk: int = 32

    def __post_init__(self):
        for field in ("kv_block_size", "max_num_seqs", "max_model_len",
                      "prefill_chunk"):
            v = getattr(self, field)
            if isinstance(v, bool) or not isinstance(v, int) or v < 1:
                raise ValueError(
                    f"serving.{field} must be a positive int, got {v!r}")
        self.num_kv_blocks = _null(self.num_kv_blocks)
        if self.num_kv_blocks is not None and self.num_kv_blocks < 2:
            raise ValueError(
                "serving.num_kv_blocks must be >= 2 (1 null + 1 usable), "
                f"got {self.num_kv_blocks!r}")
        self.kv_cache_dtype = _null(self.kv_cache_dtype)
        if self.kv_cache_dtype not in (None,) + KV_CACHE_DTYPES:
            raise ValueError(
                f"serving.kv_cache_dtype must be one of "
                f"{list(KV_CACHE_DTYPES)} (or null), got "
                f"{self.kv_cache_dtype!r}")

    @property
    def blocks_per_seq(self) -> int:
        return blocks_needed(self.max_model_len, self.kv_block_size)

    def resolved_num_blocks(self) -> int:
        if self.num_kv_blocks is not None:
            return self.num_kv_blocks
        return self.max_num_seqs * self.blocks_per_seq + 1


def build_serving_config(cfg: Any) -> ServingConfig:
    """``ServingConfig`` from a loaded YAML (its ``serving:`` node), a plain
    dict, or None for the defaults.  Keys the JAX engine knows but this
    slice leaves out raise unless null/off; unknown keys raise."""
    if cfg is None:
        return ServingConfig()
    if hasattr(cfg, "to_dict"):
        node = cfg.get("serving", cfg)
        data = node.to_dict() if hasattr(node, "to_dict") else dict(node)
    else:
        data = dict(cfg)
    for key, allowed in _LEFT_OUT.items():
        if key in data:
            v = _null(data.pop(key))
            if v not in allowed:
                raise ValueError(
                    f"serving.{key}={v!r} is not supported by the PyTorch "
                    "port yet (leave it null/off)")
    known = {f.name for f in dataclasses.fields(ServingConfig)}
    unknown = sorted(set(data) - known)
    if unknown:
        raise ValueError(
            f"unknown serving config key(s) {unknown}; known: "
            f"{sorted(known)}")
    return ServingConfig(**data)


@torch.inference_mode()
def _paged_step(model, view: PagedKVView, input_ids: torch.Tensor,
                last_col: torch.Tensor):
    """One step: write this step's tokens into the paged cache, attend,
    and greedy-pick every column.  Returns ``(greedy [B, W], last_logits
    [B, V] fp32)``; the pools in ``view`` are updated in place."""
    logits = model(input_ids, position_ids=view.positions,
                   kv_cache=view)["logits"].float()          # [B, W, V]
    rows = torch.arange(logits.shape[0], device=logits.device)
    last = logits[rows, last_col]                            # [B, V]
    greedy = logits.argmax(dim=-1)                           # [B, W]
    return greedy, last


class DecodeEngine:
    """Continuous-batching paged-KV decode over one model.

    ``device`` defaults to ``cuda`` and raises when no card is present;
    the model is moved there.  ``attn_impl="plain"`` runs the plain
    PyTorch attention instead of the kernel (the reference a card run is
    compared with)."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 generation: Optional[GenerationConfig] = None, *,
                 device=None, sample_seed: int = 0,
                 attn_impl: str = "kernel"):
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.config = config or ServingConfig()
        self.generation = generation or GenerationConfig()
        self.attn_impl = attn_impl
        mcfg = model.config
        dtype = self.config.kv_cache_dtype or DEFAULT_KV_CACHE_DTYPE
        self.quantized = dtype == "int8"
        num_blocks = self.config.resolved_num_blocks()
        self.max_blocks_per_seq = self.config.blocks_per_seq
        self.pools = init_paged_pools(
            num_layers=mcfg.num_hidden_layers,
            num_kv_heads=mcfg.num_key_value_heads, head_dim=mcfg.head_dim,
            num_blocks=num_blocks, block_size=self.config.kv_block_size,
            cache_dtype=model.compute_dtype, quantized=self.quantized,
            device=self.device)
        self.allocator = BlockAllocator(num_blocks)
        self.scheduler = Scheduler(
            self.allocator, max_num_seqs=self.config.max_num_seqs,
            prefill_chunk=self.config.prefill_chunk,
            block_size=self.config.kv_block_size,
            max_model_len=self.config.max_model_len)
        self.requests: Dict[int, Request] = {}
        self._rids = itertools.count()
        self._generator = torch.Generator(device=self.device).manual_seed(
            sample_seed)
        self.last_logits: Optional[torch.Tensor] = None
        self.steps_run = 0
        self.decode_steps = 0
        self.mixed_steps = 0
        self.tokens_generated = 0
        self.kernel_launches = 0

    # -- request intake ----------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = "default") -> int:
        """Queue one request; returns its id.  ``eos_token_id`` defaults to
        the engine's :class:`GenerationConfig` (None disables it)."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("cannot serve an empty prompt")
        if eos_token_id == "default":
            eos_token_id = self.generation.eos_token_id
        max_new = (self.generation.max_new_tokens if max_new_tokens is None
                   else max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        req = Request(rid=next(self._rids), prompt=prompt,
                      max_new_tokens=max_new, eos_token_id=eos_token_id)
        self.scheduler.add(req)
        self.requests[req.rid] = req
        return req.rid

    # -- the engine loop ---------------------------------------------------
    def _assemble(self, plan: StepPlan):
        cfg = self.config
        B, W, MB = cfg.max_num_seqs, plan.step_width, self.max_blocks_per_seq
        bs = cfg.kv_block_size
        ids = np.zeros((B, W), np.int64)
        pos = np.zeros((B, W), np.int32)
        # pad/idle tokens write into the null page (block 0), slot col % bs
        slots = np.tile(np.arange(W, dtype=np.int64) % bs, (B, 1))
        tables = np.zeros((B, MB), np.int32)
        ctx = np.ones((B,), np.int32)        # idle rows: 1 (null-page key 0)
        last = np.zeros((B,), np.int64)
        for work in plan.active:
            b, t, start = work.req.slot, len(work.tokens), work.start_pos
            ids[b, :t] = work.tokens
            pos[b, :t] = np.arange(start, start + t)
            pos[b, t:] = start + t - 1       # pads repeat the last valid
            blocks = work.req.blocks
            tables[b, :len(blocks)] = blocks
            slots[b, :t] = [slot_for(blocks, p, bs)
                            for p in range(start, start + t)]
            ctx[b] = start + t
            last[b] = t - 1
        return ids, pos, slots, tables, ctx, last

    def step(self) -> List[Request]:
        """One scheduler + device step; returns the requests that finished
        on it (an empty list when idle)."""
        plan = self.scheduler.schedule()
        if plan is None:
            return []
        ids, pos, slots, tables, ctx, last = (
            torch.from_numpy(a).to(self.device) for a in self._assemble(plan))
        view = PagedKVView(self.pools, tables, slots, ctx, pos,
                           block_size=self.config.kv_block_size,
                           quantized=self.quantized, attn_impl=self.attn_impl)
        launches0 = _pak.launches
        greedy, self.last_logits = _paged_step(self.model, view, ids, last)
        # the engine's one host sync: the [B, W] per-column argmax
        greedy = greedy.cpu().numpy()
        self.kernel_launches += _pak.launches - launches0
        sampled = {}
        for w in plan.active:
            if not w.samples_next:
                continue
            b = w.req.slot
            if self.generation.do_sample:
                sampled[b] = int(sample_logits(
                    self.last_logits[b:b + 1], self.generation,
                    self._generator)[0])
            else:
                sampled[b] = int(greedy[b, len(w.tokens) - 1])
        self.steps_run += 1
        if all(len(w.tokens) == 1 for w in plan.active):
            self.decode_steps += 1
        else:
            self.mixed_steps += 1
        appended0 = self.scheduler.tokens_appended
        done = self.scheduler.finish_step(plan, sampled)
        self.tokens_generated += self.scheduler.tokens_appended - appended0
        return done

    def run(self, max_steps: Optional[int] = None) -> Dict[int, List[int]]:
        """Step until every request finished; returns rid -> generated
        tokens.  ``max_steps`` (default: a generous work bound) turns a
        scheduler bug into a loud error instead of a hang."""
        if max_steps is None:
            budget = sum(
                blocks_needed(len(r.prompt), self.config.prefill_chunk)
                + r.max_new_tokens + 1
                for r in self.requests.values() if not r.finished)
            max_steps = 64 + 8 * budget
        steps = 0
        while self.scheduler.has_work():
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"engine made no progress within {max_steps} steps -- "
                    "scheduler stall")
        return {rid: list(r.out_tokens) for rid, r in self.requests.items()}

    # -- telemetry ---------------------------------------------------------
    def outcome_counts(self) -> Dict[str, int]:
        """Requests per lifecycle state."""
        counts: Dict[str, int] = {}
        for req in self.requests.values():
            counts[req.state.value] = counts.get(req.state.value, 0) + 1
        return counts

    def stats(self) -> Dict[str, Any]:
        return {
            "device": str(self.device),
            "attn_impl": self.attn_impl,
            "steps": self.steps_run,
            "decode_steps": self.decode_steps,
            "mixed_steps": self.mixed_steps,
            "tokens_generated": self.tokens_generated,
            "tokens_per_step": self.tokens_generated / max(1, self.steps_run),
            "kernel_launches": self.kernel_launches,
            "preemptions": self.scheduler.preemptions,
            "admissions": self.scheduler.admissions,
            "kv_pool_bytes": pool_bytes(self.pools),
            "kv_blocks_peak": self.allocator.peak_used,
            "kv_blocks_free": self.allocator.free_blocks,
            "failed_allocs": self.allocator.failed_allocs,
            "outcomes": self.outcome_counts(),
        }
