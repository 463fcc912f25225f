"""The decode engine: continuous batching over the block-paged KV cache
(counterpart: ``automodel_tpu/serving/engine.py``).

Every device step runs at ``[max_num_seqs, W]`` where ``W`` is 1 (pure
decode), ``spec_k + 1`` (pure decode under speculation) or
``prefill_chunk`` (a step carrying prefill work; decode rows ride along
with one valid token).  The scheduler (``serving/scheduler.py``) plans
each step, the engine assembles the step's ids, positions, slot mapping,
block tables and context lengths on the host, and one forward through the
model writes the step's k/v into the paged pools and attends through the
paged-decode kernel (``ops/paged_attention_kernel.py``).  The step's
``[B, W]`` argmax is the engine's one host sync; ``do_sample`` configs
sample host-side from the returned last-token logits with the engine's
``torch.Generator``.

The serving features of the JAX engine, ported:

* **policies and robustness**: ``fcfs`` / ``sjf`` with aging, deadlines
  and queue TTLs, ``max_waiting`` with three shed policies (a typed
  :class:`RequestRejected`, never an exception), ``max_preemptions`` pins,
  ``abort``;
* **prefix caching with copy-on-write** (``prefix_caching: on``): a fork
  copies the shared last block (int8 scale planes with it) into a private
  one before the step's writes, one indexed copy per pool plane on the
  same stream;
* **n-gram speculative decoding** (``speculative: ngram``): the verify
  reads ``greedy[b, t-1 : t+d]`` from the same ``[B, W]`` fetch;
  disabled, with a warning, under ``do_sample``;
* **multi-tenant adapters** (``max_adapters``): ``serving/adapters.py``
  slabs, each row routed by its ``adapter_id`` through the gmm kernel
  (``ops/lora_gmm.py``);
* **the watchdog** (``watchdog_s``): no slot progress across consecutive
  steps spanning the window (drilled by ``serve_watchdog_stall``) aborts
  the in-flight batch, zeroes the pools IN PLACE (the port owns them; JAX
  rebuilds its donated ones), flushes the prefix index and replays the
  admitted requests pinned -- greedy output stays token-identical;
* **graceful drain** (:meth:`DecodeEngine.drain`) bounded by
  ``drain_grace_s``; ``tools/serve.py`` wires it to SIGTERM / SIGINT.

The fleet keys (``replicas`` > 1, ``router_policy``,
``fleet_probation_polls``) are refused: the elastic fleet is ROADMAP
Queue 1 item 2.8.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from automodel_tpu_torch.generation.generate import (
    GenerationConfig,
    sample_logits,
)
from automodel_tpu_torch.ops import gmm_kernel as _gk
from automodel_tpu_torch.ops import paged_attention_kernel as _pak
from automodel_tpu_torch.ops.paged_attention import ATTN_IMPLS
from automodel_tpu_torch.serving.kv_cache import (
    DEFAULT_KV_CACHE_DTYPE,
    DEFAULT_PREFIX_CACHING,
    BlockAllocator,
    PagedKVView,
    PrefixIndex,
    blocks_needed,
    cow_copy_blocks,
    init_paged_pools,
    normalize_kv_cache_dtype,
    normalize_null_spelling,
    normalize_prefix_caching,
    pool_bytes,
    slot_for,
    validate_kv_cache_dtype,
    validate_prefix_caching,
)
from automodel_tpu_torch.serving.scheduler import (
    DEFAULT_SCHEDULER_POLICY,
    DEFAULT_SHED_POLICY,
    DEFAULT_SJF_AGING_STEPS,
    Request,
    RequestRejected,
    RequestState,
    Scheduler,
    StepPlan,
    normalize_scheduler_policy,
    normalize_shed_policy,
    validate_scheduler_policy,
    validate_shed_policy,
)
from automodel_tpu_torch.serving.speculative import (
    DEFAULT_SPEC_K,
    DEFAULT_SPECULATIVE,
    build_proposer,
    normalize_speculative,
    validate_speculative,
)
from automodel_tpu_torch.utils.device import resolve_device
from automodel_tpu_torch.utils.fault_injection import (
    InjectedFault,
    fault_point,
)

logger = logging.getLogger(__name__)

# drain(grace_s=...) default: "use serving.drain_grace_s" (an explicit
# None means unbounded)
_GRACE_FROM_CONFIG = object()

_FLEET = "the elastic serving fleet is not ported yet: ROADMAP Queue 1 " \
    "item 2.8"


@dataclasses.dataclass
class ServingConfig:
    """The ``serving:`` YAML section, every key of the JAX one, validated
    with the JAX messages (a programmatic config fails like a YAML one)."""

    kv_block_size: int = 16
    kv_cache_dtype: Optional[str] = None     # None/"auto" -> compute dtype
    max_num_seqs: int = 8
    max_model_len: int = 1024
    num_kv_blocks: Optional[int] = None      # None -> full residency + null
    prefill_chunk: int = 32
    scheduler_policy: Optional[str] = None   # None -> fcfs
    max_waiting: Optional[int] = None        # None -> unbounded queue
    shed_policy: Optional[str] = None        # None -> reject_newest
    prefix_caching: Optional[str] = None     # None -> off (on/off, bools ok)
    prefix_lru_blocks: Optional[int] = None  # None -> unbounded warm LRU
    max_preemptions: Optional[int] = None    # None -> never pin
    sjf_aging_steps: Optional[int] = None    # None -> default (32)
    watchdog_s: Optional[float] = None       # None -> watchdog disabled
    drain_grace_s: Optional[float] = None    # None -> unbounded drain
    speculative: Optional[str] = None        # None -> off (off/ngram, bools)
    spec_k: Optional[int] = None             # None -> default (4)
    replicas: Optional[int] = None           # refused above 1 (item 2.8)
    router_policy: Optional[str] = None      # refused (item 2.8)
    fleet_probation_polls: Optional[int] = None   # refused (item 2.8)
    max_adapters: Optional[int] = None       # None -> multi-LoRA off
    adapter_rank: Optional[int] = None       # None -> default (8)
    tenant_quota: Optional[int] = None       # None -> no per-tenant cap

    def __post_init__(self):
        for field in ("kv_block_size", "max_num_seqs", "max_model_len",
                      "prefill_chunk"):
            v = getattr(self, field)
            if isinstance(v, bool) or not isinstance(v, int) or v < 1:
                raise ValueError(
                    f"serving.{field} must be a positive int, got {v!r}")
        self.num_kv_blocks = normalize_null_spelling(self.num_kv_blocks)
        if self.num_kv_blocks is not None and self.num_kv_blocks < 2:
            raise ValueError(
                "serving.num_kv_blocks must be >= 2 (1 null + 1 usable), "
                f"got {self.num_kv_blocks!r}")
        for field in ("max_waiting", "max_preemptions", "sjf_aging_steps",
                      "replicas", "fleet_probation_polls",
                      "prefix_lru_blocks", "spec_k", "max_adapters",
                      "adapter_rank", "tenant_quota"):
            v = normalize_null_spelling(getattr(self, field))
            setattr(self, field, v)
            if v is None:
                continue
            if isinstance(v, bool) or not isinstance(v, int) or v < 1:
                raise ValueError(
                    f"serving.{field} must be an integer >= 1 (or null "
                    f"for the default), got {v!r}")
        for field in ("watchdog_s", "drain_grace_s"):
            v = normalize_null_spelling(getattr(self, field))
            setattr(self, field, v)
            if v is None:
                continue
            if isinstance(v, bool) or not isinstance(v, (int, float)) \
                    or v <= 0:
                raise ValueError(
                    f"serving.{field} must be a positive number (or null "
                    f"to disable), got {v!r}")
        self.kv_cache_dtype = validate_kv_cache_dtype(
            normalize_kv_cache_dtype(self.kv_cache_dtype))
        self.prefix_caching = validate_prefix_caching(
            normalize_prefix_caching(self.prefix_caching))
        self.speculative = validate_speculative(
            normalize_speculative(self.speculative))
        self.scheduler_policy = validate_scheduler_policy(
            normalize_scheduler_policy(self.scheduler_policy))
        self.shed_policy = validate_shed_policy(
            normalize_shed_policy(self.shed_policy))
        self.router_policy = normalize_null_spelling(self.router_policy)
        if self.replicas not in (None, 1):
            raise ValueError(f"serving.replicas={self.replicas!r}: {_FLEET}")
        if self.router_policy not in (None, "round_robin"):
            raise ValueError(
                f"serving.router_policy={self.router_policy!r}: {_FLEET}")
        if self.fleet_probation_polls is not None:
            raise ValueError(
                f"serving.fleet_probation_polls="
                f"{self.fleet_probation_polls!r}: {_FLEET}")

    @property
    def blocks_per_seq(self) -> int:
        return blocks_needed(self.max_model_len, self.kv_block_size)

    def resolved_num_blocks(self) -> int:
        if self.num_kv_blocks is not None:
            return self.num_kv_blocks
        return self.max_num_seqs * self.blocks_per_seq + 1


def build_serving_config(cfg: Any) -> ServingConfig:
    """``ServingConfig`` from a loaded YAML (its ``serving:`` node), a plain
    dict, or None for the defaults; unknown keys raise."""
    if cfg is None:
        return ServingConfig()
    if hasattr(cfg, "to_dict"):
        node = cfg.get("serving", cfg)
        data = node.to_dict() if hasattr(node, "to_dict") else dict(node)
    else:
        data = dict(cfg)
    known = {f.name for f in dataclasses.fields(ServingConfig)}
    unknown = sorted(set(data) - known)
    if unknown:
        raise ValueError(
            f"unknown serving config key(s) {unknown}; known: "
            f"{sorted(known)}")
    return ServingConfig(**data)


@torch.inference_mode()
def _paged_step(model, view: PagedKVView, input_ids: torch.Tensor,
                last_col: torch.Tensor, cow=None, adapters=None,
                adapter_ids: Optional[torch.Tensor] = None):
    """One step: run the pending copy-on-write forks (``cow`` = ``(src,
    dst)`` ``[B]`` block ids, rows without a fork ``(0, 0)``), write this
    step's tokens into the paged cache, attend, and greedy-pick every
    column.  A multi-tenant step passes the slab ``adapters`` and
    ``adapter_ids [B]`` (0 = base).  Returns ``(greedy [B, W],
    last_logits [B, V] fp32)``; the pools in ``view`` are updated in
    place.  The per-column argmax is also the speculative verify."""
    if cow is not None:
        cow_copy_blocks(view.pools, *cow)
    kw = ({} if adapter_ids is None
          else dict(adapters=adapters, adapter_ids=adapter_ids))
    logits = model(input_ids, position_ids=view.positions, kv_cache=view,
                   **kw)["logits"].float()                   # [B, W, V]
    rows = torch.arange(logits.shape[0], device=logits.device)
    last = logits[rows, last_col]                            # [B, V]
    greedy = logits.argmax(dim=-1)                           # [B, W]
    return greedy, last


class DecodeEngine:
    """Continuous-batching paged-KV decode over one model.

    ``device`` defaults to ``cuda`` and raises when no card is present;
    the model is moved there.  ``attn_impl="plain"`` runs the plain
    PyTorch attention instead of the kernel (the reference a card run is
    compared with).  ``clock`` drives deadlines, TTLs and the watchdog
    (injectable, so tests run on a fake clock); ``timers`` (a
    ``training/timers.py`` ``Timers``) gets ``serve_step``,
    ``serve_recovery`` and ``serve_drain``."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 generation: Optional[GenerationConfig] = None, *,
                 device=None, sample_seed: int = 0,
                 attn_impl: str = "kernel",
                 clock: Callable[[], float] = time.monotonic,
                 timers=None):
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}")
        refusal = getattr(model, "serving_refusal", None)
        if refusal:
            raise NotImplementedError(refusal)
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.config = config or ServingConfig()
        self.generation = generation or GenerationConfig()
        self.attn_impl = attn_impl
        self.clock = clock
        self.timers = timers
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
        self.prefix_index: Optional[PrefixIndex] = None
        if (self.config.prefix_caching or DEFAULT_PREFIX_CACHING) == "on":
            self.prefix_index = PrefixIndex(
                self.allocator, block_size=self.config.kv_block_size,
                lru_blocks=self.config.prefix_lru_blocks)
        self.adapter_slots = None
        self._slab_adapters = None
        if self.config.max_adapters:
            from automodel_tpu_torch.serving.adapters import (
                DEFAULT_ADAPTER_RANK,
                AdapterSlots,
            )

            self.adapter_slots = AdapterSlots(
                self.model, max_adapters=self.config.max_adapters,
                rank=self.config.adapter_rank or DEFAULT_ADAPTER_RANK,
                device=self.device)
            # views into the slabs: loads and swaps write them in place
            self._slab_adapters = self.adapter_slots.layer_adapters()
        spec_mode = self.config.speculative or DEFAULT_SPECULATIVE
        self.spec_k = self.config.spec_k or DEFAULT_SPEC_K
        if spec_mode != "off" and self.generation.do_sample:
            # the verify checks the greedy chain; a host-sampled token has
            # no draft to verify, so speculation is off, loudly
            logger.warning(
                "serving.speculative=%s disabled: generation.do_sample is "
                "set and speculative verification is greedy-only", spec_mode)
            spec_mode = "off"
        self.spec_mode = spec_mode
        self.scheduler = Scheduler(
            self.allocator, max_num_seqs=self.config.max_num_seqs,
            prefill_chunk=self.config.prefill_chunk,
            block_size=self.config.kv_block_size,
            max_model_len=self.config.max_model_len,
            policy=self.config.scheduler_policy or DEFAULT_SCHEDULER_POLICY,
            max_waiting=self.config.max_waiting,
            shed_policy=self.config.shed_policy or DEFAULT_SHED_POLICY,
            max_preemptions=self.config.max_preemptions,
            sjf_aging_steps=(self.config.sjf_aging_steps
                             or DEFAULT_SJF_AGING_STEPS),
            prefix_index=self.prefix_index,
            spec_proposer=build_proposer(spec_mode),
            spec_k=self.spec_k,
            tenant_quota=self.config.tenant_quota,
            multi_tenant=self.adapter_slots is not None,
            clock=clock)
        self.requests: Dict[int, Request] = {}
        self.rejections: List[RequestRejected] = []
        self._rids = itertools.count()
        self._generator = torch.Generator(device=self.device).manual_seed(
            sample_seed)
        self.last_logits: Optional[torch.Tensor] = None
        self.step_widths = set()
        self.weight_syncs = 0
        self.steps_run = 0
        self.decode_steps = 0
        self.mixed_steps = 0
        self.aborts = 0
        self.tokens_generated = 0
        self.watchdog_recoveries = 0
        self.kernel_launches = 0
        self.gmm_launches = 0
        # clock stamp of the first of the current run of no-progress steps
        self._no_progress_since: Optional[float] = None

    # -- weight handoff ----------------------------------------------------
    @torch.no_grad()
    def update_params(self, params=None, *, adapter_slot: Optional[int] = None,
                      adapters=None, adapter_name: Optional[str] = None,
                      adapter_scale: float = 1.0) -> None:
        """Adopt new weights between steps: ``params`` is the model's
        ``state_dict`` shape (tensors) or a JAX params tree (numpy, through
        ``models/weights.py::load_jax_params``); every shape and dtype must
        match, and the weights are copied into the engine's model in place
        (in-flight sequences go on under the new weights, as in JAX).
        ``adapter_slot`` / ``adapters`` load or hot-swap one tenant's
        adapter (:meth:`load_adapter`), alone or with new base weights."""
        if adapter_slot is not None:
            self.load_adapter(adapter_slot, adapters, name=adapter_name,
                              scale=adapter_scale)
            if params is None:
                return
        if params is None:
            raise ValueError(
                "update_params: pass base params, an adapter_slot swap, "
                "or both")
        own = self.model.state_dict()
        if all(isinstance(v, torch.Tensor) for v in params.values()):
            if set(params) != set(own):
                raise ValueError(
                    "update_params: incoming state_dict keys do not match "
                    "the engine's model")
            for k, v in params.items():
                if v.shape != own[k].shape or v.dtype != own[k].dtype:
                    raise ValueError(
                        f"update_params: {k} is {v.dtype}"
                        f"{tuple(v.shape)}, the engine's {own[k].dtype}"
                        f"{tuple(own[k].shape)} -- build a new engine for "
                        "a different model")
            for k, v in params.items():
                own[k].copy_(v)
        else:
            from automodel_tpu_torch.models.weights import load_jax_params

            load_jax_params(self.model, params)
        self.weight_syncs += 1

    # -- multi-tenant adapter slots ------------------------------------------
    def _require_adapters(self):
        if self.adapter_slots is None:
            raise ValueError(
                "this engine serves the base model only -- set "
                "serving.max_adapters to enable multi-tenant adapters")
        return self.adapter_slots

    def load_adapter(self, slot: int, adapters, *, name: Optional[str] = None,
                     scale: float = 1.0) -> Dict[str, Any]:
        """Load or hot-swap one tenant's LoRA tree (JAX layout) into
        ``slot`` (1-based; 0 is the base model).  ``AdapterLoadError`` on
        any failure, with the slot still serving its previous adapter."""
        return self._require_adapters().load(slot, adapters, name=name,
                                             scale=scale)

    def remove_adapter(self, slot: int) -> None:
        """Unload ``slot``; later submits naming it are refused."""
        self._require_adapters().remove(slot)

    # -- request intake ----------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = "default",
               deadline_s: Optional[float] = None,
               max_queue_s: Optional[float] = None,
               adapter_id: int = 0) -> int:
        """Queue one request; returns its id.  ``eos_token_id`` defaults to
        the engine's :class:`GenerationConfig` (None disables it).
        ``deadline_s`` is an end-to-end budget from this call,
        ``max_queue_s`` bounds WAITING time.  A request admission control
        drops is not an exception: its state is REJECTED and the typed
        :class:`RequestRejected` is appended to ``self.rejections``."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("cannot serve an empty prompt")
        if eos_token_id == "default":
            eos_token_id = self.generation.eos_token_id
        if adapter_id != 0:
            if not self._require_adapters().is_loaded(adapter_id):
                raise ValueError(
                    f"adapter_id={adapter_id} names an empty slot -- load "
                    "it first (engine.load_adapter)")
        max_new = (self.generation.max_new_tokens if max_new_tokens is None
                   else max_new_tokens)
        req = Request(rid=next(self._rids), prompt=prompt,
                      max_new_tokens=max_new, eos_token_id=eos_token_id,
                      deadline_s=deadline_s, max_queue_s=max_queue_s,
                      adapter_id=int(adapter_id))
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.submit_request(req)
        return req.rid

    def submit_request(self, req: Request) -> List[RequestRejected]:
        """Admit a built :class:`Request` through the same path as
        :meth:`submit`; returns the rejections it caused (possibly of
        other queued rows)."""
        rejected = self.scheduler.add(req)   # ValueError = caller bug only
        self.requests[req.rid] = req
        self.rejections.extend(rejected)
        return rejected

    def abort(self, rid: int) -> None:
        """Cancel a request anywhere in its lifecycle; its blocks are freed
        at once."""
        req = self.requests.get(rid)
        if req is None or req.finished:
            return
        self.scheduler.abort(req)
        self.aborts += 1

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
        # COW pairs: (0, 0) = the null page onto itself, a content no-op
        cow_src = np.zeros((B,), np.int64)
        cow_dst = np.zeros((B,), np.int64)
        for work in plan.active:
            b, start = work.req.slot, work.start_pos
            # drafts are written like tokens; only the host tells them
            # apart (acceptance advances num_computed past accepted ones)
            toks = list(work.tokens) + list(work.draft)
            t = len(toks)
            ids[b, :t] = toks
            pos[b, :t] = np.arange(start, start + t)
            pos[b, t:] = start + t - 1       # pads repeat the last valid
            blocks = work.req.blocks
            tables[b, :len(blocks)] = blocks
            slots[b, :t] = [slot_for(blocks, p, bs)
                            for p in range(start, start + t)]
            ctx[b] = start + t
            last[b] = t - 1
            if work.cow is not None:
                cow_src[b], cow_dst[b] = work.cow
        return ids, pos, slots, tables, ctx, last, cow_src, cow_dst

    def _assemble_adapter_ids(self, plan: StepPlan) -> np.ndarray:
        """``[B]`` slot routing of a multi-tenant step; idle rows carry 0
        (the zero adapter)."""
        aids = np.zeros((self.config.max_num_seqs,), np.int64)
        for work in plan.active:
            aids[work.req.slot] = work.req.adapter_id
        return aids

    def _watchdog_due(self, now: float) -> bool:
        """True when consecutive no-progress steps have spanned more than
        ``watchdog_s`` (a caller that merely pauses between productive
        steps never trips it)."""
        w = self.config.watchdog_s
        return (w is not None and self._no_progress_since is not None
                and self.scheduler.has_work()
                and now - self._no_progress_since > w)

    @torch.no_grad()
    def _watchdog_recover(self, reason: str) -> None:
        """Abort the in-flight batch and replay every admitted request:
        tables reclaimed, requests parked WAITING pinned with
        ``num_computed`` reset, the pools zeroed in place and the prefix
        index flushed (a stale hit would read zeros)."""
        logger.warning(
            "serving watchdog: %s -- aborting the in-flight batch and "
            "replaying %d admitted request(s) from their last computed "
            "token", reason, len(self.scheduler.active))
        t0 = time.perf_counter()
        for req in list(self.scheduler.active):
            self.scheduler.requeue_for_replay(req)
        for pool in self.pools.values():
            pool.zero_()
        if self.prefix_index is not None:
            self.prefix_index.flush()
        self.watchdog_recoveries += 1
        self._no_progress_since = None
        if self.timers is not None:
            self.timers("serve_recovery").add(time.perf_counter() - t0)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def step(self) -> List[Request]:
        """One scheduler + device step; returns the requests that finished
        on it (an empty list when idle).  Load and stalls never raise:
        exhaustion preempts, deadlines expire, a full queue sheds, a wedge
        recovers.  A real failure of the device step still propagates, but
        only after the same recovery ran, so a caller that catches it may
        keep stepping."""
        # the drilled client disconnect: the oldest active request aborts
        try:
            fault_point("serve_request_abort")
        except InjectedFault:
            active = self.scheduler.active
            if active:
                self.abort(min(active, key=lambda r: r.arrival).rid)
        t0 = self.clock()
        if self._watchdog_due(t0):
            self._watchdog_recover(
                f"no slot progress across consecutive steps spanning > "
                f"serving.watchdog_s={self.config.watchdog_s}")
        plan = self.scheduler.schedule(now=t0)
        if plan is None:
            if self.scheduler.has_work():
                if self._no_progress_since is None:
                    self._no_progress_since = t0
            else:
                self._no_progress_since = None       # idle is not a wedge
            return []
        (ids, pos, slots, tables, ctx, last,
         cow_src, cow_dst) = self._assemble(plan)
        launches0, gmm0 = _pak.launches, _gk.gmm_launches
        try:
            # the drilled wedged step: stands in for a device step that
            # never completed
            fault_point("serve_watchdog_stall")
            view = PagedKVView(
                self.pools, self._to_device(tables), self._to_device(slots),
                self._to_device(ctx), self._to_device(pos),
                block_size=self.config.kv_block_size,
                quantized=self.quantized, attn_impl=self.attn_impl)
            cow = None
            if cow_dst.any():
                cow = (self._to_device(cow_src), self._to_device(cow_dst))
            extra = {}
            if self.adapter_slots is not None:
                extra = dict(adapters=self._slab_adapters,
                             adapter_ids=self._to_device(
                                 self._assemble_adapter_ids(plan)))
            greedy, self.last_logits = _paged_step(
                self.model, view, self._to_device(ids),
                self._to_device(last), cow, **extra)
            # the engine's one host sync: the [B, W] per-column argmax
            # (plain decode reads one column, the verify k + 1)
            greedy = greedy.cpu().numpy()
        except InjectedFault:
            self._watchdog_recover("injected stall (serve_watchdog_stall)")
            return []
        except Exception as e:
            # a genuine failure mid-step: the pools cannot be trusted;
            # recover first, then let the error surface
            self._watchdog_recover(f"device step failed: {e!r}")
            raise
        self.kernel_launches += _pak.launches - launches0
        self.gmm_launches += _gk.gmm_launches - gmm0
        self.step_widths.add(plan.step_width)
        # slot -> the row's chain: column t-1 is the next token, columns
        # t .. t+d-1 the argmax at the d draft positions (the verify)
        sampled = {}
        for w in plan.active:
            if not w.samples_next:
                continue
            b, t = w.req.slot, len(w.tokens)
            if self.generation.do_sample:
                sampled[b] = [int(sample_logits(
                    self.last_logits[b:b + 1], self.generation,
                    self._generator)[0])]
            else:
                sampled[b] = greedy[b, t - 1:t + len(w.draft)].tolist()
        self.steps_run += 1
        # under speculation a decode step is spec_k + 1 wide: classify by
        # the rows, not the width
        if all(len(w.tokens) == 1 for w in plan.active):
            self.decode_steps += 1
        else:
            self.mixed_steps += 1
        appended0 = self.scheduler.tokens_appended
        done = self.scheduler.finish_step(plan, sampled)
        self.tokens_generated += self.scheduler.tokens_appended - appended0
        now = self.clock()
        self.scheduler.note_step_time(now - t0)
        self._no_progress_since = None               # this step progressed
        if self.timers is not None:
            self.timers("serve_step").add(now - t0)
        return done

    def run(self, max_steps: Optional[int] = None) -> Dict[int, List[int]]:
        """Step until every request reached a terminal state; returns rid
        -> generated tokens.  ``max_steps`` (default: a generous work
        bound) turns a scheduler bug into a loud error instead of a
        hang."""
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

    # -- graceful drain ----------------------------------------------------
    def drain(self, grace_s=_GRACE_FROM_CONFIG) -> Dict[str, int]:
        """Stop admitting and finish in-flight work within ``grace_s``
        (default ``serving.drain_grace_s``; None unbounded).  New and
        never-admitted waiting requests reject (reason ``draining``);
        admitted ones, parked ones included, keep stepping until done or
        until the grace runs out, then EXPIRE with their blocks
        reclaimed.  Returns :meth:`outcome_counts`."""
        if grace_s is _GRACE_FROM_CONFIG:
            grace_s = self.config.drain_grace_s
        self.scheduler.draining = True
        for req in list(self.scheduler.waiting):
            if req.was_admitted:
                continue     # parked in-flight work re-admits and finishes
            self.rejections.append(self.scheduler._reject(req, "draining"))
        t0 = self.clock()
        deadline = None if grace_s is None else t0 + grace_s
        while self.scheduler.has_work():
            if deadline is not None and self.clock() >= deadline:
                for req in (list(self.scheduler.active)
                            + list(self.scheduler.waiting)):
                    self.scheduler.expire(req, reason="drain_deadline")
                break
            self.step()
        if self.timers is not None:
            self.timers("serve_drain").add(self.clock() - t0)
        return self.outcome_counts()

    # -- the generate()-shaped entry ---------------------------------------
    def generate(self, input_ids, prompt_lens=None,
                 config: Optional[GenerationConfig] = None) -> np.ndarray:
        """Drop-in for :func:`automodel_tpu_torch.generation.generate`:
        right-padded ``[B, S]`` prompts -> ``[B, max_new_tokens]`` int32
        with ``pad_token_id`` after eos.  Every row must FINISH (a shed or
        expired row raises: this is the parity oracle)."""
        cfg = config or self.generation
        ids = np.asarray(input_ids)
        B, S = ids.shape
        lens = (np.full((B,), S, np.int64) if prompt_lens is None
                else np.asarray(prompt_lens))
        rids = [self.submit(ids[b, :int(lens[b])],
                            max_new_tokens=cfg.max_new_tokens,
                            eos_token_id=cfg.eos_token_id)
                for b in range(B)]
        self.run()
        not_finished = {rid: self.requests[rid].state.value for rid in rids
                        if self.requests[rid].state
                        is not RequestState.FINISHED}
        if not_finished:
            raise RuntimeError(
                f"engine.generate(): {len(not_finished)} of {B} rows did "
                f"not finish ({not_finished}) -- generate() cannot pad "
                "shed/expired rows; drive lossy traffic through "
                "submit()/step() and read outcome_counts()")
        out = np.full((B, cfg.max_new_tokens), cfg.pad_token_id, np.int32)
        for b, rid in enumerate(rids):
            toks = self.requests[rid].out_tokens
            out[b, :len(toks)] = toks
        return out

    # -- telemetry ---------------------------------------------------------
    def outcome_counts(self) -> Dict[str, int]:
        """Requests per lifecycle state (terminal and in flight)."""
        counts: Dict[str, int] = {}
        for req in self.requests.values():
            counts[req.state.value] = counts.get(req.state.value, 0) + 1
        return counts

    def completed_in_deadline(self) -> int:
        """FINISHED requests that met their deadline (none counts as met):
        the numerator of the goodput fraction."""
        n = 0
        for req in self.requests.values():
            if req.state is not RequestState.FINISHED:
                continue
            if (req.deadline_s is None or req.finish_time is None
                    or req.finish_time - req.submit_time <= req.deadline_s):
                n += 1
        return n

    def stats(self) -> Dict[str, Any]:
        idx = self.prefix_index
        sched = self.scheduler
        prefix = {
            "enabled": idx is not None,
            "lookups": idx.lookups if idx else 0,
            "hits": idx.hits if idx else 0,
            "misses": idx.misses if idx else 0,
            "insertions": idx.insertions if idx else 0,
            "evictions": idx.evictions if idx else 0,
            "cached_blocks": idx.cached_blocks if idx else 0,
            "cow_forks": sched.cow_forks,
            "cow_fork_failures": sched.cow_fork_failures,
            "deferrals": sched.prefix_deferrals,
        }
        spec = {
            "enabled": self.spec_mode != "off",
            "mode": self.spec_mode,
            "spec_k": self.spec_k,
            "tokens_proposed": sched.spec_tokens_proposed,
            "tokens_accepted": sched.spec_tokens_accepted,
            "draft_faults": sched.spec_draft_faults,
            "verify_failures": sched.spec_verify_failures,
        }
        slots = self.adapter_slots
        multi_tenant = {
            "enabled": slots is not None,
            "per_tenant": {k: dict(v)
                           for k, v in sorted(sched.per_tenant.items())},
        }
        if slots is not None:
            multi_tenant["adapters"] = slots.stats()
            multi_tenant["tenant_quota"] = self.config.tenant_quota
            multi_tenant["quota_deferrals"] = sched.tenant_quota_deferrals
        return {
            "device": str(self.device),
            "attn_impl": self.attn_impl,
            "prefill_tokens_saved": sched.prefix_tokens_reused,
            "cache_hit_rate": (idx.hits / max(1, idx.lookups)
                               if idx else 0.0),
            "prefix_cache": prefix,
            "spec_tokens_accepted": sched.spec_tokens_accepted,
            "accept_rate": (sched.spec_tokens_accepted
                            / max(1, sched.spec_tokens_proposed)),
            "tokens_per_step": self.tokens_generated / max(1, self.steps_run),
            "speculative": spec,
            "multi_tenant": multi_tenant,
            "steps": self.steps_run,
            "decode_steps": self.decode_steps,
            "mixed_steps": self.mixed_steps,
            "tokens_generated": self.tokens_generated,
            "kernel_launches": self.kernel_launches,
            "gmm_launches": self.gmm_launches,
            "preemptions": sched.preemptions,
            "admissions": sched.admissions,
            "aborts": self.aborts,
            "expired": sched.expired,
            "rejected": sched.rejected,
            "pinned": sched.pins,
            "watchdog_recoveries": self.watchdog_recoveries,
            "weight_syncs": self.weight_syncs,
            "kv_pool_bytes": pool_bytes(self.pools),
            "kv_blocks_peak": self.allocator.peak_used,
            "kv_blocks_free": self.allocator.free_blocks,
            "failed_allocs": self.allocator.failed_allocs,
            "step_widths": sorted(self.step_widths),
            "outcomes": self.outcome_counts(),
        }
