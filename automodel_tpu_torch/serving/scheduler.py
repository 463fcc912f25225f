"""Continuous-batching scheduler: per-request state machines over static
step slots (counterpart: ``automodel_tpu/serving/scheduler.py``; pure host
logic, the port's own copy, so the port imports nothing of the JAX
package).  For the same submissions, clock and fault spec it emits the
same :class:`StepPlan` sequence and the same outcomes as the JAX
scheduler.

The request lifecycle::

    WAITING --admit--> PREFILL --prompt done--> DECODE --eos/max--> FINISHED
       ^                  |                        |
       +---- preempt -----+------------------------+
                                       (abort -> ABORTED,
                                        deadline/TTL -> EXPIRED,
                                        load shed   -> REJECTED)

A request's *pending* tokens are ``(prompt + out_tokens)[num_computed:]``,
the tokens not yet written to the KV cache.  Prefill steps consume up to
``prefill_chunk`` of them, decode steps one; when a step empties the
pending list, the sampled token is appended.  Preemption (KV pool
exhaustion, the ``serve_block_alloc`` fault point) frees a victim's blocks
and resets ``num_computed`` to 0 (recompute), so greedy output is
unchanged.

What rides on that, as in JAX:

* **policies** (``serving.scheduler_policy``): ``fcfs`` (arrival order)
  and ``sjf`` (shortest pending work first, aged by ``waited_ticks /
  sjf_aging_steps`` so no job starves; under multi-tenancy scaled by the
  tenant's held slots);
* **deadlines and TTLs** (``deadline_s``, ``max_queue_s``), checked at step
  boundaries: an exceeded request EXPIRES with its blocks reclaimed;
  admission expires a request whose budget cannot cover its prefill at the
  EWMA step time (reason ``budget``);
* **admission control**: ``max_waiting`` bounds the queue and
  ``shed_policy`` (``reject_newest``, ``reject_oldest``, ``by_deadline``)
  picks the victim, a typed :class:`RequestRejected`, never an exception;
* **the pin breaker**: a request preempted ``max_preemptions`` times is
  never victimized again;
* **prefix caching**: admission seeds a request's table from the
  :class:`~automodel_tpu_torch.serving.kv_cache.PrefixIndex`, forks a fully
  cached last block copy-on-write, commits every newly full block, and
  defers a cold twin of an admitted request for one tick;
* **speculation**: on pure-decode steps a proposer drafts up to ``spec_k``
  tokens per sampling row, the step runs at width ``spec_k + 1``, and
  :meth:`Scheduler.finish_step` accepts the longest matching draft prefix
  plus the bonus token (commit runs before acceptance, so no unaccepted
  draft reaches the index);
* **tenants**: ``tenant_quota`` caps concurrent slots per adapter id (the
  request waits, never rejects); per-tenant counters.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import time
from typing import Callable, Dict, List, Optional, Sequence

from automodel_tpu_torch.serving.kv_cache import (
    BlockAllocator,
    OutOfBlocks,
    PrefixIndex,
    blocks_needed,
    normalize_null_spelling,
)
from automodel_tpu_torch.serving.speculative import DEFAULT_SPEC_K
from automodel_tpu_torch.utils.fault_injection import (
    InjectedFault,
    fault_point,
)

# ``serving.scheduler_policy`` config domain (enum-validated at config
# load like cp_layout / moe.dispatch — see loader._enum_fields).
SCHEDULER_POLICIES = ("fcfs", "sjf")
DEFAULT_SCHEDULER_POLICY = "fcfs"

# ``serving.shed_policy`` config domain: what a FULL waiting queue drops.
SHED_POLICIES = ("reject_newest", "reject_oldest", "by_deadline")
DEFAULT_SHED_POLICY = "reject_newest"

# Queue ticks of waiting that halve an sjf job's effective length (the
# aging rate; see the module docstring).  One tick == one schedule() call.
DEFAULT_SJF_AGING_STEPS = 32


def normalize_scheduler_policy(v):
    return normalize_null_spelling(v)


def validate_scheduler_policy(v: Optional[str]) -> Optional[str]:
    if v is None:
        return None
    if v not in SCHEDULER_POLICIES:
        raise ValueError(
            f"serving.scheduler_policy must be one of "
            f"{list(SCHEDULER_POLICIES)} (or null for the default), got "
            f"{v!r}")
    return v


def normalize_shed_policy(v):
    return normalize_null_spelling(v)


def validate_shed_policy(v: Optional[str]) -> Optional[str]:
    if v is None:
        return None
    if v not in SHED_POLICIES:
        raise ValueError(
            f"serving.shed_policy must be one of {list(SHED_POLICIES)} "
            f"(or null for the default), got {v!r}")
    return v


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"
    ABORTED = "aborted"
    # Terminal robustness states — distinct so telemetry/operators can tell
    # "caller cancelled" (ABORTED) from "deadline/TTL ran out" (EXPIRED)
    # from "admission control dropped it" (REJECTED).
    EXPIRED = "expired"
    REJECTED = "rejected"


# Requests compare by IDENTITY (eq=False), never by field value: two
# requests with identical prompts are still distinct units of work, and
# value equality silently corrupts ``req in waiting`` / ``waiting.remove``
# bookkeeping (the slot-reuse aliasing bug class — tier-1 pinned).
@dataclasses.dataclass(eq=False)
class Request:
    """One serving request and its cache bookkeeping."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    state: RequestState = RequestState.WAITING
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    blocks: List[int] = dataclasses.field(default_factory=list)
    num_computed: int = 0          # tokens written to the KV cache
    slot: Optional[int] = None     # step-buffer row while active
    arrival: int = 0               # admission-order tiebreak
    preemptions: int = 0
    # -- multi-tenant serving ----------------------------------------------
    # adapter slot this request decodes under (0 = base model); rides the
    # step buffers as the [B] int32 routing vector and namespaces the
    # request's prefix-cache hash chain
    adapter_id: int = 0
    # -- robustness layer --------------------------------------------------
    deadline_s: Optional[float] = None   # end-to-end budget from submit
    max_queue_s: Optional[float] = None  # WAITING-time TTL
    submit_time: float = 0.0             # scheduler-clock stamp at add()
    submit_tick: int = 0                 # schedule()-tick stamp at add()
    pinned: bool = False                 # never victimized once set
    finish_reason: Optional[str] = None  # why a terminal state was entered
    finish_time: Optional[float] = None  # clock stamp at the terminal state
    # Parked in-flight rows (preempted / watchdog-replayed) re-enter the
    # waiting list but are NOT queue traffic: shedding, drain rejection
    # and the queue TTL all treat them as admitted work — only the
    # deadline (and pool pressure) governs them after first admission.
    was_admitted: bool = False           # ever held a step slot
    # -- prefix caching ----------------------------------------------------
    # A pending COW fork: the step copies block cow_src -> cow_dst before
    # writing; the src ref is HELD until the copy rode a step (or the
    # request released), so the shared source can never be reclaimed and
    # rewritten underneath the fork.
    cow_src: Optional[int] = None
    cow_dst: Optional[int] = None
    chain_key: Optional[str] = None      # hash-chain parent of the next commit
    committed_blocks: int = 0            # leading blocks already indexed
    # uncached chain keys this admitted request will commit (the deferral
    # signal concurrent identical prompts wait on)
    inflight_keys: List[str] = dataclasses.field(default_factory=list)

    @property
    def seq(self) -> List[int]:
        return self.prompt + self.out_tokens

    @property
    def pending(self) -> List[int]:
        return self.seq[self.num_computed:]

    @property
    def finished(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.ABORTED,
                              RequestState.EXPIRED, RequestState.REJECTED)

    def remaining_budget(self, now: float) -> float:
        """Seconds of deadline budget left (inf without a deadline)."""
        if self.deadline_s is None:
            return math.inf
        return self.deadline_s - (now - self.submit_time)


@dataclasses.dataclass(frozen=True)
class RequestRejected:
    """The typed load-shed outcome: admission control dropped ``rid``.

    Returned from :meth:`Scheduler.add` / recorded by the engine — never
    raised, so an overloaded engine loop keeps stepping instead of
    unwinding (the serving-under-fire contract)."""

    rid: int
    reason: str                 # queue_full | draining | shed(injected)
    policy: Optional[str] = None


@dataclasses.dataclass
class RowWork:
    """One step-buffer row's work: ``tokens`` written at positions
    ``start_pos..start_pos+len(tokens)-1``; ``samples_next`` marks the row
    whose sampled token extends the request (pending emptied)."""

    req: Request
    tokens: List[int]
    start_pos: int
    samples_next: bool
    # (src, dst) whole-block COW copy the step must run BEFORE this row's
    # writes; None for the common no-fork case
    cow: Optional[tuple] = None
    # speculative draft tokens written (and verified) AFTER ``tokens`` at
    # positions start_pos+len(tokens).. — deliberately NOT part of
    # ``tokens``: drafts are a guess about the future, never pending work,
    # and ``num_computed`` only ever advances past the accepted ones
    draft: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class StepPlan:
    rows: List[Optional[RowWork]]      # len == max_num_seqs, None = idle
    # 1 (pure decode), spec_k+1 (pure decode, speculation on — ALWAYS,
    # even when every draft came back empty: draft length is data, not
    # shape) or prefill_chunk (any row still prefilling)
    step_width: int

    @property
    def active(self) -> List[RowWork]:
        return [r for r in self.rows if r is not None]


class Scheduler:
    """Admission + step assembly + preemption over ``max_num_seqs`` slots."""

    def __init__(self, allocator: BlockAllocator, *, max_num_seqs: int,
                 prefill_chunk: int, block_size: int, max_model_len: int,
                 policy: str = DEFAULT_SCHEDULER_POLICY,
                 max_waiting: Optional[int] = None,
                 shed_policy: str = DEFAULT_SHED_POLICY,
                 max_preemptions: Optional[int] = None,
                 sjf_aging_steps: int = DEFAULT_SJF_AGING_STEPS,
                 prefix_index: Optional[PrefixIndex] = None,
                 spec_proposer: Optional[Callable] = None,
                 spec_k: int = DEFAULT_SPEC_K,
                 tenant_quota: Optional[int] = None,
                 multi_tenant: bool = False,
                 clock: Callable[[], float] = time.monotonic):
        policy = validate_scheduler_policy(normalize_scheduler_policy(policy))
        shed_policy = validate_shed_policy(
            normalize_shed_policy(shed_policy))
        self.allocator = allocator
        self.max_num_seqs = max_num_seqs
        self.prefill_chunk = prefill_chunk
        self.block_size = block_size
        self.max_model_len = max_model_len
        self.policy = policy or DEFAULT_SCHEDULER_POLICY
        self.max_waiting = max_waiting
        self.shed_policy = shed_policy or DEFAULT_SHED_POLICY
        self.max_preemptions = max_preemptions
        self.sjf_aging_steps = sjf_aging_steps or DEFAULT_SJF_AGING_STEPS
        self.clock = clock
        self.draining = False
        self.waiting: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * max_num_seqs
        self._arrivals = 0
        self._ticks = 0                # schedule() calls (the aging clock)
        self._step_time_ewma: Optional[float] = None
        self.preemptions = 0
        self.admissions = 0
        self.expired = 0
        self.rejected = 0
        self.pins = 0
        # -- prefix caching (counters live even with the index off, so
        # engine/fleet stats read one shape either way) -------------------
        self.prefix_index = prefix_index
        self.prefix_tokens_reused = 0    # prompt tokens NOT re-prefilled
        self.prompt_tokens = 0           # all submitted prompt tokens
        self.cow_forks = 0
        self.cow_fork_failures = 0
        self.prefix_deferrals = 0
        # chain key -> count of admitted requests about to commit it (the
        # deferral signal for concurrent identical prompts)
        self._inflight_keys: Dict[str, int] = {}
        # -- multi-tenant serving -----------------------------------------
        # ``tenant_quota`` caps CONCURRENT slot-holders per adapter id;
        # ``multi_tenant`` gates the sjf tenant fair-share term (off, the
        # sjf key is bit-identical to the single-tenant scheduler)
        self.tenant_quota = tenant_quota
        self.multi_tenant = multi_tenant
        self.tenant_quota_deferrals = 0
        # adapter id -> {"submitted","admitted","finished","tokens"}
        self.per_tenant: Dict[int, Dict[str, int]] = {}
        # -- speculative decoding (serving/speculative.py) ----------------
        # proposer None == off; pure-decode steps then keep width 1 and
        # every spec branch below is dead code (spec-off bit-unchanged)
        self.spec_proposer = spec_proposer
        self.spec_k = spec_k
        self._spec_width = (spec_k + 1) if spec_proposer is not None else 1
        self.spec_tokens_proposed = 0    # drafts that reached a verify step
        self.spec_tokens_accepted = 0
        self.spec_draft_faults = 0
        self.spec_verify_failures = 0
        self.tokens_appended = 0         # out_tokens grown, all rows
        # Accepted-tokens-per-sampling-row EWMA: the admission budget
        # guard prices prefill in STEPS, and speculation makes one step
        # worth >1 token — dividing the priced step count by this keeps
        # admission from spuriously rejecting under speculation.  Spec-off
        # every sampling row appends exactly one token, so the EWMA stays
        # exactly 1.0 and the guard's arithmetic is bit-unchanged.
        self._tokens_per_row_ewma = 1.0

    # -- intake ------------------------------------------------------------
    def add(self, req: Request) -> List[RequestRejected]:
        """Queue one request.  Returns the typed :class:`RequestRejected`
        outcomes this admission caused — empty when ``req`` simply joined
        the queue; under ``reject_oldest`` the victim may be a DIFFERENT
        (older) request.  Impossible requests (can never fit the pool /
        model length) still raise ``ValueError``: that is a caller bug,
        not load."""
        total = len(req.prompt) + req.max_new_tokens
        if total > self.max_model_len:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + "
                f"max_new_tokens {req.max_new_tokens} exceeds "
                f"serving.max_model_len {self.max_model_len}")
        worst = blocks_needed(total, self.block_size)
        if self.prefix_index is not None:
            # A prefix hit means the leading cached blocks are SHARED, not
            # consumed: discount them from the worst case (keeping a
            # one-block margin for the COW fork) so a request whose prompt
            # is fully cached is not rejected for a pool it will barely
            # touch.  The pool-pressure machinery (preemption/parking)
            # still governs actual growth.
            cached = self.prefix_index.peek(
                self.prefix_index.chain_keys(req.prompt, req.adapter_id))
            worst -= max(0, cached - 1)
        if worst > self.allocator.num_blocks - 1:
            raise ValueError(
                f"request {req.rid} needs {worst} KV blocks but the "
                f"pool has {self.allocator.num_blocks - 1} — raise "
                "serving.num_kv_blocks / max_model_len")
        self.prompt_tokens += len(req.prompt)
        self._tenant(req)["submitted"] += 1
        req.arrival = self._arrivals
        self._arrivals += 1
        req.submit_time = self.clock()
        req.submit_tick = self._ticks
        req.state = RequestState.WAITING
        if self.draining:
            return [self._reject(req, "draining")]
        # The drilled load-shed site: an armed ``serve_shed`` behaves
        # exactly like a full waiting queue — the contract is a typed
        # rejection, never an exception out of the engine loop.
        try:
            fault_point("serve_shed")
        except InjectedFault:
            return [self._reject(req, "shed(injected)")]
        out: List[RequestRejected] = []
        if self.max_waiting is not None:
            now = req.submit_time
            while len(self.waiting) >= self.max_waiting:
                victim = self._shed_victim(req, now)
                out.append(self._reject(victim, "queue_full"))
                if victim is req:
                    return out
        self.waiting.append(req)
        return out

    def _shed_victim(self, newcomer: Request, now: float) -> Request:
        # Parked in-flight rows (preempted / watchdog-replayed) are never
        # shed candidates: they are admitted work — rejecting them would
        # discard generated tokens and re-victimize pinned requests.  When
        # the queue holds nothing BUT parked rows, the newcomer bounces.
        fresh = [r for r in self.waiting if not r.was_admitted]
        if self.shed_policy == "reject_oldest":
            if not fresh:
                return newcomer
            return min(fresh, key=lambda r: r.arrival)
        if self.shed_policy == "by_deadline":
            # drop the request most likely to miss anyway: least remaining
            # budget first; no-deadline requests (inf budget) shed
            # newest-first among themselves
            return min(fresh + [newcomer],
                       key=lambda r: (r.remaining_budget(now), -r.arrival))
        return newcomer                                  # reject_newest

    def _reject(self, req: Request, reason: str) -> RequestRejected:
        if req in self.waiting:
            self.waiting.remove(req)
        req.state = RequestState.REJECTED
        req.finish_reason = reason
        req.finish_time = self.clock()
        self.rejected += 1
        return RequestRejected(rid=req.rid, reason=reason,
                               policy=self.shed_policy)

    def abort(self, req: Request) -> None:
        """Cancel anywhere in the lifecycle: frees the block table
        IMMEDIATELY (mid-chunked-prefill included — partially-written KV
        blocks return to the free list right here, never deferred to the
        next ``schedule()``), vacates the slot — the
        ``serve_request_abort`` contract."""
        if req.finished:
            return
        self._release(req)
        req.state = RequestState.ABORTED
        req.finish_reason = "abort"
        req.finish_time = self.clock()

    def expire(self, req: Request, reason: str = "deadline") -> None:
        """Deadline/TTL cancellation: same reclaim path as an abort but the
        terminal state is EXPIRED — "we were too slow", not "caller
        cancelled"."""
        if req.finished:
            return
        self._release(req)
        req.state = RequestState.EXPIRED
        req.finish_reason = reason
        req.finish_time = self.clock()
        self.expired += 1

    def _release(self, req: Request) -> None:
        """Vacate slot + decref the whole block table (and any pending COW
        source ref) back to the allocator."""
        if req in self.waiting:
            self.waiting.remove(req)
        if req.slot is not None:
            self.slots[req.slot] = None
            req.slot = None
        self._drop_chain_state(req)
        if req.blocks:
            self.allocator.free(req.blocks)
            req.blocks = []

    def _drop_chain_state(self, req: Request) -> None:
        """Forget a request's prefix-chain bookkeeping: release the held
        COW-source ref and the in-flight commit claims.  The block TABLE
        is the caller's to free — this never touches ``req.blocks``."""
        if req.cow_src is not None:
            self.allocator.free([req.cow_src])
        req.cow_src = None
        req.cow_dst = None
        req.chain_key = None
        req.committed_blocks = 0
        self._unregister_inflight(req)

    def requeue_for_replay(self, req: Request) -> None:
        """Watchdog recovery: park an admitted request back to WAITING with
        its blocks reclaimed and ``num_computed`` reset — the recompute
        replay re-prefills prompt + generated-so-far, so greedy output
        stays token-identical.  The replayed request is PINNED (never
        re-victimized) so recovery cannot stack preemptions on top of the
        stall it just absorbed."""
        if req.finished:
            return
        self._release(req)
        req.num_computed = 0
        req.state = RequestState.WAITING
        req.pinned = True
        if req not in self.waiting:
            self.waiting.append(req)

    def adopt_replay(self, req: Request) -> None:
        """Adopt an admitted request harvested from ANOTHER scheduler
        (fleet replica loss — ``serving/fleet.py``): same recompute-replay
        parking as :meth:`requeue_for_replay`, but the row also gets THIS
        scheduler's arrival/tick stamps so aging and step-relative
        bookkeeping stay monotone.  ``submit_time`` is deliberately KEPT —
        the fleet shares one clock, and a replayed request's deadline/TTL
        budget is end-to-end, not per-engine.  The row arrives with no
        slot/blocks (the dead engine's harvest already released them) and
        stays ``was_admitted``+pinned, so shed/drain/TTL never discard it."""
        if req.finished:
            return
        req.arrival = self._arrivals
        self._arrivals += 1
        req.submit_tick = self._ticks
        req.slot = None
        req.blocks = []
        req.num_computed = 0
        # the dead engine's chain state died with its pools: the refs were
        # released by the harvest, and THIS scheduler's index re-seeds on
        # re-admission
        req.cow_src = None
        req.cow_dst = None
        req.chain_key = None
        req.committed_blocks = 0
        req.inflight_keys = []
        req.state = RequestState.WAITING
        req.pinned = True
        if req not in self.waiting:
            self.waiting.append(req)

    @property
    def active(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    def note_step_time(self, seconds: float) -> None:
        """Feed one observed device-step wall time into the EWMA the
        admission budget check prices prefill steps with."""
        if seconds <= 0:
            return
        if self._step_time_ewma is None:
            self._step_time_ewma = seconds
        else:
            self._step_time_ewma = 0.5 * self._step_time_ewma + 0.5 * seconds

    # -- internals ---------------------------------------------------------
    def _tenant(self, req: Request) -> Dict[str, int]:
        d = self.per_tenant.get(req.adapter_id)
        if d is None:
            d = {"submitted": 0, "admitted": 0, "finished": 0, "tokens": 0}
            self.per_tenant[req.adapter_id] = d
        return d

    def _tenant_active(self, adapter_id: int) -> int:
        return sum(1 for r in self.active if r.adapter_id == adapter_id)

    def _policy_key(self, req: Request, now: float):
        if self.policy == "sjf":
            work = (len(req.pending) + req.max_new_tokens
                    - len(req.out_tokens))
            waited = self._ticks - req.submit_tick
            aged = work / (1.0 + waited / float(self.sjf_aging_steps))
            if self.multi_tenant:
                # tenant fair-share: a tenant already holding k slots sees
                # its next request's effective work scaled by (1 + k), so
                # under contention idle tenants admit first.  Uniform
                # traffic (all one tenant) scales every key by the same
                # factor — ordering, and base-only behavior, unchanged.
                aged *= 1.0 + self._tenant_active(req.adapter_id)
            return (aged, req.remaining_budget(now), req.arrival)
        return req.arrival                                   # fcfs

    def _allocate(self, n: int) -> List[int]:
        # The drilled KV-exhaustion site: an armed ``serve_block_alloc``
        # fires here exactly like a genuinely empty free list, and the
        # caller's preemption path must absorb both identically.
        fault_point("serve_block_alloc")
        return self.allocator.allocate(n)

    def _preempt(self, victim: Request) -> None:
        assert victim.slot is not None
        self.slots[victim.slot] = None
        victim.slot = None
        self._drop_chain_state(victim)
        if victim.blocks:
            self.allocator.free(victim.blocks)
            victim.blocks = []
        victim.num_computed = 0          # recompute policy (see docstring)
        victim.state = RequestState.WAITING
        victim.preemptions += 1
        self.preemptions += 1
        if (self.max_preemptions is not None and not victim.pinned
                and victim.preemptions >= self.max_preemptions):
            # the preemption-storm breaker: from here on this request is
            # never re-victimized, so recompute cannot livelock
            victim.pinned = True
            self.pins += 1
        self.waiting.append(victim)

    def _ensure_blocks(self, req: Request, new_total: int) -> bool:
        """Grow ``req``'s block table to cover ``new_total`` positions,
        preempting strictly-younger UNPINNED active requests (youngest
        first) while the pool is exhausted; parks ``req`` itself when no
        victim remains.  Returns False when ``req`` was preempted."""
        need = blocks_needed(new_total, self.block_size) - len(req.blocks)
        while True:
            try:
                if need > 0:
                    req.blocks.extend(self._allocate(need))
                return True
            except (OutOfBlocks, InjectedFault) as e:
                younger = [r for r in self.active
                           if r is not req and r.arrival > req.arrival
                           and not r.pinned]
                if younger:
                    self._preempt(max(younger, key=lambda r: r.arrival))
                    continue
                if (len(self.active) > 1 or req.blocks
                        or isinstance(e, InjectedFault)):
                    # an injected alloc failure is always absorbed as a
                    # preemption (the drilled contract: never a crash);
                    # genuine exhaustion only raises in the provably
                    # impossible solo-request-no-blocks state below.  A
                    # pinned requester still parks ITSELF — that is not a
                    # victimization, and holding a half-grown table would
                    # deadlock the pool.
                    self._preempt(req)
                    return False
                raise OutOfBlocks(
                    f"request {req.rid} alone cannot fit: needs {need} more "
                    f"blocks, pool has {self.allocator.num_blocks - 1} "
                    "total — raise serving.num_kv_blocks")

    def _min_prefill_s(self, req: Request) -> Optional[float]:
        """Lower bound on wall time to prefill ``req``'s pending tokens —
        ``ceil(pending / prefill_chunk)`` steps at the EWMA step cost
        (None before any step has been observed)."""
        if self._step_time_ewma is None:
            return None
        steps = blocks_needed(len(req.pending), self.prefill_chunk)
        # normalize by accepted-tokens-per-row: under speculation the EWMA
        # step cost is a WIDE (spec_k+1) step worth >1 token of progress,
        # so pricing prefill at the raw step cost would overcharge and
        # spuriously expire admissible requests.  Spec-off the divisor is
        # exactly 1.0 (x / 1.0 is bitwise x — behavior unchanged).
        return steps * self._step_time_ewma / self._tokens_per_row_ewma

    def _expire_due(self, now: float) -> None:
        """The step-boundary deadline sweep (active AND waiting rows),
        plus queue-TTL enforcement on waiting rows."""
        # The drilled deadline site: an armed ``serve_deadline`` models
        # the oldest active request's deadline firing right now —
        # terminal EXPIRED, blocks reclaimed, every other row unaffected.
        try:
            fault_point("serve_deadline")
        except InjectedFault:
            victims = self.active
            if victims:
                self.expire(min(victims, key=lambda r: r.arrival),
                            reason="deadline(injected)")
        for req in list(self.active):
            if req.remaining_budget(now) <= 0:
                self.expire(req, reason="deadline")
        for req in list(self.waiting):
            if req.remaining_budget(now) <= 0:
                self.expire(req, reason="deadline")
            elif (not req.was_admitted and req.max_queue_s is not None
                    and now - req.submit_time > req.max_queue_s):
                # the TTL is an ADMISSION bound ("drop me if I can't even
                # start within X"): a request that was admitted, ran, and
                # was parked back is in-flight work — discarding its
                # generated tokens on a queue timer would be a silent
                # data loss; only its deadline governs it now
                self.expire(req, reason="queue_ttl")

    # -- prefix caching ----------------------------------------------------
    def _try_prefix_seed(self, req: Request) -> bool:
        """Consult the prefix index for ``req`` at the admission boundary:
        a hit seeds the block table with shared ids and fast-forwards
        ``num_computed`` (chunked prefill covers only the cold tail); a
        fully-cached sequence forks its last block copy-on-write.  Returns
        True when admission should be DEFERRED this tick — the request's
        next uncached block is already being computed by an admitted twin
        (a GRPO group's followers wait for the leader's commits instead of
        paying G duplicate prefills)."""
        idx = self.prefix_index
        if idx is None or req.blocks or req.num_computed:
            return False         # cache off, or a replay already seeded/ran
        tokens = req.seq
        keys = idx.chain_keys(tokens, req.adapter_id)
        if not keys:
            return False
        cached = idx.peek(keys)
        if cached < len(keys) and keys[cached] in self._inflight_keys:
            self.prefix_deferrals += 1
            return True
        if cached == 0:
            return False
        # The drilled lookup site: an armed ``kv_prefix_lookup`` degrades
        # to a cold prefill — byte-identical output, just no reuse.
        try:
            fault_point("kv_prefix_lookup")
        except InjectedFault:
            idx.lookups += 1
            idx.misses += 1
            return False
        chain = idx.acquire(keys)
        matched = len(chain) * self.block_size
        if matched > len(tokens) - 1:
            # the chain covers the WHOLE sequence: the last block must be
            # writable (the next decode token lands in it, or its final
            # slot is the sampled-next position) — fork it copy-on-write.
            # The drilled fork site: an armed ``kv_cow_fork`` (or genuine
            # exhaustion) drops the chain and falls back to a cold
            # prefill — the shared source block is never touched.
            src = chain[-1]
            try:
                fault_point("kv_cow_fork")
                dst = self.allocator.allocate(1)[0]
            except (OutOfBlocks, InjectedFault):
                self.allocator.free(chain)
                self.cow_fork_failures += 1
                return False
            req.cow_src = src          # ref held until the copy rode a step
            req.cow_dst = dst
            chain = chain[:-1] + [dst]
            matched -= 1               # dst's last slot is still cold
            self.cow_forks += 1
            req.committed_blocks = len(chain) - 1
            req.chain_key = keys[len(chain) - 2] if len(chain) >= 2 else None
        else:
            req.committed_blocks = len(chain)
            req.chain_key = keys[len(chain) - 1]
        req.blocks = list(chain)
        req.num_computed = matched
        return False

    def _unseed(self, req: Request) -> None:
        """Back out a prefix seed when admission bounced AFTER seeding:
        refs return to the allocator and the request is cold again."""
        self._drop_chain_state(req)
        if req.blocks:
            self.allocator.free(req.blocks)
            req.blocks = []
        req.num_computed = 0

    def _register_inflight(self, req: Request) -> None:
        """Claim the uncached chain keys this admitted request will commit
        as its prefill progresses — concurrent identical prompts defer on
        these instead of duplicating the work."""
        idx = self.prefix_index
        if idx is None:
            return
        keys = idx.chain_keys(req.seq, req.adapter_id)
        req.inflight_keys = [k for k in keys[req.committed_blocks:]
                             if not idx.has_key(k)]
        for k in req.inflight_keys:
            self._inflight_keys[k] = self._inflight_keys.get(k, 0) + 1

    def _unregister_inflight(self, req: Request) -> None:
        for k in req.inflight_keys:
            n = self._inflight_keys.get(k, 0) - 1
            if n <= 0:
                self._inflight_keys.pop(k, None)
            else:
                self._inflight_keys[k] = n
        req.inflight_keys = []

    def _commit_full(self, req: Request) -> None:
        """Index every newly-FULL block of ``req`` (prompt AND decode
        output — multi-turn reuse and preemption replay both hit them).
        First writer wins on key collisions; committed keys leave the
        in-flight claim so deferred twins admit next tick."""
        idx = self.prefix_index
        if idx is None:
            return
        bs = self.block_size
        seq = req.seq
        full = min(req.num_computed // bs, len(req.blocks))
        while req.committed_blocks < full:
            i = req.committed_blocks
            # block 0 commits under the request's TENANT root, not the
            # bare None parent — otherwise a cold non-base request would
            # index its first block where base traffic can hit it (the
            # cross-tenant KV leak chain_keys() namespacing guards against)
            parent = (req.chain_key if req.committed_blocks
                      else idx.root_key(req.adapter_id))
            key = idx.commit(parent, seq[i * bs:(i + 1) * bs],
                             req.blocks[i])
            req.chain_key = key
            req.committed_blocks += 1
            if req.inflight_keys and req.inflight_keys[0] == key:
                req.inflight_keys.pop(0)
                n = self._inflight_keys.get(key, 0) - 1
                if n <= 0:
                    self._inflight_keys.pop(key, None)
                else:
                    self._inflight_keys[key] = n

    def _admit(self, now: float) -> None:
        for req in sorted(self.waiting,
                          key=lambda r: self._policy_key(r, now)):
            free_slots = [i for i, r in enumerate(self.slots) if r is None]
            if not free_slots:
                return
            if (self.tenant_quota is not None
                    and self._tenant_active(req.adapter_id)
                    >= self.tenant_quota):
                # per-tenant admission quota: this tenant already holds its
                # share of slots — the request WAITS (no rejection, no
                # expiry) and other tenants' rows admit past it
                self.tenant_quota_deferrals += 1
                continue
            if self._try_prefix_seed(req):
                continue         # deferred: an admitted twin is prefilling
            min_prefill = self._min_prefill_s(req)
            if (min_prefill is not None
                    and req.remaining_budget(now) < min_prefill):
                # a guaranteed deadline miss never occupies a slot: expire
                # at the admission boundary instead of wasting pool space
                # (a seeded chain is released through the expire path)
                self.expire(req, reason="budget")
                continue
            first_chunk = min(len(req.pending), self.prefill_chunk)
            if self.allocator.free_blocks * self.block_size < first_chunk:
                self._unseed(req)
                continue         # in-flight admission waits for frees
            self.waiting.remove(req)
            req.slot = free_slots[0]
            self.slots[req.slot] = req
            req.state = RequestState.PREFILL
            req.was_admitted = True
            self.admissions += 1
            self._tenant(req)["admitted"] += 1
            self._register_inflight(req)
            self.prefix_tokens_reused += req.num_computed

    # -- speculative decoding ----------------------------------------------
    def _propose_draft(self, req: Request, k_max: int) -> List[int]:
        """Host-side draft proposal for one sampling DECODE row: at most
        ``min(spec_k, k_max, tokens-the-request-can-still-emit - 1)``
        tokens from the proposer (the ``- 1`` reserves the bonus token, and
        also bounds every draft's write position below ``prompt +
        max_new_tokens <= max_model_len``).  Stateless: recompute replay,
        watchdog rebuild and fleet adoption re-draft from ``req.seq``
        alone, so there is no draft state to flush or migrate."""
        k_cap = min(self.spec_k, k_max,
                    req.max_new_tokens - len(req.out_tokens) - 1)
        if k_cap <= 0:
            return []
        # The drilled proposer-failure site: an armed ``spec_draft``
        # degrades THIS row to plain decode for the step (empty draft,
        # same verify width) — byte-identical output, just no speedup.
        try:
            fault_point("spec_draft")
        except InjectedFault:
            self.spec_draft_faults += 1
            return []
        return [int(t) for t in self.spec_proposer(req.seq, k_cap)][:k_cap]

    # -- the per-step contract --------------------------------------------
    def schedule(self, now: Optional[float] = None) -> Optional[StepPlan]:
        """Expire what ran out of time, admit what fits, grow block tables
        (preempting under pressure), and emit this step's
        :class:`StepPlan` — or None when idle."""
        if now is None:
            now = self.clock()
        self._ticks += 1
        self._expire_due(now)
        self._admit(now)
        if not self.active:
            return None
        # Pure-decode steps run at the SPEC width whenever speculation is
        # on (spec_k+1; 1 when off) — even for rows whose proposer came
        # back empty — so acceptance/rejection/draft-length churn is data
        # inside one compiled program, never a new shape.
        any_prefill = any(len(r.pending) > 1 for r in self.active)
        width = self.prefill_chunk if any_prefill else self._spec_width
        speculate = self.spec_proposer is not None and not any_prefill
        rows: List[Optional[RowWork]] = [None] * self.max_num_seqs
        for req in list(self.active):
            if req.slot is None:
                continue       # preempted by an earlier row's allocation
            t = min(len(req.pending), width)
            samples_next = req.num_computed + t == len(req.seq)
            draft = (self._propose_draft(req, width - t)
                     if speculate and samples_next else [])
            if not self._ensure_blocks(req, req.num_computed + t
                                       + len(draft)):
                continue                       # preempted back to WAITING
            rows[req.slot] = RowWork(
                req=req, tokens=req.pending[:t], start_pos=req.num_computed,
                samples_next=samples_next, draft=draft,
                cow=((req.cow_src, req.cow_dst)
                     if req.cow_dst is not None else None))
        for i, w in enumerate(rows):
            if w is not None and w.req.slot != i:
                # a LATER row's allocation preempted this already-planned
                # victim (slot order can diverge from arrival order after a
                # finish + re-admission): its blocks are freed and its
                # num_computed reset, so the stale RowWork must not run
                rows[i] = None
        if not any(r is not None for r in rows):
            return self.schedule(now) if self.has_work() else None
        return StepPlan(rows=rows, step_width=width)

    def finish_step(self, plan: StepPlan,
                    sampled: Dict[int, Sequence[int]]) -> List[Request]:
        """Apply one executed plan: advance ``num_computed``, append the
        sampled tokens where the pending list emptied, retire finished
        requests (freeing their blocks).  ``sampled`` maps slot -> the
        row's greedy/sampled chain: entry 0 is the token after the last
        pending token (plain decode's one sample); entries ``1..d`` are
        the argmax AT the row's ``d`` draft positions — the verify read.
        The longest draft prefix matching the chain is accepted, plus the
        bonus token after it; ``num_computed`` advances past accepted
        drafts ONLY (their KV is valid), never the bonus token and never
        a rejected position — rejected slots are dead KV past the
        high-water mark, overwritten by whatever comes next.  Rows whose
        request reached a terminal state mid-step (an abort or watchdog
        expiry issued between ``schedule()`` and here) are skipped —
        their blocks were already reclaimed and their replay state must
        not be advanced by stale device results."""
        done: List[Request] = []
        # The drilled verify-failure site: an armed ``spec_verify`` models
        # the whole verify step's draft results being unusable — EVERY
        # draft this step is discarded with no partial acceptance (m=0),
        # each sampling row keeps only its plain-decode token (chain[0],
        # valid regardless of drafts), and KV state is clean because
        # nothing past ``num_computed`` is ever committed or shared.
        verify_failed = False
        if any(w.draft for w in plan.active):
            try:
                fault_point("spec_verify")
            except InjectedFault:
                verify_failed = True
                self.spec_verify_failures += 1
        sampling_rows = 0
        appended_total = 0
        for work in plan.active:
            req = work.req
            if req.finished or req.slot is None:
                continue
            req.num_computed += len(work.tokens)
            if work.cow is not None and req.cow_src is not None:
                # the COW copy rode this step: the private dst now holds
                # the shared slots, so the source ref can be released
                self.allocator.free([req.cow_src])
                req.cow_src = None
                req.cow_dst = None
            # Commit BEFORE acceptance: ``num_computed`` here covers no
            # draft token, so an unaccepted draft can never reach the
            # prefix index even transiently (accepted ones commit next
            # step, once they are provably part of the sequence).
            self._commit_full(req)
            if not work.samples_next:
                continue
            raw = sampled[req.slot]
            # a bare int is the no-draft chain of one (plain decode
            # callers — and the pre-speculation contract — pass scalars)
            chain = ([int(t) for t in raw]
                     if isinstance(raw, (list, tuple)) else [int(raw)])
            m = 0
            if work.draft:
                self.spec_tokens_proposed += len(work.draft)
                if not verify_failed:
                    while (m < len(work.draft)
                           and work.draft[m] == chain[m]):
                        m += 1
                self.spec_tokens_accepted += m
            appended = 0
            finish_reason = None
            for tok in chain[:m + 1]:
                req.out_tokens.append(tok)
                appended += 1
                if (req.eos_token_id is not None
                        and tok == req.eos_token_id):
                    finish_reason = "eos"
                    break
                if len(req.out_tokens) >= req.max_new_tokens:
                    finish_reason = "length"
                    break
            # accepted drafts already sit in the KV cache; the bonus token
            # (position m in the chain) does not — it is next step's
            # pending token, exactly like plain decode's sampled token
            req.num_computed += min(appended, m)
            sampling_rows += 1
            appended_total += appended
            self.tokens_appended += appended
            self._tenant(req)["tokens"] += appended
            if finish_reason is not None:
                self.slots[req.slot] = None
                req.slot = None
                self._drop_chain_state(req)
                if req.blocks:
                    self.allocator.free(req.blocks)
                    req.blocks = []
                req.state = RequestState.FINISHED
                req.finish_reason = finish_reason
                req.finish_time = self.clock()
                self._tenant(req)["finished"] += 1
                done.append(req)
            else:
                req.state = RequestState.DECODE
        if sampling_rows:
            # the admission guard's tokens-per-row EWMA (see __init__):
            # spec-off the mean is exactly 1.0 every update, so the EWMA
            # is the constant 1.0 and the guard is bit-unchanged
            mean = appended_total / sampling_rows
            self._tokens_per_row_ewma = (
                0.5 * self._tokens_per_row_ewma + 0.5 * mean)
        return done
