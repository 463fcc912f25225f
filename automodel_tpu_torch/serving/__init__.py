"""Serving of the port: the paged-KV decode engine and its features
(counterpart: ``automodel_tpu/serving``).

Layout::

    serving/
      kv_cache.py   block pools, the refcounting allocator, the paged view
                    and the content-hash PrefixIndex (shared blocks,
                    copy-on-write forks)
      scheduler.py  per-request state machine, chunked prefill, preemption,
                    deadlines / TTLs, admission control, the pin breaker,
                    sjf, prefix seeding, speculative acceptance, tenants
      engine.py     the host decode loop over the model's forward, the
                    watchdog and the graceful drain
      speculative.py
                    the n-gram draft proposer and the acceptance rule
      fleet.py      the elastic fleet: routing, the fleet-level shed,
                    replica loss -> replay on survivors, grow-back warmed
                    from a live peer's weights
      adapters.py   multi-tenant LoRA slots: device slabs, hot-swap,
                    per-row routing through the gmm kernel
      eval.py       greedy continuation scoring via the engine or
                    ``generate()``
"""

from automodel_tpu_torch.serving.adapters import (  # noqa: F401
    DEFAULT_ADAPTER_RANK,
    AdapterLoadError,
    AdapterSlots,
)
from automodel_tpu_torch.serving.engine import (  # noqa: F401
    DecodeEngine,
    ServingConfig,
    build_serving_config,
)
from automodel_tpu_torch.serving.fleet import (  # noqa: F401
    ROUTER_POLICIES,
    FleetRouter,
)
from automodel_tpu_torch.serving.kv_cache import (  # noqa: F401
    KV_CACHE_DTYPES,
    PREFIX_CACHING_MODES,
    BlockAllocator,
    OutOfBlocks,
    PagedKVView,
    PrefixIndex,
)
from automodel_tpu_torch.serving.scheduler import (  # noqa: F401
    SCHEDULER_POLICIES,
    SHED_POLICIES,
    Request,
    RequestRejected,
    RequestState,
    RowWork,
    Scheduler,
    StepPlan,
)
from automodel_tpu_torch.serving.speculative import (  # noqa: F401
    DEFAULT_SPEC_K,
    SPECULATIVE_MODES,
    NgramProposer,
    propose_ngram,
)
