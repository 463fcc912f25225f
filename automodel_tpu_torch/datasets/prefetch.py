"""Asynchronous input pipeline: bounded background prefetch over a loader
(counterpart: ``automodel_tpu/datasets/prefetch.py``).

:class:`PrefetchDataLoader` moves the host work of the input side -- the
dataset reads, the collate into numpy arrays -- onto one producer thread
with a bounded queue of ``prefetch_depth`` batches, so the training loop's
``next()`` is a queue pop while the card runs the previous step.  The
producer touches no tensor and no CUDA API: host-to-device copies stay on
the training thread (``training/train_step.py::to_device_batch``).

Resume state.  :class:`~automodel_tpu_torch.datasets.dataloader.
StatefulDataLoader` advances its position *before* yielding, so with k
batches queued the inner loader's live ``state_dict()`` runs up to k
batches ahead of what training consumed.  The producer snapshots the inner
state beside every batch, and three positions are kept apart:

* **produced** -- the inner loader's live state (ahead; never persisted);
* **pending** -- the snapshot of the last batch ``next()`` handed out
  (:meth:`pending_state`), "resume after that batch";
* **committed** -- the snapshot of the last batch whose optimizer step ran
  (:meth:`commit_state`); :meth:`state_dict` returns it, so a resume starts
  at exactly the next unconsumed batch.

The recipe takes the pending snapshot before a step and commits it after
the step (``recipes/llm/train_ft.py::_run_train_optim_step``).

Failures: any exception in the producer (the dataset, the collate, an
armed ``AUTOMODEL_FAULT=input_producer``) is passed through the queue and
raised by the consumer's next ``next()``.  On shutdown (epoch end,
``max_steps``, an abandoned iterator, ``close()``) the producer is stopped
and joined, and the inner loader is rewound to the last *yielded* batch, so
a later ``iter()`` continues exactly where the consumer left off: the
stream is the synchronous (``prefetch_depth: 0``) one, batch for batch.
"""

from __future__ import annotations

import copy
import logging
import queue
import threading
import time
from typing import Any, Iterator, Optional, Tuple

from automodel_tpu_torch.utils.fault_injection import fault_point

logger = logging.getLogger(__name__)

_ITEM, _END, _ERR = 0, 1, 2
_POLL_S = 0.05
PRODUCER_THREAD_NAME = "automodel-input-producer"


class _Producer:
    """One background pass over the inner loader (one epoch of iteration).
    A daemon thread; every blocking queue operation polls a stop event, so
    neither side can deadlock the process."""

    def __init__(self, loader: Any, depth: int):
        self.loader = loader
        self.queue: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
        self.stop = threading.Event()
        self.produce_s = 0.0      # host seconds spent producing batches
        self.thread = threading.Thread(target=self._run,
                                       name=PRODUCER_THREAD_NAME, daemon=True)
        self.thread.start()

    def _put(self, item) -> bool:
        while not self.stop.is_set():
            try:
                self.queue.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _snapshot(self) -> Optional[dict]:
        if hasattr(self.loader, "state_dict"):
            return copy.deepcopy(self.loader.state_dict())
        return None

    def _run(self) -> None:
        try:
            it = iter(self.loader)
            while not self.stop.is_set():
                fault_point("input_producer")
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    # the state after exhaustion (the epoch has rolled)
                    self._put((_END, self._snapshot()))
                    return
                self.produce_s += time.perf_counter() - t0
                # the state advanced before the yield: "resume after batch"
                if not self._put((_ITEM, (batch, self._snapshot()))):
                    return
        except BaseException as e:          # raised again by the consumer
            self._put((_ERR, e))

    def get(self) -> Tuple[int, Any]:
        while True:
            try:
                return self.queue.get(timeout=_POLL_S)
            except queue.Empty:
                if not self.thread.is_alive():
                    # the last item may have landed between the timeout
                    # and the liveness check
                    try:
                        return self.queue.get_nowait()
                    except queue.Empty:
                        raise RuntimeError(
                            "input producer thread died without reporting")

    def shutdown(self) -> bool:
        """Stop and join; True when the thread exited (False: still stuck
        inside the dataset)."""
        self.stop.set()
        while True:      # unblock a producer parked on a full queue
            try:
                self.queue.get_nowait()
            except queue.Empty:
                break
        self.thread.join(timeout=10.0)
        return not self.thread.is_alive()


class PrefetchDataLoader:
    """Bounded background prefetch around a ``StatefulDataLoader``-like
    loader, with consumed-batch resume semantics (module docstring).
    Iteration, ``len()``, ``set_epoch``, ``state_dict`` /
    ``load_state_dict`` and attribute access delegate to the inner loader.
    ``prefetch_depth`` must be >= 1: depth 0 is "no wrapper"
    (:func:`wrap_prefetch`)."""

    def __init__(self, loader: Any, prefetch_depth: int = 2):
        if int(prefetch_depth) < 1:
            raise ValueError(
                "prefetch_depth must be >= 1 for PrefetchDataLoader; use "
                "wrap_prefetch (or the bare loader) for depth 0")
        self.loader = loader
        self.prefetch_depth = int(prefetch_depth)
        self._producer: Optional[_Producer] = None
        self._pending: Optional[dict] = None    # after the last YIELDED batch
        self._committed: Optional[dict] = None  # after the last CONSUMED one
        # on clean exhaustion: (last batch's snapshot, post-epoch state)
        self._exhausted: Optional[Tuple[Optional[dict], Optional[dict]]] = None
        # where a shutdown rewinds the inner loader: the last yielded batch
        # of the active pass
        self._rewind_target: Optional[dict] = None
        # a producer that outlived its join timeout; no pass starts while it
        # is alive
        self._zombie: Optional[threading.Thread] = None
        self._produce_s_done = 0.0

    @property
    def produce_s(self) -> float:
        """Host seconds the producer threads spent producing batches."""
        live = self._producer.produce_s if self._producer is not None else 0.0
        return self._produce_s_done + live

    # -- iteration ---------------------------------------------------------
    def __iter__(self) -> Iterator[Any]:
        # a restart while an earlier pass is live first rewinds to that
        # pass's last yielded batch, so its queued lookahead is replayed
        self.close()
        if self._zombie is not None:
            if self._zombie.is_alive():
                raise RuntimeError(
                    "a previous input producer thread is still running "
                    "(stalled dataset read?); refusing to start a "
                    "concurrent pass over the same loader")
            self._zombie = None
            self._apply_rewind()       # the rewind deferred at its shutdown
        self._exhausted = None
        self._rewind_target = (copy.deepcopy(self.loader.state_dict())
                               if hasattr(self.loader, "state_dict")
                               else None)
        prod = _Producer(self.loader, self.prefetch_depth)
        self._producer = prod
        try:
            while True:
                kind, payload = prod.get()
                if kind == _END:
                    self._exhausted = (self._rewind_target, payload)
                    if (payload is not None and self._committed is not None
                            and self._committed == self._rewind_target):
                        # every yielded batch was consumed: the committed
                        # state becomes the post-epoch one
                        self._committed = copy.deepcopy(payload)
                    self._rewind_target = payload   # do not unroll the epoch
                    return
                if kind == _ERR:
                    raise payload
                batch, snap = payload
                self._rewind_target = snap
                self._pending = snap
                yield batch
        finally:
            # exhaustion, error, break, max_steps or a collected generator;
            # a pass that close() already superseded owns nothing
            if self._producer is prod:
                self._producer = None
                self._stop_and_rewind(prod)

    def close(self) -> None:
        """Stop any active producer and rewind the inner loader to the last
        yielded batch (idempotent)."""
        prod, self._producer = self._producer, None
        if prod is not None:
            self._stop_and_rewind(prod)

    def _stop_and_rewind(self, prod: _Producer) -> None:
        self._produce_s_done += prod.produce_s
        if prod.shutdown():
            self._apply_rewind()
            return
        # a producer stuck inside the dataset could overwrite a rewind when
        # it wakes: leave the live state alone and rewind once it is dead
        self._zombie = prod.thread
        logger.warning(
            "input producer thread did not stop within its join timeout; "
            "deferring the loader rewind until it exits")

    def _apply_rewind(self) -> None:
        if (self._rewind_target is not None
                and hasattr(self.loader, "load_state_dict")):
            self.loader.load_state_dict(copy.deepcopy(self._rewind_target))

    # -- consumed-state contract --------------------------------------------
    def pending_state(self) -> Optional[dict]:
        """Snapshot of the last batch ``next()`` handed out ("resume after
        that batch"); pass it to :meth:`commit_state` once that batch's
        optimizer step has run."""
        return self._pending

    def commit_state(self, snap: Optional[dict]) -> None:
        if snap is None:
            return
        fin = self._exhausted
        if fin is not None and fin[1] is not None and snap == fin[0]:
            snap = fin[1]       # last batch of an exhausted pass
        self._committed = copy.deepcopy(snap)

    # -- StatefulDataLoader surface ----------------------------------------
    def state_dict(self) -> dict:
        if self._committed is not None:
            return copy.deepcopy(self._committed)
        if self._pending is not None:
            # no commits yet: resume after the last yielded batch (the live
            # inner state would skip the queued lookahead)
            return copy.deepcopy(self._pending)
        return self.loader.state_dict()

    def load_state_dict(self, sd: dict) -> None:
        self.close()
        self.loader.load_state_dict(sd)
        self._committed = copy.deepcopy(sd)
        self._pending = None
        self._exhausted = None

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __getattr__(self, name: str) -> Any:
        if name == "loader":      # never recurse before __init__ ran
            raise AttributeError(name)
        return getattr(self.loader, name)


def wrap_prefetch(loader: Any, prefetch_depth: Optional[int]) -> Any:
    """``prefetch_depth >= 1`` -> :class:`PrefetchDataLoader`; 0 or None ->
    the loader unchanged (the synchronous path)."""
    depth = 0 if prefetch_depth is None else int(prefetch_depth)
    if depth <= 0:
        return loader
    return PrefetchDataLoader(loader, depth)
