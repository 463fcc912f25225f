"""Online eval: score each committed checkpoint as the committer
publishes it (counterpart: ``automodel_tpu/post_training/eval_watch.py``).

The watcher polls the checkpoint root for committed ``epoch_*_step_*``
directories (the commit is an atomic rename, so ``.tmp`` staging
directories are never seen), loads each new checkpoint's HF weights into
its own model and scores them through ``serving/eval.py`` (greedy
continuation scoring, through the engine or ``generate()``), logging
``eval/*``.  The recipes' ``online_eval:`` hook runs it on a background
thread in the training process; the loop only drains its results.  A
checkpoint is scored at most once, and a scoring failure warns and moves
on: eval is telemetry.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from automodel_tpu_torch.checkpoint import checkpointing as ckpt

logger = logging.getLogger(__name__)


class CheckpointEvalWatcher:
    """Polls a checkpoint root and scores each newly committed checkpoint.

    ``model`` is the watcher's own (each checkpoint's weights are loaded
    into it; pass a copy, never the model being trained); ``rows``:
    ``(prompt, gold continuation)`` pairs as ``serving/eval.py::
    rows_from_dataset`` makes them; ``device`` where the scoring runs.
    """

    def __init__(self, model, checkpoint_dir: str, rows, *,
                 via: str = "engine", max_new_tokens: Optional[int] = None,
                 serving=None, device=None,
                 on_result: Optional[Callable[[Dict], None]] = None,
                 poll_interval_s: float = 10.0):
        if not rows:
            raise ValueError("CheckpointEvalWatcher: no scoreable rows")
        self.model = model
        self.checkpoint_dir = checkpoint_dir
        self.rows = list(rows)
        self.via = via
        self.max_new_tokens = max_new_tokens
        self.serving = serving
        self.device = device
        self.on_result = on_result
        self.poll_interval_s = poll_interval_s
        self.results: List[Dict[str, Any]] = []
        self._scored: set = set()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- discovery ---------------------------------------------------------
    def pending(self) -> List[Tuple[int, int, str]]:
        """Committed-and-unscored checkpoints, oldest first."""
        return [(e, s, p) for e, s, p
                in ckpt.list_committed_checkpoints(self.checkpoint_dir)
                if s not in self._scored]

    # -- scoring -----------------------------------------------------------
    def score_checkpoint(self, path: str, step: int) -> Dict[str, Any]:
        from automodel_tpu_torch.models.hf_io import load_hf_weights
        from automodel_tpu_torch.serving.eval import greedy_continuation_score

        t0 = time.perf_counter()
        load_hf_weights(self.model, os.path.join(path, "model"))
        res = greedy_continuation_score(
            self.model, self.rows, via=self.via,
            max_new_tokens=self.max_new_tokens, serving=self.serving,
            device=self.device)
        return {
            "step": step,
            "path": path,
            "eval/score": res["score"],
            "eval/exact_match": res["exact_match"],
            "eval/rows": res["rows"],
            "eval/latency_s": time.perf_counter() - t0,
        }

    def poll(self) -> List[Dict[str, Any]]:
        """Score every newly committed checkpoint; returns this poll's
        results (also appended to ``self.results``).  Non-blocking when
        nothing new committed."""
        out: List[Dict[str, Any]] = []
        for _epoch, step, path in self.pending():
            self._scored.add(step)   # at-most-once even if scoring fails
            try:
                res = self.score_checkpoint(path, step)
            except Exception:
                logger.warning(
                    "online eval of checkpoint %s failed; skipping it "
                    "(eval is telemetry, training is unaffected)",
                    path, exc_info=True)
                continue
            self.results.append(res)
            out.append(res)
            logger.info(
                "online eval | step %d | eval/score %.4f | "
                "eval/exact_match %.4f | rows %d | %.2fs",
                step, res["eval/score"], res["eval/exact_match"],
                res["eval/rows"], res["eval/latency_s"])
            if self.on_result is not None:
                self.on_result(res)
        return out

    def drain_results(self) -> List[Dict[str, Any]]:
        """Results scored since the last drain (the recipe hook's
        logging surface — never blocks the training loop)."""
        out, self.results = self.results, []
        return out

    # -- background thread (the in-recipe hook) ----------------------------
    def start(self) -> "CheckpointEvalWatcher":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.poll()
                except Exception:
                    logger.warning("online-eval poll failed",
                                   exc_info=True)
                self._stop.wait(self.poll_interval_s)

        self._thread = threading.Thread(
            target=loop, name="automodel-eval-watch", daemon=True)
        self._thread.start()
        return self

    def stop(self, final_poll: bool = False) -> None:
        """Stop the background thread; ``final_poll`` scores anything
        committed since the last poll before returning (end-of-training
        checkpoints)."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None
        if final_poll:
            self.poll()


def rows_from_eval_config(cfg, *, section: str = "validation_dataset",
                          limit: Optional[int] = 16, tokenizer=None):
    """(prompt, target) rows from an eval YAML's dataset section — the
    hellaswag-style schema ``serving/eval.py`` consumes."""
    from automodel_tpu_torch.serving.eval import rows_from_dataset

    node = cfg.get(section) if hasattr(cfg, "get") else None
    if node is None:
        raise ValueError(f"config has no {section!r} section")
    kwargs = {"tokenizer": tokenizer} if tokenizer is not None else {}
    dataset = (node.instantiate(**kwargs)
               if hasattr(node, "instantiate") else node)
    return rows_from_dataset(dataset, limit=limit)
