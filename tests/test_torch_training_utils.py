"""The port's small helpers against the JAX package's: token accounting
(``training/utils.py``), guarded imports (``utils/safe_import.py``) and
logging set-up (``loggers/log_utils.py``)."""

import logging

import numpy as np
import pytest

from automodel_tpu.loggers import log_utils as jax_log
from automodel_tpu.training import utils as jax_utils
from automodel_tpu.utils import safe_import as jax_safe
from automodel_tpu_torch.loggers import log_utils
from automodel_tpu_torch.training import utils
from automodel_tpu_torch.utils import safe_import


def _labels(seed, shape):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 50, shape)
    labels[rng.random(shape) < 0.2] = -100          # interior ignores
    for row in labels.reshape(-1, shape[-1]):
        row[len(row) - int(rng.integers(0, shape[-1] // 2)):] = -100
    return labels


@pytest.mark.parametrize("shape", [(4, 33), (2, 3, 17), (1, 8)])
def test_token_counts_match_jax(shape):
    labels = _labels(sum(shape), shape)
    assert (utils.count_tail_padding(labels)
            == jax_utils.count_tail_padding(labels))
    batch = {"labels": labels}
    assert utils.count_tokens(batch) == jax_utils.count_tokens(batch)
    group = [batch, {"labels": _labels(7, shape)}]
    assert utils.count_tokens(group) == jax_utils.count_tokens(group)


def test_token_counts_one_label_per_example_match_jax():
    batch = {"labels": np.array([1, -100, 3]),
             "input_ids": np.ones((3, 9), np.int32),
             "attention_mask": np.tri(3, 9, 5, dtype=np.int32)}
    assert utils.count_tokens(batch) == jax_utils.count_tokens(batch)
    del batch["attention_mask"]
    assert utils.count_tokens(batch) == jax_utils.count_tokens(batch)


def test_safe_import_matches_jax():
    for mod in (safe_import, jax_safe):
        ok, m = mod.safe_import("json")
        assert ok and m.dumps([1]) == "[1]"
        ok, m = mod.safe_import("no_such_module_here")
        assert not ok and not m and "unavailable" in repr(m)
        with pytest.raises(ImportError, match="no_such_module_here"):
            m.anything
        with pytest.raises(ImportError):
            m()
        ok, f = mod.safe_import_from("json", "loads")
        assert ok and f("2") == 2
        ok, f = mod.safe_import_from("json", "no_such_symbol")
        assert not ok and not f
        ok, f = mod.safe_import_from("no_such_module_here", "x")
        assert not ok and not f


@pytest.mark.parametrize("mod", [log_utils, jax_log], ids=["port", "jax"])
def test_setup_logging(mod, monkeypatch):
    root = logging.getLogger()
    saved = (list(root.handlers), root.level)
    monkeypatch.setenv("LOGGING_LEVEL", str(logging.WARNING))
    try:
        mod.setup_logging(modules_to_filter=["some.noisy.module"])
        assert root.level == logging.WARNING
        (handler,) = root.handlers
        assert isinstance(handler.formatter, mod.ColorFormatter)
        assert any(isinstance(f, mod.RankFilter) for f in handler.filters)
        assert (logging.getLogger("some.noisy.module").level
                == logging.WARNING)
    finally:
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])
        logging.captureWarnings(False)
    record = logging.LogRecord("x", logging.INFO, "f", 1, "m", None, None)
    assert mod.RankFilter(rank=0).filter(record)
    assert not mod.RankFilter(rank=1).filter(record)
    assert mod.RankFilter().rank == 0
    fmt = mod.ColorFormatter(use_color=False)
    assert fmt.format(record).endswith("| x: m")
