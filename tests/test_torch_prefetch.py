"""The port's async input pipeline (``datasets/prefetch.py``) against the
semantics the JAX package's ``tests/unit_tests/test_prefetch.py`` checks:
the stream at depth 1 and 2 is the synchronous one (and the JAX loader's),
commit/resume lands at exactly the next batch, uncommitted lookahead is not
persisted, an abandoned iteration rewinds, a producer failure (including
``AUTOMODEL_FAULT=input_producer``) surfaces within one ``next()``, and the
thread stops on ``close()``.  The SFT recipe at ``prefetch_depth: 2``
trains bit-identically to ``prefetch_depth: 0``.  All exact: the pipeline
only moves host work to another thread.
"""

import os
import threading

import numpy as np
import pytest
import torch

from automodel_tpu.datasets.dataloader import (
    StatefulDataLoader as JaxLoader,
)
from automodel_tpu.datasets.llm.mock import (
    build_unpacked_dataset as jax_dataset,
)
from automodel_tpu.datasets.prefetch import wrap_prefetch as jax_wrap
from automodel_tpu_torch.config.loader import parse_args_and_load_config
from automodel_tpu_torch.datasets.dataloader import StatefulDataLoader
from automodel_tpu_torch.datasets.llm.mock import build_unpacked_dataset
from automodel_tpu_torch.datasets.prefetch import (
    PRODUCER_THREAD_NAME,
    PrefetchDataLoader,
    wrap_prefetch,
)
from automodel_tpu_torch.recipes.llm import train_ft
from automodel_tpu_torch.utils import fault_injection as fi

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TINY = os.path.join(REPO, "automodel_tpu_torch", "examples",
                         "tiny_llama_sft.yaml")
DATA = dict(num_sentences=40, vocab_size=64, mean_len=12.0, seed=3)


def _loader(**kw):
    kw.setdefault("batch_size", 4)
    kw.setdefault("seed", 11)
    return StatefulDataLoader(build_unpacked_dataset(**DATA), **kw)


def _fingerprint(batch):
    return tuple((k, np.asarray(batch[k]).tobytes()) for k in sorted(batch))


def _collect(loader, epochs=1):
    out = []
    for _ in range(epochs):
        out.extend(_fingerprint(b) for b in loader)
    return out


@pytest.mark.parametrize("depth", [1, 2])
def test_stream_matches_sync_and_the_jax_loader(depth):
    """Two epochs (the shuffle rolls over): the same bytes at depth 0, at
    this depth, and from the JAX loader with and without its prefetch."""
    ref = _collect(_loader(), epochs=2)
    assert len(ref) == 20
    assert _collect(wrap_prefetch(_loader(), depth), epochs=2) == ref
    jax_loader = JaxLoader(jax_dataset(**DATA), batch_size=4, seed=11)
    assert _collect(jax_loader, epochs=2) == ref
    jax_pref = jax_wrap(JaxLoader(jax_dataset(**DATA), batch_size=4, seed=11),
                        depth)
    assert _collect(jax_pref, epochs=2) == ref


def test_wrap_prefetch_depth_zero_is_the_bare_loader():
    loader = _loader()
    assert wrap_prefetch(loader, 0) is loader
    assert wrap_prefetch(loader, None) is loader
    w = wrap_prefetch(loader, 1)
    assert isinstance(w, PrefetchDataLoader)
    assert len(w) == len(loader) and w.batch_size == 4     # delegation
    w.set_epoch(0)
    with pytest.raises(ValueError):
        PrefetchDataLoader(loader, 0)


def test_commit_resume_at_exact_next_batch():
    ref = _collect(_loader())
    w = wrap_prefetch(_loader(), 3)
    it = iter(w)
    seen = []
    for _ in range(4):
        seen.append(_fingerprint(next(it)))
        w.commit_state(w.pending_state())
    sd = w.state_dict()
    it.close()
    assert seen == ref[:4]
    w2 = wrap_prefetch(_loader(), 3)
    w2.load_state_dict(sd)
    assert _collect(w2) == ref[4:]


def test_uncommitted_lookahead_is_not_persisted():
    ref = _collect(_loader())
    w = wrap_prefetch(_loader(), 2)
    it = iter(w)
    next(it)
    w.commit_state(w.pending_state())      # batch 1 consumed
    next(it)                               # batch 2 pulled, never committed
    sd = w.state_dict()
    it.close()
    w2 = wrap_prefetch(_loader(), 2)
    w2.load_state_dict(sd)
    assert _fingerprint(next(iter(w2))) == ref[1]


def test_state_dict_without_commits_resumes_after_last_yielded():
    ref = _collect(_loader())
    w = wrap_prefetch(_loader(), 3)
    it = iter(w)
    next(it)
    next(it)
    sd = w.state_dict()
    it.close()
    w2 = wrap_prefetch(_loader(), 3)
    w2.load_state_dict(sd)
    assert _collect(w2) == ref[2:]


def test_abandoned_iteration_rewinds_to_last_yielded():
    ref = _collect(_loader())
    w = wrap_prefetch(_loader(), 4)
    it = iter(w)
    got = [_fingerprint(next(it)) for _ in range(3)]
    it.close()
    assert got == ref[:3]
    assert _collect(w) == ref[3:]
    # a restart while the previous iterator is still referenced
    w = wrap_prefetch(_loader(), 4)
    it = iter(w)
    got = [_fingerprint(next(it)) for _ in range(2)]
    got.extend(_collect(w))
    assert got == ref
    del it


class _Boom(RuntimeError):
    pass


class _BadDataset:
    """Map-style: the third sample cannot be read."""

    def __len__(self):
        return 6

    def __getitem__(self, i):
        if i == 2:
            raise _Boom("collate exploded")
        return {"input_ids": [i + 2] * 5, "labels": [i + 2] * 5}


def test_producer_exception_surfaces_within_one_next():
    w = wrap_prefetch(StatefulDataLoader(_BadDataset(), batch_size=1,
                                         shuffle=False), 2)
    it = iter(w)
    next(it)
    next(it)
    with pytest.raises(_Boom, match="collate exploded"):
        next(it)
    assert not any(t.name == PRODUCER_THREAD_NAME
                   for t in threading.enumerate())


@pytest.mark.fault
@pytest.mark.parametrize("how", ["configure", "env"])
def test_fault_input_producer_surfaces_within_one_next(how, monkeypatch):
    fi.reset_faults()
    if how == "env":
        monkeypatch.setenv(fi.FAULT_ENV, "input_producer:2")
        monkeypatch.setattr(fi, "_env_loaded", False)
    else:
        fi.configure_faults("input_producer:2")
    try:
        it = iter(wrap_prefetch(_loader(), 2))
        next(it)                     # produced on the first hit
        with pytest.raises(fi.InjectedFault, match="input_producer"):
            next(it)                 # the second hit fired
    finally:
        fi.reset_faults()


def test_fault_spec_parsing():
    pts = fi.parse_fault_spec("a:1, b:3:kill ,c::exit")
    assert [(p.name, p.trigger_at, p.mode) for p in pts.values()] == [
        ("a", 1, "raise"), ("b", 3, "kill"), ("c", 1, "kill")]
    for bad in ("a:0", ":1", "a:1:boom"):
        with pytest.raises(ValueError):
            fi.parse_fault_spec(bad)
    fi.reset_faults()
    fi.fault_point("a")                      # unarmed: nothing happens


def test_producer_thread_stops_on_close():
    w = wrap_prefetch(_loader(), 2)
    it = iter(w)
    next(it)
    thread = w._producer.thread
    assert thread.is_alive()
    it.close()
    thread.join(timeout=5.0)
    assert not thread.is_alive() and w._producer is None
    assert PRODUCER_THREAD_NAME not in [t.name for t in threading.enumerate()]
    assert w.produce_s > 0


def _recipe(depth):
    recipe = train_ft.TrainFinetuneRecipeForNextTokenPrediction(
        parse_args_and_load_config(
            ["-c", PORT_TINY, "--device", "cpu",
             "--dataloader.prefetch_depth", str(depth),
             "--validation_dataloader.prefetch_depth", str(depth)]))
    return recipe.setup().run_train_validation_loop()


def test_recipe_prefetch_depth_2_is_bit_identical_to_depth_0():
    sync, pref = _recipe(0), _recipe(2)
    assert isinstance(pref.dataloader, PrefetchDataLoader)
    assert isinstance(pref.val_dataloader, PrefetchDataLoader)
    assert not isinstance(sync.dataloader, PrefetchDataLoader)
    for key in ("step", "loss", "grad_norm", "num_label_tokens", "lr"):
        assert [m[key] for m in pref.history] == [m[key] for m in sync.history]
    assert pref.val_history == sync.val_history
    for a, b in zip(pref.model.parameters(), sync.model.parameters()):
        assert torch.equal(a, b)
    # every step committed its group: the resume point is the sync one
    assert pref.dataloader.state_dict() == sync.dataloader.state_dict()
