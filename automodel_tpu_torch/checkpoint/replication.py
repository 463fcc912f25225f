"""Live decode weights between serving replicas: the transport that warms
a re-admitted replica from a live peer (counterpart: the live-params half
of ``automodel_tpu/checkpoint/replication.py``).

A peer's current weights (its model's ``state_dict``) are serialized into
a shard map, one entry per tensor: ``(sha256, bytes, dtype, shape)`` over
the tensor's raw host bytes, the integrity currency of the JAX catalog.
:func:`push_live_params` keeps one generation per replica, keyed by
``(replica_id, version)`` (the engine's ``weight_syncs``), and advertises
it (an optional ``live_catalog.r<id>.json`` mirror); :func:`fetch_live_params`
rebuilds the tensors on the host, each checked against its digest, shape
and dtype, and gives None when anything fails (no advertisement, the
version moved, a flipped byte, the drilled ``ckpt_replica_restore``): the
fleet's admission then fails typed.  :func:`drop_live_params` retracts an
advertisement on a loss or a teardown, so a dead replica never warms a
newcomer.  The stores live in this process (the fleet runs its replicas in
one process, as JAX's does); the checkpoint ring (``push_replica``,
``restore_from_peers``) needs several processes and waits for ROADMAP
Queue 1 item 12.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from automodel_tpu_torch.utils.fault_injection import fault_point

logger = logging.getLogger(__name__)

LIVE_CATALOG_FILE_PREFIX = "live_catalog"

# one shard: (sha256 hex digest, raw bytes, dtype, shape)
Shard = Tuple[str, bytes, torch.dtype, Tuple[int, ...]]

_lock = threading.Lock()


def _tensor_bytes(t: torch.Tensor) -> bytes:
    """The raw host bytes of ``t`` in C order (any dtype, 0-d included)."""
    t = t.detach().to("cpu").contiguous()
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def serialize_tree(tree: Mapping[str, torch.Tensor]) -> Dict[str, Shard]:
    """``{name: tensor}`` (a ``state_dict``) -> ``{name: shard}``; the
    digest is sha256 over the tensor's raw bytes."""
    shards = {}
    for key, t in tree.items():
        buf = _tensor_bytes(t)
        shards[key] = (hashlib.sha256(buf).hexdigest(), buf, t.dtype,
                       tuple(t.shape))
    return shards


def _rebuild_tree(abstract: Mapping[str, Any],
                  shards: Dict[str, Shard]) -> Dict[str, torch.Tensor]:
    """Shard map -> ``{name: host tensor}`` with ``abstract``'s keys (each
    value anything with ``shape`` and ``dtype``).  ``KeyError`` on a
    missing shard, ``ValueError`` on a digest, shape or dtype mismatch."""
    out = {}
    for key, a in abstract.items():
        fault_point("ckpt_replica_restore")      # a corrupt shard mid-fetch
        if key not in shards:
            raise KeyError(f"replica shard {key!r} missing")
        digest, buf, dtype, shape = shards[key]
        if hashlib.sha256(buf).hexdigest() != digest:
            raise ValueError(f"replica shard {key!r} fails its sha256")
        if tuple(shape) != tuple(a.shape) or dtype != a.dtype:
            raise ValueError(
                f"replica shard {key!r} is {dtype}{tuple(shape)}, the "
                f"fetch expects {a.dtype}{tuple(a.shape)}")
        raw = torch.frombuffer(bytearray(buf), dtype=torch.uint8)
        out[key] = raw.view(dtype).reshape(shape)
    return out


class LiveParamsEntry:
    """One replica's advertised weights: the shard map and the
    ``weight_syncs`` version it was serialized at."""

    def __init__(self, replica_id: int, version: int,
                 shards: Dict[str, Shard]):
        self.replica_id = int(replica_id)
        self.version = int(version)
        self.shards = shards

    @property
    def nbytes(self) -> int:
        return sum(len(s[1]) for s in self.shards.values())


# replica_id -> LiveParamsEntry
_LIVE_STORES: Dict[int, LiveParamsEntry] = {}


def reset() -> None:
    """Forget every live-params store (tests, process teardown)."""
    with _lock:
        _LIVE_STORES.clear()


def push_live_params(*, replica_id: int, params: Mapping[str, torch.Tensor],
                     version: int = 0,
                     catalog_dir: Optional[str] = None) -> LiveParamsEntry:
    """Advertise one replica's current weights (``{name: tensor}``, on any
    device: each is copied to the host once).  One generation per
    replica: a re-push replaces the previous one."""
    shards = serialize_tree(params)
    entry = LiveParamsEntry(replica_id, version, shards)
    with _lock:
        _LIVE_STORES[entry.replica_id] = entry
    _advertise_live(entry, catalog_dir)
    logger.info("replica %d live params advertised (version %d, %d "
                "shard(s), %.1f MB)", entry.replica_id, entry.version,
                len(shards), entry.nbytes / 1e6)
    return entry


def fetch_live_params(*, abstract: Mapping[str, Any],
                      replica_id: Optional[int] = None,
                      version: Optional[int] = None
                      ) -> Optional[Dict[str, torch.Tensor]]:
    """A digest-verified fetch: ``{name: host tensor}`` matching
    ``abstract``, or None when the admission must abort (no advertisement,
    the version moved, a shard fails its digest, shape or dtype).  Without
    ``replica_id`` the newest advertisement is taken."""
    with _lock:
        if replica_id is not None:
            entries = ([_LIVE_STORES[int(replica_id)]]
                       if int(replica_id) in _LIVE_STORES else [])
        else:
            entries = sorted(_LIVE_STORES.values(),
                             key=lambda e: (-e.version, e.replica_id))
    if not entries:
        logger.warning("no live-params advertisement%s -- the admission "
                       "fails typed", f" for replica {replica_id}"
                       if replica_id is not None else "")
        return None
    entry = entries[0]
    if version is not None and entry.version != int(version):
        logger.warning("live params of replica %d are version %d, the fetch "
                       "pinned %d -- the peer synced weights mid-admission",
                       entry.replica_id, entry.version, version)
        return None
    try:
        tree = _rebuild_tree(abstract, entry.shards)
    except Exception as e:
        logger.warning("live params of replica %d (version %d) failed "
                       "verification mid-fetch (%s) -- the admission "
                       "aborts, typed", entry.replica_id, entry.version, e)
        return None
    logger.info("fetched replica %d's live params (version %d, %d "
                "shard(s), digest-verified)", entry.replica_id,
                entry.version, len(entry.shards))
    return tree


def drop_live_params(replica_id: int,
                     catalog_dir: Optional[str] = None) -> bool:
    """Forget a replica's weights and retract its advertisement (a loss or
    a teardown); True iff a store was dropped."""
    with _lock:
        entry = _LIVE_STORES.pop(int(replica_id), None)
    if catalog_dir:
        try:
            os.remove(_catalog_path(catalog_dir, int(replica_id)))
        except OSError:
            pass
    if entry is not None:
        logger.info("replica %d live params dropped (version %d)",
                    entry.replica_id, entry.version)
    return entry is not None


def live_stores_snapshot() -> Dict[int, Tuple[int, int]]:
    """``{replica_id: (version, n_shards)}``."""
    with _lock:
        return {r: (e.version, len(e.shards))
                for r, e in _LIVE_STORES.items()}


def _catalog_path(catalog_dir: str, replica_id: int) -> str:
    return os.path.join(catalog_dir,
                        f"{LIVE_CATALOG_FILE_PREFIX}.r{replica_id}.json")


def _advertise_live(entry: LiveParamsEntry,
                    catalog_dir: Optional[str]) -> None:
    """The catalog's file mirror (best effort, as in JAX): every shard's
    digest, byte count, dtype and shape."""
    if not catalog_dir:
        return
    path = _catalog_path(catalog_dir, entry.replica_id)
    try:
        os.makedirs(catalog_dir, exist_ok=True)
        catalog = {
            "replica": entry.replica_id,
            "version": entry.version,
            "shards": {k: {"sha256": v[0], "bytes": len(v[1]),
                           "dtype": str(v[2]).removeprefix("torch."),
                           "shape": list(v[3])}
                       for k, v in entry.shards.items()},
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(catalog, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError as e:
        logger.warning("live-params catalog mirror %s failed: %s", path, e)
