"""Crash-safe checkpoints: the commit protocol, manifests, retention and
discovery (counterpart: ``automodel_tpu/checkpoint/checkpointing.py``).

The directory layout, names and manifest fields are the JAX package's, so
each package finds and verifies the other's checkpoints:

    <checkpoint_dir>/epoch_{e}_step_{s}/
        model/            consolidated HF safetensors (``models/hf_io.py``)
        optim/            optimizer state and the LR schedule (``.pt``)
        <key>.pt          ``state_dict()`` of each tracked host-side object
        config.yaml       the run config
        manifest.json     commit record, written last

Every writer targets ``epoch_{e}_step_{s}.tmp``; once everything is
written the manifest (each file with its size, sha256 for the small
host-side files) goes in and the staging directory is renamed to its final
name, so a directory is visible under that name iff it is complete.  A
kill at any point leaves at most a ``.tmp`` that discovery ignores and the
next save clears.  The port runs one process, so the JAX protocol's votes
and barriers have one voter and are not needed; Orbax is JAX-only, so the
optimizer, schedule, RNG and loader state are ``torch.save`` files
(``.pt``), hashed in the manifest like the JAX package's pickles.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import random
import re
import shutil
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

FRAMEWORK = "automodel_tpu_torch"
FRAMEWORK_VERSION = "0.1.0"
MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1
STAGING_SUFFIX = ".tmp"
_GC_SUFFIX = ".gc.tmp"
# Host-side files small enough to checksum on every save; the safetensors
# payloads get size-only entries.
_CHECKSUM_SUFFIXES = (".pt", ".yaml", ".yml", ".json")
_CKPT_RE = re.compile(r"epoch_(\d+)_step_(\d+)$")


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint directory is uncommitted or fails manifest validation."""


class CheckpointSaveError(RuntimeError):
    """A save was aborted before commit; only staging was touched, the
    previous committed checkpoint is unaffected."""


@dataclasses.dataclass
class CheckpointingConfig:
    """The YAML ``checkpoint`` section: the JAX dataclass's fields that
    the port reads (keys for multi-host writes, PEFT and the model cache
    are ignored, as any unknown key is).  ``replicate_to_peers`` is
    validated and pushes nothing at one process."""

    enabled: bool = True
    checkpoint_dir: str = "checkpoints/"
    model_save_format: str = "safetensors"
    save_consolidated: bool = True
    restore_from: Optional[str] = None
    keep_last_k: Optional[int] = None
    keep_every_n_steps: Optional[int] = None
    io_retries: int = 3
    io_retry_backoff: float = 0.1
    async_save: bool = True
    replicate_to_peers: bool = True

    def __post_init__(self):
        if self.model_save_format == "torch_save":   # reference alias
            self.model_save_format = "orbax"
        if self.model_save_format not in ("safetensors", "orbax"):
            raise ValueError(
                f"unknown model_save_format {self.model_save_format!r}")
        if self.keep_last_k is not None and int(self.keep_last_k) < 0:
            raise ValueError(f"keep_last_k must be >= 0, got {self.keep_last_k}")
        if (self.keep_every_n_steps is not None
                and int(self.keep_every_n_steps) < 1):
            raise ValueError(
                f"keep_every_n_steps must be >= 1, got {self.keep_every_n_steps}")
        if int(self.io_retries) < 0:
            raise ValueError(f"io_retries must be >= 0, got {self.io_retries}")
        for name in ("async_save", "replicate_to_peers"):
            value = getattr(self, name)
            if value is None or (isinstance(value, str) and value.strip()
                                 .lower() in ("", "none", "null")):
                setattr(self, name, True)       # null means the default
            elif not isinstance(value, bool):
                raise ValueError(f"checkpoint.{name} must be a bool (or null "
                                 f"for the default), got {value!r}")


def build_checkpoint_config(cfg=None, **kwargs) -> CheckpointingConfig:
    """From the YAML section (a ``ConfigNode`` or None) plus overrides;
    keys the dataclass does not know are ignored, as in JAX."""
    fields = {f.name for f in dataclasses.fields(CheckpointingConfig)}
    if cfg is not None:
        kwargs = {**{k: v for k, v in cfg.to_dict().items() if k in fields},
                  **kwargs}
    return CheckpointingConfig(**{k: v for k, v in kwargs.items()
                                  if k in fields})


def retry_io(fn: Callable, *args, retries: int = 3, backoff: float = 0.1,
             desc: str = "", **kwargs):
    """Call ``fn``, retrying ``OSError`` failures ``retries`` more times
    with exponential backoff (``backoff * 2**attempt`` seconds plus up to
    25 % jitter); the last failure re-raises."""
    attempts = int(retries) + 1
    for attempt in range(attempts):
        try:
            return fn(*args, **kwargs)
        except OSError as e:
            if attempt == attempts - 1:
                raise
            delay = backoff * (2 ** attempt) * (1.0 + 0.25 * random.random())
            logger.warning(
                "transient I/O failure%s (attempt %d/%d, retrying in %.2fs): %s",
                f" in {desc}" if desc else "", attempt + 1, attempts, delay, e)
            time.sleep(delay)


# ---------------------------------------------------------------------------
# Integrity manifest -- written last, the commit marker
# ---------------------------------------------------------------------------
# Hashes of host-side files computed while writing them (``save_stateful``
# holds the bytes anyway), so ``build_manifest`` does not re-read a file it
# just wrote: abspath -> (size, sha256), popped on use; a size mismatch
# falls back to re-hashing.
_HASH_HINTS: Dict[str, Tuple[int, str]] = {}
_hash_hints_lock = threading.Lock()


def record_file_hash(path: str, size: int, sha256: str) -> None:
    with _hash_hints_lock:
        _HASH_HINTS[os.path.abspath(path)] = (int(size), sha256)


def _pop_file_hash(path: str, size: int) -> Optional[str]:
    with _hash_hints_lock:
        hint = _HASH_HINTS.pop(os.path.abspath(path), None)
    return hint[1] if hint is not None and hint[0] == size else None


def _purge_file_hashes(prefix: str) -> None:
    """Drop the hints under a staging directory being cleared."""
    prefix = os.path.abspath(prefix) + os.sep
    with _hash_hints_lock:
        for key in [k for k in _HASH_HINTS if k.startswith(prefix)]:
            del _HASH_HINTS[key]


def file_sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def build_manifest(ckpt_path: str, *, epoch: int, step: int,
                   config: Optional[CheckpointingConfig] = None
                   ) -> Dict[str, Any]:
    """Every file under a (staged) checkpoint with its size, plus sha256
    for the host-side files (suffixes in ``_CHECKSUM_SUFFIXES``)."""
    files: List[Dict[str, Any]] = []
    for root, _dirs, names in os.walk(ckpt_path):
        for name in sorted(names):
            if root == ckpt_path and name.startswith(MANIFEST_NAME):
                continue
            full = os.path.join(root, name)
            rel = os.path.relpath(full, ckpt_path).replace(os.sep, "/")
            entry: Dict[str, Any] = {"path": rel,
                                     "size": os.path.getsize(full)}
            if name.endswith(_CHECKSUM_SUFFIXES):
                entry["sha256"] = (_pop_file_hash(full, entry["size"])
                                   or file_sha256(full))
            files.append(entry)
    return {
        "manifest_version": MANIFEST_VERSION,
        "framework": FRAMEWORK,
        "framework_version": FRAMEWORK_VERSION,
        "torch_version": torch.__version__,
        "format": (config.model_save_format if config is not None
                   else CheckpointingConfig.model_save_format),
        "epoch": int(epoch),
        "step": int(step),
        "files": sorted(files, key=lambda e: e["path"]),
    }


def write_manifest(ckpt_path: str, *, epoch: int, step: int,
                   config: Optional[CheckpointingConfig] = None
                   ) -> Dict[str, Any]:
    """Build and atomically write ``manifest.json`` inside ``ckpt_path``."""
    manifest = build_manifest(ckpt_path, epoch=epoch, step=step,
                              config=config)
    tmp = os.path.join(ckpt_path, MANIFEST_NAME + ".tmp")

    def _write():
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(ckpt_path, MANIFEST_NAME))

    cfg = config or CheckpointingConfig()
    retry_io(_write, retries=cfg.io_retries, backoff=cfg.io_retry_backoff,
             desc=f"manifest for {ckpt_path}")
    return manifest


def read_manifest(ckpt_path: str) -> Optional[Dict[str, Any]]:
    """The parsed manifest, or None for an uncommitted directory; an
    unparseable one raises :class:`CheckpointIntegrityError`."""
    path = os.path.join(ckpt_path, MANIFEST_NAME)
    if not os.path.isfile(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except ValueError as e:
        raise CheckpointIntegrityError(
            f"checkpoint {ckpt_path} is corrupt: {MANIFEST_NAME} is not "
            f"valid JSON ({e})") from e


def is_committed(ckpt_path: str) -> bool:
    """Committed iff under its final name (not staging) with a manifest."""
    name = os.path.basename(os.path.normpath(ckpt_path))
    return (os.path.isdir(ckpt_path)
            and not name.endswith((STAGING_SUFFIX, _GC_SUFFIX))
            and os.path.isfile(os.path.join(ckpt_path, MANIFEST_NAME)))


def verify_manifest(ckpt_path: str, *, deep: bool = True) -> Dict[str, Any]:
    """Check ``ckpt_path`` against its manifest (every file present at its
    recorded size; ``deep``: the checksums too); the manifest on success,
    else :class:`CheckpointIntegrityError` naming the directory and the
    first problem."""
    name = os.path.basename(os.path.normpath(ckpt_path))
    if name.endswith((STAGING_SUFFIX, _GC_SUFFIX)):
        raise CheckpointIntegrityError(
            f"checkpoint {ckpt_path} is an uncommitted staging directory "
            "(interrupted save) -- resume from a committed checkpoint")
    manifest = read_manifest(ckpt_path)
    if manifest is None:
        raise CheckpointIntegrityError(
            f"checkpoint {ckpt_path} has no {MANIFEST_NAME}: it was never "
            "committed (interrupted save)")
    for entry in manifest.get("files", ()):
        full = os.path.join(ckpt_path, *entry["path"].split("/"))
        if not os.path.isfile(full):
            raise CheckpointIntegrityError(
                f"checkpoint {ckpt_path} is corrupt: manifest lists "
                f"{entry['path']} but the file is missing")
        size = os.path.getsize(full)
        if size != entry["size"]:
            raise CheckpointIntegrityError(
                f"checkpoint {ckpt_path} is corrupt: {entry['path']} is "
                f"{size} bytes, manifest recorded {entry['size']}")
        if deep and "sha256" in entry and file_sha256(full) != entry["sha256"]:
            raise CheckpointIntegrityError(
                f"checkpoint {ckpt_path} is corrupt: {entry['path']} fails "
                "its sha256 checksum")
    return manifest


# ---------------------------------------------------------------------------
# Atomic commit protocol
# ---------------------------------------------------------------------------
def staging_path(final_path: str) -> str:
    return final_path.rstrip("/") + STAGING_SUFFIX


def prepare_staging(final_path: str,
                    config: Optional[CheckpointingConfig] = None) -> str:
    """(Re)create the empty staging directory of ``final_path``: leftovers
    of an interrupted save must not leak into the new manifest."""
    cfg = config or CheckpointingConfig()
    staging = staging_path(final_path)
    _purge_file_hashes(staging)
    try:
        if os.path.isdir(staging):
            retry_io(shutil.rmtree, staging, retries=cfg.io_retries,
                     backoff=cfg.io_retry_backoff,
                     desc=f"clearing stale staging {staging}")
        retry_io(os.makedirs, staging, exist_ok=True, retries=cfg.io_retries,
                 backoff=cfg.io_retry_backoff,
                 desc=f"creating staging {staging}")
    except OSError as e:
        raise CheckpointSaveError(
            f"could not prepare staging {staging}") from e
    return staging


def commit_checkpoint(staging: str, final_path: str, *, epoch: int,
                      step: int, config: Optional[CheckpointingConfig] = None
                      ) -> str:
    """Finalize a fully written staging directory: manifest, then the
    atomic rename to ``final_path``.  A committed directory of the same
    step is first renamed aside (``.gc.tmp``) and removed after, and put
    back if the new rename fails."""
    cfg = config or CheckpointingConfig()
    husk = None
    try:
        write_manifest(staging, epoch=epoch, step=step, config=cfg)
        if os.path.isdir(final_path):
            husk = final_path + _GC_SUFFIX
            if os.path.isdir(husk):
                retry_io(shutil.rmtree, husk, retries=cfg.io_retries,
                         backoff=cfg.io_retry_backoff, desc=f"husk {husk}")
            retry_io(os.replace, final_path, husk, retries=cfg.io_retries,
                     backoff=cfg.io_retry_backoff,
                     desc=f"setting aside {final_path}")
        retry_io(os.replace, staging, final_path, retries=cfg.io_retries,
                 backoff=cfg.io_retry_backoff,
                 desc=f"committing {final_path}")
    except OSError as e:
        if husk is not None and not os.path.isdir(final_path):
            try:
                os.replace(husk, final_path)
            except OSError as rb:
                logger.warning("could not roll back %s -> %s: %s", husk,
                               final_path, rb)
        raise CheckpointSaveError(
            f"commit of {final_path} failed; staging left at {staging} for "
            "inspection") from e
    if husk is not None:
        try:       # best effort: retention GC sweeps husks anyway
            retry_io(shutil.rmtree, husk, retries=cfg.io_retries,
                     backoff=cfg.io_retry_backoff, desc=f"husk {husk}")
        except OSError as e:
            logger.warning("could not remove replaced checkpoint %s: %s",
                           husk, e)
    return final_path


# ---------------------------------------------------------------------------
# Retention GC and discovery
# ---------------------------------------------------------------------------
def checkpoint_dir_name(epoch: int, step: int) -> str:
    return f"epoch_{epoch}_step_{step}"


def list_committed_checkpoints(checkpoint_dir: str
                               ) -> List[Tuple[int, int, str]]:
    """Committed checkpoints as ``(epoch, step, path)``, oldest first."""
    if not os.path.isdir(checkpoint_dir):
        return []
    out = []
    for name in sorted(os.listdir(checkpoint_dir)):
        m = _CKPT_RE.search(name)
        path = os.path.join(checkpoint_dir, name)
        if m and is_committed(path):
            out.append((int(m.group(1)), int(m.group(2)), path))
    out.sort(key=lambda t: t[:2])
    return out


def gc_checkpoints(checkpoint_dir: str, *, keep_last_k: Optional[int] = None,
                   keep_every_n_steps: Optional[int] = None,
                   protect: Iterable[str] = (),
                   config: Optional[CheckpointingConfig] = None) -> List[str]:
    """Delete superseded committed checkpoints; the deleted paths.

    Keeps the newest ``keep_last_k`` (None/0 keeps everything), every step
    that is a multiple of ``keep_every_n_steps`` and anything in
    ``protect`` (the checkpoint the run resumed from).  A victim is renamed
    to ``.gc.tmp`` before its removal, so a crash never leaves a half
    deleted directory that looks committed; stale husks and staging
    leftovers older than the newest commit are swept too.  Never call it
    while a save is in flight."""
    cfg = config or CheckpointingConfig()
    deleted: List[str] = []
    committed = list_committed_checkpoints(checkpoint_dir)
    protected = {os.path.realpath(p) for p in protect if p}

    def _remove(path: str) -> None:
        husk = path if path.endswith(_GC_SUFFIX) else path + _GC_SUFFIX
        try:
            if not path.endswith(_GC_SUFFIX):
                retry_io(os.replace, path, husk, retries=cfg.io_retries,
                         backoff=cfg.io_retry_backoff, desc=f"GC {path}")
            retry_io(shutil.rmtree, husk, retries=cfg.io_retries,
                     backoff=cfg.io_retry_backoff, desc=f"GC {husk}")
            deleted.append(path)
        except OSError as e:       # GC must never fail a successful save
            logger.warning("checkpoint GC could not remove %s: %s", path, e)

    if os.path.isdir(checkpoint_dir):
        for name in os.listdir(checkpoint_dir):
            if name.endswith(_GC_SUFFIX):
                _remove(os.path.join(checkpoint_dir, name))
    if committed:
        newest = committed[-1][:2]
        for name in os.listdir(checkpoint_dir):
            if not name.endswith(STAGING_SUFFIX) or name.endswith(_GC_SUFFIX):
                continue
            m = _CKPT_RE.search(name[: -len(STAGING_SUFFIX)])
            if m and (int(m.group(1)), int(m.group(2))) <= newest:
                _remove(os.path.join(checkpoint_dir, name))
    if not keep_last_k or keep_last_k < 1:
        return deleted
    for _epoch, step, path in committed[:-keep_last_k]:
        if keep_every_n_steps and step > 0 and step % keep_every_n_steps == 0:
            continue               # milestone pin
        if os.path.realpath(path) in protected:
            continue               # the resume source stays until outranked
        _remove(path)
    return deleted


def find_latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """Newest committed checkpoint by (epoch, step), or None; staging
    leftovers, husks and manifest-less directories are skipped."""
    best, best_key = None, (-1, -1)
    if not os.path.isdir(checkpoint_dir):
        return None
    for name in os.listdir(checkpoint_dir):
        m = _CKPT_RE.search(name)
        if not m:
            continue
        path = os.path.join(checkpoint_dir, name)
        if not is_committed(path):
            logger.warning("skipping uncommitted checkpoint dir %s (no %s -- "
                           "interrupted save?)", path, MANIFEST_NAME)
            continue
        key = (int(m.group(1)), int(m.group(2)))
        if key > best_key:
            best_key, best = key, path
    return best


# ---------------------------------------------------------------------------
# Host-side statefuls (optimizer, schedules, RNG, loaders)
# ---------------------------------------------------------------------------
class _HashingWriter:
    """A file wrapper that hashes what is written through it."""

    def __init__(self, f):
        self.f, self.sha, self.size = f, hashlib.sha256(), 0

    def write(self, data) -> int:
        self.sha.update(data)
        self.size += len(memoryview(data).cast("B"))
        return self.f.write(data)

    def flush(self) -> None:
        self.f.flush()


def save_stateful(dirpath: str, key: str, sd: Dict[str, Any],
                  config: Optional[CheckpointingConfig] = None) -> None:
    """``torch.save`` one state dict as ``<dirpath>/<key>.pt``, hashing the
    bytes on their way to the file (the manifest takes the hash)."""
    cfg = config or CheckpointingConfig()
    path = os.path.join(dirpath, f"{key}.pt")

    def _write():
        with open(path, "wb") as f:
            out = _HashingWriter(f)
            torch.save(sd, out)
        return out

    out = retry_io(_write, retries=cfg.io_retries,
                   backoff=cfg.io_retry_backoff, desc=f"stateful {key}")
    record_file_hash(path, out.size, out.sha.hexdigest())


def load_stateful(dirpath: str, key: str, obj: Any,
                  config: Optional[CheckpointingConfig] = None,
                  map_location=None) -> Any:
    """Load ``<dirpath>/<key>.pt`` into ``obj.load_state_dict``; returns
    ``obj``."""
    cfg = config or CheckpointingConfig()
    sd = retry_io(torch.load, os.path.join(dirpath, f"{key}.pt"),
                  map_location=map_location, weights_only=False,
                  retries=cfg.io_retries, backoff=cfg.io_retry_backoff,
                  desc=f"stateful {key}")
    obj.load_state_dict(sd)
    return obj


def has_stateful(dirpath: str, key: str) -> bool:
    return os.path.exists(os.path.join(dirpath, f"{key}.pt"))
