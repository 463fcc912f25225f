"""YAML configs with ``_target_`` instantiation and CLI overrides
(counterparts: ``automodel_tpu/config/loader.py`` and
``automodel_tpu/config/arg_parser.py``).

A :class:`ConfigNode` wraps a YAML mapping with attribute access, dotted
``get`` / ``set_by_dotted`` and recursive ``instantiate()``, which resolves
a ``_target_`` import path and calls it with the node's other fields.
Targets under ``automodel_tpu.`` are remapped to ``automodel_tpu_torch.``,
so the JAX package's YAMLs load unchanged and build the port's objects.
Values of ``*_fn`` keys (``collate_fn: pkg.mod.fn``) resolve to the
callable at load time.  :func:`parse_args_and_load_config` reads
``--config/-c`` and dotted overrides (``--optimizer.lr 1e-4``,
``--a.b=v``, a bare ``--flag`` is True).
"""

from __future__ import annotations

import argparse
import ast
import copy
import importlib
from typing import Any, List, Optional, Sequence, Tuple

import yaml

_TARGET_KEY = "_target_"
_JAX_PREFIX = "automodel_tpu."
_PORT_PREFIX = "automodel_tpu_torch."


class TargetResolutionError(ImportError):
    """A ``_target_`` string names nothing importable."""


def translate_target(target: str) -> str:
    """``automodel_tpu.x.y`` -> ``automodel_tpu_torch.x.y``; others as is."""
    if target.startswith(_JAX_PREFIX):
        return _PORT_PREFIX + target[len(_JAX_PREFIX):]
    return target


def resolve_target(target: Any) -> Any:
    """Resolve a dotted ``_target_`` path (longest importable module
    prefix, then attributes) to a Python object."""
    if not isinstance(target, str):
        return target
    target = translate_target(target)
    parts = target.split(".")
    last_err = None
    for split in range(len(parts) - 1, 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:split]))
        except ImportError as e:
            last_err = e
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
            return obj
        except AttributeError as e:
            last_err = e
    raise TargetResolutionError(f"Cannot resolve _target_ {target!r}: "
                                f"{last_err}")


class ConfigNode:
    """A YAML mapping with attribute access, dotted paths and
    ``instantiate``."""

    def __init__(self, data=None):
        object.__setattr__(self, "_data", {})
        for k, v in dict(data or {}).items():
            self._data[k] = self._wrap(v)

    def _wrap(self, value: Any) -> Any:
        if isinstance(value, dict):
            return ConfigNode(value)
        if isinstance(value, (list, tuple)):
            return [self._wrap(v) for v in value]
        return value

    def __getattr__(self, name: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if name in data:
            return data[name]
        raise AttributeError(f"Config has no field {name!r}")

    def __repr__(self) -> str:
        return f"ConfigNode({self.to_dict()!r})"

    def get(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, ConfigNode) and part in node._data:
                node = node._data[part]
            else:
                return default
        return node

    def set_by_dotted(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            nxt = node._data.get(part)
            if not isinstance(nxt, ConfigNode):
                nxt = ConfigNode({})
                node._data[part] = nxt
            node = nxt
        node._data[parts[-1]] = node._wrap(value)

    def to_dict(self) -> dict:
        def unwrap(v):
            if isinstance(v, ConfigNode):
                return {k: unwrap(x) for k, x in v._data.items()}
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return copy.deepcopy(v)

        return {k: unwrap(v) for k, v in self._data.items()}

    def instantiate(self, *args: Any, **override_kwargs: Any) -> Any:
        """Call the resolved ``_target_`` with this node's fields (nested
        ``_target_`` nodes instantiated first); ``override_kwargs`` win."""
        if _TARGET_KEY not in self._data:
            raise ValueError(f"Cannot instantiate config without "
                             f"{_TARGET_KEY!r}: {self!r}")
        fn = resolve_target(self._data[_TARGET_KEY])
        kwargs = {k: _instantiate_value(v) for k, v in self._data.items()
                  if k != _TARGET_KEY}
        kwargs.update(override_kwargs)
        return fn(*args, **kwargs)


def _instantiate_value(v: Any) -> Any:
    if isinstance(v, ConfigNode) and _TARGET_KEY in v._data:
        return v.instantiate()
    if isinstance(v, list):
        return [_instantiate_value(x) for x in v]
    return v


def _resolve_fn_keys(node: ConfigNode) -> None:
    """Resolve string values of ``*_fn`` / ``*_func`` keys to callables
    (left as strings when nothing importable has the name)."""
    for k, v in list(node._data.items()):
        if isinstance(v, ConfigNode):
            _resolve_fn_keys(v)
        elif isinstance(v, str) and k.endswith(("_fn", "_func")):
            try:
                node._data[k] = resolve_target(v)
            except TargetResolutionError:
                pass


def load_yaml_config(path: str) -> ConfigNode:
    with open(path) as f:
        node = ConfigNode(yaml.safe_load(f) or {})
    _resolve_fn_keys(node)
    validate_config_enums(node)
    return node


def translate_value(value: str) -> Any:
    """Literal reading of a CLI override: ``"1e-4"`` -> float, ``"[1,2]"``
    -> list, ``true``/``false`` -> bool, ``null``/``none`` -> None, else
    the string."""
    low = value.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    if low in ("null", "none", "~"):
        return None
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        pass
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    return value


def parse_cli_overrides(argv: Sequence[str]) -> List[Tuple[str, Any]]:
    """``--a.b.c v`` / ``--a.b=v`` / ``--flag`` -> (dotted, value) pairs."""
    overrides: List[Tuple[str, Any]] = []
    argv = list(argv)
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(
                f"Unexpected argument {tok!r}; overrides start with --")
        body = tok[2:]
        if "=" in body:
            key, _, raw = body.partition("=")
            overrides.append((key, translate_value(raw)))
            i += 1
        elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            overrides.append((body, translate_value(argv[i + 1])))
            i += 2
        else:
            overrides.append((body, True))
            i += 1
    return overrides


def validate_config_enums(cfg: ConfigNode) -> None:
    """Raise ``ValueError`` for an enum-valued field outside its allowed set
    (null spellings mean the default), at load time and again after the
    CLI overrides, as the JAX loader does; the port checks
    ``moe.dispatch``, ``fp8.dtype`` and ``fp8.recipe_name``."""
    from automodel_tpu_torch.ops.moe import (
        normalize_moe_dispatch,
        validate_moe_dispatch,
    )
    from automodel_tpu_torch.ops.quant import (
        normalize_quant_dtype,
        normalize_quant_recipe,
        validate_quant_dtype,
        validate_quant_recipe,
    )

    validate_moe_dispatch(normalize_moe_dispatch(cfg.get("moe.dispatch")))
    validate_quant_dtype(normalize_quant_dtype(cfg.get("fp8.dtype")))
    validate_quant_recipe(normalize_quant_recipe(cfg.get("fp8.recipe_name")))


def parse_args_and_load_config(argv: Optional[Sequence[str]] = None,
                               default_config: Optional[str] = None
                               ) -> ConfigNode:
    """Load the ``--config/-c`` YAML and apply dotted CLI overrides."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--config", "-c", default=default_config)
    known, rest = parser.parse_known_args(argv)
    if known.config is None:
        raise SystemExit("Missing required --config/-c argument")
    cfg = load_yaml_config(known.config)
    for dotted, value in parse_cli_overrides(rest):
        cfg.set_by_dotted(dotted, value)
    _resolve_fn_keys(cfg)
    validate_config_enums(cfg)
    return cfg


def dump_yaml_config(data: dict, path: str) -> None:
    """Write a config (``ConfigNode.to_dict()``) as YAML; leaves YAML cannot
    represent (a resolved callable) are written as their dotted names, as
    the JAX package's ``dump_yaml_config`` does."""

    class _Dumper(yaml.SafeDumper):
        pass

    def _by_name(dumper: yaml.SafeDumper, value: Any):
        name = getattr(value, "__module__", "") + "." + getattr(
            value, "__qualname__", getattr(value, "__name__", str(value)))
        return dumper.represent_str(name.strip("."))

    _Dumper.add_multi_representer(object, _by_name)
    with open(path, "w") as f:
        yaml.dump(data, f, Dumper=_Dumper, sort_keys=False)
