"""Guarded optional imports (counterpart:
``automodel_tpu/utils/safe_import.py``).

An optional dependency (``wandb``, ...) imports to a placeholder that
raises a clear ``ImportError`` when used, so a module can be imported
without it and only the feature that needs it fails.
"""

from __future__ import annotations

import importlib
from typing import Any, Tuple


class UnavailablePlaceholder:
    """Stands in for a missing module or symbol; any use raises
    ``ImportError``."""

    def __init__(self, name: str, error: Exception):
        self._name = name
        self._error = error

    def _raise(self):
        raise ImportError(
            f"{self._name} is required for this feature but could not be "
            f"imported: {self._error}")

    def __getattr__(self, item):
        self._raise()

    def __call__(self, *args, **kwargs):
        self._raise()

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:
        return f"<unavailable: {self._name}>"


def safe_import(module: str) -> Tuple[bool, Any]:
    """``(imported_ok, module_or_placeholder)``."""
    try:
        return True, importlib.import_module(module)
    except Exception as e:  # ImportError and failures inside the import
        return False, UnavailablePlaceholder(module, e)


def safe_import_from(module: str, symbol: str) -> Tuple[bool, Any]:
    """``(imported_ok, symbol_or_placeholder)``."""
    ok, mod = safe_import(module)
    if not ok:
        return False, UnavailablePlaceholder(f"{module}.{symbol}", mod._error)
    try:
        return True, getattr(mod, symbol)
    except AttributeError as e:
        return False, UnavailablePlaceholder(f"{module}.{symbol}", e)
