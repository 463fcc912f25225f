"""Module matching for PEFT target selection (counterpart:
``automodel_tpu/peft/module_matcher.py``, kept here as the port's own copy).

``wildcard_match`` patterns; precedence: ``match_all_linear`` >
``target_modules`` > all-linear-except-``exclude_modules``.  Names are the
JAX tree paths of the linear kernels' parents (``layers.self_attn.q_proj``),
which ``peft/lora.py::match_targets`` derives from the port's modules
through ``models/weights.py::jax_leaves``, so one YAML matches the same
projections in both packages.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional


def wildcard_match(pattern: str, name: Optional[str]) -> bool:
    """``*`` matches any run of characters, dots included."""
    if name is None:
        return False
    regex = "^" + re.escape(pattern).replace(r"\*", ".*") + "$"
    return re.fullmatch(regex, name) is not None


@dataclasses.dataclass
class ModuleMatcher:
    target_modules: List[str] = dataclasses.field(default_factory=list)
    exclude_modules: List[str] = dataclasses.field(default_factory=list)
    match_all_linear: bool = False

    def match(self, name: str) -> bool:
        """``name`` is the dotted JAX path of a linear kernel's parent
        (``layers.mlp.gate_proj``); a pattern may match it or its last
        component."""
        leaf = name.rsplit(".", 1)[-1]
        if self.match_all_linear:
            return not self._excluded(name, leaf)
        if self.target_modules:
            return any(
                wildcard_match(p, name) or wildcard_match(p, leaf)
                for p in self.target_modules)
        return not self._excluded(name, leaf)

    def _excluded(self, name: str, leaf: str) -> bool:
        return any(
            wildcard_match(p, name) or wildcard_match(p, leaf)
            for p in self.exclude_modules)
