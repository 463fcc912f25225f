"""Multi-tenant adapter slots: the "which weights" side of multi-LoRA
serving (counterpart: ``automodel_tpu/serving/adapters.py``).

One :class:`AdapterSlots` holds, per targeted projection, a pair of device
slabs stacked over E = ``max_adapters + 1`` slots::

    A: [L, E, in, r]      B: [L, E, r, out]

Slot 0 is the base model and stays all zero: a request with ``adapter_id
== 0`` gets an exactly-zero delta through the grouped matmul
(``ops/lora_gmm.py``), so base traffic needs no mask.  Slots
1..max_adapters are hot-swappable tenants.

A load takes a trained single-adapter tree in the JAX layout, ``{module
path: {"A": [L, in, r], "B": [L, r, out]}}`` (numpy, torch or JAX arrays;
``models/weights.py::jax_adapter_tree`` reads one), digests it as the JAX
registry does (sha256 of each leaf's bytes, then of the digests in key
order, so both packages stamp one tree alike), checks its geometry
against :func:`~automodel_tpu_torch.peft.lora.adapter_slab_shapes`,
stages every new slot slice on the device, and only then writes them into
the slabs in place and flips the registry.  Any failure (drilled by the
``adapter_load`` / ``adapter_swap`` fault points) raises
:class:`AdapterLoadError` with every slab byte untouched.  Shapes never
change, so a swap adds no step shape.

The tenant's LoRA scale (alpha / r) is folded into its B slab rows at load
time, so tenants with different alphas share one batch.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from automodel_tpu_torch.models.llama import LayerAdapter
from automodel_tpu_torch.models.weights import jax_adapter_tree
from automodel_tpu_torch.peft.lora import PeftConfig, adapter_slab_shapes
from automodel_tpu_torch.utils.fault_injection import (
    InjectedFault,
    fault_point,
)

# serving.adapter_rank default: PeftConfig.dim's default
DEFAULT_ADAPTER_RANK = 8


class AdapterLoadError(RuntimeError):
    """A slot load or swap failed; the slot's previous adapter (or the zero
    adapter) is still serving."""


def tree_digest(tree: Dict[str, Dict[str, np.ndarray]]) -> str:
    """The registry digest of an adapter tree: sha256 over the sha256 of
    each leaf's raw bytes, in the JAX key-path order (``['<path>']['A']``
    sorted), as ``serialize_tree`` stamps it in the JAX package."""
    leaf = {f"[{path!r}][{part!r}]": hashlib.sha256(
                np.asarray(ab[part]).tobytes()).hexdigest()
            for path, ab in tree.items() for part in ab}
    return hashlib.sha256(
        "".join(leaf[k] for k in sorted(leaf)).encode("ascii")).hexdigest()


class AdapterSlots:
    """Host-side slot registry plus device slabs for batched multi-LoRA."""

    def __init__(self, model, *, max_adapters: int, rank: int,
                 target_modules=None, device=None):
        self.max_adapters = int(max_adapters)
        self.rank = int(rank)
        self.num_slots = self.max_adapters + 1          # slot 0 = base
        cfg = PeftConfig(dim=self.rank)
        if target_modules is not None:
            cfg = PeftConfig(dim=self.rank,
                             target_modules=list(target_modules))
        self._shapes = adapter_slab_shapes(model, cfg, self.num_slots)
        self._dtype = model.compute_dtype
        self.device = (torch.device(device) if device is not None
                       else model.inv_freq.device)
        self.slabs: Dict[str, Dict[str, torch.Tensor]] = {
            path: {"A": torch.zeros(a_shape, dtype=self._dtype,
                                    device=self.device),
                   "B": torch.zeros(b_shape, dtype=self._dtype,
                                    device=self.device)}
            for path, (a_shape, b_shape) in self._shapes.items()}
        # slot -> {"name", "digest", "scale", "version"}
        self._registry: Dict[int, Dict[str, Any]] = {}
        self.loads = 0
        self.swaps = 0
        self.load_failures = 0

    # -- queries -----------------------------------------------------------
    def is_loaded(self, adapter_id: int) -> bool:
        """Slot 0 (base) always serves; others only once loaded."""
        return adapter_id == 0 or adapter_id in self._registry

    def loaded_slots(self) -> Dict[int, Dict[str, Any]]:
        return {k: dict(v) for k, v in sorted(self._registry.items())}

    def stats(self) -> Dict[str, Any]:
        return {
            "max_adapters": self.max_adapters,
            "rank": self.rank,
            "loaded": sorted(self._registry),
            "loads": self.loads,
            "swaps": self.swaps,
            "load_failures": self.load_failures,
            "slots": self.loaded_slots(),
        }

    def layer_adapters(self) -> List[Dict[str, LayerAdapter]]:
        """One ``{_proj name: LayerAdapter(A [E, in, r], B [E, r, out])}``
        per layer (views into the slabs) for the model's forward."""
        L = next(iter(self._shapes.values()))[0][0]
        return [{path[len("layers."):]: LayerAdapter(A=s["A"][i],
                                                     B=s["B"][i])
                 for path, s in self.slabs.items()}
                for i in range(L)]

    # -- mutation ----------------------------------------------------------
    def _check_slot(self, slot: int) -> None:
        if not (1 <= int(slot) <= self.max_adapters):
            raise AdapterLoadError(
                f"adapter slot {slot} out of range [1, {self.max_adapters}] "
                "(slot 0 is reserved for the base model)")

    @torch.no_grad()
    def load(self, slot: int, adapters: Dict[str, Any], *,
             name: Optional[str] = None, scale: float = 1.0
             ) -> Dict[str, Any]:
        """Load (or hot-swap) one tenant's adapter tree into ``slot``;
        returns the new registry entry.  Raises :class:`AdapterLoadError`
        on any failure, with every slab untouched."""
        self._check_slot(slot)
        swap = slot in self._registry
        try:
            fault_point("adapter_swap" if swap else "adapter_load")
            host = jax_adapter_tree(adapters)
            got, want = set(host), set(self._shapes)
            if got != want:
                raise AdapterLoadError(
                    f"adapter tree targets {sorted(got)} but this engine "
                    f"serves slabs for {sorted(want)}")
            digest = tree_digest(host)
            staged = {}
            for path, (a_shape, b_shape) in self._shapes.items():
                A, B = host[path]["A"], host[path]["B"]
                want_a = (a_shape[0],) + a_shape[2:]     # (L, in, r)
                want_b = (b_shape[0],) + b_shape[2:]     # (L, r, out)
                if A.shape != want_a or B.shape != want_b:
                    raise AdapterLoadError(
                        f"{path}: adapter is A{A.shape}/B{B.shape}, slot "
                        f"geometry is A{want_a}/B{want_b} (uniform rank "
                        f"r={self.rank} across slots)")
                # the tenant's alpha / r folded into B
                staged[path] = (
                    torch.from_numpy(np.ascontiguousarray(A)).to(
                        self.device, self._dtype),
                    torch.from_numpy(np.ascontiguousarray(
                        B * np.float32(scale))).to(self.device,
                                                   self._dtype))
        except AdapterLoadError:
            self.load_failures += 1
            raise
        except (InjectedFault, KeyError, ValueError, TypeError) as e:
            self.load_failures += 1
            raise AdapterLoadError(
                f"adapter {'swap' if swap else 'load'} into slot {slot} "
                f"failed: {e}") from e
        # commit: every slice staged, now written in place
        for path, (A, B) in staged.items():
            self.slabs[path]["A"][:, slot].copy_(A)
            self.slabs[path]["B"][:, slot].copy_(B)
        entry = {"name": name or f"adapter-{slot}", "digest": digest,
                 "scale": float(scale),
                 "version": self._registry.get(slot, {}).get("version", 0) + 1}
        self._registry[slot] = entry
        if swap:
            self.swaps += 1
        else:
            self.loads += 1
        return dict(entry)

    @torch.no_grad()
    def remove(self, slot: int) -> None:
        """Zero a slot's rows and forget it; later submits naming it are
        refused."""
        self._check_slot(slot)
        if slot not in self._registry:
            raise AdapterLoadError(f"adapter slot {slot} is not loaded")
        for s in self.slabs.values():
            s["A"][:, slot].zero_()
            s["B"][:, slot].zero_()
        del self._registry[slot]

    @torch.no_grad()
    def clone_from(self, other: "AdapterSlots") -> None:
        """Adopt a peer's slabs and registry (copies)."""
        if self._shapes != other._shapes:
            raise AdapterLoadError(
                "peer adapter slabs have different geometry")
        for path, s in other.slabs.items():
            for part in ("A", "B"):
                self.slabs[path][part].copy_(s[part])
        self._registry = {k: dict(v) for k, v in other._registry.items()}
