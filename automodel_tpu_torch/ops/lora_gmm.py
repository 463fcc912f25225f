"""Grouped multi-LoRA adapter delta on the gmm kernel (counterpart:
``automodel_tpu/ops/lora_gmm.py``).

Multi-tenant serving batches requests that each carry their own rank-r
adapter over one base model.  A projection's delta is

    delta[row] = (x[row] @ A[g]) @ B[g],    g = adapter_ids[row]

which is the MoE dispatch shape: rows group by adapter id the way tokens
group by expert.  :func:`multi_lora_delta` sorts the step's rows by adapter
id and runs the two rank-r products through ``ops/gmm_kernel.py::gmm``:
on CUDA tensors the port's grouped-matmul kernel (``csrc/gmm.cu``, kernel
5), with ``K = in, N = r`` and then ``K = r, N = out``; on CPU tensors its
plain version.  There is no other route: a kernel that fails to build or
launch raises.  :func:`multi_lora_delta_reference` is the dense per-row
plain version the tests hold it against.

Slabs are per layer, ``A [E, in, r]`` / ``B [E, r, out]``; slot 0 is the
base model (all zeros), so ``adapter_id == 0`` rows get an exactly-zero
delta.  The sort is the same for every projection and layer of a step:
:func:`lora_routing` computes it once and the model passes it along.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from automodel_tpu_torch.ops.gmm_kernel import gmm


class LoraRouting(NamedTuple):
    """A step's row order by adapter id: ``order`` / ``inv`` ``[B * S]``
    permutations and ``group_sizes [E]`` int32, all on the rows' device."""
    order: torch.Tensor
    inv: torch.Tensor
    group_sizes: torch.Tensor


def lora_routing(adapter_ids: torch.Tensor, seq: int,
                 num_slots: int) -> LoraRouting:
    """Routing of ``[B]`` adapter ids over rows of ``seq`` tokens each
    (stable sort, so rows of one adapter keep their order); no host sync
    on a CUDA tensor (the group sizes are a scatter-add, not a
    ``bincount``)."""
    ids = adapter_ids.long().repeat_interleave(seq)
    order = torch.argsort(ids, stable=True)
    inv = torch.argsort(order)
    sizes = torch.zeros(num_slots, dtype=torch.int32, device=ids.device)
    sizes.scatter_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
    return LoraRouting(order, inv, sizes)


def multi_lora_delta(x: torch.Tensor, a_slab: torch.Tensor,
                     b_slab: torch.Tensor, adapter_ids: torch.Tensor,
                     routing: Optional[LoraRouting] = None) -> torch.Tensor:
    """Per-request grouped adapter delta of one projection.

    ``x [B, S, in]`` (every token of row ``b`` belongs to adapter
    ``adapter_ids[b]``), ``a_slab [E, in, r]``, ``b_slab [E, r, out]``,
    ``adapter_ids [B]`` in ``[0, E)``.  Returns ``[B, S, out]`` in ``x``'s
    dtype with ``delta[b, s] = (x[b, s] @ A[g]) @ B[g]``; the rank-r
    intermediate is rounded to ``x``'s dtype between the two products, as
    in JAX."""
    B, S, fin = x.shape
    E = a_slab.shape[0]
    fout = b_slab.shape[-1]
    if routing is None:
        routing = lora_routing(adapter_ids, S, E)
    rows = x.reshape(B * S, fin)[routing.order]
    h = gmm(rows, a_slab.to(x.dtype), routing.group_sizes)      # [B*S, r]
    d = gmm(h, b_slab.to(x.dtype), routing.group_sizes)         # [B*S, out]
    return d[routing.inv].reshape(B, S, fout)


def multi_lora_delta_reference(x: torch.Tensor, a_slab: torch.Tensor,
                               b_slab: torch.Tensor,
                               adapter_ids: torch.Tensor) -> torch.Tensor:
    """Dense per-row plain version: gather each row's own ``(A, B)`` and
    multiply in fp32, cast to ``x``'s dtype."""
    ids = adapter_ids.long()
    a = a_slab[ids].float()                          # [B, in, r]
    b = b_slab[ids].float()                          # [B, r, out]
    return torch.einsum("bsi,bir,bro->bso", x.float(), a, b).to(x.dtype)
