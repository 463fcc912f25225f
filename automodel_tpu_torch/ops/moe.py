"""Mixture-of-experts routing and expert compute (counterpart:
``automodel_tpu/ops/moe.py``).

Two formulations behind the ``moe.dispatch`` knob, as in JAX:

* ``sorted`` (default): sort-based dispatch.  The ``[T*k]`` routed
  assignments are stably sorted by expert id into per-expert segments, each
  padded to ``block_rows`` rows; the SwiGLU expert FFNs run as three grouped
  matmuls over the sorted buffer (``ops/gmm_kernel.py``: the hand-written
  ``csrc/gmm.cu`` kernels on the card) and the results are scatter-added
  back with the combine weights.  No tensor carries an expert dimension.
* ``onehot``: the GShard dispatch/combine one-hot einsums, kept as the
  parity oracle; the sorted path matches it, capacity drops included.

Routing is HF Mixtral's (fp32 softmax over all experts, top-k, optional
renormalisation) with its Switch load-balancing loss.  With
``capacity_factor=None`` both paths are dropless; under a finite factor an
assignment past its (group, expert) capacity is dropped with GShard's
slot-major priority and the residual stream passes the token on.

The router product, top-k, the sort, the counts and the scatter are plain
torch ops, as they are XLA ops outside Pallas in JAX.  On the card none of
them reads a value back to the host: the counts are a ``scatter_add_``
(``torch.bincount`` would synchronise) and the segment layout comes from
``cumsum`` and ``searchsorted``.  With quantized compute on (``quant=``,
``fp8.enabled``) the sorted path's grouped matmuls are
``ops/gmm_quant_kernel.py``'s (``csrc/gmm_quant.cu`` on the card); the
onehot oracle ignores ``quant``, as JAX's does.  The DeepSeek routers wait
for a later slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

MOE_DISPATCHES = ("sorted", "onehot")
DEFAULT_MOE_DISPATCH = "sorted"


def normalize_moe_dispatch(dispatch: Optional[str]) -> Optional[str]:
    """YAML null spellings ("none", "null", "") mean the default."""
    if isinstance(dispatch, str) and dispatch.lower() in ("none", "null", ""):
        return None
    return dispatch


def validate_moe_dispatch(dispatch: Optional[str]) -> Optional[str]:
    """None (defer to the default) or a member of ``MOE_DISPATCHES``."""
    if dispatch is None:
        return None
    if dispatch not in MOE_DISPATCHES:
        raise ValueError(
            f"moe.dispatch must be one of {list(MOE_DISPATCHES)}, "
            f"got {dispatch!r}")
    return dispatch


def resolve_moe_dispatch(dispatch: Optional[str]) -> str:
    validate_moe_dispatch(dispatch)
    return dispatch if dispatch is not None else DEFAULT_MOE_DISPATCH


def topk_routing(router_logits: torch.Tensor, k: int, norm_topk: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 softmax over all experts, top-k, renormalised to 1 unless
    ``norm_topk`` is False -> ``(weights [..., k], expert_idx [..., k],
    probs [..., E])``."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    weights, idx = torch.topk(probs, k, dim=-1)
    if norm_topk:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, idx, probs


def _one_hot(idx: torch.Tensor, num_classes: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, num_classes)`` (the pad
    sentinel) gives the zero vector."""
    return (idx[..., None] == torch.arange(num_classes, device=idx.device)
            ).to(dtype)


def routing_stats(probs: torch.Tensor, expert_idx: torch.Tensor,
                  num_experts: int,
                  valid_tokens: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(tokens_per_expert [k, E], router_prob [E])``, means over the
    tokens (over the ``valid_tokens`` ones when given).  Layers are averaged
    before the loss's product (:func:`load_balancing_loss`), as HF
    concatenates every layer's tokens."""
    mask = _one_hot(expert_idx, num_experts, torch.float32)
    token_dims = tuple(range(mask.dim() - 2))
    probs = probs.float()
    prob_dims = tuple(range(probs.dim() - 1))
    if valid_tokens is None:
        return mask.mean(dim=token_dims), probs.mean(dim=prob_dims)
    v = valid_tokens.float()
    denom = v.sum().clamp(min=1.0)
    return (mask.sum(dim=token_dims) / denom,
            (probs * v[..., None]).sum(dim=prob_dims) / denom)


def load_balancing_loss(tokens_per_expert: torch.Tensor,
                        router_prob: torch.Tensor) -> torch.Tensor:
    """``E * sum_{k,e} f_{k,e} * P_e`` (HF ``load_balancing_loss_func``)."""
    return (tokens_per_expert * router_prob[None, :]).sum() \
        * router_prob.shape[-1]


def _group_size(tokens: int, requested: int) -> int:
    return min(requested, tokens)


def group_tokens(x2d: torch.Tensor, group_size: int
                 ) -> Tuple[torch.Tensor, int]:
    """``[T, H] -> ([G, M, H], pad)``: ``M = min(group_size, T)`` and
    ``pad`` zero rows appended to fill the last group."""
    T, H = x2d.shape
    M = _group_size(T, group_size)
    G = -(-T // M)
    pad = G * M - T
    if pad:
        x2d = F.pad(x2d, (0, 0, 0, pad))
    return x2d.reshape(G, M, H), pad


def mask_padded_tokens(weights: torch.Tensor, idx: torch.Tensor, pad: int,
                       num_experts: int):
    """Route the ``pad`` trailing tokens of the ``[G*M]`` stream to the
    sentinel expert ``E`` with weight 0 -> ``(weights, idx, valid [G, M] |
    None)``."""
    if not pad:
        return weights, idx, None
    G, M = idx.shape[:2]
    valid = (torch.arange(G * M, device=idx.device) < G * M - pad
             ).reshape(G, M)
    idx = torch.where(valid[..., None], idx, torch.full_like(idx, num_experts))
    weights = torch.where(valid[..., None], weights, torch.zeros_like(weights))
    return weights, idx, valid


def group_and_capacity(tokens: int, group_size: int, num_experts: int,
                       k: int, capacity_factor: Optional[float]
                       ) -> Tuple[int, int]:
    """(tokens per group M, per-group expert capacity C);
    ``capacity_factor=None`` is dropless (C = M)."""
    M = _group_size(tokens, group_size)
    if capacity_factor is None:
        return M, M
    C = min(M, max(int(math.ceil(k * M / num_experts
                                 * float(capacity_factor))), 1))
    return M, C


def route(x: torch.Tensor, gate_kernel: torch.Tensor, *,
          num_experts_per_tok: int, group_size: int = 512,
          norm_topk: bool = True):
    """Router of :func:`moe_mlp_block`: ``x [B, S, H]`` against
    ``gate_kernel [H, E]`` in fp32 -> ``(xg [G, M, H], weights [G, M, k],
    idx [G, M, k], probs [G, M, E], valid, pad)``; pad tokens carry the
    sentinel id ``E``."""
    B, S, H = x.shape
    E = gate_kernel.shape[-1]
    T = B * S
    xg, pad = group_tokens(x.reshape(T, H), _group_size(T, group_size))
    router_logits = xg.float() @ gate_kernel.float()
    weights, idx, probs = topk_routing(router_logits, int(num_experts_per_tok),
                                       norm_topk=norm_topk)
    weights, idx, valid = mask_padded_tokens(weights, idx, pad, E)
    return xg, weights, idx, probs, valid, pad


def moe_mlp_block(
    x: torch.Tensor,                # [B, S, H]
    gate_kernel: torch.Tensor,      # [H, E]
    w_gate: torch.Tensor,           # [E, H, I]
    w_up: torch.Tensor,             # [E, H, I]
    w_down: torch.Tensor,           # [E, I, H]
    *,
    num_experts_per_tok: int,
    capacity_factor: Optional[float] = 2.0,
    group_size: int = 512,
    compute_dtype: torch.dtype = torch.bfloat16,
    norm_topk: bool = True,
    dispatch: Optional[str] = None,
    quant=None,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Top-k routed SwiGLU expert FFN -> ``(out [B, S, H],
    (tokens_per_expert [k, E], router_prob [E]))``.  ``impl`` reaches the
    grouped matmuls (None: the kernels on CUDA tensors); ``quant`` (a
    ``QuantConfig`` or None) quantizes the sorted path's."""
    B, S, H = x.shape
    E = gate_kernel.shape[-1]
    k = int(num_experts_per_tok)
    _, C = group_and_capacity(B * S, group_size, E, k, capacity_factor)
    xg, weights, idx, probs, valid, pad = route(
        x, gate_kernel, num_experts_per_tok=k, group_size=group_size,
        norm_topk=norm_topk)
    aux = routing_stats(probs, idx, E, valid_tokens=valid)
    out = expert_ffn(xg, weights, idx, w_gate, w_up, w_down, capacity=C,
                     dispatch=dispatch, compute_dtype=compute_dtype,
                     quant=quant, impl=impl)
    out = out.reshape(-1, H)
    if pad:
        out = out[:B * S]
    return out.reshape(B, S, H), aux


def expert_ffn(xg, weights, idx, w_gate, w_up, w_down, *, capacity: int,
               dispatch: Optional[str] = None,
               compute_dtype: torch.dtype = torch.bfloat16,
               quant=None, impl: Optional[str] = None) -> torch.Tensor:
    """The ``sorted`` grouped-matmul path by default, ``onehot`` as the
    oracle; ``quant`` applies to the sorted path only (the onehot
    formulation is the bf16 oracle and never quantizes)."""
    if resolve_moe_dispatch(dispatch) == "onehot":
        return expert_dispatch_ffn(xg, weights, idx, w_gate, w_up, w_down,
                                   capacity=capacity,
                                   compute_dtype=compute_dtype)
    return sorted_expert_ffn(xg, weights, idx, w_gate, w_up, w_down,
                             capacity=capacity, compute_dtype=compute_dtype,
                             quant=quant, impl=impl)


def expert_dispatch_ffn(xg, weights, idx, w_gate, w_up, w_down, *,
                        capacity: int,
                        compute_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """GShard dispatch/combine one-hots ``[G, M, E, C]`` (slot-major
    priority: slot j's assignments claim capacity after all slots < j) and
    the expert-batched SwiGLU FFN."""
    G, M, H = xg.shape
    E = w_gate.shape[0]
    k = idx.shape[-1]
    C = capacity
    cd = compute_dtype
    dispatch = torch.zeros(G, M, E, C, dtype=cd, device=xg.device)
    combine = torch.zeros(G, M, E, C, dtype=cd, device=xg.device)
    counts = torch.zeros(G, 1, E, dtype=torch.int64, device=xg.device)
    for j in range(k):
        oh = _one_hot(idx[..., j], E, torch.int64)               # [G, M, E]
        pos = torch.cumsum(oh, dim=1) - oh + counts
        counts = counts + oh.sum(dim=1, keepdim=True)
        keep = (oh * (pos < C)).to(cd)
        d = keep[..., None] * _one_hot(pos, C, cd)               # [G, M, E, C]
        dispatch = dispatch + d
        combine = combine + weights[..., j, None, None].to(cd) * d
    expert_in = torch.einsum("gmec,gmh->egch", dispatch, xg.to(cd))
    h_gate = torch.einsum("egch,ehi->egci", expert_in, w_gate.to(cd))
    h_up = torch.einsum("egch,ehi->egci", expert_in, w_up.to(cd))
    expert_out = torch.einsum("egci,eih->egch", F.silu(h_gate) * h_up,
                              w_down.to(cd))
    return torch.einsum("egch,gmec->gmh", expert_out, combine)


def _assignment_positions(idx: torch.Tensor, num_experts: int
                          ) -> torch.Tensor:
    """``[G, M, k]`` slot-major position of each assignment in its (group,
    expert) capacity queue: the oracle's priority, so both paths drop the
    same assignments."""
    G, M, k = idx.shape
    counts = torch.zeros(G, 1, num_experts, dtype=torch.int64,
                         device=idx.device)
    pos = []
    for j in range(k):
        oh = _one_hot(idx[..., j], num_experts, torch.int64)
        pj = torch.cumsum(oh, dim=1) - oh + counts
        counts = counts + oh.sum(dim=1, keepdim=True)
        pos.append((pj * oh).sum(dim=-1))
    return torch.stack(pos, dim=-1)


def expert_segments(eid: torch.Tensor, num_experts: int, block_rows: int):
    """The sorted layout of the assignments ``eid [N]`` (expert ids; ``E``
    for dropped / pad ones): ``(order, sizes [E], padded [E], n_pad)`` with
    expert e's rows at a ``block_rows``-aligned offset, each segment padded
    to a multiple of ``block_rows``; ``n_pad`` is the buffer's static
    length."""
    E, B = num_experts, int(block_rows)
    N = eid.shape[0]
    order = torch.argsort(eid, stable=True)          # ties keep token order
    sizes = torch.zeros(E + 1, dtype=torch.int64, device=eid.device)
    sizes.scatter_add_(0, eid.long(), torch.ones_like(eid, dtype=torch.int64))
    sizes = sizes[:E]
    padded = (sizes + B - 1) // B * B
    n_pad = -(-(N + E * B) // B) * B
    return order, sizes, padded, n_pad


def sorted_expert_ffn(xg, weights, idx, w_gate, w_up, w_down, *,
                      capacity: Optional[int] = None,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      block_rows: int = 128, quant=None,
                      impl: Optional[str] = None) -> torch.Tensor:
    """Sort-based expert FFN over ``xg [G, M, H]``: drops decided with the
    oracle's priority (skipped when dropless), a stable sort of the
    assignments by expert, block-aligned segments, a gather, three grouped
    matmuls (quantized when ``quant`` is on and H and I are multiples of
    16, the JAX package's rule), SiLU x up, and a weighted ``index_add``
    back to the tokens."""
    from automodel_tpu_torch.ops.gmm_kernel import gmm
    from automodel_tpu_torch.ops.gmm_quant_kernel import gmm_quant

    G, M, H = xg.shape
    E = w_gate.shape[0]
    I_mlp = w_gate.shape[-1]
    k = idx.shape[-1]
    T, N = G * M, G * M * k
    cd = compute_dtype
    B = int(block_rows)
    if capacity is not None and capacity < M:
        pos = _assignment_positions(idx, E)
        eid = torch.where(pos < capacity, idx, torch.full_like(idx, E))
    else:
        eid = idx
    order, sizes, padded, n_pad = expert_segments(eid.reshape(N), E, B)
    ends = torch.cumsum(padded, 0)
    seg_off = ends - padded
    raw_off = torch.cumsum(sizes, 0) - sizes
    rows = torch.arange(n_pad, device=xg.device)
    gid = torch.searchsorted(ends, rows, right=True)
    gid_c = gid.clamp(max=E - 1)
    rank = rows - seg_off[gid_c]
    size_g = sizes[gid_c]
    in_seg = (gid < E) & (rank < size_g)
    slot = raw_off[gid_c] + torch.minimum(rank, (size_g - 1).clamp(min=0))
    src = order[slot.clamp(0, N - 1)]                 # assignment index
    tok = src // k                                    # its token row

    x_flat = xg.reshape(T, H)
    # index_select: its backward is an index_add (as JAX's gather's is a
    # scatter-add); x_flat[tok]'s sorts the indices first (~7 ms a call at
    # the Qwen3-30B-A3B shape on the H100)
    x_sorted = torch.where(in_seg[:, None], x_flat.index_select(0, tok),
                           x_flat.new_zeros(())).to(cd)
    wg, wu, wd = (w.to(cd) for w in (w_gate, w_up, w_down))
    group_sizes = padded.to(torch.int32)

    if (quant is not None and getattr(quant, "enabled", False)
            and H % 16 == 0 and I_mlp % 16 == 0):
        def mm(lhs, rhs):
            return gmm_quant(lhs, rhs, group_sizes, quant.dtype,
                             quant.recipe_name, block_aligned=True,
                             block_rows=B, impl=impl)
    else:
        def mm(lhs, rhs):
            return gmm(lhs, rhs, group_sizes, block_aligned=True,
                       block_rows=B, impl=impl)

    h_act = F.silu(mm(x_sorted, wg)) * mm(x_sorted, wu)
    out_sorted = mm(h_act, wd)
    w_sorted = torch.where(in_seg, weights.reshape(N)[src],
                           weights.new_zeros(())).to(cd)
    out = torch.zeros(T, H, dtype=cd, device=xg.device).index_add(
        0, tok, out_sorted * w_sorted[:, None])
    return out.reshape(G, M, H)
