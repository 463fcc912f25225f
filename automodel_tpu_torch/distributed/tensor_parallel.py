"""Autograd-aware collectives of tensor and sequence parallelism over the
mesh's ``tp`` group (the collectives GSPMD inserts for the JAX package's
``heads`` / ``mlp`` / ``vocab`` rules and ``act_seq`` under
``sequence_parallel``).

Every tp rank computes the same loss and back-propagates its own copy, so
a replicated activation's gradient is whole on every rank.  Around a
column-parallel product the input enters with :func:`copy_to_tp` (the
backward sums the ranks' partial input gradients), and a row-parallel
product's partial output leaves with :func:`reduce_from_tp` (a sum; the
backward passes the whole gradient).  Under sequence parallelism the
activations between blocks hold ``S / tp`` rows a rank:
:func:`gather_seq` (all-gather; the backward reduce-scatters) and
:func:`reduce_scatter_seq` (the backward all-gathers) take their place.
:func:`gather_seq_whole` gathers rows whose gradient comes back whole (the
backward keeps this rank's rows), :func:`gather_vocab` the vocab-sharded
logits (the backward keeps this rank's columns).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass
class TPContext:
    """The tp group a model runs in, and whether the activations between
    blocks are sequence-sharded."""

    group: object
    size: int
    rank: int
    sequence_parallel: bool = False


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    x = x.contiguous().clone()
    dist.all_reduce(x, op=op, group=group)
    return x


def _all_gather(x, group, size, dim):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x, group, size, dim):
    parts = [p.contiguous() for p in torch.chunk(x, size, dim=dim)]
    out = torch.empty_like(parts[0])
    if dist.get_backend(group) == "gloo":
        # gloo has no reduce_scatter: a sum, then this rank's rows
        total = _all_reduce(x, group)
        return torch.chunk(total, size, dim=dim)[
            dist.get_rank(group)].contiguous()
    dist.reduce_scatter(out, parts, group=group)
    return out


def _local(x, group, size, dim):
    return torch.chunk(x, size, dim=dim)[dist.get_rank(group)].contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, dim, whole):
        ctx.args = (group, size, dim, whole)
        return _all_gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        group, size, dim, whole = ctx.args
        if whole:
            return _local(g, group, size, dim), None, None, None, None
        return _reduce_scatter(g, group, size, dim), None, None, None, None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, dim):
        ctx.args = (group, size, dim)
        return _reduce_scatter(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        group, size, dim = ctx.args
        return _all_gather(g, group, size, dim), None, None, None


def copy_to_tp(x, tp: TPContext):
    return _Copy.apply(x, tp.group)


def reduce_from_tp(x, tp: TPContext):
    return _Reduce.apply(x, tp.group)


def gather_seq(x, tp: TPContext, dim: int = 1):
    return _GatherSeq.apply(x, tp.group, tp.size, dim, False)


def gather_seq_whole(x, tp: TPContext, dim: int = 1):
    return _GatherSeq.apply(x, tp.group, tp.size, dim, True)


def reduce_scatter_seq(x, tp: TPContext, dim: int = 1):
    return _ReduceScatterSeq.apply(x, tp.group, tp.size, dim)


def gather_vocab(x, tp: TPContext):
    return _GatherSeq.apply(x, tp.group, tp.size, x.dim() - 1, True)


def enter_block(x, tp: TPContext):
    """A block's normed input before its column-parallel products."""
    return gather_seq(x, tp) if tp.sequence_parallel else copy_to_tp(x, tp)


def leave_block(y, tp: TPContext):
    """A row-parallel product's partial output back to the residual."""
    return (reduce_scatter_seq(y, tp) if tp.sequence_parallel
            else reduce_from_tp(y, tp))


class _MaxNoGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group, dist.ReduceOp.MAX)

    @staticmethod
    def backward(ctx, g):
        return None, None


def max_over_tp(x, tp: TPContext):
    """The elementwise max over the tp ranks, without gradient (the
    stop-gradient max of a log-sum-exp merge)."""
    return _MaxNoGrad.apply(x.detach(), tp.group)
