"""Ring attention: context-parallel attention over the mesh's ``cp`` axis
(counterpart: ``automodel_tpu/ops/ring_attention.py``).

Each cp rank holds a slice of the sequence's q, k, v (and segment ids).
The k / v / id blocks travel around the cp group (``batch_isend_irecv``
under NCCL, ``isend`` / ``irecv`` under gloo; the next block's transfer is
posted before this block is computed), and each rank merges its queries'
attention over every arriving block by the blocks' log-sum-exp, as the
JAX ring's ``tiling.combine_online_softmax`` does.

Every token has a global position given by the sequence layout
(``ops/zigzag.py``; :func:`_shard_positions`): ``contiguous`` gives rank
``i`` chunk ``i`` of ``cp``, ``zigzag`` chunks ``i`` and ``2 cp - 1 - i``
of ``2 cp``.  A block is cut into the layout's pieces (one or two chunks a
side), and each pair of pieces is fully visible (the key chunk lies
before the query chunk), causal on the diagonal (the same chunk), or
masked and not launched.  On CUDA tensors each visible pair is one launch
of kernel 9 (``csrc/flash_attn_fwd.cu`` / ``flash_attn_bwd.cu``) with the
query piece's and the key piece's own segment ids (upstream splash's
``SegmentIds(q, kv)``); on CPU tensors the same pairs run kernel 9's plain
versions.  A row with no key in a pair has lse ``-inf`` and weighs
nothing in the merge.

The backward is the standard ring backward: each pair's
``flash_attn_bwd`` gets the merged ``out`` and ``lse`` of its query rows
(so ``P`` and ``delta`` are the whole row's); dq sums on the rank, while
dk / dv accumulate in fp32 buffers that travel with their block and come
home after ``cp`` steps.

A sliding window or a logit soft cap is taken on CPU tensors only (each
block is then one plain product masked by position arithmetic, as the JAX
ring's ``_block_attend``); on CUDA tensors it raises (ROADMAP Queue 2 C,
"the ring's window and soft-cap blocks").

:func:`ring_rank_forward` / :func:`ring_rank_backward` run one rank's
schedule over blocks handed in directly (no transfer): ``chip_smoke.py``
drives the cp-4 schedule of a whole sequence in one process with them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_RING_CAP_WINDOW = ("the ring's window and soft-cap blocks on CUDA "
                    "(ROADMAP Queue 2 C)")


def _shard_positions(shard_index: int, s_local: int, cp: int, layout: str,
                     device=None) -> torch.Tensor:
    """The global token positions ``[s_local]`` (int64) that shard
    ``shard_index`` holds under the layout."""
    if layout == "zigzag":
        if s_local % 2:
            raise ValueError(
                f"zigzag layout needs an even local sequence length, got "
                f"{s_local} (global seq must divide 2*cp)")
        c = s_local // 2
        half = torch.arange(c, device=device)
        return torch.cat([shard_index * c + half,
                          (2 * cp - 1 - shard_index) * c + half])
    if layout != "contiguous":
        raise ValueError(f"unknown cp layout {layout!r}")
    return shard_index * s_local + torch.arange(s_local, device=device)


def _pieces(shard_index: int, s_local: int, cp: int,
            layout: str) -> List[Tuple[int, int, int]]:
    """``[(chunk, start, length)]``: the runs of consecutive positions a
    shard holds, with their chunk's index in the layout's order."""
    if layout == "zigzag":
        c = s_local // 2
        return [(shard_index, 0, c), (2 * cp - 1 - shard_index, c, c)]
    return [(shard_index, 0, s_local)]


def _rows(t: Optional[torch.Tensor], start: int, length: int):
    return None if t is None else t[:, start:start + length].contiguous()


def _k9_fwd(q, k, v, causal, seg_q, seg_kv, scale, impl):
    from automodel_tpu_torch.ops import splash_attention as sa

    kw = dict(causal=causal, segment_ids=seg_q, scale=scale,
              kv_segment_ids=seg_kv)
    if impl == "kernel":
        return sa.flash_attn_fwd_cuda(q, k, v, **kw)
    return sa.splash_attention_plain(q, k, v, **kw)


def _k9_bwd(q, k, v, out, lse, dout, causal, seg_q, seg_kv, scale, impl):
    from automodel_tpu_torch.ops import splash_attention as sa

    kw = dict(causal=causal, segment_ids=seg_q, scale=scale,
              kv_segment_ids=seg_kv)
    if impl == "kernel":
        return sa.flash_attn_bwd_cuda(q, k, v, out, lse, dout, **kw)
    return sa.splash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)


def _pairs(my_idx: int, kv_idx: int, s_local: int, cp: int, layout: str,
           causal: bool):
    """The launched piece pairs of one block: ``(q piece, kv piece,
    causal)``."""
    for qc, qs, ql in _pieces(my_idx, s_local, cp, layout):
        for kc, ks, kl in _pieces(kv_idx, s_local, cp, layout):
            if causal and kc > qc:
                continue
            yield (qs, ql), (ks, kl), causal and kc == qc


# ---------------------------------------------------------------------------
# position-masked plain blocks (window / soft cap; CPU tensors)
# ---------------------------------------------------------------------------
def _pos_scores(q, k, q_pos, kv_pos, seg_q, seg_kv, causal, scale, cap,
                window):
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    qg = q.float().reshape(B, S, Hk, Hq // Hk, D)
    x = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    dx = None
    if cap is not None:
        th = torch.tanh(x / cap)
        x = cap * th
        dx = 1.0 - th * th
    valid = torch.ones(B, S, k.shape[1], dtype=torch.bool, device=q.device)
    diff = q_pos[:, None] - kv_pos[None, :]
    if causal:
        valid = valid & (diff >= 0)[None]
    if window is not None:
        valid = valid & (diff < window)[None]
    if seg_q is not None:
        valid = valid & (seg_q[:, :, None] == seg_kv[:, None, :])
        valid = valid & (seg_kv != 0)[:, None, :]
    return x, dx, valid[:, None, None]


def _pos_fwd(q, k, v, q_pos, kv_pos, seg_q, seg_kv, causal, scale, cap,
             window):
    B, S, Hq, D = q.shape
    x, _, valid = _pos_scores(q, k, q_pos, kv_pos, seg_q, seg_kv, causal,
                              scale, cap, window)
    x = x.masked_fill(~valid, float("-inf"))
    lse = torch.logsumexp(x, dim=-1)
    safe = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    p = torch.exp(x - safe[..., None])
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, S, Hq, D), lse.reshape(B, Hq, S)


def _pos_bwd(q, k, v, out, lse, dout, q_pos, kv_pos, seg_q, seg_kv, causal,
             scale, cap, window):
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    G = Hq // Hk
    x, dx, valid = _pos_scores(q, k, q_pos, kv_pos, seg_q, seg_kv, causal,
                               scale, cap, window)
    p = torch.exp(x - lse.reshape(B, Hk, G, S)[..., None])
    p = torch.where(valid, p, torch.zeros_like(p))
    dog = dout.float().reshape(B, S, Hk, G, D)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    delta = (dout.float() * out.float()).sum(-1)
    delta = delta.reshape(B, S, Hk, G).permute(0, 2, 3, 1)
    ds = p * (dp - delta[..., None])
    if dx is not None:
        ds = ds * dx
    ds = ds * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()).reshape(
        B, S, Hq, D)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds,
                      q.float().reshape(B, S, Hk, G, D))
    return dq, dk, dv


# ---------------------------------------------------------------------------
# one rank's blocks
# ---------------------------------------------------------------------------
class _Spec:
    """The call's constants: layout, mask and route."""

    def __init__(self, cp, layout, causal, scale, cap, window, impl):
        self.cp, self.layout, self.causal = cp, layout, causal
        self.scale, self.cap, self.window, self.impl = (scale, cap, window,
                                                        impl)
        self.positional = cap is not None or window is not None


def _merge(acc, lse_run, out_b, lse_b, rows):
    """Merge one partial ``(out_b [B, r, Hq, D], lse_b [B, Hq, r])`` into
    rows ``rows`` of the running ``(acc, lse_run)`` in place."""
    s0, n = rows
    a = acc[:, s0:s0 + n]
    l0 = lse_run[..., s0:s0 + n]
    new = torch.logaddexp(l0, lse_b)
    dead = torch.isneginf(new)
    w0 = torch.where(dead, torch.zeros_like(new), torch.exp(l0 - new))
    w1 = torch.where(dead, torch.zeros_like(new), torch.exp(lse_b - new))
    a.mul_(w0.transpose(1, 2)[..., None]).add_(
        out_b.float() * w1.transpose(1, 2)[..., None])
    lse_run[..., s0:s0 + n] = new


def _block_forward(spec: _Spec, acc, lse_run, q, seg, k_t, v_t, seg_t,
                   my_idx, kv_idx):
    S = q.shape[1]
    if spec.positional:
        q_pos = _shard_positions(my_idx, S, spec.cp, spec.layout, q.device)
        kv_pos = _shard_positions(kv_idx, S, spec.cp, spec.layout, q.device)
        out_b, lse_b = _pos_fwd(q, k_t, v_t, q_pos, kv_pos, seg, seg_t,
                                spec.causal, spec.scale, spec.cap,
                                spec.window)
        _merge(acc, lse_run, out_b, lse_b, (0, S))
        return
    for (qs, ql), (ks, kl), pc in _pairs(my_idx, kv_idx, S, spec.cp,
                                        spec.layout, spec.causal):
        out_b, lse_b = _k9_fwd(
            _rows(q, qs, ql), _rows(k_t, ks, kl), _rows(v_t, ks, kl), pc,
            _rows(seg, qs, ql), _rows(seg_t, ks, kl), spec.scale, spec.impl)
        _merge(acc, lse_run, out_b, lse_b, (qs, ql))


def _block_backward(spec: _Spec, dq, dk_t, dv_t, q, seg, k_t, v_t, seg_t,
                    out, lse, dout, my_idx, kv_idx):
    """Add one block's gradients into ``dq`` (this rank's rows) and
    ``dk_t`` / ``dv_t`` (the block's keys), fp32."""
    S = q.shape[1]
    if spec.positional:
        q_pos = _shard_positions(my_idx, S, spec.cp, spec.layout, q.device)
        kv_pos = _shard_positions(kv_idx, S, spec.cp, spec.layout, q.device)
        a, b, c = _pos_bwd(q, k_t, v_t, out, lse, dout, q_pos, kv_pos, seg,
                           seg_t, spec.causal, spec.scale, spec.cap,
                           spec.window)
        dq.add_(a)
        dk_t.add_(b)
        dv_t.add_(c)
        return
    for (qs, ql), (ks, kl), pc in _pairs(my_idx, kv_idx, S, spec.cp,
                                        spec.layout, spec.causal):
        a, b, c = _k9_bwd(
            _rows(q, qs, ql), _rows(k_t, ks, kl), _rows(v_t, ks, kl),
            _rows(out, qs, ql), lse[..., qs:qs + ql].contiguous(),
            _rows(dout, qs, ql), pc, _rows(seg, qs, ql),
            _rows(seg_t, ks, kl), spec.scale, spec.impl)
        dq[:, qs:qs + ql].add_(a.float())
        dk_t[:, ks:ks + kl].add_(b.float())
        dv_t[:, ks:ks + kl].add_(c.float())


def _init_state(q):
    B, S, Hq, D = q.shape
    acc = torch.zeros(B, S, Hq, D, dtype=torch.float32, device=q.device)
    lse = torch.full((B, Hq, S), float("-inf"), dtype=torch.float32,
                     device=q.device)
    return acc, lse


def _finish(q, acc, lse):
    """The output in q's dtype and the merged lse as the backward reads
    it: 0 for a row with no key anywhere (its gradient is 0)."""
    out = acc.to(q.dtype).contiguous()
    return out, torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)


def _resolve(q, k, causal, scale, cap, window, impl, layout, cp):
    impl = impl or ("kernel" if q.is_cuda else "plain")
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    if (cap is not None or window is not None) and q.is_cuda:
        raise NotImplementedError(
            "ring attention with a sliding window or a logit soft cap runs "
            "on CPU tensors only; the CUDA blocks take causal or full "
            f"attention with segment ids: it comes with {_RING_CAP_WINDOW}")
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown cp layout {layout!r}")
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return _Spec(cp, layout, causal, scale, cap, window, impl)


def ring_rank_forward(q, segment_ids, blocks: Sequence[Tuple], my_idx: int,
                      cp: int, *, layout: str = "zigzag", causal=True,
                      scale=None, logits_soft_cap=None,
                      local_window_size=None, impl=None):
    """One rank's forward over ``blocks`` (``[(k, v, seg)]`` in arrival
    order: step ``t`` holds shard ``(my_idx - t) % cp``'s) -> ``(out,
    lse)``, the lse as :func:`ring_rank_backward` reads it."""
    spec = _resolve(q, blocks[0][0], causal, scale, logits_soft_cap,
                    local_window_size, impl, layout, cp)
    acc, lse = _init_state(q)
    for t, (k_t, v_t, seg_t) in enumerate(blocks):
        _block_forward(spec, acc, lse, q, segment_ids, k_t, v_t, seg_t,
                       my_idx, (my_idx - t) % cp)
    return _finish(q, acc, lse)


def ring_rank_backward(q, segment_ids, blocks: Sequence[Tuple], out, lse,
                       dout, my_idx: int, cp: int, *, layout="zigzag",
                       causal=True, scale=None, logits_soft_cap=None,
                       local_window_size=None, impl=None):
    """One rank's backward -> ``(dq fp32, [(kv shard, dk fp32, dv
    fp32)])``: the keys' gradients per arriving block, which the ring
    carries home."""
    spec = _resolve(q, blocks[0][0], causal, scale, logits_soft_cap,
                    local_window_size, impl, layout, cp)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkv = []
    for t, (k_t, v_t, seg_t) in enumerate(blocks):
        kv_idx = (my_idx - t) % cp
        dk = torch.zeros(k_t.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        _block_backward(spec, dq, dk, dv, q, segment_ids, k_t, v_t, seg_t,
                        out, lse, dout.contiguous(), my_idx, kv_idx)
        dkv.append((kv_idx, dk, dv))
    return dq, dkv


# ---------------------------------------------------------------------------
# the ring over a process group
# ---------------------------------------------------------------------------
class _Ring:
    """The cp group's neighbours and the block transfer."""

    def __init__(self, group):
        self.group = group
        ranks = dist.get_process_group_ranks(group)
        self.cp = len(ranks)
        self.idx = dist.get_rank(group)
        self.nxt = ranks[(self.idx + 1) % self.cp]
        self.prv = ranks[(self.idx - 1) % self.cp]
        self.nccl = dist.get_backend(group) == "nccl"

    def rotate(self, tensors):
        """Post the transfer of ``tensors`` to the next rank and of the
        previous rank's to new buffers -> ``(requests, buffers)``."""
        tensors = [t.contiguous() for t in tensors]
        bufs = [torch.empty_like(t) for t in tensors]
        if self.nccl:
            ops = []
            for t, b in zip(tensors, bufs):
                ops.append(dist.P2POp(dist.isend, t, self.nxt, self.group))
                ops.append(dist.P2POp(dist.irecv, b, self.prv, self.group))
            return dist.batch_isend_irecv(ops), bufs
        reqs = []
        for t, b in zip(tensors, bufs):
            reqs.append(dist.isend(t, self.nxt, group=self.group))
            reqs.append(dist.irecv(b, self.prv, group=self.group))
        return reqs, bufs

    @staticmethod
    def wait(reqs):
        for r in reqs:
            r.wait()


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg, ring: _Ring, spec: _Spec):
        acc, lse = _init_state(q)
        blk = [k, v] + ([seg] if seg is not None else [])
        for t in range(ring.cp):
            pending = ring.rotate(blk) if t < ring.cp - 1 else None
            k_t, v_t = blk[0], blk[1]
            seg_t = blk[2] if seg is not None else None
            _block_forward(spec, acc, lse, q, seg, k_t, v_t, seg_t,
                           ring.idx, (ring.idx - t) % ring.cp)
            if pending is not None:
                ring.wait(pending[0])
                blk = pending[1]
        out, lse = _finish(q, acc, lse)
        ctx.save_for_backward(q, k, v, out, lse,
                              *([seg] if seg is not None else []))
        ctx.ring, ctx.spec, ctx.has_seg = ring, spec, seg is not None
        return out

    @staticmethod
    def backward(ctx, dout):
        ring, spec = ctx.ring, ctx.spec
        q, k, v, out, lse, *rest = ctx.saved_tensors
        seg = rest[0] if ctx.has_seg else None
        dout = dout.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_t = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv_t = torch.zeros_like(dk_t)
        blk = [k, v] + ([seg] if seg is not None else [])
        for t in range(ring.cp):
            pending = ring.rotate(blk) if t < ring.cp - 1 else None
            k_t, v_t = blk[0], blk[1]
            seg_t = blk[2] if seg is not None else None
            _block_backward(spec, dq, dk_t, dv_t, q, seg, k_t, v_t, seg_t,
                            out, lse, dout, ring.idx,
                            (ring.idx - t) % ring.cp)
            # the keys' gradients travel with their block (home after cp
            # steps)
            if ring.cp > 1:
                reqs, (dk_t, dv_t) = ring.rotate([dk_t, dv_t])
                ring.wait(reqs)
            if pending is not None:
                ring.wait(pending[0])
                blk = pending[1]
        return (dq.to(q.dtype), dk_t.to(k.dtype), dv_t.to(v.dtype), None,
                None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group, causal: bool = True,
                   segment_ids: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None,
                   local_window_size: Optional[int] = None,
                   logits_soft_cap: Optional[float] = None,
                   layout: str = "contiguous",
                   impl: Optional[str] = None) -> torch.Tensor:
    """Differentiable ring attention of this rank's ``q [B, S_local, Hq,
    D]`` over the cp ``group``'s ``k`` / ``v [B, S_local, Hk, D]``
    (``segment_ids [B, S_local]``, 0 = padding), the rows in ``layout``
    order (the batch was permuted on the host, ``ops/zigzag.py``)."""
    ring = _Ring(group)
    spec = _resolve(q, k, causal, scale, logits_soft_cap, local_window_size,
                    impl, layout, ring.cp)
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32).contiguous()
    return _RingAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), segment_ids, ring, spec)


def sharded_ring_attention(q, k, v, mesh_manager, *, causal=True,
                           segment_ids=None, scale=None,
                           local_window_size=None, logits_soft_cap=None,
                           layout: str = "contiguous", impl=None):
    """:func:`ring_attention` over the manager's ``cp`` group; the tensors
    are this rank's shards (batch rows of its data coordinate, heads of
    its tp coordinate, the sequence slice of its cp coordinate)."""
    return ring_attention(
        q, k, v, group=mesh_manager.group(("cp",)), causal=causal,
        segment_ids=segment_ids, scale=scale,
        local_window_size=local_window_size,
        logits_soft_cap=logits_soft_cap, layout=layout, impl=impl)
