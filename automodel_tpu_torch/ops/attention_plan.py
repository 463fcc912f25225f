"""The tile plan of the attention kernels (``csrc/attn_core.cuh``, under
both rungs: ``ops/splash_attention.py`` and ``ops/flash_attention.py``),
mirrored in Python for the CPU tests, and the workspace the wrappers hand
the kernels.

The kernels cut the (query, key) plane into tiles and classify each once,
from causality, the trailing window, the ragged edge at ``S`` and the
segment ids of 64-row tiles (:func:`tile_metas`):

* ``SKIP``: no pair of the tile can attend; the tile is never loaded;
* ``FULL``: every pair attends; no per-element mask;
* ``PARTIAL``: the mask is applied per element (:func:`allowed`).

Tiles and work items per pass (:data:`PASSES`; :func:`tiles` by head_dim):

* ``fwd``: an item is a 128-row q tile of one (head, batch row), the last
  q tiles first; it visits 128-key tiles (64-key ones at head_dim 192)
  from the last one its rows may reach down to the first;
* ``dq``: the same items; 64-key tiles;
* ``dkv``: an item is a 128-key tile of one (kv head, batch row), the first
  key tiles first; it visits, for each query head of the group, the 64-row
  q tiles that may see its keys, in order.  At head_dim 192 the pass runs
  twice over the same items and tiles, summing dV in the first and dK in
  the second: the two accumulators do not fit one thread's registers
  together.

The segment rule is splash's (segment 0 never attends and is never
attended) or, with ``seg_eq``, the flash rung's equality (segment 0 attends
segment 0).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

TILE = 64                      # rows of a segment meta
SKIP, PARTIAL, FULL = 0, 1, 2
INT_MAX = 2 ** 31 - 1

# pass -> (q rows, keys) of a tile, head_dim 64 and 128
PASSES = {"fwd": (128, 128), "dq": (128, 64), "dkv": (64, 128)}
# head_dim 192 (MLA): the forward's K + V stage of 128 keys would not fit
# three times beside the Q tile in shared memory
PASSES_D192 = {"fwd": (128, 64), "dq": (128, 64), "dkv": (64, 128)}


def tiles(kind: str, head_dim: int = 64) -> Tuple[int, int]:
    """``(q rows, keys)`` of a tile of pass ``kind`` at ``head_dim``."""
    return (PASSES_D192 if head_dim == 192 else PASSES)[kind]


class Meta(NamedTuple):
    """The ids of a span of rows under the rule: the lowest and highest
    that can attend (``lo > hi`` when none) and whether every row lies
    inside ``S`` and holds that one id."""
    lo: int
    hi: int
    uni: bool


def tile_metas(seg: Sequence[int], S: int, seg_eq: bool) -> List[Meta]:
    """The metas of the 64-row tiles of one batch row, as ``tile_meta``
    computes them."""
    metas = []
    for t in range(-(-S // TILE)):
        lo, hi, clean = INT_MAX, -1, True
        for row in range(t * TILE, t * TILE + TILE):
            s = int(seg[row]) if row < S else -1
            if s < 0 or (not seg_eq and s == 0):
                clean = False
                continue
            lo, hi = min(lo, s), max(hi, s)
        metas.append(Meta(lo, hi, clean and lo == hi))
    return metas


def merged(metas: Sequence[Meta], t0: int, n: int) -> Meta:
    """The meta of tiles ``t0 .. t0 + n - 1`` (those past the end hold no
    id and spoil uniformity)."""
    lo, hi, uni = INT_MAX, -1, True
    for t in range(t0, t0 + n):
        if t >= len(metas):
            uni = False
            continue
        lo, hi, uni = min(lo, metas[t].lo), max(hi, metas[t].hi), \
            uni and metas[t].uni
    return Meta(lo, hi, uni and lo == hi)


def classify(q0: int, bm: int, k0: int, bn: int, S: int, causal: bool,
             window: int, qm: Optional[Meta], km: Optional[Meta]) -> int:
    """The class of q rows ``[q0, q0 + bm)`` against keys ``[k0, k0 +
    bn)``; ``qm`` / ``km`` None without segments; ``window`` 0 is none."""
    if q0 >= S or k0 >= S:
        return SKIP
    q1, k1 = min(q0 + bm, S), min(k0 + bn, S)
    if causal and k0 > q1 - 1:
        return SKIP
    if window > 0 and q0 - (k1 - 1) >= window:
        return SKIP
    seg = qm is not None
    if seg and (qm.hi < km.lo or km.hi < qm.lo):
        return SKIP
    full = (q0 + bm <= S and k0 + bn <= S
            and (not causal or k0 + bn - 1 <= q0)
            and (window <= 0 or q0 + bm - 1 - k0 < window)
            and (not seg or (qm.uni and km.uni and qm.lo == km.lo)))
    return FULL if full else PARTIAL


def allowed(qi: int, kj: int, S: int, causal: bool, window: int, sq: int,
            sk: int, seg_eq: bool) -> bool:
    """May query ``qi`` attend key ``kj``?  (``sq == sk == 1`` without
    segments.)"""
    return (qi < S and kj < S and (not causal or kj <= qi)
            and (window <= 0 or qi - kj < window) and sq == sk
            and (seg_eq or sk != 0))


def kv_range(q0: int, bm: int, bn: int, S: int, causal: bool,
             window: int) -> Tuple[int, int]:
    """The kv tiles ``[lo, hi]`` q rows ``[q0, q0 + bm)`` may reach."""
    hi = (min(q0 + bm, S) - 1) // bn if causal else (S - 1) // bn
    lo = max(0, q0 - window + 1) // bn if window > 0 else 0
    return lo, hi


def q_range(k0: int, bn: int, bm: int, S: int, causal: bool,
            window: int) -> Tuple[int, int]:
    """The q tiles ``[lo, hi]`` that may see keys ``[k0, k0 + bn)``."""
    lo = k0 // bm if causal else 0
    hi = (S - 1) // bm
    if window > 0:
        hi = min(hi, (min(k0 + bn, S) - 1 + window - 1) // bm)
    return lo, hi


def items(kind: str, B: int, S: int, Hq: int, Hk: int, head_dim: int = 64
          ) -> List[Tuple[int, int, int]]:
    """The work items of pass ``kind`` in the kernel's order: ``(b, head,
    first row)`` (q head and q row for ``fwd`` / ``dq``, kv head and key
    for ``dkv``); CTA ``c`` takes items ``c, c + grid, ...``."""
    bm, bn = tiles(kind, head_dim)
    if kind == "dkv":
        n = -(-S // bn)
        return [(bh // Hk, bh % Hk, r * bn) for r in range(n)
                for bh in range(B * Hk)]
    n = -(-S // bm)
    return [(bh // Hq, bh % Hq, (n - 1 - r) * bm) for r in range(n)
            for bh in range(B * Hq)]


def visits(kind: str, S: int, causal: bool, window: int,
           seg: Optional[Sequence[int]], seg_eq: bool, first: int,
           groups: int = 1, head_dim: int = 64
           ) -> List[Tuple[int, int, int]]:
    """The tiles an item of pass ``kind`` starting at row ``first`` visits,
    in the kernel's order: ``(q0, k0, class)`` of every tile in its range,
    skipped ones included (the kernel loads and multiplies the others).
    ``dkv`` walks its q tiles once per query head of the group
    (``groups``); ``seg`` is the batch row's segment ids or None."""
    bm, bn = tiles(kind, head_dim)
    metas = None if seg is None else tile_metas(seg, S, seg_eq)

    def meta(row, rows):
        return None if metas is None else merged(metas, row // TILE,
                                                 rows // TILE)

    out = []
    if kind == "dkv":
        km = meta(first, bn)
        lo, hi = q_range(first, bn, bm, S, causal, window)
        for _ in range(groups):
            for qt in range(lo, hi + 1):
                q0 = qt * bm
                out.append((q0, first, classify(q0, bm, first, bn, S, causal,
                                                 window, meta(q0, bm), km)))
        return out
    qm = meta(first, bm)
    lo, hi = kv_range(first, bm, bn, S, causal, window)
    for j in range(hi, lo - 1, -1):
        k0 = j * bn
        out.append((first, k0, classify(first, bm, k0, bn, S, causal, window,
                                        qm, meta(k0, bn))))
    return out


def tile_meta_workspace(segment_ids: Optional[torch.Tensor], B: int,
                        S: int) -> Optional[torch.Tensor]:
    """The int32 scratch ``[B, ceil(S / 64), 4]`` the kernels' ``tile_meta``
    launch fills from the segment ids (None without segments)."""
    if segment_ids is None:
        return None
    return torch.empty(B, -(-S // TILE), 4, dtype=torch.int32,
                       device=segment_ids.device)
