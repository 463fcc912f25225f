// Shared pieces of the flash-rung kernels (flash_mha_fwd.cu,
// flash_mha_bwd.cu): the upstream Pallas MHA flash kernel's mask rule and
// the segment set of a tile that decides which tiles hold live work.  The
// tensor-core fragments and the row-tile loader come from
// flash_attn_common.cuh.
//
// The mask: query row qi attends key kj iff seg_q == seg_k (and kj <= qi
// when causal).  Segment 0 (padding) attends segment 0: unlike the splash
// kernels' rule, padding is a segment like any other, so every row of
// self-attention attends at least itself.

#pragma once

#include <limits.h>

#include "flash_attn_common.cuh"

namespace flash {

__device__ __forceinline__ bool allowed_eq(int qi, int kj, int S, int causal,
                                           int has_seg, int seg_q,
                                           int seg_k) {
  return qi < S && kj < S && (!causal || kj <= qi) &&
         (!has_seg || seg_q == seg_k);
}

// The segment ids present in a tile of rows: the range of its nonzero ids
// and whether it holds padding.  A row of another tile can match one of
// them only if its id passes meets(); the test may pass ids the tile does
// not hold (a range, not a set), never the reverse, so a skipped tile is
// always dead.
struct SegSet {
  int lo, hi, has0;

  __device__ __forceinline__ bool meets(int s) const {
    return s == 0 ? has0 != 0 : (s >= lo && s <= hi);
  }
};

// Fill `set` (shared memory) from rows row0 .. row0 + rows - 1 of seg_b;
// called by every thread of the block (rows <= kThreads), ends in a
// barrier.
__device__ __forceinline__ void build_seg_set(SegSet* set, const int* seg_b,
                                              int row0, int rows, int S,
                                              int tid) {
  if (tid == 0) {
    set->lo = INT_MAX;
    set->hi = 0;
    set->has0 = 0;
  }
  __syncthreads();
  if (tid < rows && row0 + tid < S) {
    const int s = seg_b[row0 + tid];
    if (s == 0) {
      set->has0 = 1;
    } else {
      atomicMin(&set->lo, s);
      atomicMax(&set->hi, s);
    }
  }
  __syncthreads();
}

// Stage the segment ids of rows row0 .. row0 + rows - 1 in seg_s (-1 past
// S) and vote: does any of them meet `set`?  Called by every thread; the
// vote is a barrier.
__device__ __forceinline__ bool tile_is_live(int* seg_s, const SegSet& set,
                                             const int* seg_b, int row0,
                                             int rows, int S, int tid) {
  int s = -1;
  if (tid < rows) {
    s = row0 + tid < S ? seg_b[row0 + tid] : -1;
    seg_s[tid] = s;
  }
  return __syncthreads_or(tid < rows && s >= 0 && set.meets(s)) != 0;
}

}  // namespace flash
