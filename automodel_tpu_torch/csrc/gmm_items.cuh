// Work items and epilogue stores of the grouped forward products on
// wgmma_gemm.cuh's mainloop, shared by gmm.cu (the bf16 gmm and its dlhs)
// and gmm_quant.cu (the 8-bit gmm).
//
// The rows of lhs [m, K] are contiguous per-group segments: group g holds
// rows [ends[g-1], ends[g]) (ends the inclusive prefix sum of the group
// sizes, clipped to m, computed on the device).  Up to kMaxGroups groups
// every CTA copies the clipped ends into shared memory; past that they
// live in a global workspace [E] that one clip_ends launch fills before
// the product (the same values, so the same items in the same order).
// Items, n_n (n_m + E) of them for n_m 128-row and n_n BN-column tiles of
// out, fixed by shapes alone:
//   * primary (i < n_m n_n): row tile i / n_n, column tile i % n_n (the
//     column tiles of a row tile run together, so their CTAs share the lhs
//     rows, and a group's row tiles follow each other, so its weights stay
//     in L2), for the group holding the tile's first row (binary search of
//     ends); a tile past every group is an item of zeros (part E, nk 0);
//   * extra (i >= n_m n_n): group (i - n_m n_n) / n_n, column tile
//     (i - n_m n_n) % n_n, for the row tile where that group starts, active
//     only when it starts strictly inside a tile (idle, part -1, when it is
//     empty or starts on a tile boundary: no load, no store).
// Each item multiplies the whole 128-row tile of lhs by its group's
// weights (Tile::b_row = g * b_rows: the group's block of one tensor map
// over every group's weights) and stores only its group's rows [r_lo,
// r_hi): the other rows were multiplied by the wrong weights and are never
// written, so no operand load is masked and every row is written by
// exactly one item (deterministic).  Rows at or past ends[E-1] ([r_hi,
// z_hi)) are written 0 by the item of the last non-empty group in their
// tile, or by the primary item of a tile that starts past every group.
// ops/gmm_kernel.py::gmm_work_items mirrors the plan in Python.

#pragma once

#include "wgmma_gemm.cuh"

namespace gi {

using lce::bf16;
using lce::pack_bf16;

// at most this many groups keep their plan in shared memory; more keep it
// in a global workspace
constexpr int kMaxGroups = 1024;

// ends[g] = min(ends_in[g], m) for g < E, by every thread (the caller
// synchronises before reading: the mainloop's first __syncthreads does)
__device__ __forceinline__ void load_ends(int* ends, const int* ends_in,
                                         int E, int m) {
  for (int g = threadIdx.x; g < E; g += blockDim.x)
    ends[g] = min(__ldg(ends_in + g), m);
}

namespace {

// the global plan past kMaxGroups: ends[g] = min(ends_in[g], m)
__global__ void __launch_bounds__(256)
clip_ends(int* __restrict__ ends, const int* __restrict__ ends_in, int E,
          int m) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < E) ends[g] = min(ends_in[g], m);
}

}  // namespace

// The clipped ends an item reads: the CTA's shared copy `shared` (filled by
// load_ends) up to kMaxGroups groups, else the workspace `global` that
// launch_clip_ends filled.
__device__ __forceinline__ const int* plan_ends(int* shared,
                                                const int* ends_in,
                                                const int* global, int E,
                                                int m) {
  if (E > kMaxGroups) return global;
  load_ends(shared, ends_in, E, m);
  return shared;
}

// Fill the workspace `ws` [E] when E > kMaxGroups (nothing otherwise).
// Returns 0, -1 for a missing workspace, else the launch's cudaError_t.
inline int launch_clip_ends(int* ws, const int* ends_in, int E, int m,
                            cudaStream_t s) {
  if (E <= kMaxGroups) return 0;
  if (ws == nullptr) return -1;
  clip_ends<<<(E + 255) / 256, 256, 0, s>>>(ws, ends_in, E, m);
  return static_cast<int>(cudaGetLastError());
}

// first g with ends[g] > row (E when none): ends is non-decreasing
__device__ __forceinline__ int first_group_past(const int* ends, int E,
                                                int row) {
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid] > row) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

// Item i of the plan above for BN-column tiles and kt K tiles per product.
// part: the group, -1 idle, E a tile of zeros.
__device__ __forceinline__ wg::Tile fwd_item(int i, const int* ends, int E,
                                             int n_m, int n_n, int bn,
                                             int kt, int b_rows) {
  wg::Tile t;
  int g, tm, tn;
  const int primary = n_m * n_n;
  if (i < primary) {
    tm = i / n_n;
    tn = i % n_n;
    g = first_group_past(ends, E, tm * wg::kBM);       // E: past all
  } else {
    g = (i - primary) / n_n;
    tn = (i - primary) % n_n;
    const int lo = g ? ends[g - 1] : 0;
    tm = lo / wg::kBM;
    if (ends[g] <= lo || lo % wg::kBM == 0) g = -1;    // idle
  }
  t.m0 = tm * wg::kBM;
  t.n0 = tn * bn;
  t.kt0 = 0;
  t.part = g;
  t.nk = g >= 0 && g < E ? kt : 0;
  t.b_row = t.nk ? g * b_rows : 0;
  return t;
}

// The rows item t writes: [r_lo, r_hi) its sums, [r_hi, z_hi) zeros.
__device__ __forceinline__ void fwd_rows(const wg::Tile& t, const int* ends,
                                         int E, int m, int& r_lo, int& r_hi,
                                         int& z_hi) {
  const int g = t.part, m1 = min(t.m0 + wg::kBM, m);
  if (g < 0) {
    r_lo = r_hi = z_hi = t.m0;
  } else if (g >= E) {
    r_lo = r_hi = t.m0;
    z_hi = m1;
  } else {
    const int lo = g ? ends[g - 1] : 0, hi = ends[g];
    r_lo = max(lo, t.m0);
    r_hi = min(hi, m1);
    z_hi = hi == ends[E - 1] ? m1 : r_hi;
  }
}

// Zeros into rows [r0, r1) of consumer warpgroup w's 64-row half of the
// BN-column tile at (m0, n0) of `o` [.., ld] (columns < ncols), 16 bytes a
// store.
template <int BN, typename T>
__device__ __forceinline__ void store_zeros(T* o, long long ld, int ncols,
                                            int m0, int n0, int w, int r0,
                                            int r1) {
  constexpr int kVec = 16 / sizeof(T);
  const int lo = max(r0, m0 + 64 * w), hi = min(r1, m0 + 64 * w + 64);
  const int t = threadIdx.x & 127;
  for (int idx = t; idx < (hi - lo) * (BN / kVec); idx += 128) {
    const int row = lo + idx / (BN / kVec);
    const int col = n0 + kVec * (idx % (BN / kVec));
    if (col < ncols)                       // ncols % kVec == 0
      *reinterpret_cast<uint4*>(o + row * ld + col) = make_uint4(0, 0, 0, 0);
  }
}

// Thread t of a lane quad holds, for one accumulator row, the bf16 pairs
// at columns 8 (4 a + s) + 2 t of four column groups (v[s], s = 0..3);
// afterwards it holds the 8 columns of group 4 a + t in order.  Two
// butterfly steps of shuffles (a 4 x 4 transpose of 32-bit words).
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 1; b <= 2; b <<= 1) {
    const bool up = lane & b;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s & b) continue;
      const uint32_t y =
          __shfl_xor_sync(0xffffffffu, up ? v[s] : v[s | b], b);
      if (up) v[s] = y;
      else v[s | b] = y;
    }
  }
}

// Consumer warpgroup w's half of a 128 x BN tile of sums into `o` [..,
// ld] at (m0, n0) in bf16: rows [r_lo, r_hi) get the sums, [r_hi, z_hi)
// zeros, columns < ncols.  pair(i) gives accumulator registers i and i + 1
// as packed bf16 (the sums, or the caller's function of them).  Each
// thread stores 16 bytes (8 columns of one row) at a time, BN / 16 stores
// an item, after a quad transpose: a quarter of the store instructions
// that bf16 pairs straight from the fragment take.
template <int BN, class Pair>
__device__ __forceinline__ void store_tile(bf16* o, long long ld, int ncols,
                                           int m0, int n0, int w,
                                           Pair&& pair, int r_lo, int r_hi,
                                           int z_hi) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + wg::acc_row(w, 2 * h);
    const bool sums = row >= r_lo && row < r_hi;
    const bool keep = row >= r_lo && row < z_hi;
#pragma unroll
    for (int a = 0; a < BN / 32; ++a) {
      uint32_t v[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int i = 4 * (4 * a + s) + 2 * h;
        v[s] = sums ? pair(i) : 0u;
      }
      quad_transpose(v);
      const int col = n0 + 8 * (4 * a + t);
      if (keep && col < ncols)                 // ncols % 8 == 0
        *reinterpret_cast<uint4*>(o + row * ld + col) =
            make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

}  // namespace gi
