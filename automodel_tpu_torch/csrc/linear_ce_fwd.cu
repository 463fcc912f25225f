// Fused linear cross-entropy, forward, for Hopper (sm_90a); plain C
// interface for ctypes.
//
// Replaces the TPU kernel automodel_tpu/ops/linear_ce_kernel.py:132
// (_fwd_kernel, called by _fwd_pallas at :180): per row of h [T, H] bf16,
//   lse  = logsumexp_v (h W)[row, v]      (fp32)
//   pick = (h W)[row, label]              (fp32; 0 for a label outside [0, V))
// with W the LM head, read in the port's storage: w [V, H] row-major (the
// [H, V] head is its transposed view, K-contiguous for h W^T), so no copy
// of the 525 MB head is ever made.  The [T, V] logits never exist: each
// 128 x 256 logits tile lives in registers only.
//
// Bound: 2 T H V operations on the bf16 tensor cores (8.6 TFLOP at T 16384,
// H 2048, V 128256: 8.7 ms at 989 TFLOP/s); bytes (h, W once) are far
// below that.
//
// Design.  The TPU kernel walks the vocabulary as a sequential grid axis
// with (max, sumexp, pick) in scratch.  Here the logits tiles are products
// on wgmma_gemm.cuh's mainloop (TMA ring, a producer warp, two wgmma
// consumer warpgroups, persistent CTAs), Cfg<bf16, bf16, K-major, K-major,
// 256> as dlogits (linear_ce_bwd.cu): A = h [T][H], B = w [V][H], 128 x 256
// tiles over the whole of K = H, the V tail and the ragged T zero-filled by
// TMA.  Two launches:
//   * lce_fwd_partial: each CTA walks runs of vocab tiles, a run being a
//     contiguous range of vocab tiles (one of `splits` ranges of the
//     vocabulary) of one row tile.  The epilogue folds each tile's sums
//     into per-thread running (max, sumexp, pick) of the thread's two rows
//     (the wgmma fragment gives a lane quad all 256 columns of its rows, so
//     a tile needs no shared memory), kept in registers from one item of
//     the run to the next; at the run's end the quad combines by shuffles
//     and writes fp32 partials [split][T];
//   * lce_fwd_combine: per row, lse = M + log sum_i s_i e^{m_i - M} over
//     the splits in order, pick = sum_i pick_i (no atomics: the result does
//     not depend on timing).
// The plan (ops/linear_ce_kernel.py::linear_ce_fwd_plan mirrors it): row
// tiles go in groups of R (at most kRowTilesMax: 32 tiles of h are 16 MB at
// H 2048, well inside the 50 MB L2), each split into Q runs, R Q <= SMs
// CTAs: CTA c takes row r = c % R and split q = c / R of every group, so
// the CTAs resident at one time walk Q runs of W tiles in step, each W
// tile read from device memory once a group and shared by the R CTAs of
// its split, while the group's R tiles of h stay in L2 (a run that kept
// one row tile across the whole vocabulary would reread h from device
// memory for every vocab tile, about 32 GB).  (R, Q): the largest R whose
// run length times groups is within an eighth of the least (fewer passes
// over W for a few idle items): at T 16384, V 128256 on 132 SMs, R 32 and
// Q 4 over 4 groups, runs of 125 or 126 tiles.  The mainloop's round-robin
// item i is item k = i / G of CTA c = i % G (G = R Q): group k / L,
// position k % L of its run (L the longest run; a shorter run's last
// position and the row tiles past T of the last group are idle items, no
// loads).  Columns past V are masked to -inf (TMA fills them with 0) and
// the running max starts at the finite -1e30, so m_prev - m_new is never
// inf - inf; a label on a masked column, or outside [0, V), picks nothing.
// Exponentials are ex2 of an FFMA with a log2 e prescale, as dlogits'.

#include "wgmma_gemm.cuh"

namespace lce {
namespace {

using FwdCfg = wg::Cfg<wg::kBF16, wg::kBF16, false, false, 256, false>;
constexpr int kBN = FwdCfg::BN;
constexpr float kNegInit = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRowTilesMax = 32;

// epilogue: the whole of it, or none (timing the product alone; no
// partials, no combine)
enum FwdEpi { kEpiFull = 0, kEpiNone = 1 };

struct Plan {
  int R, Q, L, groups;
};

Plan fwd_plan(int T, int V, int sms) {
  const int n_m = (T + wg::kBM - 1) / wg::kBM;
  const int n_v = (V + kBN - 1) / kBN;
  const int r_max = min(min(n_m, kRowTilesMax), max(sms, 1));
  auto plan = [&](int R) {
    const int Q = min(n_v, max(1, sms / R));
    return Plan{R, Q, (n_v + Q - 1) / Q, (n_m + R - 1) / R};
  };
  long long least = -1;
  for (int R = 1; R <= r_max; ++R) {
    const Plan p = plan(R);
    const long long cost = (long long)p.L * p.groups;
    if (least < 0 || cost < least) least = cost;
  }
  for (int R = r_max; R > 1; --R) {
    const Plan p = plan(R);
    if (8LL * p.L * p.groups <= 9 * least) return p;
  }
  return plan(1);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Fold the sums of one row of a tile (registers i with (i / 2) % 2 = r:
// 64 of its 256 columns) into the row's running (m, s, pk); TAIL: columns
// at or past V count as -inf.  Four partial maxima and sums keep the
// dependency chains short.
template <bool TAIL>
__device__ __forceinline__ void fold(const float (&acc)[kBN / 2], int r,
                                     int n0, int V, int lab, float& m,
                                     float& s, float& pk) {
  auto x = [&](int i) {
    return TAIL && n0 + wg::acc_col(i) >= V ? -INFINITY : acc[i];
  };
  float mx[4] = {kNegInit, kNegInit, kNegInit, kNegInit};
#pragma unroll
  for (int i = 2 * r; i < kBN / 2; i += 4)
    mx[(i >> 2) & 3] = fmaxf(mx[(i >> 2) & 3], fmaxf(x(i), x(i + 1)));
  const float m_new = fmaxf(fmaxf(m, fmaxf(mx[0], mx[1])),
                            fmaxf(mx[2], mx[3]));
  const float mb = m_new * kLog2e;
  float sum[4] = {s * ex2(fmaf(m, kLog2e, -mb)), 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 2 * r; i < kBN / 2; i += 4)
    sum[(i >> 2) & 3] += ex2(fmaf(x(i), kLog2e, -mb)) +
                         ex2(fmaf(x(i + 1), kLog2e, -mb));
  s = (sum[0] + sum[1]) + (sum[2] + sum[3]);
  m = m_new;
  if (static_cast<unsigned>(lab - n0) < static_cast<unsigned>(kBN)) {
#pragma unroll
    for (int i = 2 * r; i < kBN / 2; i += 4) {
      const int col = n0 + wg::acc_col(i);
      if (col == lab) pk += acc[i];
      if (col + 1 == lab) pk += acc[i + 1];
    }
  }
}

struct FwdArgs {
  const int* labels;
  float *part_m, *part_s, *part_p;
  int T, V, kt, n_m, n_v, R, Q, L, groups, epi;
};

__global__ void __launch_bounds__(wg::kThreads, 1)
lce_fwd_partial(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb, const FwdArgs p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int G = gridDim.x;
  // CTA c's item k: group k / L, run (row c % R, split c / R), position
  // k % L; part = the split
  auto tile = [&](int i) {
    const int c = i % G, k = i / G;
    const int q = c / p.R, j = k % p.L;
    const int tm = (k / p.L) * p.R + c % p.R;
    const int v = q * p.n_v / p.Q + j;
    wg::Tile t;
    t.m0 = tm * wg::kBM;
    t.n0 = v * kBN;
    t.kt0 = 0;
    t.part = q;
    t.nk = tm < p.n_m && v < (q + 1) * p.n_v / p.Q ? p.kt : 0;
    return t;
  };
  // the running (max, sumexp, pick) of this thread's two rows (registers
  // i with (i / 2) % 2 = 0, 1) over the run so far, and their labels (-1
  // outside [0, V)); k counts this CTA's items
  float m[2], s[2], pk[2];
  int lab[2];
  int k = 0;
  auto pre = [&](int w, const wg::Tile& t) {
    if (k % p.L) return;                 // inside a run
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = t.m0 + wg::acc_row(w, 2 * r);
      const int l = row < p.T ? p.labels[row] : -1;
      lab[r] = l >= 0 && l < p.V ? l : -1;
      m[r] = kNegInit;
      s[r] = 0.f;
      pk[r] = 0.f;
    }
  };
  auto epi = [&](int w, const wg::Tile& t, float (&acc)[kBN / 2]) {
    const bool last = k % p.L == p.L - 1;
    ++k;
    if (p.epi == kEpiNone) {             // timing: the product alone
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) x += acc[i];
      if (x == 0x1p127f) p.part_m[0] = x;          // never taken
      return;
    }
    if (t.nk > 0) {
      const bool tail = t.n0 + kBN > p.V;      // mask the columns past V
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (tail) fold<true>(acc, r, t.n0, p.V, lab[r], m[r], s[r], pk[r]);
        else fold<false>(acc, r, t.n0, p.V, lab[r], m[r], s[r], pk[r]);
      }
    }
    if (!last) return;
    // the run's end: combine the 4 lanes of each quad (same rows, other
    // columns), then lane 0 of the quad writes the rows' partials
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
        const float so = __shfl_xor_sync(0xffffffffu, s[r], off);
        const float po = __shfl_xor_sync(0xffffffffu, pk[r], off);
        const float mn = fmaxf(m[r], mo);
        s[r] = s[r] * ex2((m[r] - mn) * kLog2e) + so * ex2((mo - mn) * kLog2e);
        m[r] = mn;
        pk[r] += po;
      }
      const int row = t.m0 + wg::acc_row(w, 2 * r);
      if ((threadIdx.x & 3) == 0 && row < p.T) {
        const size_t o = (size_t)t.part * p.T + row;
        p.part_m[o] = m[r];
        p.part_s[o] = s[r];
        p.part_p[o] = pk[r];
      }
    }
  };
  wg::mainloop<FwdCfg>(smem, &ta, &tb, G * p.groups * p.L, tile, epi, pre);
}

__global__ void lce_fwd_combine(const float* __restrict__ part_m,
                                const float* __restrict__ part_s,
                                const float* __restrict__ part_p,
                                float* __restrict__ lse,
                                float* __restrict__ pick, int T, int nsplit) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= T) return;
  float mm = kNegInit;
  for (int i = 0; i < nsplit; ++i) mm = fmaxf(mm, part_m[(size_t)i * T + row]);
  float ss = 0.f, pp = 0.f;
  for (int i = 0; i < nsplit; ++i) {
    const size_t o = (size_t)i * T + row;
    ss += part_s[o] * __expf(part_m[o] - mm);
    pp += part_p[o];
  }
  lse[row] = mm + logf(ss);
  pick[row] = pp;
}

}  // namespace
}  // namespace lce

// The number of vocab splits the forward uses for (T, V) on this device
// (ops/linear_ce_kernel.py::linear_ce_fwd_plan gives the same); the caller
// allocates 3 fp32 scratch arrays of nsplit * T.
extern "C" int linear_ce_fwd_splits(int T, int V) {
  return lce::fwd_plan(T, V, lce::num_sms()).Q;
}

// h [T, H] bf16 row-major; w [V, H] bf16 row-major; labels [T] int32;
// scratch: 3 fp32 arrays of nsplit * T (nsplit from linear_ce_fwd_splits);
// lse, pick [T] fp32.  epi (FwdEpi): 0 the kernel; 1 times the product
// alone and writes neither partials nor lse / pick.  h and w 16-byte
// aligned (TMA).  Returns 0, -1 for a shape the kernel does not take or an
// nsplit that is not the plan's, a tensor-map error
// (wgmma_gemm.cuh::make_map), else the cudaError_t of a launch.
extern "C" int linear_ce_fwd(const void* h, const void* w, const int* labels,
                             float* part_m, float* part_s, float* part_p,
                             int nsplit, float* lse, float* pick, int T,
                             int H, int V, int epi, void* stream) {
  using namespace lce;
  if (T <= 0 || V <= 0 || H <= 0 || H % 8 != 0 || epi < kEpiFull ||
      epi > kEpiNone)
    return -1;
  const Plan pl = fwd_plan(T, V, num_sms());
  if (nsplit != pl.Q) return -1;
  CUtensorMap ta, tb;
  int rc = wg::operand_map<FwdCfg, true>(&ta, h, T, H, H);
  if (rc) return rc;
  rc = wg::operand_map<FwdCfg, false>(&tb, w, V, H, H);
  if (rc) return rc;
  rc = wg::prepare<FwdCfg>(lce_fwd_partial);
  if (rc) return rc;
  const FwdArgs p{labels, part_m, part_s, part_p, T, V,
                  (H + FwdCfg::BK - 1) / FwdCfg::BK,
                  (T + wg::kBM - 1) / wg::kBM, (V + kBN - 1) / kBN,
                  pl.R, pl.Q, pl.L, pl.groups, epi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lce_fwd_partial<<<pl.R * pl.Q, wg::kThreads, FwdCfg::kSmemBytes, st>>>(
      ta, tb, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || epi == kEpiNone) return static_cast<int>(err);
  lce_fwd_combine<<<(T + 255) / 256, 256, 0, st>>>(part_m, part_s, part_p,
                                                   lse, pick, T, nsplit);
  return static_cast<int>(cudaGetLastError());
}
