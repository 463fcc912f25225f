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
// Design.  The TPU kernel walks the vocabulary as a sequential grid axis
// with (max, sumexp, pick) in scratch; Hopper CTAs run in no order, and 128
// row tiles (T 16384) are fewer than the work needs, so the vocabulary is
// also split across CTAs:
//   * launch 1: one CTA per (128-row tile, vocab split); it walks the
//     256-column vocab tiles of its split, computes each logits tile with
//     the shared tile product (linear_ce_gemm.cuh) and folds it into
//     per-thread online (max, sumexp, pick) for its 8 rows; at the end the
//     4 lanes of a quad and the 4 column warps combine through shuffles and
//     shared memory and the CTA writes fp32 partials [split][T];
//   * launch 2: per row, lse = M + log sum_i s_i e^{m_i - M} over the
//     splits and pick = sum_i pick_i.
// Grid order: row tiles vary fastest inside groups of 32 row tiles, so the
// CTAs resident at one time are ~32 row tiles x ~4 splits: they walk the
// same W tiles together (read from HBM once, then from L2) and their h rows
// stay in L2.  Vocab columns past V are masked in the kernel (finite -1e30
// start for the running max, so m_prev - m_new is never inf - inf); a label
// on a masked column picks nothing.
//
// Bound: 2 T H V operations on the bf16 tensor cores (8.6 TFLOP at T 16384,
// H 2048, V 128256: 8.7 ms at 989 TFLOP/s); bytes (h, W once) are far
// below that.  What the simple design leaves: mma.sync instead of wgmma,
// cp.async instead of TMA, no warp specialisation, no persistent schedule.

#include "linear_ce_gemm.cuh"

namespace lce {
namespace {

constexpr float kNegInit = -1e30f;
constexpr int kRowGroup = 32;

__global__ void __launch_bounds__(kThreads, 1)
lce_fwd_partial(const bf16* __restrict__ h, const bf16* __restrict__ w,
                const int* __restrict__ labels, float* __restrict__ part_m,
                float* __restrict__ part_s, float* __restrict__ part_p, int T,
                int H, int V, int n_m, int nsplit, int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ float red_m[4][kBM], red_s[4][kBM], red_p[4][kBM];

  int tm, split;
  grouped_tile(blockIdx.x, n_m, nsplit, kRowGroup, &tm, &split);
  const int m0 = tm * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  const int n_vt = (V + kBN - 1) / kBN;
  const int vt_lo = split * tiles_per_split;
  const int vt_hi = min(n_vt, vt_lo + tiles_per_split);

  // this thread's 8 rows: r = i * 2 + hh -> m0 + wm*64 + i*16 + g + hh*8
  int lab[8];
  float m[8], s[8], p[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = m0 + wm * 64 + (r >> 1) * 16 + g + (r & 1) * 8;
    lab[r] = row < T ? labels[row] : -1;
    m[r] = kNegInit;
    s[r] = 0.f;
    p[r] = 0.f;
  }

  const Operand A{h, H, T, H};
  const Operand B{w, H, V, H};
  float acc[4][kNT][4];
  for (int vt = vt_lo; vt < vt_hi; ++vt) {
    const int n0 = vt * kBN;
    zero_acc(acc);
    gemm_tile<true, true>(acc, A, B, m0, n0, H, smem);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = r >> 1, e0 = (r & 1) * 2;
      float mx = kNegInit;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * kWN + j * 8 + 2 * t + e;
          const float x = acc[i][j][e0 + e];
          if (col < V) {
            mx = fmaxf(mx, x);
            if (col == lab[r]) p[r] += x;
          }
        }
      const float m_new = fmaxf(m[r], mx);
      float sum = s[r] * __expf(m[r] - m_new);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * kWN + j * 8 + 2 * t + e;
          if (col < V) sum += __expf(acc[i][j][e0 + e] - m_new);
        }
      s[r] = sum;
      m[r] = m_new;
    }
  }

  // combine the 4 lanes of a quad (same rows, other columns)
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float so = __shfl_xor_sync(0xffffffffu, s[r], off);
      const float po = __shfl_xor_sync(0xffffffffu, p[r], off);
      const float mn = fmaxf(m[r], mo);
      s[r] = s[r] * __expf(m[r] - mn) + so * __expf(mo - mn);
      m[r] = mn;
      p[r] += po;
    }
    if (t == 0) {
      const int lr = wm * 64 + (r >> 1) * 16 + g + (r & 1) * 8;
      red_m[wn][lr] = m[r];
      red_s[wn][lr] = s[r];
      red_p[wn][lr] = p[r];
    }
  }
  __syncthreads();
  // combine the 4 column warps, one thread per row
  if (tid < kBM && m0 + tid < T) {
    float mm = red_m[0][tid];
#pragma unroll
    for (int c = 1; c < 4; ++c) mm = fmaxf(mm, red_m[c][tid]);
    float ss = 0.f, pp = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      ss += red_s[c][tid] * __expf(red_m[c][tid] - mm);
      pp += red_p[c][tid];
    }
    const size_t o = (size_t)split * T + m0 + tid;
    part_m[o] = mm;
    part_s[o] = ss;
    part_p[o] = pp;
  }
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

// The number of vocab splits the forward uses for (T, V) on this device;
// the caller allocates 3 fp32 scratch arrays of nsplit * T.
extern "C" int linear_ce_fwd_splits(int T, int V) {
  using namespace lce;
  const int n_m = (T + kBM - 1) / kBM;
  const int n_vt = (V + kBN - 1) / kBN;
  int nsplit = (4 * num_sms() + n_m - 1) / n_m;
  nsplit = max(1, min(nsplit, n_vt));
  const int per = (n_vt + nsplit - 1) / nsplit;
  return (n_vt + per - 1) / per;          // no empty split
}

// h [T, H] bf16 row-major; w [V, H] bf16 row-major; labels [T] int32;
// scratch: 3 fp32 arrays of nsplit * T (nsplit from linear_ce_fwd_splits);
// lse, pick [T] fp32.  Returns 0, -1 for a shape the kernel does not take,
// else the cudaError_t of a launch.
extern "C" int linear_ce_fwd(const void* h, const void* w, const int* labels,
                             float* part_m, float* part_s, float* part_p,
                             int nsplit, float* lse, float* pick, int T,
                             int H, int V, void* stream) {
  using namespace lce;
  if (T <= 0 || V <= 0 || H <= 0 || H % 8 != 0 || nsplit < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      lce_fwd_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_m = (T + kBM - 1) / kBM;
  const int n_vt = (V + kBN - 1) / kBN;
  const int per = (n_vt + nsplit - 1) / nsplit;
  if ((long long)(nsplit - 1) * per >= n_vt) return -1;   // an empty split
  lce_fwd_partial<<<n_m * nsplit, kThreads, kSmemBytes, st>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w), labels,
      part_m, part_s, part_p, T, H, V, n_m, nsplit, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lce_fwd_combine<<<(T + 255) / 256, 256, 0, st>>>(part_m, part_s, part_p,
                                                   lse, pick, T, nsplit);
  return static_cast<int>(cudaGetLastError());
}
