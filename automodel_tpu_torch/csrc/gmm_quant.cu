// Quantized grouped matmul of the sorted mixture-of-experts path, for Hopper
// (sm_90a); plain C interface for ctypes.
//
// Replaces the TPU kernel automodel_tpu/ops/gmm_quant_kernel.py:182
// (_gmm_quant_pallas_impl: the Pallas body gmm_kernel.py:187 _gmm_kernel,
// run by _gmm_pallas at :206 with an int32 or fp32 accumulator and fp32
// out) together with the quant_cast of its operands and the _rescale
// (gmm_quant_kernel.py:94) that the JAX package runs around it in XLA.
// The rows of lhs [m, K] are contiguous per-group segments (segment g is
// rows [ends[g-1], ends[g]), ends the inclusive prefix sum of the group
// sizes), each multiplying its expert rhs[g] [K, N]:
//   out[r, :] = (raw[r, :] * s_lhs[r]) * s_rhs[g(r), :]
//   raw[rows of g] = quant(lhs[rows of g], s_lhs) @ quant(rhs[g], s_rhs[g])
// with gemm8.cuh's quant (ops/quant.py::quant_cast bit for bit); int8 x int8
// summed in int32 (exact), e4m3 / e5m2 in fp32.  s_rhs[g, j] at
// s_rhs + g * srhs_e + j * srhs_n (rowwise: per
// expert and column; tensorwise: per expert).  lhs and rhs are bf16; rhs[g]
// is read in place from the forward's experts [E, K, N] (N-major) or, for
// the backward's rhs^T, from the [E, N, K] storage of the experts
// (K-major).  Rows past ends[E-1] are written 0.  out is fp32 or bf16.
//
// Bound: at the Qwen3-30B-A3B shape (139,392 block-padded routed rows of a
// 147,456-row buffer, K, N = 2048, 768) the bytes -- the grouped bf16 rows
// and the experts read once, the bf16 output written once, 1.2 GB -- take
// 0.36 ms at 3.35 TB/s, above the 0.22 ms of the 2 (sum of group sizes) K N
// operations on the 8-bit tensor cores (1,979 TOP/s).
//
// Design.  Two passes, as qdot.cu: gemm8.cuh's pack quantizes lhs (K-major
// as it is) and every expert (transposed to K-major in shared memory when
// it is stored N-major) once into 8-bit scratch copies; then gmm.cu's
// grouped schedule runs on the codes.  One CTA per (128-row tile, 256-column
// tile) of out finds the first group ending past its first row by a binary
// search of `ends` (computed on the device: no host sync), then adds each
// meeting group's rows, cut out of the tile by a row range [lo, hi) in the
// loader (rows outside load as 0).  The epilogue finds each row's group
// again for its expert scale.  The tile product and its cp.async pipeline
// are gemm8.cuh's.  (Quantizing with eager torch ops
// around an 8-bit-only kernel, as a first version did, took 8.5 ms a call
// at the Qwen3-30B-A3B shape against 1.6 ms for the product, on an H100
// 80GB HBM3 at 700 W: XLA fuses those ops, eager PyTorch does not.)

#include "gemm8.cuh"

namespace gmmq {
using namespace g8;

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

template <int QA, int QB>
__global__ void __launch_bounds__(kThreads, 1)
gmm_quant_kernel(const uint8_t* __restrict__ lhs,
                 const uint8_t* __restrict__ rhs, const int* __restrict__ ends,
                 const float* __restrict__ s_lhs,
                 const float* __restrict__ s_rhs, int srhs_e, int srhs_n,
                 void* __restrict__ out, int m, int K, int N, int E,
                 int out_bf16, int group_m) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int n_m = (m + kBM - 1) / kBM;
  const int n_n = (N + kBN - 1) / kBN;
  int tm, tn;
  lce::grouped_tile(blockIdx.x, n_m, n_n, group_m, &tm, &tn);
  const int m0 = tm * kBM, n0 = tn * kBN;
  const int m1 = min(m0 + kBM, m);

  using T = AccT<QA, QB>;
  T acc[kMT][kNT][4];
  zero(acc);
  for (int g = first_group_past(ends, E, m0); g < E; ++g) {
    const int lo = g ? min(ends[g - 1], m) : 0;
    if (lo >= m1) break;
    const int hi = min(ends[g], m);
    if (hi <= lo) continue;                          // empty group
    product<QA, QB>(acc, lhs, K, lo, hi, rhs + (size_t)g * N * K, K,
                    N, m0, n0, K, smem);
  }

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3, gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + i * 16 + gq + h * 8;
      if (row >= m1) continue;
      const int g = first_group_past(ends, E, row);
      const float s_r = g < E ? s_lhs[row] : 0.f;
      const float* s_g = s_rhs + (size_t)min(g, E - 1) * srhs_e;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = n0 + wn * kWN + j * 8 + 2 * t;
        if (col >= N) continue;         // N % 16 == 0: pairs in or out
        float v0 = 0.f, v1 = 0.f;       // rows past the groups
        if (g < E) {
          v0 = (as_f32(acc[i][j][2 * h]) * s_r) * s_g[(size_t)col * srhs_n];
          v1 = (as_f32(acc[i][j][2 * h + 1]) * s_r) *
               s_g[(size_t)(col + 1) * srhs_n];
        }
        store2(out, N, 1, out_bf16, row, col, v0, v1);
      }
    }
}

template <int QA, int QB>
int launch(const void* lhs, const void* rhs, const int* ends,
           const float* s_lhs, const float* s_rhs, int srhs_e, int srhs_n,
           void* out, int m, int K, int N, int E, int out_bf16,
           cudaStream_t s) {
  auto kernel = gmm_quant_kernel<QA, QB>;
  int rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes));
  if (rc) return rc;
  const int n_m = (m + kBM - 1) / kBM;
  const int n_n = (N + kBN - 1) / kBN;
  const int group_m = max(1, min(n_m, lce::num_sms() / n_n));
  kernel<<<n_m * n_n, kThreads, kSmemBytes, s>>>(
      static_cast<const uint8_t*>(lhs), static_cast<const uint8_t*>(rhs),
      ends, s_lhs, s_rhs, srhs_e, srhs_n, out, m, K, N, E, out_bf16,
      group_m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gmmq

// out [m, N] (fp32, or bf16 when out_bf16) <- per group
// (quant(lhs) @ quant(rhs[g])) * s_lhs[row] * s_rhs[g, col]: lhs [m, K]
// bf16 row-major; rhs[g] [K, N] bf16 at rhs + g * rhs_e, element (k, n) at
// k * rhs_ld + n (rhs_kmajor 0) or n * rhs_ld + k (rhs_kmajor 1); qa / qb:
// 0 int8, 1 e4m3, 2 e5m2, in the pairs (1,1) (2,1) (1,2) (0,0); ends [E]
// int32 the inclusive prefix sum of the group sizes; s_lhs [m] fp32;
// s_rhs at g * srhs_e + col * srhs_n; lhs_q [m][K] and rhs_q [E][N][K]
// bytes of scratch.  K and N multiples of 16, rhs_ld and rhs_e multiples
// of 8, m > 0, E > 0, pointers 16-byte aligned.  Returns 0, -1 for what it
// does not take, else the first failed launch's cudaError_t.
extern "C" int gmm_quant(const void* lhs, const void* rhs, long long rhs_e,
                         long long rhs_ld, int rhs_kmajor, const int* ends,
                         const float* s_lhs, const float* s_rhs, int srhs_e,
                         int srhs_n, void* lhs_q, void* rhs_q, void* out,
                         int m, int K, int N, int E, int out_bf16, int qa,
                         int qb, void* stream) {
  using namespace gmmq;
  if (m <= 0 || E <= 0 || K <= 0 || N <= 0 || K % 16 || N % 16) return -1;
  if (rhs_ld % 8 || rhs_e % 8) return -1;
  const bool pair_ok = (qa == kE4M3 && qb == kE4M3) ||
                       (qa == kE5M2 && qb == kE4M3) ||
                       (qa == kE4M3 && qb == kE5M2) ||
                       (qa == kS8 && qb == kS8);
  if (!pair_ok) return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  int rc = pack(qa, lhs, K, 0, 1, s_lhs, 1, 0, m, K, K, lhs_q, 1, s);
  if (rc) return rc;
  rc = pack(qb, rhs, rhs_ld, rhs_e, rhs_kmajor, s_rhs, srhs_n, srhs_e, N, K,
            K, rhs_q, E, s);
  if (rc) return rc;
  if (qa == kE4M3 && qb == kE4M3)
    return launch<kE4M3, kE4M3>(lhs_q, rhs_q, ends, s_lhs, s_rhs, srhs_e,
                                srhs_n, out, m, K, N, E, out_bf16, s);
  if (qa == kE5M2 && qb == kE4M3)
    return launch<kE5M2, kE4M3>(lhs_q, rhs_q, ends, s_lhs, s_rhs, srhs_e,
                                srhs_n, out, m, K, N, E, out_bf16, s);
  if (qa == kE4M3 && qb == kE5M2)
    return launch<kE4M3, kE5M2>(lhs_q, rhs_q, ends, s_lhs, s_rhs, srhs_e,
                                srhs_n, out, m, K, N, E, out_bf16, s);
  return launch<kS8, kS8>(lhs_q, rhs_q, ends, s_lhs, s_rhs, srhs_e, srhs_n,
                          out, m, K, N, E, out_bf16, s);
}
