// Grouped matmuls of the sorted mixture-of-experts path, for Hopper
// (sm_90a); plain C interface for ctypes.
//
// Replaces the TPU kernels automodel_tpu/ops/gmm_kernel.py:187 (_gmm_kernel,
// launched at :225) and :256 (_tgmm_kernel, launched at :290).  The rows of
// lhs [m, K] are contiguous per-group segments sized by group_sizes [E]
// (segment g is rows [ends[g-1], ends[g]), ends the inclusive prefix sum):
//   gmm:   out[rows of g] = lhs[rows of g] @ rhs[g]      out [m, N]
//          rhs [E, K, N], or with trans_rhs its [E, N, K] storage read as
//          rhs[g]^T in place (the backward's dlhs = gmm(dout, rhs^T));
//          rows past ends[E-1] are written 0
//   tgmm:  out[g] = lhs[rows of g]^T @ dout[rows of g]   out [E, K, N]
//          an empty group's block is written 0
// bf16 operands, fp32 accumulate, bf16 out.
//
// Bound: 2 (sum of group sizes) K N operations on the bf16 tensor cores
// (0.41 TFLOP, 0.42 ms at 989 TFLOP/s for the routed rows of
// Qwen3-30B-A3B: 131072 x 2048 x 768); the bytes (lhs, the experts'
// weights and the output once) take about a third of that.
//
// Design.  The Pallas kernels enumerate (row tile, group) work items in one
// sequential grid axis and carry an fp32 VMEM accumulator from one item to
// the next.  CTAs here run in no order, so each owns its output tile and
// walks the groups it needs itself:
//   gmm:   one CTA per (128-row tile, 256-column tile) of out.  It finds the
//          first group ending past its first row by a binary search of
//          `ends` (computed on the device by the wrapper: no host sync), then
//          adds lhs[rows of g in the tile] @ rhs[g] for each group g that
//          meets the tile; the rows of other groups are cut out by the
//          operand's row range [lo, hi) and load as 0.  A tile no group
//          meets writes 0.  Rows of a group padded to the tile (the sorted
//          path pads every segment to 128 rows) meet one group per tile.
//   tgmm:  one CTA per (group, 128-row tile of K, 256-column tile of N),
//          whose K loop walks the group's rows; both operands are read with
//          ldmatrix.trans from their row-major storage.
// The tile product is linear_ce_gemm.cuh's (mma.sync m16n8k16, 3-stage
// cp.async of 64-deep tiles, ldmatrix; 8 warps of 64 x 64).

#include "linear_ce_gemm.cuh"

namespace gmmk {
using namespace lce;

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

template <bool TRANS>
__global__ void __launch_bounds__(kThreads, 1)
gmm_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
           const int* __restrict__ ends, bf16* __restrict__ out, int m, int K,
           int N, int E, int group_m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int n_m = (m + kBM - 1) / kBM;
  const int n_n = (N + kBN - 1) / kBN;
  int tm, tn;
  grouped_tile(blockIdx.x, n_m, n_n, group_m, &tm, &tn);
  const int m0 = tm * kBM, n0 = tn * kBN;
  const int m1 = min(m0 + kBM, m);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3, g8 = lane >> 2, t = lane & 3;

  float acc[4][kNT][4];
  zero_acc(acc);
  for (int g = first_group_past(ends, E, m0); g < E; ++g) {
    const int lo = g ? min(ends[g - 1], m) : 0;
    if (lo >= m1) break;
    const int hi = min(ends[g], m);
    if (hi <= lo) continue;                          // empty group
    const Operand A{lhs, K, hi, K, lo};              // rows [lo, hi), K-major
    const bf16* w = rhs + (size_t)g * K * N;
    if (TRANS) {     // rhs[g] stored [N][K]: B K-major
      const Operand B{w, K, N, K};
      gemm_tile<true, true>(acc, A, B, m0, n0, K, smem);
    } else {         // rhs[g] stored [K][N]: B N-major
      const Operand B{w, N, K, N};
      gemm_tile<true, false>(acc, A, B, m0, n0, K, smem);
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = r >> 1, e0 = (r & 1) * 2;
    const int row = m0 + wm * 64 + i * 16 + g8 + (r & 1) * 8;
    if (row >= m1) continue;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = n0 + wn * kWN + j * 8 + 2 * t;
      if (col < N)        // N % 8 == 0: a pair is in or out as a whole
        *reinterpret_cast<uint32_t*>(out + (size_t)row * N + col) =
            pack_bf16(acc[i][j][e0], acc[i][j][e0 + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
tgmm_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ dout,
            const int* __restrict__ ends, bf16* __restrict__ out, int m, int K,
            int N, int E) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int n_k = (K + kBM - 1) / kBM;
  const int n_n = (N + kBN - 1) / kBN;
  const int per_group = n_k * n_n;
  const int g = blockIdx.x / per_group;
  const int in_group = blockIdx.x % per_group;
  const int k0 = (in_group % n_k) * kBM, n0 = (in_group / n_k) * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3, g8 = lane >> 2, t = lane & 3;

  const int lo = g ? min(ends[g - 1], m) : 0;
  const int rows = min(ends[g], m) - lo;
  float acc[4][kNT][4];
  zero_acc(acc);
  if (rows > 0) {
    const Operand A{lhs + (size_t)lo * K, K, rows, K};   // [row][k]: M-major
    const Operand B{dout + (size_t)lo * N, N, rows, N};  // [row][n]: N-major
    gemm_tile<false, false>(acc, A, B, k0, n0, rows, smem);
  }

  bf16* o = out + (size_t)g * K * N;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = r >> 1, e0 = (r & 1) * 2;
    const int kk = k0 + wm * 64 + i * 16 + g8 + (r & 1) * 8;
    if (kk >= K) continue;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = n0 + wn * kWN + j * 8 + 2 * t;
      if (col < N)
        *reinterpret_cast<uint32_t*>(o + (size_t)kk * N + col) =
            pack_bf16(acc[i][j][e0], acc[i][j][e0 + 1]);
    }
  }
}

template <typename F>
int prepare(F kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes));
}

}  // namespace gmmk

// Shapes both kernels take: K and N multiples of 8 (16-byte rows), m > 0,
// E > 0; `ends` [E] int32 the inclusive prefix sum of the group sizes.
// Each returns 0, -1 for a shape it does not take, else the cudaError_t of
// the launch.

// out [m, N] bf16 <- lhs [m, K] (grouped rows) @ rhs [E, K, N], or with
// trans_rhs rhs stored [E, N, K] and read transposed
extern "C" int gmm_fwd(const void* lhs, const void* rhs, const int* ends,
                       void* out, int m, int K, int N, int E, int trans_rhs,
                       void* stream) {
  using namespace gmmk;
  if (m <= 0 || E <= 0 || K % 8 || N % 8 || K <= 0 || N <= 0) return -1;
  const int n_m = (m + kBM - 1) / kBM;
  const int n_n = (N + kBN - 1) / kBN;
  const int group_m = max(1, min(n_m, num_sms() / n_n));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto a = static_cast<const bf16*>(lhs);
  const auto b = static_cast<const bf16*>(rhs);
  const auto o = static_cast<bf16*>(out);
  int rc;
  if (trans_rhs) {
    if ((rc = prepare(gmm_kernel<true>))) return rc;
    gmm_kernel<true><<<n_m * n_n, kThreads, kSmemBytes, s>>>(
        a, b, ends, o, m, K, N, E, group_m);
  } else {
    if ((rc = prepare(gmm_kernel<false>))) return rc;
    gmm_kernel<false><<<n_m * n_n, kThreads, kSmemBytes, s>>>(
        a, b, ends, o, m, K, N, E, group_m);
  }
  return static_cast<int>(cudaGetLastError());
}

// out [E, K, N] bf16 <- per group lhs[rows of g]^T @ dout[rows of g], with
// lhs [m, K] and dout [m, N]
extern "C" int tgmm(const void* lhs, const void* dout, const int* ends,
                    void* out, int m, int K, int N, int E, void* stream) {
  using namespace gmmk;
  if (m <= 0 || E <= 0 || K % 8 || N % 8 || K <= 0 || N <= 0) return -1;
  const int n_k = (K + kBM - 1) / kBM;
  const int n_n = (N + kBN - 1) / kBN;
  int rc = prepare(tgmm_kernel);
  if (rc) return rc;
  tgmm_kernel<<<E * n_k * n_n, kThreads, kSmemBytes,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(lhs), static_cast<const bf16*>(dout), ends,
      static_cast<bf16*>(out), m, K, N, E);
  return static_cast<int>(cudaGetLastError());
}
