// Quantized matmul for Hopper (sm_90a); plain C interface for ctypes.
//
// Replaces the TPU kernel automodel_tpu/ops/qdot_kernel.py:89 (_qdot_kernel,
// launched at :127): out [m, n] = (raw * sa) * sb with
//   raw = quant(a [m, k], sa) @ quant(b [k, n], sb)   exact 8-bit products
//   quant(x, s) = x / s (IEEE fp32 division), then
//       int8: round half to even, clip to +-127         (int32 sums)
//       e4m3 / e5m2: round to nearest even, saturating  (fp32 sums)
// which is ops/quant.py::quant_cast's rule (clip-then-round and
// round-then-saturate give the same codes).  sa is [m] or one value, sb
// [n] or one value: rowwise scales ride the output dimensions only.  a and
// b are bf16 and each is read in place in either orientation:
//   a: K-major [m][k] or M-major [k][m];  b: K-major [n][k] or N-major [k][n]
// (forward x @ W^T: K / K; dgrad g @ W: K / N; wgrad x^T @ g: M / N).  out
// is fp32 or bf16, row-major or transposed (the wgrad writes the weight
// gradient in the [N, K] storage of nn.Linear).
//
// Bound: 2 m k n operations on the 8-bit tensor cores (1,979 TOP/s dense);
// at the Llama-3.2-1B training shapes (m 16,384, k and n 512-8192) that is
// 3-10x the time of moving a, b and out once.
//
// Design.  The Pallas kernel quantizes each (tm, K) x (K, tn) bf16 tile
// pair in VMEM right before its MXU dot, so the quantized copies never
// exist in HBM; but it quantizes every element of a once per column tile
// and of b once per row tile.  On the H100 the IEEE division that bit-exact
// quantization needs costs ~20 instructions an element, and done per tile
// (a first version of this kernel) it took 14x the bf16 product's time (4.97
// against 0.35 ms at m, k, n = 16384, 2048, 4096 on an H100 80GB HBM3 at
// 700 W).  So each call runs two passes:
//   pack:  gemm8.cuh's quantize pass writes each operand's 8-bit codes
//          K-major into a scratch copy [mn][kp] (kp = k rounded up to 16,
//          zero-filled), transposing an M/N-major source in shared memory
//          on the way: 1 byte written for every 2 read, each element
//          quantized once.
//   gemm:  one CTA per 128 x 256 output tile runs gemm8.cuh's 8-bit tile
//          product over the two copies (3-stage cp.async, ldmatrix,
//          mma.sync m16n8k32, fp32 or int32 sums) and rescales in the
//          epilogue in the JAX rung's order.
// wgmma and TMA are later work.

#include "gemm8.cuh"

namespace qdotk {
using namespace g8;

struct Args {
  const uint8_t* aq;   // [M][kp] codes
  const uint8_t* bq;   // [N][kp] codes
  const float* sa;
  const float* sb;
  void* out;
  int M, N, kp;
  int sa_stride, sb_stride;
  long long ors, ocs;
  int out_bf16, group_m;
};

template <int QA, int QB>
__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(const Args p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int n_m = (p.M + kBM - 1) / kBM;
  const int n_n = (p.N + kBN - 1) / kBN;
  int tm, tn;
  lce::grouped_tile(blockIdx.x, n_m, n_n, p.group_m, &tm, &tn);
  const int m0 = tm * kBM, n0 = tn * kBN, tid = threadIdx.x;

  using T = AccT<QA, QB>;
  T acc[kMT][kNT][4];
  zero(acc);
  product<QA, QB>(acc, p.aq, p.kp, 0, p.M, p.bq, p.kp, p.N, m0, n0,
                  p.kp, smem);

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + i * 16 + g + h * 8;
      if (row >= p.M) continue;
      const float s_r = p.sa[(long long)row * p.sa_stride];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = n0 + wn * kWN + j * 8 + 2 * t;
        if (col >= p.N) continue;       // N % 8 == 0: pairs in or out
        const float v0 = (as_f32(acc[i][j][2 * h]) * s_r) *
                         p.sb[(long long)col * p.sb_stride];
        const float v1 = (as_f32(acc[i][j][2 * h + 1]) * s_r) *
                         p.sb[(long long)(col + 1) * p.sb_stride];
        store2(p.out, p.ors, p.ocs, p.out_bf16, row, col, v0, v1);
      }
    }
}

template <int QA, int QB>
int gemm(const Args& p, cudaStream_t s) {
  auto kernel = gemm_kernel<QA, QB>;
  const int rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes));
  if (rc) return rc;
  const int n_m = (p.M + kBM - 1) / kBM;
  const int n_n = (p.N + kBN - 1) / kBN;
  kernel<<<n_m * n_n, kThreads, kSmemBytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace qdotk

// out [m, n] (fp32, or bf16 when out_bf16) <- (quant(a) @ quant(b)) * sa * sb.
// a [m, k] bf16: a_kmajor ? storage [m][lda] : storage [k][lda] (M-major);
// b [k, n] bf16: b_kmajor ? storage [n][ldb] : storage [k][ldb] (N-major);
// sa[i * sa_stride], sb[j * sb_stride] (stride 0: one scale); out element
// (i, j) at out + i * out_rs + j * out_cs with out_cs == 1 or out_rs == 1;
// qa / qb: 0 int8, 1 e4m3, 2 e5m2, in the pairs (1,1) (2,1) (1,2) (0,0);
// aq [m][kp] and bq [n][kp] bytes of scratch, kp = k rounded up to 16.  The
// vectorised dimension of each operand (k for K-major, m / n otherwise), n,
// lda and ldb are multiples of 8; pointers 16-byte aligned.  Returns 0, -1
// for what it does not take, else the first failed launch's cudaError_t.
extern "C" int qdot(const void* a, const void* b, const float* sa,
                    const float* sb, void* out, void* aq, void* bq, int m,
                    int n, int k, long long lda, long long ldb, int a_kmajor,
                    int b_kmajor, int sa_stride, int sb_stride,
                    long long out_rs, long long out_cs, int out_bf16, int qa,
                    int qb, void* stream) {
  using namespace qdotk;
  if (m <= 0 || n <= 0 || k <= 0 || n % 8 || lda % 8 || ldb % 8) return -1;
  if ((a_kmajor || b_kmajor) && k % 8) return -1;
  if (!a_kmajor && m % 8) return -1;
  if (out_cs != 1 && out_rs != 1) return -1;
  const bool pair_ok = (qa == kE4M3 && qb == kE4M3) ||
                       (qa == kE5M2 && qb == kE4M3) ||
                       (qa == kE4M3 && qb == kE5M2) ||
                       (qa == kS8 && qb == kS8);
  if (!pair_ok) return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  const int kp = (k + 15) / 16 * 16;
  int rc = pack(qa, a, lda, 0, a_kmajor, sa, sa_stride, 0, m, k, kp, aq, 1, s);
  if (rc) return rc;
  rc = pack(qb, b, ldb, 0, b_kmajor, sb, sb_stride, 0, n, k, kp, bq, 1, s);
  if (rc) return rc;
  const int n_m = (m + kBM - 1) / kBM;
  const int n_n = (n + kBN - 1) / kBN;
  const Args p{static_cast<const uint8_t*>(aq),
               static_cast<const uint8_t*>(bq), sa, sb, out, m, n, kp, sa_stride, sb_stride, out_rs, out_cs,
               out_bf16, max(1, min(n_m, lce::num_sms() / n_n))};
  if (qa == kE4M3 && qb == kE4M3) return gemm<kE4M3, kE4M3>(p, s);
  if (qa == kE5M2 && qb == kE4M3) return gemm<kE5M2, kE4M3>(p, s);
  if (qa == kE4M3 && qb == kE5M2) return gemm<kE4M3, kE5M2>(p, s);
  return gemm<kS8, kS8>(p, s);
}
