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
// pair in VMEM right before its MXU dot; on the H100 the IEEE division
// that bit-exact quantization needs costs ~20 instructions an element, and
// done per tile it took 14x the bf16 product's time (an H100 80GB HBM3 at
// 700 W).  So a call runs two steps, launched by the wrapper one after the
// other on its stream:
//   qdot_pack:    gemm8.cuh's quantize pass writes each operand's 8-bit
//                 codes K-major into a scratch copy [mn][kp] (kp = k
//                 rounded up to 16, zero-filled), each element quantized
//                 once; K-major is also the only layout 8-bit wgmma reads.
//   qdot_product: the 8-bit product on wgmma_gemm.cuh's mainloop (TMA
//                 into a ring of stages, one producer warp, two consumer
//                 warpgroups, one persistent CTA per SM): 128 x 128 output
//                 tiles on wgmma m64n128k32 for fp8 (6 stages), 128 x 256
//                 on m64n256k32 for int8 (4 stages), rescaled in the
//                 epilogue in the JAX rung's order.  An e4m3 / e5m2
//                 mma.sync (the first version of this kernel) lowers on
//                 sm_90a to an fp8 -> f16 unpack and f16 HMMA, so fp8 ran
//                 at the f16 rate at best; wgmma runs it at the 8-bit
//                 rate.
// fp8 accumulation.  Hopper's fp8 wgmma keeps about 14 bits of its sums
// over long K (DeepSeek-V3 report, section 3.3.2).  The fp8 product adds
// each stage's wgmma sums (128 of K, 4 steps of k32) into separate fp32
// registers (PROMOTE), which doubles the accumulator registers, hence the
// 128-column tile.  Measured by chip_smoke.py's qdot_fp8_accumulation line
// (an H100 80GB HBM3 at 700 W; all-positive e4m3 operands, so that no
// error cancels; relative L2 against float64 sums of the same codes):
// 5.5e-4 at K 8192 and 16384 with the promotion, 0.144 and 0.251 without,
// where the mma.sync product of the first version kept 2.2e-7 / 3.0e-7.
// So it stays; the 5.5e-4 that remains is the rounding inside each
// 128-deep block.  int8 sums are exact in s32 (|sum| <= K * 127^2 < 2^31
// for K < 133,000).
// Split-K.  When the output tiles do not fill the card (the k/v wgrad,
// [2048, 512]: 64 tiles on 132 SMs) the wrapper splits K into `splits`
// ranges of whole K tiles (its plan: ops/qdot_kernel.py::split_plan); the
// work item of tile x and range y writes its raw partial sums (fp32 or
// s32) into the workspace slice y, and reduce_kernel adds the slices in a
// fixed order, then rescales.  No atomics: int8 stays bit-identical and
// fp8 runs are deterministic.
// Registers (nvcc 12.9 -Xptxas -v): 168 a thread in every product kernel
// (the bound of 384 threads a CTA; setmaxnreg lends the consumers up to
// 232), no spills; 32 in reduce_kernel, 32-39 in the pack pass.

#include "gemm8.cuh"
#include "wgmma_gemm.cuh"

namespace qdotk {

struct Args {
  const float* sa;
  const float* sb;
  void* out;
  void* ws;                // [splits][M][N] raw partial sums (splits > 1)
  int M, N, kt_total, kt_split;
  int sa_stride, sb_stride;
  long long ors, ocs;
  int out_bf16, group_m, n_m, n_n;
};

__device__ __forceinline__ float as_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float as_f32(float v) { return v; }

// (raw * sa[row]) * sb[col], (raw1 * sa[row]) * sb[col + 1] into out
template <typename T>
__device__ __forceinline__ void rescale_store(const Args& p, int row,
                                              int col, T r0, T r1) {
  const float s_r = p.sa[(long long)row * p.sa_stride];
  const float v0 = (as_f32(r0) * s_r) * p.sb[(long long)col * p.sb_stride];
  const float v1 =
      (as_f32(r1) * s_r) * p.sb[(long long)(col + 1) * p.sb_stride];
  g8::store2(p.out, p.ors, p.ocs, p.out_bf16, row, col, v0, v1);
}

template <class C>
__global__ void __launch_bounds__(wg::kThreads, 1)
product_kernel(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb, const Args p,
               int splits) {
  extern __shared__ __align__(1024) uint8_t smem[];
  auto tile = [&](int i) {
    return wg::grid_tile(i, p.n_m, p.n_n, p.group_m, C::BN, p.kt_total,
                         p.kt_split);
  };
  auto epi = [&](int w, const wg::Tile& t, auto& acc) {
    using T = typename std::remove_reference<decltype(acc[0])>::type;
    T* part = static_cast<T*>(p.ws) + (long long)t.part * p.M * p.N;
#pragma unroll
    for (int i = 0; i < C::BN / 2; i += 2) {
      const int row = t.m0 + wg::acc_row(w, i);
      const int col = t.n0 + wg::acc_col(i);
      if (row >= p.M || col >= p.N) continue;     // N % 8 == 0: pairs
      if (splits > 1) {
        T* o = part + (long long)row * p.N + col;
        o[0] = acc[i];
        o[1] = acc[i + 1];
      } else {
        rescale_store(p, row, col, acc[i], acc[i + 1]);
      }
    }
  };
  wg::mainloop<C>(smem, &ta, &tb, p.n_m * p.n_n * splits, tile, epi);
}

// out = rescale(sum over the splits, in order, of the partial sums)
template <typename T>
__global__ void __launch_bounds__(256)
reduce_kernel(const T* __restrict__ ws, int splits, const Args p) {
  const long long pairs = (long long)p.M * p.N / 2;
  const long long slice = (long long)p.M * p.N;
  for (long long q = blockIdx.x * 256LL + threadIdx.x; q < pairs;
       q += (long long)gridDim.x * 256) {
    const long long e = 2 * q;
    T r0 = ws[e], r1 = ws[e + 1];
    for (int s = 1; s < splits; ++s) {
      r0 += ws[s * slice + e];
      r1 += ws[s * slice + e + 1];
    }
    rescale_store(p, static_cast<int>(e / p.N), static_cast<int>(e % p.N),
                  r0, r1);
  }
}

template <class C>
int product(const Args& p0, const void* aq, const void* bq, int kp,
            int splits, cudaStream_t s) {
  Args p = p0;
  CUtensorMap ta, tb;
  int rc = wg::operand_map<C, true>(&ta, aq, p.M, kp, kp);
  if (rc) return rc;
  rc = wg::operand_map<C, false>(&tb, bq, p.N, kp, kp);
  if (rc) return rc;
  auto kernel = product_kernel<C>;
  rc = wg::prepare<C>(kernel);
  if (rc) return rc;
  p.n_m = (p.M + wg::kBM - 1) / wg::kBM;
  p.n_n = (p.N + C::BN - 1) / C::BN;
  p.kt_total = (kp + C::BK - 1) / C::BK;
  if (splits < 1 || p.kt_split < 1 ||
      (splits - 1) * p.kt_split >= p.kt_total ||   // an empty split
      splits * p.kt_split < p.kt_total)            // K not covered
    return -1;
  p.group_m = wg::group_rows(p.n_m, p.n_n);
  const int work = p.n_m * p.n_n * splits;
  const int ctas = work < lce::num_sms() ? work : lce::num_sms();
  kernel<<<ctas, wg::kThreads, C::kSmemBytes, s>>>(ta, tb, p, splits);
  rc = static_cast<int>(cudaGetLastError());
  if (rc || splits == 1) return rc;
  using T = typename C::Acc;
  const long long need = ((long long)p.M * p.N / 2 + 255) / 256;
  const int blocks = need < 4096 ? static_cast<int>(need) : 4096;
  reduce_kernel<T><<<blocks, 256, 0, s>>>(static_cast<const T*>(p.ws), splits,
                                           p);
  return static_cast<int>(cudaGetLastError());
}

// fp8 pairs: 128-column tiles with fp32 promotion per stage; int8: 256
template <int QA, int QB>
using Fp8Cfg = wg::Cfg<QA, QB, false, false, 128, true>;
using S8Cfg = wg::Cfg<wg::kS8, wg::kS8, false, false, 256, false>;
// the same fp8 product without promotion: measured by chip_smoke.py's
// accumulation probe only
using Fp8RawCfg = wg::Cfg<wg::kE4M3, wg::kE4M3, false, false, 256, false>;

}  // namespace qdotk

// aq [m][kp] <- quant(a) and bq [n][kp] <- quant(b), K-major codes.
// a [m, k] bf16: a_kmajor ? storage [m][lda] : storage [k][lda] (M-major);
// b [k, n] bf16: b_kmajor ? storage [n][ldb] : storage [k][ldb] (N-major);
// sa[i * sa_stride], sb[j * sb_stride] (stride 0: one scale); qa / qb: 0
// int8, 1 e4m3, 2 e5m2; kp = k rounded up to 16.  The vectorised dimension
// of each operand (k for K-major, m / n otherwise), lda and ldb are
// multiples of 8; pointers 16-byte aligned.  Returns 0, -1 for what it
// does not take, else the first failed launch's cudaError_t.
extern "C" int qdot_pack(const void* a, const void* b, const float* sa,
                         const float* sb, void* aq, void* bq, int m, int n,
                         int k, long long lda, long long ldb, int a_kmajor,
                         int b_kmajor, int sa_stride, int sb_stride, int qa,
                         int qb, void* stream) {
  using namespace g8;
  if (m <= 0 || n <= 0 || k <= 0 || lda % 8 || ldb % 8) return -1;
  if ((a_kmajor || b_kmajor) && k % 8) return -1;
  if ((!a_kmajor && m % 8) || (!b_kmajor && n % 8)) return -1;
  if (qa < kS8 || qa > kE5M2 || qb < kS8 || qb > kE5M2) return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  const int kp = (k + 15) / 16 * 16;
  const int rc =
      pack(qa, a, lda, 0, a_kmajor, sa, sa_stride, 0, m, k, kp, aq, 1, s);
  if (rc) return rc;
  return pack(qb, b, ldb, 0, b_kmajor, sb, sb_stride, 0, n, k, kp, bq, 1, s);
}

// out [m, n] (fp32, or bf16 when out_bf16) <- (aq bq^T) * sa * sb over the
// codes qdot_pack wrote (kp a multiple of 16), in the pairs (qa, qb) =
// (1,1) (2,1) (1,2) (0,0).  out element (i, j) at out + i * out_rs + j *
// out_cs with out_cs == 1 or out_rs == 1.  splits > 1: K split into ranges
// of kt_split K tiles (128 codes each), each range's raw sums written to
// ws [splits][m][n] (fp32, s32 for int8), then added in order and
// rescaled.  promote 0 (e4m3 pairs only): the fp8 product without the
// per-stage fp32 promotion, for chip_smoke.py's accumulation probe.  n a
// multiple of 8.  Returns 0, -1 for what it does not take, else a
// cudaError_t or a tensor-map error (wgmma_gemm.cuh::make_map).
extern "C" int qdot_product(const void* aq, const void* bq, const float* sa,
                            const float* sb, void* out, void* ws, int m,
                            int n, int kp, int sa_stride, int sb_stride,
                            long long out_rs, long long out_cs, int out_bf16,
                            int qa, int qb, int splits, int kt_split,
                            int promote, void* stream) {
  using namespace qdotk;
  if (m <= 0 || n <= 0 || kp <= 0 || n % 8 || kp % 16) return -1;
  if (out_cs != 1 && out_rs != 1) return -1;
  if (splits > 1 && ws == nullptr) return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  Args p{sa, sb, out, ws, m, n, 0, kt_split, sa_stride, sb_stride,
         out_rs, out_cs, out_bf16, 1, 1, 1};
  if (!promote) {
    if (qa != g8::kE4M3 || qb != g8::kE4M3) return -1;
    return product<Fp8RawCfg>(p, aq, bq, kp, splits, s);
  }
  if (qa == g8::kE4M3 && qb == g8::kE4M3)
    return product<Fp8Cfg<wg::kE4M3, wg::kE4M3>>(p, aq, bq, kp, splits, s);
  if (qa == g8::kE5M2 && qb == g8::kE4M3)
    return product<Fp8Cfg<wg::kE5M2, wg::kE4M3>>(p, aq, bq, kp, splits, s);
  if (qa == g8::kE4M3 && qb == g8::kE5M2)
    return product<Fp8Cfg<wg::kE4M3, wg::kE5M2>>(p, aq, bq, kp, splits, s);
  if (qa == g8::kS8 && qb == g8::kS8)
    return product<S8Cfg>(p, aq, bq, kp, splits, s);
  return -1;
}
