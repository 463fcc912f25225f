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
// s_rhs + g * srhs_e + j * srhs_n (rowwise: per expert and column;
// tensorwise: per expert).  lhs and rhs are bf16; rhs[g] is read in place
// from the forward's experts [E, K, N] (N-major) or, for the backward's
// rhs^T, from the [E, N, K] storage of the experts (K-major).  Rows past
// ends[E-1] are written 0.  out is fp32 or bf16.
//
// Bound: at the Qwen3-30B-A3B shape (139,392 block-padded routed rows of a
// 147,456-row buffer, K, N = 2048, 768) the bytes -- the grouped bf16 rows
// and the experts read once, the bf16 output written once, 1.2 GB -- take
// 0.36 ms at 3.35 TB/s, above the 0.22 ms of the 2 (sum of group sizes) K N
// operations on the 8-bit tensor cores (1,979 TOP/s).  The two passes below
// also write and re-read the 8-bit codes, 2.24 GB in all: 0.67 ms.
//
// Design.  Two launches, as qdot.cu (quantizing per tile inside the
// product would run the IEEE division of every lhs element once per column
// tile; with eager torch ops around an 8-bit-only kernel, as a first
// version did, it took 8.5 ms a call here against 1.6 ms for the product,
// on an H100 80GB HBM3 at 700 W):
//   gmm_quant_pack:    gemm8.cuh's pack quantizes lhs (K-major as it is)
//                      and every expert (transposed to K-major in shared
//                      memory when it is stored N-major) once into 8-bit
//                      scratch copies: lhs_q [m][K], rhs_q [E][N][K];
//   gmm_quant_product: the grouped product on wgmma_gemm.cuh's mainloop
//                      (TMA ring, a producer warp, two wgmma consumer
//                      warpgroups, one persistent CTA per SM) over
//                      gmm_items.cuh's grouped forward items, as gmm.cu:
//                      n_n (n_m + E) items fixed by shapes (one per output
//                      tile for the group holding its first row, one more
//                      per group starting inside a tile), each storing only
//                      its own group's rows; rows past the groups written 0
//                      by exactly one item; one tensor map over every
//                      expert's codes ([E N][K], Tile::b_row = g N); `ends`
//                      computed on the device (no host sync).  int8:
//                      Cfg<s8, s8, K, K, 256> (exact s32 sums, 4 stages);
//                      fp8 pairs: Cfg<., ., K, K, 128, PROMOTE> (each
//                      stage's 128 of K added into separate fp32 registers,
//                      qdot.cu's note says why; 6 stages).  The epilogue
//                      rescales in the JAX rung's order, (raw * s_lhs[r]) *
//                      s_rhs[g, col], and writes bf16 with gmm_items.cuh's
//                      quad-transposed 16-byte stores, or fp32 pairs.

#include "gemm8.cuh"
#include "gmm_items.cuh"

namespace gmmq {
namespace {

using g8::as_f32;

using S8Cfg = wg::Cfg<wg::kS8, wg::kS8, false, false, 256, false>;
template <int QA, int QB>
using Fp8Cfg = wg::Cfg<QA, QB, false, false, 128, true>;

struct Args {
  const int* ends;
  const int* plan;          // the clipped ends past gi::kMaxGroups groups
  const float* s_lhs;
  const float* s_rhs;
  void* out;
  int srhs_e, srhs_n, m, K, N, E, kt, n_m, n_n, out_bf16;
};

template <class C>
__global__ void __launch_bounds__(wg::kThreads, 1)
gmm_quant_product_kernel(const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap tb,
                         const Args p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ int ends_s[gi::kMaxGroups];
  const int* ends = gi::plan_ends(ends_s, p.ends, p.plan, p.E, p.m);
  // (the mainloop's first __syncthreads publishes ends)
  auto tile = [&](int i) {
    return gi::fwd_item(i, ends, p.E, p.n_m, p.n_n, C::BN, p.kt, p.N);
  };
  // rows [r_lo, r_hi) get the item's sums, [r_hi, z_hi) zeros; s_r: the
  // lhs scales of this thread's two rows (0 outside the item's rows)
  int r_lo = 0, r_hi = 0, z_hi = 0;
  float s_r[2];
  auto pre = [&](int w, const wg::Tile& t) {
    gi::fwd_rows(t, ends, p.E, p.m, r_lo, r_hi, z_hi);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = t.m0 + wg::acc_row(w, 2 * h);
      s_r[h] = row >= r_lo && row < r_hi ? p.s_lhs[row] : 0.f;
    }
  };
  auto epi = [&](int w, const wg::Tile& t, auto& acc) {
    if (t.nk == 0) {
      if (p.out_bf16)
        gi::store_zeros<C::BN>(static_cast<gi::bf16*>(p.out), p.N, p.N,
                               t.m0, t.n0, w, r_hi, z_hi);
      else
        gi::store_zeros<C::BN>(static_cast<float*>(p.out), p.N, p.N, t.m0,
                               t.n0, w, r_hi, z_hi);
      return;
    }
    const float* s_g = p.s_rhs + (size_t)t.part * p.srhs_e;
    const float s_all = s_g[0];              // tensorwise: one scale
    // registers i, i + 1 rescaled: (raw * s_lhs[row]) * s_rhs[g, col]
    auto rescaled = [&](int i) {
      const int col = t.n0 + wg::acc_col(i);
      float s0 = s_all, s1 = s_all;
      if (p.srhs_n) {
        s0 = col < p.N ? s_g[(size_t)col * p.srhs_n] : 0.f;
        s1 = col < p.N ? s_g[(size_t)(col + 1) * p.srhs_n] : 0.f;
      }
      const float sr = s_r[(i >> 1) & 1];
      return make_float2((as_f32(acc[i]) * sr) * s0,
                         (as_f32(acc[i + 1]) * sr) * s1);
    };
    if (p.out_bf16) {
      gi::store_tile<C::BN>(
          static_cast<gi::bf16*>(p.out), p.N, p.N, t.m0, t.n0, w,
          [&](int i) {
            const float2 v = rescaled(i);
            return gi::pack_bf16(v.x, v.y);
          },
          r_lo, r_hi, z_hi);
      return;
    }
    float* out = static_cast<float*>(p.out);
#pragma unroll
    for (int i = 0; i < C::BN / 2; i += 2) {
      const int row = t.m0 + wg::acc_row(w, i);
      const int col = t.n0 + wg::acc_col(i);
      if (row < r_lo || row >= z_hi || col >= p.N) continue;  // N % 16 == 0
      const float2 v = row < r_hi ? rescaled(i) : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(out + (size_t)row * p.N + col) = v;
    }
  };
  wg::mainloop<C>(smem, &ta, &tb, p.n_n * (p.n_m + p.E), tile, epi, pre);
}

template <class C>
int product(Args p, const void* lhs_q, const void* rhs_q, cudaStream_t s) {
  CUtensorMap ta, tb;
  int rc = wg::operand_map<C, true>(&ta, lhs_q, p.m, p.K, p.K);
  if (rc) return rc;
  rc = wg::operand_map<C, false>(&tb, rhs_q, (long long)p.E * p.N, p.K, p.K);
  if (rc) return rc;
  auto kernel = gmm_quant_product_kernel<C>;
  if ((rc = wg::prepare<C>(kernel))) return rc;
  p.kt = (p.K + C::BK - 1) / C::BK;
  p.n_m = (p.m + wg::kBM - 1) / wg::kBM;
  p.n_n = (p.N + C::BN - 1) / C::BN;
  const int work = p.n_n * (p.n_m + p.E);
  const int sms = lce::num_sms();
  kernel<<<work < sms ? work : sms, wg::kThreads, C::kSmemBytes, s>>>(ta, tb,
                                                                      p);
  return static_cast<int>(cudaGetLastError());
}

bool pair_ok(int qa, int qb) {
  using namespace g8;
  return (qa == kE4M3 && qb == kE4M3) || (qa == kE5M2 && qb == kE4M3) ||
         (qa == kE4M3 && qb == kE5M2) || (qa == kS8 && qb == kS8);
}

}  // namespace
}  // namespace gmmq

// The shapes both launches take: m > 0, E > 0, K and N multiples of 16,
// rhs_ld and rhs_e multiples of 8, pointers 16-byte aligned; qa / qb:
// 0 int8, 1 e4m3, 2 e5m2, in the pairs (1,1) (2,1) (1,2) (0,0).  Each
// returns 0, -1 for what it does not take, else the first failed launch's
// cudaError_t or a tensor-map error (wgmma_gemm.cuh::make_map).

// lhs_q [m][K] <- quant(lhs [m, K] bf16 row-major, s_lhs [m]) and rhs_q
// [E][N][K] <- quant(rhs[g], s_rhs[g]): rhs[g] [K, N] bf16 at rhs + g *
// rhs_e, element (k, n) at k * rhs_ld + n (rhs_kmajor 0) or n * rhs_ld + k
// (rhs_kmajor 1); s_rhs at g * srhs_e + col * srhs_n.
extern "C" int gmm_quant_pack(const void* lhs, const void* rhs,
                              long long rhs_e, long long rhs_ld,
                              int rhs_kmajor, const float* s_lhs,
                              const float* s_rhs, int srhs_e, int srhs_n,
                              void* lhs_q, void* rhs_q, int m, int K, int N,
                              int E, int qa, int qb, void* stream) {
  using namespace gmmq;
  if (m <= 0 || E <= 0 || K <= 0 || N <= 0 || K % 16 || N % 16 ||
      rhs_ld % 8 || rhs_e % 8 || !pair_ok(qa, qb))
    return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  const int rc =
      g8::pack(qa, lhs, K, 0, 1, s_lhs, 1, 0, m, K, K, lhs_q, 1, s);
  if (rc) return rc;
  return g8::pack(qb, rhs, rhs_ld, rhs_e, rhs_kmajor, s_rhs, srhs_n, srhs_e,
                  N, K, K, rhs_q, E, s);
}

// out [m, N] (fp32, or bf16 when out_bf16) <- per group (lhs_q[rows of g]
// @ rhs_q[g]^T) * s_lhs[row] * s_rhs[g, col] over the codes gmm_quant_pack
// wrote; ends [E] int32 the inclusive prefix sum of the group sizes; plan
// an int32 workspace [E] past 1024 groups (unused, may be null, at or
// below).
extern "C" int gmm_quant_product(const void* lhs_q, const void* rhs_q,
                                 const int* ends, int* plan,
                                 const float* s_lhs, const float* s_rhs,
                                 int srhs_e, int srhs_n, void* out, int m,
                                 int K, int N, int E, int out_bf16, int qa,
                                 int qb, void* stream) {
  using namespace gmmq;
  if (m <= 0 || E <= 0 || K <= 0 || N <= 0 || K % 16 || N % 16 ||
      !pair_ok(qa, qb) || (E > gi::kMaxGroups && plan == nullptr))
    return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  const int rc = gi::launch_clip_ends(plan, ends, E, m, s);
  if (rc) return rc;
  Args p{ends, plan, s_lhs, s_rhs, out, srhs_e, srhs_n, m, K, N, E, 0, 0, 0,
         out_bf16};
  using namespace g8;
  if (qa == kE4M3 && qb == kE4M3)
    return product<Fp8Cfg<wg::kE4M3, wg::kE4M3>>(p, lhs_q, rhs_q, s);
  if (qa == kE5M2 && qb == kE4M3)
    return product<Fp8Cfg<wg::kE5M2, wg::kE4M3>>(p, lhs_q, rhs_q, s);
  if (qa == kE4M3 && qb == kE5M2)
    return product<Fp8Cfg<wg::kE4M3, wg::kE5M2>>(p, lhs_q, rhs_q, s);
  return product<S8Cfg>(p, lhs_q, rhs_q, s);
}
