// Fused linear cross-entropy, backward, for Hopper (sm_90a); plain C
// interface for ctypes.
//
// Replaces the TPU kernels automodel_tpu/ops/linear_ce_kernel.py:222
// (_bwd_dh_kernel) and :248 (_bwd_dw_kernel), called by _bwd_pallas at :283
// and :305.  From (h [T, H], W, labels, lse, dlse, dpick) they give
//   dlogits = exp(h W - lse) * dlse + onehot(label) * dpick   (:209-219)
//   dh = dlogits W^T          [T, H] bf16
//   dW = h^T dlogits          stored [V, H] bf16, summed over T in fp32
// with W read in the port's storage w [V, H] row-major, as the forward.
//
// Design.  The Pallas kernels each keep a full-width fp32 accumulator
// resident while they walk the other axis ([TM, H] for dh, [H, TV] for dW:
// 8 MB of VMEM at (1024, 2048)) and each recompute the logits, 4 matmul
// units in all.  An SM holds 256 KB of registers and 227 KB of shared
// memory, so here the backward walks rows in chunks of Tc (the wrapper's
// choice, 2048 by default) with three launches per chunk:
//   1. linear_ce_dlogits: the logits of the chunk recomputed tile by tile
//      (the shared 128 x 256 tile product), dlogits applied in registers
//      with vocab columns past V and labels outside [0, V) masked, written
//      as bf16 [Tc, ldv] (ldv = V rounded up to 128; the pad columns are
//      written as 0).  The rounding to bf16 before the products is the TPU
//      kernel's own (:231, :258: dlog.astype(w.dtype));
//   2. linear_ce_dh: dh[chunk] = dlogits W, a tile product with K = V that
//      reads W [V, H] as an N-major operand (ldmatrix.trans);
//   3. linear_ce_dw: dW += dlogits^T h[chunk] on wgmma_gemm.cuh's Hopper
//      mainloop: TMA loads dlogits [Tc][ldv] (M = V contiguous) and h
//      [Tc][H] (N = H contiguous) as 64 x 64 boxes, and bf16 wgmma reads
//      both as MN-major shared tiles through its transpose bits, so
//      neither is copied into another layout; 128 x 256 output tiles, a
//      4-stage ring, one persistent CTA per SM, ragged chunk rows and the
//      V tail zero-filled by TMA.
//      It sums into one fp32 [V, H] buffer: the first chunk writes it,
//      the later ones add, and the last writes the bf16 result (one
//      chunk: no fp32 buffer).  That round trip moves 2.1 GB per chunk
//      at Llama-3's vocabulary (~0.63 ms at 3.35 TB/s); it is kept (PERF.md
//      says what it costs).
// Three matmul units instead of four: the one recompute serves dh and dW,
// for 2 Tc V bytes of dlogits written and read twice per chunk.  No
// [T, V] tensor exists, only the [Tc, V] chunk.
//
// Bound: 6 T H V operations on the bf16 tensor cores (the recompute, dh
// and dW: 25.8 TFLOP at T 16384, H 2048, V 128256, 26.1 ms at 989
// TFLOP/s); the bytes (h, W, dh, dW once; the dlogits chunks and the fp32
// dW read-modify-write on top) stay well below that.

#include "linear_ce_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace lce {
namespace {

// dlogits of rows r0 .. r0 + rows of the chunk, tile (tm, tn) per CTA
__global__ void __launch_bounds__(kThreads, 1)
lce_dlogits(const bf16* __restrict__ h, const bf16* __restrict__ w,
            const int* __restrict__ labels, const float* __restrict__ lse,
            const float* __restrict__ dlse, const float* __restrict__ dpick,
            bf16* __restrict__ dl, int r0, int rows, int H, int V, int ldv,
            int group_m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int n_m = (rows + kBM - 1) / kBM;
  const int n_n = (ldv + kBN - 1) / kBN;
  int tm, tn;
  grouped_tile(blockIdx.x, n_m, n_n, group_m, &tm, &tn);
  const int m0 = tm * kBM, n0 = tn * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;

  const Operand A{h + (size_t)r0 * H, H, rows, H};
  const Operand B{w, H, V, H};
  float acc[4][kNT][4];
  zero_acc(acc);
  gemm_tile<true, true>(acc, A, B, m0, n0, H, smem);

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = r >> 1, e0 = (r & 1) * 2;
    const int lrow = m0 + wm * 64 + i * 16 + g + (r & 1) * 8;
    if (lrow >= rows) continue;
    const int row = r0 + lrow;
    const int lab = labels[row];
    const float l = lse[row], ds = dlse[row], dp = dpick[row];
    bf16* out = dl + (size_t)lrow * ldv;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = n0 + wn * kWN + j * 8 + 2 * t;
      if (col >= ldv) continue;     // ldv % 8 == 0: a pair is in or out
      float v2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = col + e;
        float d = 0.f;
        if (c < V) {
          d = __expf(acc[i][j][e0 + e] - l) * ds;
          if (c == lab) d += dp;
        }
        v2[e] = d;
      }
      *reinterpret_cast<uint32_t*>(out + col) = pack_bf16(v2[0], v2[1]);
    }
  }
}

// dh[r0 + m, n] = sum_v dl[m, v] w[v, n]
__global__ void __launch_bounds__(kThreads, 1)
lce_dh(const bf16* __restrict__ dl, const bf16* __restrict__ w,
       bf16* __restrict__ dh, int rows, int H, int V, int ldv, int group_m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int n_m = (rows + kBM - 1) / kBM;
  const int n_n = (H + kBN - 1) / kBN;
  int tm, tn;
  grouped_tile(blockIdx.x, n_m, n_n, group_m, &tm, &tn);
  const int m0 = tm * kBM, n0 = tn * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;

  const Operand A{dl, ldv, rows, ldv};          // [m][k = v], K-major
  const Operand B{w, H, V, H};                  // [k = v][n], N-major
  float acc[4][kNT][4];
  zero_acc(acc);
  gemm_tile<true, false>(acc, A, B, m0, n0, V, smem);

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = r >> 1, e0 = (r & 1) * 2;
    const int m = m0 + wm * 64 + i * 16 + g + (r & 1) * 8;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int n = n0 + wn * kWN + j * 8 + 2 * t;
      if (n < H)      // H % 8 == 0: a pair is in or out as a whole
        *reinterpret_cast<uint32_t*>(dh + (size_t)m * H + n) =
            pack_bf16(acc[i][j][e0], acc[i][j][e0 + 1]);
    }
  }
}

// dW[v, n] (+)= sum_m dl[m, v] h[m, n]; mode 0: write dw32, 1: add into
// dw32, 2: add dw32 (if has_prev) and write bf16 dw
using DwCfg = wg::Cfg<wg::kBF16, wg::kBF16, true, true, 256, false>;

struct DwArgs {
  float* dw32;
  bf16* dw;
  int V, H, kt, mode, has_prev, n_m, n_n, group_m;
};

__global__ void __launch_bounds__(wg::kThreads, 1)
lce_dw(const __grid_constant__ CUtensorMap ta,
       const __grid_constant__ CUtensorMap tb, const DwArgs p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  auto tile = [&](int i) {
    return wg::grid_tile(i, p.n_m, p.n_n, p.group_m, DwCfg::BN, p.kt, p.kt);
  };
  // The previous sums are loaded a batch at a time, all before the batch's
  // stores: the compiler may not move a load of the buffer past a store
  // to it, so pair by pair each load would wait out a trip to device
  // memory.
  auto epi = [&](int w, const wg::Tile& t, float (&acc)[DwCfg::BN / 2]) {
    constexpr int kBatch = 32;
    const bool add = p.mode == 1 || (p.mode == 2 && p.has_prev);
#pragma unroll
    for (int i0 = 0; i0 < DwCfg::BN / 2; i0 += kBatch) {
      float2 prev[kBatch / 2];
#pragma unroll
      for (int j = 0; j < kBatch; j += 2) {
        const int v = t.m0 + wg::acc_row(w, i0 + j);
        const int n = t.n0 + wg::acc_col(i0 + j);
        prev[j / 2] = add && v < p.V && n < p.H
            ? *reinterpret_cast<const float2*>(p.dw32 + (size_t)v * p.H + n)
            : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < kBatch; j += 2) {
        const int v = t.m0 + wg::acc_row(w, i0 + j);
        const int n = t.n0 + wg::acc_col(i0 + j);
        if (v >= p.V || n >= p.H) continue;   // H % 8 == 0: pairs
        const size_t o = (size_t)v * p.H + n;
        const float2 x = make_float2(acc[i0 + j] + prev[j / 2].x,
                                     acc[i0 + j + 1] + prev[j / 2].y);
        if (p.mode == 2)
          *reinterpret_cast<uint32_t*>(p.dw + o) = pack_bf16(x.x, x.y);
        else
          *reinterpret_cast<float2*>(p.dw32 + o) = x;
      }
    }
  };
  wg::mainloop<DwCfg>(smem, &ta, &tb, p.n_m * p.n_n, tile, epi);
}

template <typename K>
int prepare(K kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes));
}

}  // namespace
}  // namespace lce

// Shapes the backward kernels take: H and ldv (the dlogits row length,
// >= V) multiples of 8.  Each returns 0, -1 for a shape they do not take,
// else the cudaError_t of the launch.

// dl [rows, ldv] bf16 <- dlogits of rows r0 .. r0 + rows of h [T, H]
extern "C" int linear_ce_dlogits(const void* h, const void* w,
                                 const int* labels, const float* lse,
                                 const float* dlse, const float* dpick,
                                 void* dl, int r0, int rows, int H, int V,
                                 int ldv, void* stream) {
  using namespace lce;
  if (rows <= 0 || H % 8 || V <= 0 || ldv % 8 || ldv < V) return -1;
  int rc = prepare(lce_dlogits);
  if (rc) return rc;
  const int n_m = (rows + kBM - 1) / kBM;
  const int n_n = (ldv + kBN - 1) / kBN;
  lce_dlogits<<<n_m * n_n, kThreads, kSmemBytes,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w), labels, lse,
      dlse, dpick, static_cast<bf16*>(dl), r0, rows, H, V, ldv, n_m);
  return static_cast<int>(cudaGetLastError());
}

// dh [rows, H] bf16 <- dl [rows, ldv] w [V, H]
extern "C" int linear_ce_dh(const void* dl, const void* w, void* dh,
                            int rows, int H, int V, int ldv, void* stream) {
  using namespace lce;
  if (rows <= 0 || H % 8 || V <= 0 || ldv % 8 || ldv < V) return -1;
  int rc = prepare(lce_dh);
  if (rc) return rc;
  const int n_m = (rows + kBM - 1) / kBM;
  const int n_n = (H + kBN - 1) / kBN;
  lce_dh<<<n_m * n_n, kThreads, kSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dl), static_cast<const bf16*>(w),
      static_cast<bf16*>(dh), rows, H, V, ldv, n_m);
  return static_cast<int>(cudaGetLastError());
}

// dw32 [V, H] fp32 / dw [V, H] bf16 (+)= dl[rows, ldv]^T h[rows, H];
// mode 0 writes dw32, 1 adds into dw32, 2 writes dw (+ dw32 if has_prev).
// dl and h 16-byte aligned (TMA); also returns a tensor-map error
// (wgmma_gemm.cuh::make_map).
extern "C" int linear_ce_dw(const void* dl, const void* h, float* dw32,
                            void* dw, int rows, int H, int V, int ldv,
                            int mode, int has_prev, void* stream) {
  using namespace lce;
  if (rows <= 0 || H % 8 || V <= 0 || ldv % 8 || ldv < V || mode < 0 ||
      mode > 2)
    return -1;
  CUtensorMap ta, tb;
  int rc = wg::operand_map<DwCfg, true>(&ta, dl, V, rows, ldv);
  if (rc) return rc;
  rc = wg::operand_map<DwCfg, false>(&tb, h, H, rows, H);
  if (rc) return rc;
  rc = wg::prepare<DwCfg>(lce_dw);
  if (rc) return rc;
  DwArgs p{dw32, static_cast<bf16*>(dw), V, H,
           (rows + DwCfg::BK - 1) / DwCfg::BK, mode, has_prev,
           (V + wg::kBM - 1) / wg::kBM, (H + DwCfg::BN - 1) / DwCfg::BN, 1};
  p.group_m = wg::group_rows(p.n_m, p.n_n);
  const int work = p.n_m * p.n_n;
  lce_dw<<<work < lce::num_sms() ? work : lce::num_sms(), wg::kThreads,
           DwCfg::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(ta, tb, p);
  return static_cast<int>(cudaGetLastError());
}
