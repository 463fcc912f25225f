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
// choice, 2048 by default) with three launches per chunk, all three
// persistent kernels on wgmma_gemm.cuh's Hopper mainloop (TMA loads into a
// ring of shared-memory stages, a producer warp, two wgmma consumer
// warpgroups, 128 x 256 output tiles, one CTA per SM; ragged chunk rows and
// the V tail zero-filled by TMA):
//   1. lce_dlogits (kernel 3's recompute, _dlogits_tile :209): the logits
//      of the chunk, h [Tc][H] (K-major) by W [V][H] (K-major: the head's
//      row-major storage), tile by tile; the epilogue applies
//      exp(acc - lse) dlse + (col == label) dpick in registers with vocab
//      columns past V and labels outside [0, V) masked, rounds to bf16 (the
//      TPU kernel's own rounding, :231, :258: dlog.astype(w.dtype)) and
//      stores [Tc][ldv] (ldv = V rounded up to 128; the pad columns are
//      written as 0).  The tiles of one column of W run on neighbouring
//      CTAs (all row tiles of a chunk in one group), so W is read from
//      device memory about once per chunk and the chunk of h stays in L2;
//   2. lce_dh (kernel 3, _bwd_dh_kernel :222): dh[chunk] = dlogits W, K =
//      V: dlogits [Tc][ldv] K-major, W [V][H] read as 64 x 64 MN-major
//      boxes through wgmma's transpose bit (nothing is copied), fp32 sums,
//      bf16 out; Tc 2048 gives 16 x 8 = 128 tiles, one per SM;
//   3. lce_dw (kernel 4, _bwd_dw_kernel :248): dW += dlogits^T h[chunk],
//      both operands MN-major (dlogits [Tc][ldv], M = V contiguous; h
//      [Tc][H], N = H contiguous) as 64 x 64 boxes.
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
// dW read-modify-write on top) stay well below that.  What is left: the
// consumers run each tile's epilogue (dlogits' exp and 64 KB of stores a
// tile) between two mainloops instead of overlapping it, and a ragged last
// chunk leaves dh's 128-row tiles short of the SMs (no split K).

#include "linear_ce_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace lce {
namespace {

// dlogits [rows][ldv] bf16 of rows r0 .. r0 + rows (the row vectors
// already offset by r0): A = h chunk [rows][H], B = w [V][H], both K-major
using DlCfg = wg::Cfg<wg::kBF16, wg::kBF16, false, false, 256, false>;
// dh [rows][H] bf16 = dl [rows][ldv] (K-major, K = V) w [V][H] (MN-major)
using DhCfg = wg::Cfg<wg::kBF16, wg::kBF16, false, true, 256, false>;

// dlogits epilogue: the whole of it, its arithmetic without the stores, or
// none (the last two time the kernel's parts; the port runs kEpiFull)
enum DlEpi { kEpiFull = 0, kEpiMath = 1, kEpiNone = 2 };

struct DlArgs {
  const int* labels;
  const float *lse, *dlse, *dpick;
  bf16* dl;
  int rows, V, ldv, kt, n_m, n_n, group_m, epi;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__global__ void __launch_bounds__(wg::kThreads, 1)
lce_dlogits(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tb, const DlArgs p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  constexpr float kLog2e = 1.4426950408889634f;
  auto tile = [&](int i) {
    return wg::grid_tile(i, p.n_m, p.n_n, p.group_m, DlCfg::BN, p.kt, p.kt);
  };
  // a thread's sums lie on two rows (registers i with (i / 2) % 2 = 0, 1):
  // their lse (times log2 e), dlse, dpick and label, loaded while the
  // tile's products run
  float lse2[2], ds[2], dp[2];
  int lab[2];
  bool in[2];
  auto pre = [&](int w, const wg::Tile& t) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = t.m0 + wg::acc_row(w, 2 * r);
      in[r] = row < p.rows;
      lse2[r] = in[r] ? p.lse[row] * kLog2e : 0.f;
      ds[r] = in[r] ? p.dlse[row] : 0.f;
      dp[r] = in[r] ? p.dpick[row] : 0.f;
      lab[r] = in[r] ? p.labels[row] : -1;
    }
  };
  auto epi = [&](int w, const wg::Tile& t, float (&acc)[DlCfg::BN / 2]) {
    if (p.epi == kEpiNone) {       // timing: the product alone
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < DlCfg::BN / 2; ++i) x += acc[i];
      if (x == 0x1p127f) p.dl[0] = __float2bfloat16(x);   // never taken
      return;
    }
    const bool full = t.n0 + DlCfg::BN <= p.V;     // no vocab tail here
#pragma unroll
    for (int i = 0; i < DlCfg::BN / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const int col = t.n0 + wg::acc_col(i);
      if (!in[r] || (!full && col >= p.ldv)) continue;   // ldv % 8 == 0
      float d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = col + e;
        d[e] = ex2(fmaf(acc[i + e], kLog2e, -lse2[r])) * ds[r];
        if (c == lab[r]) d[e] += dp[r];
        if (!full && c >= p.V) d[e] = 0.f;
      }
      const uint32_t v = pack_bf16(d[0], d[1]);
      // kEpiMath (timing: no stores) keeps one the compiler cannot prove
      // dead
      if (p.epi == kEpiFull || v == 0x7fc07fc0u)
        *reinterpret_cast<uint32_t*>(
            p.dl + (size_t)(t.m0 + wg::acc_row(w, i)) * p.ldv + col) = v;
    }
  };
  wg::mainloop<DlCfg>(smem, &ta, &tb, p.n_m * p.n_n, tile, epi, pre);
}

struct DhArgs {
  bf16* dh;
  int rows, H, kt, n_m, n_n, group_m;
};

__global__ void __launch_bounds__(wg::kThreads, 1)
lce_dh(const __grid_constant__ CUtensorMap ta,
       const __grid_constant__ CUtensorMap tb, const DhArgs p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  auto tile = [&](int i) {
    return wg::grid_tile(i, p.n_m, p.n_n, p.group_m, DhCfg::BN, p.kt, p.kt);
  };
  auto epi = [&](int w, const wg::Tile& t, float (&acc)[DhCfg::BN / 2]) {
#pragma unroll
    for (int i = 0; i < DhCfg::BN / 2; i += 2) {
      const int m = t.m0 + wg::acc_row(w, i);
      const int n = t.n0 + wg::acc_col(i);
      if (m < p.rows && n < p.H)      // H % 8 == 0: a pair is in or out
        *reinterpret_cast<uint32_t*>(p.dh + (size_t)m * p.H + n) =
            pack_bf16(acc[i], acc[i + 1]);
    }
  };
  wg::mainloop<DhCfg>(smem, &ta, &tb, p.n_m * p.n_n, tile, epi);
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

}  // namespace
}  // namespace lce

// Shapes the backward kernels take: H and ldv (the dlogits row length,
// >= V) multiples of 8.  Each returns 0, -1 for a shape they do not take,
// else the cudaError_t of the launch.

// dl [rows, ldv] bf16 <- dlogits of rows r0 .. r0 + rows of h [T, H]; h
// and w 16-byte aligned (TMA).  epi (DlEpi): 0 the kernel; 1 and 2 time
// its parts (no stores; no epilogue) and leave dl as it was.  Also
// returns a tensor-map error (wgmma_gemm.cuh::make_map).
extern "C" int linear_ce_dlogits(const void* h, const void* w,
                                 const int* labels, const float* lse,
                                 const float* dlse, const float* dpick,
                                 void* dl, int r0, int rows, int H, int V,
                                 int ldv, int epi, void* stream) {
  using namespace lce;
  if (rows <= 0 || H % 8 || V <= 0 || ldv % 8 || ldv < V || epi < kEpiFull ||
      epi > kEpiNone)
    return -1;
  CUtensorMap ta, tb;
  int rc = wg::operand_map<DlCfg, true>(
      &ta, static_cast<const bf16*>(h) + (size_t)r0 * H, rows, H, H);
  if (rc) return rc;
  rc = wg::operand_map<DlCfg, false>(&tb, w, V, H, H);
  if (rc) return rc;
  rc = wg::prepare<DlCfg>(lce_dlogits);
  if (rc) return rc;
  // every row tile of the chunk in one group: the CTAs resident at one
  // time share a few column tiles of W, read once a chunk
  const int n_m = (rows + wg::kBM - 1) / wg::kBM;
  DlArgs p{labels + r0, lse + r0, dlse + r0, dpick + r0,
           static_cast<bf16*>(dl), rows, V, ldv,
           (H + DlCfg::BK - 1) / DlCfg::BK, n_m,
           (ldv + DlCfg::BN - 1) / DlCfg::BN, n_m, epi};
  const int work = p.n_m * p.n_n;
  lce_dlogits<<<work < lce::num_sms() ? work : lce::num_sms(), wg::kThreads,
                DlCfg::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      ta, tb, p);
  return static_cast<int>(cudaGetLastError());
}

// dh [rows, H] bf16 <- dl [rows, ldv] w [V, H]; dl and w 16-byte aligned
// (TMA); also returns a tensor-map error.
extern "C" int linear_ce_dh(const void* dl, const void* w, void* dh,
                            int rows, int H, int V, int ldv, void* stream) {
  using namespace lce;
  if (rows <= 0 || H % 8 || V <= 0 || ldv % 8 || ldv < V) return -1;
  CUtensorMap ta, tb;
  int rc = wg::operand_map<DhCfg, true>(&ta, dl, rows, V, ldv);
  if (rc) return rc;
  rc = wg::operand_map<DhCfg, false>(&tb, w, H, V, H);
  if (rc) return rc;
  rc = wg::prepare<DhCfg>(lce_dh);
  if (rc) return rc;
  DhArgs p{static_cast<bf16*>(dh), rows, H, (V + DhCfg::BK - 1) / DhCfg::BK,
           (rows + wg::kBM - 1) / wg::kBM, (H + DhCfg::BN - 1) / DhCfg::BN,
           1};
  p.group_m = wg::group_rows(p.n_m, p.n_n);
  const int work = p.n_m * p.n_n;
  lce_dh<<<work < lce::num_sms() ? work : lce::num_sms(), wg::kThreads,
           DhCfg::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(ta, tb, p);
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
