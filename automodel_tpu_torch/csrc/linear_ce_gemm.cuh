// Shared tile product of the fused linear cross-entropy forward
// (linear_ce_fwd.cu) and the grouped matmuls (gmm.cu), and the helpers the
// backward (linear_ce_bwd.cu) and wgmma_gemm.cuh share: one CTA of 8 warps
// computes a
// 128 x 256 fp32 tile C = A B over a K loop, bf16 operands on the tensor
// cores (mma.sync m16n8k16, fp32 accumulate), fed by a 3-stage cp.async
// pipeline of 64-deep K tiles and ldmatrix fragment loads.  Each warp owns
// a 64 x 64 block: 8 ldmatrix.x4 feed 32 mma per 16-deep step, which keeps
// shared-memory reads below the tensor rate (a 64 x 32 block needs 6 for
// 16, and 32-deep K tiles twice the barriers; both ran slower on the H100).
//
// Each operand lies in device memory in one of two orientations, chosen at
// compile time:
//   A: K-major [M][K] (A_K = true) or M-major [K][M] (A_K = false)
//   B: K-major [N][K] (B_K = true) or N-major [K][N] (B_K = false)
// A K-major tile is staged in shared memory as [128][64 + 8] and read with
// ldmatrix; an M/N-major tile as [64][128 + 8] and read with ldmatrix.trans,
// so no operand is ever copied into another layout in device memory.  The
// 8-element row padding keeps the eight 16-byte rows of every ldmatrix
// phase in distinct banks.
//
// Every 16-byte vector of a tile is loaded under a predicate (storage row
// inside the operand, storage column inside it); a vector outside is
// zero-filled by cp.async, so ragged M, N and K need no padding copies.
// The contiguous extent of every operand must be a multiple of 8 elements
// (16 bytes), which the callers check.
//
// Accumulator layout of warp w (wm = w / 4 rows of 64, wn = w % 4 columns of
// kWN), lane l (g = l / 4, t = l % 4): acc[i][j][e] is the element
//   row m0 + wm * 64 + i * 16 + g + (e >= 2 ? 8 : 0)
//   col n0 + wn * kWN + j * 8 + 2 * t + (e & 1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace lce {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;          // 8 warps: 2 (rows) x 4 (columns)
constexpr int kWN = 64;                // columns per warp
constexpr int kNT = kWN / 8;           // n8 tiles per warp
constexpr int kBM = 128;
constexpr int kBN = 4 * kWN;
constexpr int kBK = 64;
constexpr int kStages = 3;
constexpr int kPad = 8;
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int kATileElems = cmax(kBM * (kBK + kPad), kBK * (kBM + kPad));
constexpr int kBTileElems = cmax(kBN * (kBK + kPad), kBK * (kBN + kPad));
constexpr int kStageElems = kATileElems + kBTileElems;
constexpr int kSmemBytes = kStages * kStageElems * 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b0, const uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One operand of the product: storage [rows][ld] with the storage rows
// [lo, rows) and the columns [0, cols) valid (cols a multiple of 8); a
// load outside reads 0.  K_MAJOR says whether its storage rows run over
// M/N (true) or over K (false).  `lo` lets a grouped product (gmm.cu) cut
// one group's rows out of a row tile.
struct Operand {
  const bf16* ptr;
  long long ld;
  int rows, cols;
  int lo = 0;
};

// Stage the tile (mn0.., k0..) of one operand, MN rows/columns wide, into
// shared memory `s`.
template <bool K_MAJOR, int MN>
__device__ __forceinline__ void load_tile(bf16* s, const Operand& op, int mn0,
                                          int k0, int tid) {
  if (K_MAJOR) {                       // [MN mn][kBK k] -> s[mn][k]
    constexpr int VPR = kBK / 8;
#pragma unroll
    for (int i = tid; i < MN * VPR; i += kThreads) {
      const int r = i / VPR, c = (i % VPR) * 8;
      const int gr = mn0 + r, gc = k0 + c;
      const bool ok = gr >= op.lo && gr < op.rows && gc < op.cols;
      const bf16* src = ok ? op.ptr + (size_t)gr * op.ld + gc : op.ptr;
      cp_async16(s + r * (kBK + kPad) + c, src, ok);
    }
  } else {                             // [kBK k][MN mn] -> s[k][mn]
    constexpr int VPR = MN / 8;
#pragma unroll
    for (int i = tid; i < kBK * VPR; i += kThreads) {
      const int r = i / VPR, c = (i % VPR) * 8;
      const int gr = k0 + r, gc = mn0 + c;
      const bool ok = gr >= op.lo && gr < op.rows && gc < op.cols;
      const bf16* src = ok ? op.ptr + (size_t)gr * op.ld + gc : op.ptr;
      cp_async16(s + r * (MN + kPad) + c, src, ok);
    }
  }
}

__device__ __forceinline__ void zero_acc(float acc[4][kNT][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// acc += A[m0:m0+kBM, 0:K] B[0:K, n0:n0+kBN]; `smem` holds kSmemBytes.
// Ends with a __syncthreads, so the caller may reuse `smem` at once.
template <bool A_K, bool B_K>
__device__ __forceinline__ void gemm_tile(float acc[4][kNT][4],
                                          const Operand& a, const Operand& b,
                                          int m0, int n0, int K, bf16* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int q = lane >> 3, r8 = lane & 7;
  const int KT = (K + kBK - 1) / kBK;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) {
      bf16* st = smem + s * kStageElems;
      load_tile<A_K, kBM>(st, a, m0, s * kBK, tid);
      load_tile<B_K, kBN>(st + kATileElems, b, n0, s * kBK, tid);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {   // refill the stage computed in the previous iteration
      const int nk = kt + kStages - 1;
      if (nk < KT) {
        bf16* st = smem + (nk % kStages) * kStageElems;
        load_tile<A_K, kBM>(st, a, m0, nk * kBK, tid);
        load_tile<B_K, kBN>(st + kATileElems, b, n0, nk * kBK, tid);
      }
      cp_async_commit();
    }
    const bf16* sa = smem + (kt % kStages) * kStageElems;
    const bf16* sb = sa + kATileElems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4];          // [m16 tile][a0..a3]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mb = wm * 64 + i * 16;
        if (A_K)
          ldsm_x4(af[i], sa + (mb + r8 + (q & 1) * 8) * (kBK + kPad) + kk +
                             (q >> 1) * 8);
        else
          ldsm_x4_t(af[i], sa + (kk + r8 + (q >> 1) * 8) * (kBM + kPad) + mb +
                               (q & 1) * 8);
      }
      uint32_t bfr[kNT / 2][4];   // [n8 tile pair][b0, b1 of each tile]
#pragma unroll
      for (int p = 0; p < kNT / 2; ++p) {
        const int nb = wn * kWN + p * 16;
        if (B_K)
          ldsm_x4(bfr[p], sb + (nb + r8 + (q >> 1) * 8) * (kBK + kPad) + kk +
                              (q & 1) * 8);
        else
          ldsm_x4_t(bfr[p], sb + (kk + r8 + (q & 1) * 8) * (kBN + kPad) + nb +
                                (q >> 1) * 8);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma_bf16(acc[i][j], af[i], bfr[j >> 1][(j & 1) * 2],
                   bfr[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// (tile_m, tile_n) of CTA `id` over an n_m x n_n grid of output tiles, row
// tiles fastest inside groups of `group_m` row tiles: the CTAs resident at
// one time cover a few column tiles of every row tile of their group, so
// they share the B tiles they read (and the group's A rows) through L2.
__device__ __forceinline__ void grouped_tile(int id, int n_m, int n_n,
                                             int group_m, int* tm, int* tn) {
  const int per_group = group_m * n_n;
  const int first = (id / per_group) * group_m;
  const int size = min(n_m - first, group_m);
  const int in_group = id % per_group;
  *tm = first + in_group % size;
  *tn = in_group / size;
}

inline int num_sms() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 132;
}

}  // namespace lce
