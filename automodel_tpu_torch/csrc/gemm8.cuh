// The 8-bit tile product of gmm_quant.cu and the quantize pass of the
// quantized matmuls (qdot.cu, gmm_quant.cu; qdot's product runs on
// wgmma_gemm.cuh).  The product: one CTA of 8 warps computes a
// 128 x 256 tile C = A B over a K loop with both operands 8-bit -- int8 x
// int8 (int32 sums, exact) or e4m3 / e5m2 in any pairing (fp32 sums) -- on
// the tensor cores (mma.sync m16n8k32); each warp owns a 64 x 64 block, so
// 8 ldmatrix.x4 feed 32 mma per 32-deep step.
//
// 8-bit mma.sync takes .row.col operands only and ldmatrix has no byte-wise
// .trans, so both operands are K-major in device memory ([rows][ld] bytes,
// the quantized copies pack() writes) and in shared memory: A as [128 m][64 k]
// bytes, B as [256 n][64 k] bytes, each row padded to 80 bytes so the eight
// 16-byte rows of every ldmatrix phase fall in distinct banks.  ldmatrix.x4
// of the b16 view hands each lane 4 consecutive k bytes of one row, which
// is the m16n8k32 fragment layout of A (rows g / g + 8, k 4t.. and 16 + 4t..)
// and of B (column g, k 4t.. and 16 + 4t..).  Tiles stream through a
// 3-stage cp.async pipeline; every 16-byte vector is loaded under a
// predicate (storage row inside [lo, hi), k inside K) and zero-filled
// outside, so ragged edges need no padding copies (K a multiple of 16).
//
// On sm_90a only int8 runs natively in mma.sync (SASS IMMA.16832.S8.S8);
// ptxas lowers an e4m3 / e5m2 mma.sync to an fp8 -> f16 unpack of the
// fragments (F2FP.F16.E4M3.UNPACK_B) and f16 MMAs (HMMA.16816.F32), so fp8
// here runs at the f16 tensor-core rate at best, plus the unpacks and
// their registers: Hopper's fp8 rate is wgmma's (wgmma_gemm.cuh).  The same
// lowering keeps fp8 sums in a true fp32 accumulator: the DeepSeek-V3
// report (section 3.3.2) found Hopper's fp8 wgmma keeping about 14 bits of
// the sums over long K, and fp8 GEMMs add each 128 of K into separate fp32
// registers for that; measured here (an H100 80GB HBM3 at 700 W,
// all-positive e4m3 / e5m2 operands so that no error cancels), relative L2
// against float64 sums was 2.2e-7 at K = 8192 and 3.0e-7 at K = 16384
// without that promotion, 1.2e-7 / 1.6e-7 with it, which cost 64 registers,
// spills and 12 % of the time.  So there is none.  int8 sums are exact in
// int32 (|sum| <= K * 127^2 < 2^31 for K < 133,000).
//
// Accumulator layout of warp w (wm = w / 4 rows of 64, wn = w % 4 columns of
// 64), lane l (g = l / 4, t = l % 4): acc[i][j][e] is the element
//   row m0 + wm * 64 + i * 16 + g + (e >= 2 ? 8 : 0)
//   col n0 + wn * 64 + j * 8 + 2 * t + (e & 1).

#pragma once

#include <cuda_fp8.h>
#include <type_traits>

#include "linear_ce_gemm.cuh"   // cp.async, bf16, grouped_tile, num_sms

namespace g8 {

using lce::cp_async16;
using lce::cp_async_commit;
using lce::cp_async_wait;
using lce::smem_u32;

enum QType : int { kS8 = 0, kE4M3 = 1, kE5M2 = 2 };

constexpr int kThreads = 256;         // 8 warps: 2 (rows) x 4 (columns)
constexpr int kWN = 64;               // columns per warp
constexpr int kBM = 128;
constexpr int kBN = 4 * kWN;
constexpr int kBK = 64;               // k elements (= bytes) per tile
constexpr int kMT = 4;                // m16 tiles per warp
constexpr int kNT = kWN / 8;          // n8 tiles per warp
constexpr int kLd = kBK + 16;         // shared row pitch in bytes
constexpr int kATileBytes = kBM * kLd;
constexpr int kStageBytes = (kBM + kBN) * kLd;
constexpr int kStages = 3;
constexpr int kSmemBytes = kStages * kStageBytes;

template <int QA, int QB>
using AccT =
    typename std::conditional<QA == kS8 && QB == kS8, int, float>::type;

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const uint8_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

#define G8_MMA_F32(TA, TB)                                                   \
  asm volatile("mma.sync.aligned.m16n8k32.row.col.f32." TA "." TB ".f32 "    \
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "              \
               "{%0, %1, %2, %3};\n"                                         \
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),        \
                 "r"(b1))

// c += a b for one m16n8k32 tile, fp8 operands, fp32 sums
template <int QA, int QB>
__device__ __forceinline__ void mma8(float c[4], const uint32_t a[4],
                                     uint32_t b0, uint32_t b1) {
  static_assert(QA != kS8 && QB != kS8, "int8 pairs only with int8");
  if constexpr (QA == kE4M3 && QB == kE4M3) G8_MMA_F32("e4m3", "e4m3");
  else if constexpr (QA == kE5M2 && QB == kE4M3) G8_MMA_F32("e5m2", "e4m3");
  else if constexpr (QA == kE4M3 && QB == kE5M2) G8_MMA_F32("e4m3", "e5m2");
  else G8_MMA_F32("e5m2", "e5m2");
}

#undef G8_MMA_F32

// c += a b for one m16n8k32 tile, int8 operands, int32 sums
template <int QA, int QB>
__device__ __forceinline__ void mma8(int c[4], const uint32_t a[4],
                                     uint32_t b0, uint32_t b1) {
  static_assert(QA == kS8 && QB == kS8, "int8 pairs only with int8");
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A_tile B_tile over one kBK-deep pair of shared tiles
template <int QA, int QB, typename T>
__device__ __forceinline__ void mma_tile(T acc[kMT][kNT][4],
                                         const uint8_t* sa,
                                         const uint8_t* sb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3, q = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 32) {
    uint32_t af[kMT][4];      // a0..a3 of each m16 tile
#pragma unroll
    for (int i = 0; i < kMT; ++i)
      ldsm_x4(af[i], sa + (wm * 64 + i * 16 + r8 + (q & 1) * 8) * kLd + kk +
                         (q >> 1) * 16);
    uint32_t bfr[kNT / 2][4]; // b0, b1 of two n8 tiles each
#pragma unroll
    for (int p = 0; p < kNT / 2; ++p)
      ldsm_x4(bfr[p], sb + (wn * kWN + p * 16 + r8 + (q >> 1) * 8) * kLd +
                          kk + (q & 1) * 16);
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        mma8<QA, QB>(acc[i][j], af[i], bfr[j >> 1][(j & 1) * 2],
                     bfr[j >> 1][(j & 1) * 2 + 1]);
  }
}

template <typename T>
__device__ __forceinline__ void zero(T acc[kMT][kNT][4]) {
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = T(0);
}

// one operand's k tile [ROWS][kBK bytes] from K-major storage [rows][ld]
// with the storage rows [lo, hi) and k < K valid, the rest zero-filled
template <int ROWS>
__device__ __forceinline__ void load8(uint8_t* s, const uint8_t* p,
                                      long long ld, int lo, int hi, int K,
                                      int r0, int k0, int tid) {
#pragma unroll
  for (int j = 0; j < ROWS * (kBK / 16) / kThreads; ++j) {
    const int v = tid + j * kThreads, r = v >> 2, c = (v & 3) * 16;
    const int gr = r0 + r, gc = k0 + c;
    const bool ok = gr >= lo && gr < hi && gc < K;
    cp_async16(s + r * kLd + c, ok ? p + (long long)gr * ld + gc : p, ok);
  }
}

// acc += A[rows lo..hi of the tile m0..] B^T over K: A [.][lda] and B
// [N][ldb] K-major 8-bit; `smem` holds kSmemBytes.  Ends with a
// __syncthreads, so the caller may reuse `smem`.
template <int QA, int QB, typename T>
__device__ __forceinline__ void product(T acc[kMT][kNT][4],
                                        const uint8_t* A, long long lda,
                                        int lo, int hi, const uint8_t* B,
                                        long long ldb, int N, int m0, int n0,
                                        int K, uint8_t* smem) {
  const int tid = threadIdx.x;
  const int KT = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) {
      uint8_t* st = smem + s * kStageBytes;
      load8<kBM>(st, A, lda, lo, hi, K, m0, s * kBK, tid);
      load8<kBN>(st + kATileBytes, B, ldb, 0, N, K, n0, s * kBK, tid);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {   // refill the stage computed in the previous iteration
      const int nk = kt + kStages - 1;
      if (nk < KT) {
        uint8_t* st = smem + (nk % kStages) * kStageBytes;
        load8<kBM>(st, A, lda, lo, hi, K, m0, nk * kBK, tid);
        load8<kBN>(st + kATileBytes, B, ldb, 0, N, K, n0, nk * kBK, tid);
      }
      cp_async_commit();
    }
    const uint8_t* st = smem + (kt % kStages) * kStageBytes;
    mma_tile<QA, QB>(acc, st, st + kATileBytes);
  }
  cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ float as_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float as_f32(float v) { return v; }

// out[row][col], out[row][col + 1] in fp32 or bf16 (round to nearest even,
// the cast of the same fp32 value): out's column stride `ocs` is 1 (a
// pair store) or its row stride `ors` is 1 (a transposed output)
__device__ __forceinline__ void store2(void* out, long long ors,
                                       long long ocs, bool bf16_out, int row,
                                       int col, float v0, float v1) {
  if (ocs == 1) {
    const long long o = (long long)row * ors + col;
    if (bf16_out)
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                         o) = __floats2bfloat162_rn(v0, v1);
    else
      *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
          make_float2(v0, v1);
  } else {
    const long long o = (long long)row * ors + (long long)col * ocs;
    if (bf16_out) {
      __nv_bfloat16* p = static_cast<__nv_bfloat16*>(out);
      p[o] = __float2bfloat16_rn(v0);
      p[o + ocs] = __float2bfloat16_rn(v1);
    } else {
      float* p = static_cast<float*>(out);
      p[o] = v0;
      p[o + ocs] = v1;
    }
  }
}

// ---------------------------------------------------------------------------
// The quantize pass: bf16 -> 8-bit codes, K-major, once per element
// ---------------------------------------------------------------------------
// quant(x, s) = x / s (IEEE fp32 division: no reciprocal, so the codes are
// ops/quant.py::quant_cast's bit for bit), then int8: round half to even and
// clip to +-127; e4m3 / e5m2: round to nearest even, saturating to +-qmax
// (the same codes as clipping first).
template <int QT>
__device__ __forceinline__ uint32_t quant8(float x, float s) {
  const float v = __fdiv_rn(x, s);
  if constexpr (QT == kS8) {
    const float r = fminf(fmaxf(rintf(v), -127.f), 127.f);
    return static_cast<uint32_t>(__float2int_rn(r)) & 0xffu;
  } else if constexpr (QT == kE4M3) {
    return __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
  } else {
    return __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E5M2);
  }
}

// element e (0..7) of 8 packed bf16 as fp32
__device__ __forceinline__ float bf16_at(const uint4& v, int e) {
  const int i = e >> 1;
  const uint32_t w = i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

constexpr int kPT = 64;                 // pack tile: 64 mn x 64 k
constexpr int kPLd = kPT + 16;          // its shared row pitch in bytes

// q [MN][kp] <- quant(X) for X logical [MN][K] bf16 stored K-major (X[mn][k]
// at p[mn * ld + k]) or MN-major (at p[k * ld + mn]), scale[mn * sstride];
// codes past K are 0.  blockIdx.z walks a batch of such operands (the MoE
// experts): p, scale and q advance by p_batch, s_batch and MN * kp.  One CTA
// per 64 x 64 (mn, k) tile loads 16-byte vectors, quantizes them and writes
// the codes K-major through shared memory, where an MN-major tile is
// transposed: 1 byte written for every 2 read.
template <bool K_MAJOR, int QT>
__global__ void __launch_bounds__(256)
pack_kernel(const uint16_t* __restrict__ p, long long ld, long long p_batch,
            const float* __restrict__ scale, int sstride, long long s_batch,
            int MN, int K, int kp, uint8_t* __restrict__ q) {
  __shared__ __align__(16) uint8_t tile[kPT][kPLd];
  p += blockIdx.z * p_batch;
  scale += blockIdx.z * s_batch;
  q += blockIdx.z * (long long)MN * kp;
  const int mn0 = blockIdx.x * kPT, k0 = blockIdx.y * kPT, tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < 2; ++j) {         // 64 x 8 vectors of 8 elements
    const int v = tid + j * 256, r = v >> 3, c = (v & 7) * 8;
    if (K_MAJOR) {                      // row r = mn, 8 consecutive k
      const int mn = mn0 + r, k = k0 + c;
      const uint4 x = mn < MN && k < K
          ? *reinterpret_cast<const uint4*>(p + (long long)mn * ld + k)
          : make_uint4(0u, 0u, 0u, 0u);
      const float sc = scale[(long long)min(mn, MN - 1) * sstride];
      uint32_t b[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) b[e] = quant8<QT>(bf16_at(x, e), sc);
      *reinterpret_cast<uint2*>(&tile[r][c]) =
          make_uint2(b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24,
                     b[4] | b[5] << 8 | b[6] << 16 | b[7] << 24);
    } else {                            // row r = k, 8 consecutive mn
      const int k = k0 + r, mn = mn0 + c;
      const uint4 x = k < K && mn < MN
          ? *reinterpret_cast<const uint4*>(p + (long long)k * ld + mn)
          : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        tile[c + e][r] = static_cast<uint8_t>(quant8<QT>(
            bf16_at(x, e),
            scale[(long long)min(mn + e, MN - 1) * sstride]));
    }
  }
  __syncthreads();
  const int r = tid >> 2, c = (tid & 3) * 16;   // 64 rows x 4 x 16 bytes
  const int mn = mn0 + r, k = k0 + c;
  if (mn < MN && k < kp)
    *reinterpret_cast<uint4*>(q + (long long)mn * kp + k) =
        *reinterpret_cast<const uint4*>(&tile[r][c]);
}

template <int QT>
int pack_as(const void* x, long long ld, long long x_batch, int k_major,
            const float* scale, int sstride, long long s_batch, int MN,
            int K, int kp, void* q, int batches, cudaStream_t s) {
  const dim3 grid((MN + kPT - 1) / kPT, (kp + kPT - 1) / kPT, batches);
  const auto src = static_cast<const uint16_t*>(x);
  const auto dst = static_cast<uint8_t*>(q);
  if (k_major)
    pack_kernel<true, QT><<<grid, 256, 0, s>>>(src, ld, x_batch, scale,
                                               sstride, s_batch, MN, K, kp,
                                               dst);
  else
    pack_kernel<false, QT><<<grid, 256, 0, s>>>(src, ld, x_batch, scale,
                                                sstride, s_batch, MN, K, kp,
                                                dst);
  return static_cast<int>(cudaGetLastError());
}

// Quantize `batches` operands of type qt (kS8, kE4M3, kE5M2) into K-major
// codes [batches][MN][kp]; the vectorised dimension (K when k_major, else
// MN), ld and x_batch are multiples of 8, kp a multiple of 16 >= K.
inline int pack(int qt, const void* x, long long ld, long long x_batch,
                int k_major, const float* scale, int sstride,
                long long s_batch, int MN, int K, int kp, void* q,
                int batches, cudaStream_t s) {
  if (qt == kS8)
    return pack_as<kS8>(x, ld, x_batch, k_major, scale, sstride, s_batch, MN,
                        K, kp, q, batches, s);
  if (qt == kE4M3)
    return pack_as<kE4M3>(x, ld, x_batch, k_major, scale, sstride, s_batch,
                          MN, K, kp, q, batches, s);
  return pack_as<kE5M2>(x, ld, x_batch, k_major, scale, sstride, s_batch, MN,
                        K, kp, q, batches, s);
}

}  // namespace g8
