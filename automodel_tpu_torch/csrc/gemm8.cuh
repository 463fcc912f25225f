// The quantize pass of the quantized matmuls (qdot.cu, gmm_quant.cu) and
// the helpers their epilogues share.  Both products run on wgmma_gemm.cuh
// over the 8-bit codes this pass writes: K-major in device memory
// ([rows][ld] bytes), the only layout 8-bit wgmma reads.
//
// int8 x int8 sums are exact in int32 (|sum| <= K * 127^2 < 2^31 for K <
// 133,000); e4m3 / e5m2 sums are fp32 with a promotion every 128 of K
// (qdot.cu's note says why).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace g8 {

enum QType : int { kS8 = 0, kE4M3 = 1, kE5M2 = 2 };

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
// ops/quant.py::quant_cast's bit for bit; s > 0, so a zero x is its own
// quotient and skips the division, whose slow path takes zero numerators),
// then int8: clip to +-127 and round half to even by adding 1.5 * 2^23,
// whose low byte is then the two's-complement code (clip-then-round and
// round-then-clip give the same codes); e4m3 / e5m2: round to nearest
// even, saturating to +-qmax (the same codes as clipping first).
template <int QT>
__device__ __forceinline__ uint32_t quant8(float x, float s) {
  const float v = x == 0.f ? x : __fdiv_rn(x, s);
  if constexpr (QT == kS8) {
    const float c = fminf(fmaxf(v, -127.f), 127.f);
    return __float_as_uint(c + 12582912.f) & 0xffu;
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

// X logical [MN][K] bf16 stored K-major (X[mn][k] at p[mn * ld + k]) ->
// codes q [MN][kp] (codes past K are 0), scale[mn * sstride]; blockIdx.y
// walks a batch of such operands (the MoE experts): p, scale and q advance
// by p_batch, s_batch and MN * kp.  Elementwise, no shared memory: each
// thread quantizes kKChunks chunks of 16 consecutive k of one row (both
// chunks' 16-byte loads issued first) and stores each chunk's codes with
// one 16-byte store.
constexpr int kKChunks = 2;

template <int QT>
__global__ void __launch_bounds__(256)
pack_kmajor(const uint16_t* __restrict__ p, long long ld, long long p_batch,
            const float* __restrict__ scale, int sstride, long long s_batch,
            int MN, int K, int kp, uint8_t* __restrict__ q) {
  p += blockIdx.y * p_batch;
  scale += blockIdx.y * s_batch;
  q += blockIdx.y * (long long)MN * kp;
  const int per_row = kp >> 4, total = MN * per_row;
  const int c0 = blockIdx.x * kKChunks * 256 + threadIdx.x;
  uint4 x[kKChunks][2];
  int mn[kKChunks], k[kKChunks];
#pragma unroll
  for (int u = 0; u < kKChunks; ++u) {
    const int c = c0 + u * 256;
    mn[u] = c / per_row;
    k[u] = (c - mn[u] * per_row) << 4;
    const uint16_t* src = p + (long long)mn[u] * ld + k[u];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      x[u][h] = c < total && k[u] + 8 * h < K
          ? *reinterpret_cast<const uint4*>(src + 8 * h)
          : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int u = 0; u < kKChunks; ++u) {
    if (c0 + u * 256 >= total) continue;
    const float sc = scale[(long long)mn[u] * sstride];
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t b = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        b |= quant8<QT>(bf16_at(x[u][i >> 1], 4 * (i & 1) + e), sc)
             << (8 * e);
      w[i] = b;
    }
    *reinterpret_cast<uint4*>(q + (long long)mn[u] * kp + k[u]) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The same from MN-major storage (X[mn][k] at p[k * ld + mn]), transposed
// through shared memory: a CTA takes a tile of 128 k x 64 mn; thread (kb =
// t / 8, mb = t % 8) loads 4 k rows of 8 mn (16 bytes each, coalesced over
// mb), quantizes them and transposes the 4 x 8 codes in registers into 8
// words, one per mn holding its 4 k codes, which go into a [64 mn][128 k]
// tile whose 16-byte chunks are swizzled by mn / 8 (the warp's 32 word
// stores fall in 32 banks); then each thread stores two 16-byte chunks of
// the K-major codes.
template <int QT>
__global__ void __launch_bounds__(256)
pack_mnmajor(const uint16_t* __restrict__ p, long long ld, long long p_batch,
             const float* __restrict__ scale, int sstride, long long s_batch,
             int MN, int K, int kp, uint8_t* __restrict__ q) {
  __shared__ __align__(16) uint32_t tile[64][32];
  p += blockIdx.z * p_batch;
  scale += blockIdx.z * s_batch;
  q += blockIdx.z * (long long)MN * kp;
  const int mn0 = blockIdx.x * 64, k0 = blockIdx.y * 128, t = threadIdx.x;
  const int kb = t >> 3, mb = t & 7, mn = mn0 + 8 * mb;
  uint4 x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * kb + i;
    x[i] = k < K && mn < MN
        ? *reinterpret_cast<const uint4*>(p + (long long)k * ld + mn)
        : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float sc = scale[(long long)min(mn + e, MN - 1) * sstride];
    uint32_t b = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      b |= quant8<QT>(bf16_at(x[i], e), sc) << (8 * i);
    tile[8 * mb + e][(((kb >> 2) ^ mb) << 2) | (kb & 3)] = b;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int v = t + j * 256, r = v >> 3, c = v & 7;   // row, 16-byte chunk
    const int m = mn0 + r, k = k0 + 16 * c;
    if (m < MN && k < kp)
      *reinterpret_cast<uint4*>(q + (long long)m * kp + k) =
          *reinterpret_cast<const uint4*>(&tile[r][(c ^ (r >> 3)) << 2]);
  }
}

template <int QT>
int pack_as(const void* x, long long ld, long long x_batch, int k_major,
            const float* scale, int sstride, long long s_batch, int MN,
            int K, int kp, void* q, int batches, cudaStream_t s) {
  const auto src = static_cast<const uint16_t*>(x);
  const auto dst = static_cast<uint8_t*>(q);
  if (k_major) {
    const long long chunks = (long long)MN * (kp >> 4);
    if (chunks >= (1LL << 31) - kKChunks * 256) return -1;
    const dim3 grid(static_cast<unsigned>(
                        (chunks + kKChunks * 256 - 1) / (kKChunks * 256)),
                    batches);
    pack_kmajor<QT><<<grid, 256, 0, s>>>(src, ld, x_batch, scale, sstride,
                                         s_batch, MN, K, kp, dst);
  } else {
    const dim3 grid((MN + 63) / 64, (kp + 127) / 128, batches);
    pack_mnmajor<QT><<<grid, 256, 0, s>>>(src, ld, x_batch, scale, sstride,
                                          s_batch, MN, K, kp, dst);
  }
  return static_cast<int>(cudaGetLastError());
}

// Quantize `batches` operands of type qt (kS8, kE4M3, kE5M2) into K-major
// codes [batches][MN][kp] with positive scales; the vectorised dimension
// (K when k_major, else MN), ld and x_batch are multiples of 8, kp a
// multiple of 16 >= K.
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
