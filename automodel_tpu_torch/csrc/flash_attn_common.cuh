// Shared pieces of the training-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): bf16 tensor-core fragments of mma.sync m16n8k16, the
// row-tile loader and the attention mask.
//
// Fragment layout of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// for lane l, g = l / 4, t = l % 4 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"):
//   A 16x16 (row-major):  a0 = (g, 2t..2t+1)  a1 = (g+8, 2t..)
//                         a2 = (g, 2t+8..)    a3 = (g+8, 2t+8..)
//   B 16x8  (k x n):      b0 = (k 2t..2t+1, n g)  b1 = (k 2t+8.., n g)
//   C 16x8  (fp32):       c0,c1 = (g, 2t..2t+1)   c2,c3 = (g+8, 2t..)
// Each 32-bit register holds two bf16, the lower column (or k) in the low
// half.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;     // 4 warps
constexpr int kPad = 8;           // smem row padding (bf16): 16 bytes

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two consecutive bf16 of one smem row (even column)
__device__ __forceinline__ uint32_t ld_pair(const bf16* s, int ld, int r,
                                            int c) {
  return *reinterpret_cast<const uint32_t*>(s + r * ld + c);
}

// (r, c) and (r + 1, c) of an smem tile: two rows, one column
__device__ __forceinline__ uint32_t ld_col_pair(const bf16* s, int ld, int r,
                                                int c) {
  const uint32_t lo = __bfloat16_as_ushort(s[r * ld + c]);
  const uint32_t hi = __bfloat16_as_ushort(s[(r + 1) * ld + c]);
  return lo | (hi << 16);
}

// A = s[m][k] (row-major), rows m0..m0+15, columns k0..k0+15
__device__ __forceinline__ void ld_a(uint32_t a[4], const bf16* s, int ld,
                                     int m0, int k0, int g, int t) {
  a[0] = ld_pair(s, ld, m0 + g, k0 + 2 * t);
  a[1] = ld_pair(s, ld, m0 + g + 8, k0 + 2 * t);
  a[2] = ld_pair(s, ld, m0 + g, k0 + 2 * t + 8);
  a[3] = ld_pair(s, ld, m0 + g + 8, k0 + 2 * t + 8);
}

// A(m, k) = s[k][m] (stored transposed)
__device__ __forceinline__ void ld_a_t(uint32_t a[4], const bf16* s, int ld,
                                       int m0, int k0, int g, int t) {
  a[0] = ld_col_pair(s, ld, k0 + 2 * t, m0 + g);
  a[1] = ld_col_pair(s, ld, k0 + 2 * t, m0 + g + 8);
  a[2] = ld_col_pair(s, ld, k0 + 2 * t + 8, m0 + g);
  a[3] = ld_col_pair(s, ld, k0 + 2 * t + 8, m0 + g + 8);
}

// B(k, n) = s[n][k]: n0..n0+7, k0..k0+15 (pairs contiguous along k)
__device__ __forceinline__ void ld_b_nk(uint32_t b[2], const bf16* s, int ld,
                                        int n0, int k0, int g, int t) {
  b[0] = ld_pair(s, ld, n0 + g, k0 + 2 * t);
  b[1] = ld_pair(s, ld, n0 + g, k0 + 2 * t + 8);
}

// B(k, n) = s[k][n]
__device__ __forceinline__ void ld_b_kn(uint32_t b[2], const bf16* s, int ld,
                                        int k0, int n0, int g, int t) {
  b[0] = ld_col_pair(s, ld, k0 + 2 * t, n0 + g);
  b[1] = ld_col_pair(s, ld, k0 + 2 * t + 8, n0 + g);
}

// A fragment of the 16 columns kc*16.. of a 16 x N fp32 C-tile array
// (c[n-tile][4]) rounded to bf16: the accumulator of one product is the
// left operand of the next.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float* c0,
                                       const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// ROWS rows of D bf16 from global (row r at src + r * row_stride) into
// smem rows of ld = D + kPad; rows at or past S are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          size_t row_stride, int row0, int S,
                                          int tid) {
  constexpr int VPR = D / 8;                 // 16-byte vectors per row
  constexpr int LD = D + kPad;
#pragma unroll
  for (int i = tid; i < ROWS * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) *
                                                      row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// May query row `qi` attend key `kj`?  seg_q / seg_k are the two segment
// ids (segment 0 is padding and attends nothing); has_seg = 0 ignores them.
__device__ __forceinline__ bool allowed(int qi, int kj, int S, int causal,
                                        int window, int has_seg, int seg_q,
                                        int seg_k) {
  return qi < S && kj < S && (!causal || kj <= qi) &&
         (window <= 0 || qi - kj < window) &&
         (!has_seg || (seg_q == seg_k && seg_k != 0));
}

}  // namespace flash
