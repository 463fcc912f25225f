// Flash rung (MHA flash attention), forward, for Hopper (sm_90a); plain C
// interface for ctypes.
//
// Replaces the TPU kernel automodel_tpu/ops/flash_attention.py:66 (_flash:
// the upstream Pallas MHA flash kernel, forward half), called by
// flash_attention_bshd (:90).  Same function: q, k, v [B, H, S, D] bf16
// (MHA: the wrapper repeats kv heads for GQA), softmax(scale * q k^T) v,
// causal or full, segment ids [B, S] int32 with the upstream equality rule
// (segment 0 attends segment 0; flash_mha.cuh).  Writes out [B, H, S, D]
// bf16 and the row log-sum-exp lse [B, H, S] fp32 for the backward.
//
// Design (simple and right first; FlashAttention-2 shape, the layout of
// flash_attn_fwd.cu):
//   * one CTA per (64-row q tile, head, batch row), 4 warps of 16 query
//     rows, looping over 64-key tiles (the loop replaces the upstream
//     kernel's sequential kv grid axis); q tiles are issued last-first so
//     the long causal rows start early.
//   * kv tiles wholly in the causal future are never visited; with
//     segments a tile is skipped only when none of its key ids can equal
//     one of the q tile's (the SegSet vote).  Padding is a segment, so a
//     tile of padding rows is live work.
//   * S = Q K^T and O += P V on the tensor cores (mma.sync m16n8k16 bf16,
//     fp32 accumulate); online softmax in fp32 registers; P rounded to
//     bf16 for the second product; the scale applied to the fp32 scores,
//     as the upstream kernel does.
//
// Bound: at the SFT shape (B 8, S 2048, 32 heads, D 64, packed segments)
// the work is bound by operations -- 4 * D * H * (attended pairs) on the
// bf16 tensor cores -- well above the bytes of q, k, v and out.  What the
// simple design leaves: plain 16-byte loads without copy/compute overlap,
// per-word shared-memory fragment reads (no ldmatrix), mma.sync instead of
// wgmma; those are later work.

#include "flash_mha.cuh"

namespace flash {
namespace {

constexpr int kBM = 64;   // query rows per CTA
constexpr int kBN = 64;   // keys per tile

template <int D>
constexpr int mha_fwd_smem_bytes() {
  return (kBM + 2 * kBN) * (D + kPad) * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const int* __restrict__ seg,
               bf16* __restrict__ out, float* __restrict__ lse, int S, int H,
               float scale, int causal) {
  constexpr int LD = D + kPad;
  constexpr int KD = D / 16;                 // k-chunks over head_dim
  constexpr int NT = kBN / 8;                // n-tiles of the score row
  constexpr int DT = D / 8;                  // n-tiles of the output row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + kBM * LD;
  bf16* v_s = k_s + kBN * LD;
  __shared__ int kseg_s[kBN];
  __shared__ SegSet qset;

  const int n_qt = (S + kBM - 1) / kBM;
  const int q0 = (n_qt - 1 - blockIdx.x) * kBM;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * S;     // row (b, h, 0)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int has_seg = seg != nullptr;
  const int* seg_b = has_seg ? seg + (size_t)b * S : nullptr;

  load_rows<D, kBM>(q_s, q + head * D, D, q0, S, tid);
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  int qseg[2] = {0, 0};
  if (has_seg) {
#pragma unroll
    for (int i = 0; i < 2; ++i) qseg[i] = row[i] < S ? seg_b[row[i]] : 0;
    build_seg_set(&qset, seg_b, q0, kBM, S, tid);    // ends in a barrier
  } else {
    __syncthreads();
  }

  uint32_t qa[KD][4];
#pragma unroll
  for (int kc = 0; kc < KD; ++kc) ld_a(qa[kc], q_s, LD, warp * 16, kc * 16, g, t);

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int kv_hi = causal ? min(S, q0 + kBM) : S;
  for (int kv0 = 0; kv0 < kv_hi; kv0 += kBN) {
    if (has_seg && !tile_is_live(kseg_s, qset, seg_b, kv0, kBN, S, tid))
      continue;
    load_rows<D, kBN>(k_s, k + head * D, D, kv0, S, tid);
    load_rows<D, kBN>(v_s, v + head * D, D, kv0, S, tid);
    __syncthreads();

    // scores of this warp's 16 rows against the 64 keys
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KD; ++kc) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bb[2];
        ld_b_nk(bb, k_s, LD, nt * 8, kc * 16, g, t);
        mma_bf16(sc[nt], qa[kc], bb);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = nt * 8 + 2 * t + (e & 1);
        const bool ok = allowed_eq(row[i], kv0 + c, S, causal, has_seg,
                                   qseg[i], has_seg ? kseg_s[c] : 0);
        sc[nt][e] = ok ? sc[nt][e] * scale : -INFINITY;
      }
    }
    // online softmax: row g (i = 0) and row g + 8 (i = 1), each held by
    // the 4 lanes of a quad
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mx = fmaxf(mx, fmaxf(sc[nt][2 * i], sc[nt][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float ref = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = __expf(m[i] - ref);
      float ps = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float p0 = __expf(sc[nt][2 * i] - ref);
        const float p1 = __expf(sc[nt][2 * i + 1] - ref);
        sc[nt][2 * i] = p0;
        sc[nt][2 * i + 1] = p1;
        ps += p0 + p1;
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][2 * i] *= alpha;
        o[dt][2 * i + 1] *= alpha;
      }
    }
    // O += P V
#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc) {
      uint32_t pa[4];
      c_to_a(pa, sc[2 * kc], sc[2 * kc + 1]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t bb[2];
        ld_b_kn(bb, v_s, LD, kc * 16, dt * 8, g, t);
        mma_bf16(o[dt], pa, bb);
      }
    }
    __syncthreads();              // k_s / v_s / kseg_s free for the next tile
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
    // every row attends at least itself, so l > 0; the guard keeps a
    // malformed call finite
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    bf16* o_row = out + (head + row[i]) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(o_row + dt * 8 + 2 * t) =
          pack_bf16(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
    if (t == 0) lse[head + row[i]] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* seg,
           void* out, float* lse, int B, int S, int H, float scale,
           int causal, cudaStream_t stream) {
  constexpr int smem = mha_fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      mha_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBM - 1) / kBM, H, B);
  mha_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), seg, static_cast<bf16*>(out), lse, S, H,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace flash

// Returns 0 on success, -1 for an unsupported head_dim, else the
// cudaError_t of the launch.  seg may be null (no segments).
extern "C" int flash_mha_fwd(const void* q, const void* k, const void* v,
                             const int* seg, void* out, float* lse, int B,
                             int S, int H, int D, float scale, int causal,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return flash::launch<64>(q, k, v, seg, out, lse, B, S, H, scale, causal,
                             st);
  if (D == 128)
    return flash::launch<128>(q, k, v, seg, out, lse, B, S, H, scale, causal,
                              st);
  return -1;
}
