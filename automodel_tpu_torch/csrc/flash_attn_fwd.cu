// Training attention, forward, for Hopper (sm_90a); plain C interface for
// ctypes.
//
// Replaces the TPU kernel automodel_tpu/ops/splash_attention.py:129
// (_build_kernel: upstream Pallas splash attention, forward half), called
// by splash_attention_bshd (:183).  Same function, on the JAX package's
// layout: q [B, S, Hq, D], k/v [B, S, Hk, D] bf16 (Hq a multiple of Hk,
// no kv-head repeat), causal or full, packed-sequence segment ids [B, S]
// int32 (0 = padding: never attends, never attended), a static sliding
// window (attend [q - window + 1, q]), an optional logit soft cap
// cap * tanh(x / cap) and a softmax scale.  Writes out [B, S, Hq, D] bf16
// and the row log-sum-exp lse [B, Hq, S] fp32 that the backward needs.  A
// query row with no key to attend (segment 0, or an empty window) gets
// out = 0 and lse = 0.
//
// Design (simple and right first; FlashAttention-2 shape):
//   * one CTA per (64-row q tile, q head, batch row), 4 warps of 16 query
//     rows.  The CTA loops over 64-key tiles: the loop replaces splash's
//     sequential kv grid axis (CTAs run in no order on Hopper).  q tiles
//     are issued last-first so the long causal rows start early.
//   * kv tiles wholly in the causal future or wholly before the window are
//     never visited; with segments, a tile whose key segments all differ
//     from the q tile's is skipped after one block vote (splash skips only
//     by the static mask; the packed data skips more here).
//   * S = Q K^T and O += P V on the tensor cores (mma.sync m16n8k16 bf16,
//     fp32 accumulate), online softmax in fp32 registers, P rounded to
//     bf16 for the second product.  The scale is applied in fp32 inside
//     the kernel (splash folds it into q in q's dtype first).
//   * ragged edges are masked in the kernel, so any S works (no padding to
//     a block multiple).
//
// Bound: at the SFT shape (B 8, S 2048, Hq/Hk 32/8, D 64, packed
// segments) the work is bound by operations -- 4 * D * Hq * (attended
// pairs) on the bf16 tensor cores -- well above the bytes of q, k, v and
// out.  What the simple design leaves: operands go global -> registers ->
// smem with plain 16-byte loads and no copy/compute overlap (no cp.async /
// TMA pipeline), fragments are read from smem one 32-bit word at a time
// (no ldmatrix), and mma.sync instead of wgmma reaches at most about
// two thirds of the wgmma rate.  Those are later work.

#include "flash_attn_common.cuh"

namespace flash {
namespace {

constexpr int kBM = 64;   // query rows per CTA
constexpr int kBN = 64;   // keys per tile

template <int D>
constexpr int fwd_smem_bytes() {
  return (kBM + 2 * kBN) * (D + kPad) * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg,
                 bf16* __restrict__ out, float* __restrict__ lse, int S,
                 int Hq, int Hk, float scale, float cap, int causal,
                 int window) {
  constexpr int LD = D + kPad;
  constexpr int KD = D / 16;                 // k-chunks over head_dim
  constexpr int NT = kBN / 8;                // n-tiles of the score row
  constexpr int DT = D / 8;                  // n-tiles of the output row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + kBM * LD;
  bf16* v_s = k_s + kBN * LD;
  __shared__ int kseg_s[kBN];
  __shared__ int qseg_lo, qseg_hi;

  const int n_qt = (S + kBM - 1) / kBM;
  const int q0 = (n_qt - 1 - blockIdx.x) * kBM;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int has_seg = seg != nullptr;
  const int* seg_b = has_seg ? seg + (size_t)b * S : nullptr;

  load_rows<D, kBM>(q_s, q + ((size_t)b * S * Hq + hq) * D, (size_t)Hq * D,
                    q0, S, tid);
  if (tid == 0) {
    qseg_lo = 0x7fffffff;
    qseg_hi = 0;
  }
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  int qseg[2] = {1, 1};
  if (has_seg) {
#pragma unroll
    for (int i = 0; i < 2; ++i) qseg[i] = row[i] < S ? seg_b[row[i]] : 0;
  }
  __syncthreads();
  if (has_seg && tid < kBM && q0 + tid < S) {
    const int s = seg_b[q0 + tid];
    if (s != 0) {
      atomicMin(&qseg_lo, s);
      atomicMax(&qseg_hi, s);
    }
  }
  __syncthreads();

  uint32_t qa[KD][4];
#pragma unroll
  for (int kc = 0; kc < KD; ++kc) ld_a(qa[kc], q_s, LD, warp * 16, kc * 16, g, t);

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_lo = (kv_lo / kBN) * kBN;
  const int kv_hi = causal ? min(S, q0 + kBM) : S;
  const bool live = !has_seg || qseg_hi > 0;   // all-padding tile: no work

  for (int kv0 = kv_lo; live && kv0 < kv_hi; kv0 += kBN) {
    if (has_seg) {
      int s = 0;
      if (tid < kBN && kv0 + tid < S) s = seg_b[kv0 + tid];
      if (tid < kBN) kseg_s[tid] = s;
      const bool hit = tid < kBN && s != 0 && s >= qseg_lo && s <= qseg_hi;
      if (!__syncthreads_or(hit)) continue;
    }
    load_rows<D, kBN>(k_s, k + ((size_t)b * S * Hk + hk) * D, (size_t)Hk * D,
                      kv0, S, tid);
    load_rows<D, kBN>(v_s, v + ((size_t)b * S * Hk + hk) * D, (size_t)Hk * D,
                      kv0, S, tid);
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
        float x = sc[nt][e] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        const bool ok = allowed(row[i], kv0 + c, S, causal, window, has_seg,
                                qseg[i], has_seg ? kseg_s[c] : 0);
        sc[nt][e] = ok ? x : -INFINITY;
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
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    bf16* o_row = out + (((size_t)b * S + row[i]) * Hq + hq) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(o_row + dt * 8 + 2 * t) =
          pack_bf16(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
    if (t == 0)
      lse[((size_t)b * Hq + hq) * S + row[i]] =
          l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* seg,
           void* out, float* lse, int B, int S, int Hq, int Hk, float scale,
           float cap, int causal, int window, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBM - 1) / kBM, Hq, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), seg, static_cast<bf16*>(out), lse, S, Hq,
      Hk, scale, cap, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace flash

// Returns 0 on success, -1 for an unsupported head_dim, else the
// cudaError_t of the launch.  seg may be null (no segments); cap <= 0 is no
// soft cap; window <= 0 is no window.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const int* seg, void* out, float* lse, int B,
                              int S, int Hq, int Hk, int D, float scale,
                              float cap, int causal, int window,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return flash::launch<64>(q, k, v, seg, out, lse, B, S, Hq, Hk, scale,
                             cap, causal, window, st);
  if (D == 128)
    return flash::launch<128>(q, k, v, seg, out, lse, B, S, Hq, Hk, scale,
                              cap, causal, window, st);
  return -1;
}
