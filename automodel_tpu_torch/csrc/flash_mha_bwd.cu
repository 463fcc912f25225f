// Flash rung (MHA flash attention), backward, for Hopper (sm_90a); plain C
// interface for ctypes.
//
// Replaces the TPU kernel automodel_tpu/ops/flash_attention.py:66 (_flash:
// the upstream Pallas MHA flash kernel, its backward: separate dkv and dq
// passes), called by flash_attention_bshd (:90).  Inputs are the forward's
// operands and results: q, k, v, out, dout [B, H, S, D] bf16, lse [B, H, S]
// fp32, segment ids [B, S] (equality rule, flash_mha.cuh).  Outputs dq, dk,
// dv [B, H, S, D] bf16.
//
// Three kernels, launched in order on the caller's stream:
//   1. delta[b, h, s] = sum_d dout * out (fp32), one warp per row;
//   2. dK/dV: one CTA per (64-key tile, head, batch row) loops over the q
//      tiles that can see its keys:
//        P = exp(scale * S - lse)   dV += P^T dO   dP = dO V^T
//        dS = P * (dP - delta)      dK += dS^T Q
//      computed as S^T = K Q^T, so that P^T and dS^T come out of the
//      accumulators in the left-operand layout of dV and dK; dK and dV are
//      summed in registers and written once;
//   3. dQ: one CTA per (64-row q tile, head, batch row) loops over the kv
//      tiles its rows can see, recomputes P and dS and sums dQ += dS K in
//      registers.
//   Split, as the upstream kernel is, rather than fused: the fused form
//   (flash_attn_bwd.cu) sums dQ across kv tiles with fp32 atomics, whose
//   order changes from run to run; here every output element is written
//   by one thread once, so the backward is deterministic, at the cost of
//   computing the scores and dP twice.  A q or kv tile is skipped only when
//   no (q, k) pair in it can match under equality and causality (padding
//   tiles are live work).
//
// Bound: operations -- 10 * D * H * (attended pairs) over the bf16
// tensor-core rate (the split recomputes two of the products: 14 are
// done).  The simple design pays on top: plain 16-byte loads without
// copy/compute overlap, per-element shared-memory fragment reads for the
// transposed operands (no ldmatrix.trans), mma.sync instead of wgmma.

#include "flash_mha.cuh"

namespace flash {
namespace {

constexpr int kBM = 64;   // query rows per dQ CTA
constexpr int kBN = 64;   // keys per dK/dV CTA and per dQ kv tile

template <int D>
struct DkvTile {
  // query rows per inner tile: 64 at head_dim 64; 32 at 128, which keeps
  // the dK/dV accumulators (2 * D/8 * 4 floats) plus the score tiles inside
  // the register file
  static constexpr int BM = D == 64 ? 64 : 32;
  static constexpr int LD = D + kPad;
  static constexpr int kSmemBytes = (2 * kBN + 2 * BM) * LD * 2 + 2 * BM * 4;
};

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * kBM + 2 * kBN) * (D + kPad) * 2;
}

__global__ void __launch_bounds__(kThreads)
mha_delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                 float* __restrict__ delta, int rows, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kThreads / 32) + warp;   // (b * H + h) * S + s
  if (r >= rows) return;
  const bf16* o = out + (size_t)r * D;
  const bf16* d = dout + (size_t)r * D;
  float acc = 0.f;
  for (int i = 2 * lane; i < D; i += 64) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(o + i));
    const float2 c = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(d + i));
    acc += a.x * c.x + a.y * c.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
mha_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ seg, bf16* __restrict__ dk,
               bf16* __restrict__ dv, int S, int H, float scale, int causal) {
  using T = DkvTile<D>;
  constexpr int BM = T::BM, LD = T::LD;
  constexpr int KD = D / 16;                // k-chunks over head_dim
  constexpr int NQ = BM / 8;                // n-tiles over the q tile
  constexpr int DT = D / 8;                 // n-tiles over head_dim
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kBN * LD;
  bf16* q_s = v_s + kBN * LD;
  bf16* do_s = q_s + BM * LD;
  float* lse_s = reinterpret_cast<float*>(do_s + BM * LD);
  float* dl_s = lse_s + BM;
  __shared__ int qseg_s[BM];
  __shared__ SegSet kset;

  const int k0 = blockIdx.x * kBN, h = blockIdx.y, b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * S;     // row (b, h, 0)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int has_seg = seg != nullptr;
  const int* seg_b = has_seg ? seg + (size_t)b * S : nullptr;

  load_rows<D, kBN>(k_s, k + head * D, D, k0, S, tid);
  load_rows<D, kBN>(v_s, v + head * D, D, k0, S, tid);
  // this thread's key rows in the S^T accumulators
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  int kseg[2] = {0, 0};
  if (has_seg) {
#pragma unroll
    for (int i = 0; i < 2; ++i) kseg[i] = key[i] < S ? seg_b[key[i]] : 0;
    build_seg_set(&kset, seg_b, k0, kBN, S, tid);    // ends in a barrier
  } else {
    __syncthreads();
  }

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  const bf16* q_h = q + head * D;
  const bf16* do_h = dout + head * D;
  const int q_lo = causal ? (k0 / BM) * BM : 0;
  for (int qq0 = q_lo; qq0 < S; qq0 += BM) {
    if (has_seg && !tile_is_live(qseg_s, kset, seg_b, qq0, BM, S, tid))
      continue;
    load_rows<D, BM>(q_s, q_h, D, qq0, S, tid);
    load_rows<D, BM>(do_s, do_h, D, qq0, S, tid);
    if (tid < BM) {
      const bool in = qq0 + tid < S;
      lse_s[tid] = in ? lse[head + qq0 + tid] : 0.f;
      dl_s[tid] = in ? delta[head + qq0 + tid] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BM queries
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KD; ++kc) {
      uint32_t ka[4], va[4];
      ld_a(ka, k_s, LD, warp * 16, kc * 16, g, t);
      ld_a(va, v_s, LD, warp * 16, kc * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        uint32_t bq[2], bd[2];
        ld_b_nk(bq, q_s, LD, nt * 8, kc * 16, g, t);
        ld_b_nk(bd, do_s, LD, nt * 8, kc * 16, g, t);
        mma_bf16(st[nt], ka, bq);
        mma_bf16(dpt[nt], va, bd);
      }
    }
    // P^T and dS^T (dS without the softmax scale, applied at the end)
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, qi = nt * 8 + 2 * t + (e & 1);
        const bool ok = allowed_eq(qq0 + qi, key[i], S, causal, has_seg,
                                   has_seg ? qseg_s[qi] : 0, kseg[i]);
        const float p = ok ? __expf(st[nt][e] * scale - lse_s[qi]) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - dl_s[qi]);
      }
    }
    // dV += P^T dO and dK += dS^T Q (contraction over the q tile)
#pragma unroll
    for (int kc = 0; kc < BM / 16; ++kc) {
      uint32_t pa[4], sa[4];
      c_to_a(pa, st[2 * kc], st[2 * kc + 1]);
      c_to_a(sa, dpt[2 * kc], dpt[2 * kc + 1]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t bd[2], bq[2];
        ld_b_kn(bd, do_s, LD, kc * 16, dt * 8, g, t);
        ld_b_kn(bq, q_s, LD, kc * 16, dt * 8, g, t);
        mma_bf16(dv_acc[dt], pa, bd);
        mma_bf16(dk_acc[dt], sa, bq);
      }
    }
    __syncthreads();        // q_s / do_s / qseg_s free for the next tile
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= S) continue;
    const size_t base = (head + key[i]) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int d = dt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dk + base + d) =
          pack_bf16(dk_acc[dt][2 * i] * scale, dk_acc[dt][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + d) =
          pack_bf16(dv_acc[dt][2 * i], dv_acc[dt][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
mha_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ seg, bf16* __restrict__ dq, int S,
              int H, float scale, int causal) {
  constexpr int LD = D + kPad;
  constexpr int KD = D / 16;                 // k-chunks over head_dim
  constexpr int NT = kBN / 8;                // n-tiles of the score row
  constexpr int DT = D / 8;                  // n-tiles of the dQ row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + kBM * LD;
  bf16* k_s = do_s + kBM * LD;
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
  load_rows<D, kBM>(do_s, dout + head * D, D, q0, S, tid);
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  int qseg[2] = {0, 0};
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse_r[i] = row[i] < S ? lse[head + row[i]] : 0.f;
    dl_r[i] = row[i] < S ? delta[head + row[i]] : 0.f;
  }
  if (has_seg) {
#pragma unroll
    for (int i = 0; i < 2; ++i) qseg[i] = row[i] < S ? seg_b[row[i]] : 0;
    build_seg_set(&qset, seg_b, q0, kBM, S, tid);    // ends in a barrier
  } else {
    __syncthreads();
  }

  float dqa[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[dt][e] = 0.f;

  const int kv_hi = causal ? min(S, q0 + kBM) : S;
  for (int kv0 = 0; kv0 < kv_hi; kv0 += kBN) {
    if (has_seg && !tile_is_live(kseg_s, qset, seg_b, kv0, kBN, S, tid))
      continue;
    load_rows<D, kBN>(k_s, k + head * D, D, kv0, S, tid);
    load_rows<D, kBN>(v_s, v + head * D, D, kv0, S, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x 64 keys
    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KD; ++kc) {
      uint32_t qa[4], da[4];
      ld_a(qa, q_s, LD, warp * 16, kc * 16, g, t);
      ld_a(da, do_s, LD, warp * 16, kc * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bk[2], bv[2];
        ld_b_nk(bk, k_s, LD, nt * 8, kc * 16, g, t);
        ld_b_nk(bv, v_s, LD, nt * 8, kc * 16, g, t);
        mma_bf16(sc[nt], qa, bk);
        mma_bf16(dp[nt], da, bv);
      }
    }
    // dS (without the softmax scale, applied at the end)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = nt * 8 + 2 * t + (e & 1);
        const bool ok = allowed_eq(row[i], kv0 + c, S, causal, has_seg,
                                   qseg[i], has_seg ? kseg_s[c] : 0);
        const float p = ok ? __expf(sc[nt][e] * scale - lse_r[i]) : 0.f;
        sc[nt][e] = p * (dp[nt][e] - dl_r[i]);
      }
    }
    // dQ += dS K
#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc) {
      uint32_t sa[4];
      c_to_a(sa, sc[2 * kc], sc[2 * kc + 1]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t bk[2];
        ld_b_kn(bk, k_s, LD, kc * 16, dt * 8, g, t);
        mma_bf16(dqa[dt], sa, bk);
      }
    }
    __syncthreads();              // k_s / v_s / kseg_s free for the next tile
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
    bf16* dq_row = dq + (head + row[i]) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(dq_row + dt * 8 + 2 * t) =
          pack_bf16(dqa[dt][2 * i] * scale, dqa[dt][2 * i + 1] * scale);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* delta, const int* seg,
           void* dq, void* dk, void* dv, int B, int S, int H, float scale,
           int causal, cudaStream_t stream) {
  const int rows = B * H * S;
  const int warps = kThreads / 32;
  mha_delta_kernel<<<(rows + warps - 1) / warps, kThreads, 0, stream>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), delta,
      rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int dkv_smem = DkvTile<D>::kSmemBytes;
  err = cudaFuncSetAttribute(mha_dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_kv((S + kBN - 1) / kBN, H, B);
  mha_dkv_kernel<D><<<grid_kv, kThreads, dkv_smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      seg, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, scale,
      causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int dq_smem = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(mha_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_q((S + kBM - 1) / kBM, H, B);
  mha_dq_kernel<D><<<grid_q, kThreads, dq_smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      seg, static_cast<bf16*>(dq), S, H, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace flash

// Returns 0 on success, -1 for an unsupported head_dim, else the
// cudaError_t of a launch.  delta is fp32 scratch [B, H, S]; seg may be
// null (no segments).
extern "C" int flash_mha_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const float* lse, float* delta, const int* seg,
                             void* dq, void* dk, void* dv, int B, int S,
                             int H, int D, float scale, int causal,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return flash::launch<64>(q, k, v, out, dout, lse, delta, seg, dq, dk, dv,
                             B, S, H, scale, causal, st);
  if (D == 128)
    return flash::launch<128>(q, k, v, out, dout, lse, delta, seg, dq, dk, dv,
                              B, S, H, scale, causal, st);
  return -1;
}
