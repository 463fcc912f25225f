// Training attention, backward, for Hopper (sm_90a); plain C interface for
// ctypes.
//
// Replaces the TPU kernel automodel_tpu/ops/splash_attention.py:129
// (_build_kernel: upstream Pallas splash attention, its fused dq/dkv
// backward, use_fused_bwd_kernel=True at :166-170), called by
// splash_attention_bshd (:183).  Inputs are the forward's operands and
// results: q [B, S, Hq, D], k/v [B, S, Hk, D], out and dout [B, S, Hq, D]
// (bf16), lse [B, Hq, S] fp32, the same mask arguments as the forward.
// Outputs: dq accumulated in fp32 [B, S, Hq, D] (zeroed by the caller),
// dk/dv [B, S, Hk, D] bf16.
//
// Two kernels, launched in order on the caller's stream:
//   1. delta[b, h, s] = sum_d dout * out (fp32), one warp per row;
//   2. one CTA per (64-key tile, kv head, batch row) loops over the G query
//      heads of its group and over the q tiles that can see its keys:
//        P   = exp(x - lse), x = S * scale (soft-capped where a cap is set)
//        dV += P^T dO          dP = dO V^T
//        dS  = P * (dP - delta) * dx/dS
//        dK += dS^T Q          dQ += dS K  (fp32 atomicAdd into the buffer)
//      computed as S^T = K Q^T so that P^T and dS^T come out of the
//      accumulators already in the left-operand layout of dV and dK.  dK and
//      dV of a kv head are summed in registers across the whole group: no
//      atomics for them.  dS^T goes through shared memory (bf16) for dQ.
//   The CTA skips the q tiles that lie wholly before its keys (causal),
//   wholly past the window, or (with segments) share no segment with them.
//
// Bound: like the forward, operations -- 10 * D * Hq * (attended pairs)
// over the bf16 tensor-core rate (five products per pair; the recomputed
// scores are one of them).  The simple design pays on top: plain 16-byte
// loads without copy/compute overlap, per-element smem fragment reads for
// the transposed operands (no ldmatrix.trans), and one fp32 atomicAdd per
// dQ element per (kv tile, q tile) pair.  A separate dQ pass, cp.async /
// TMA pipelines and wgmma are later work.

#include "flash_attn_common.cuh"

namespace flash {
namespace {

constexpr int kBN = 64;   // keys per CTA

template <int D>
struct BwdTile {
  // query rows per inner tile: 64 at head_dim 64; 32 at 128, which keeps
  // the dK/dV accumulators (2 * D/8 * 4 floats) plus the score tiles
  // inside the register file
  static constexpr int BM = D == 64 ? 64 : 32;
  static constexpr int LD = D + kPad;
  static constexpr int LDS = BM + kPad;      // dS^T rows: [key][query]
  static constexpr int kSmemBytes =
      (2 * kBN + 2 * BM) * LD * 2 + kBN * LDS * 2 + 2 * BM * 4;
};

__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const bf16* __restrict__ out,
                       const bf16* __restrict__ dout,
                       float* __restrict__ delta, int rows, int S, int Hq,
                       int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kThreads / 32) + warp;   // (b * S + s) * Hq + h
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
  if (lane == 0) {
    const int h = r % Hq, bs = r / Hq, s = bs % S, b = bs / S;
    delta[((size_t)b * Hq + h) * S + s] = acc;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, const int* __restrict__ seg,
                 float* __restrict__ dq, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int S, int Hq, int Hk, float scale,
                 float cap, int causal, int window) {
  using T = BwdTile<D>;
  constexpr int BM = T::BM, LD = T::LD, LDS = T::LDS;
  constexpr int KD = D / 16;                // k-chunks over head_dim
  constexpr int NQ = BM / 8;                // n-tiles over the q tile
  constexpr int DT = D / 8;                 // n-tiles over head_dim
  constexpr int RG = BM / 16;               // 16-row q groups in the dQ pass
  constexpr int DW = D * RG / 4;            // dQ columns per warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kBN * LD;
  bf16* q_s = v_s + kBN * LD;
  bf16* do_s = q_s + BM * LD;
  bf16* ds_s = do_s + BM * LD;
  float* lse_s = reinterpret_cast<float*>(ds_s + kBN * LDS);
  float* dl_s = lse_s + BM;
  __shared__ int qseg_s[BM];
  __shared__ int kseg_lo, kseg_hi;

  const int k0 = blockIdx.x * kBN, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int has_seg = seg != nullptr;
  const int* seg_b = has_seg ? seg + (size_t)b * S : nullptr;

  load_rows<D, kBN>(k_s, k + ((size_t)b * S * Hk + hk) * D, (size_t)Hk * D,
                    k0, S, tid);
  load_rows<D, kBN>(v_s, v + ((size_t)b * S * Hk + hk) * D, (size_t)Hk * D,
                    k0, S, tid);
  if (tid == 0) {
    kseg_lo = 0x7fffffff;
    kseg_hi = 0;
  }
  // this thread's key rows in the S^T accumulators
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  int kseg[2] = {1, 1};
  if (has_seg) {
#pragma unroll
    for (int i = 0; i < 2; ++i) kseg[i] = key[i] < S ? seg_b[key[i]] : 0;
  }
  __syncthreads();
  if (has_seg && tid < kBN && k0 + tid < S) {
    const int s = seg_b[k0 + tid];
    if (s != 0) {
      atomicMin(&kseg_lo, s);
      atomicMax(&kseg_hi, s);
    }
  }
  __syncthreads();

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  int q_lo = causal ? k0 : 0;
  q_lo = (q_lo / BM) * BM;
  const int q_hi = window > 0 ? min(S, k0 + kBN - 1 + window) : S;
  const bool live = !has_seg || kseg_hi > 0;   // all-padding keys: zeros

  for (int gq = 0; live && gq < G; ++gq) {
    const int hq = hk * G + gq;
    const bf16* q_h = q + ((size_t)b * S * Hq + hq) * D;
    const bf16* do_h = dout + ((size_t)b * S * Hq + hq) * D;
    const float* lse_h = lse + ((size_t)b * Hq + hq) * S;
    const float* dl_h = delta + ((size_t)b * Hq + hq) * S;
    for (int qq0 = q_lo; qq0 < q_hi; qq0 += BM) {
      if (has_seg) {
        int s = 0;
        if (tid < BM && qq0 + tid < S) s = seg_b[qq0 + tid];
        if (tid < BM) qseg_s[tid] = s;
        const bool hit = tid < BM && s != 0 && s >= kseg_lo && s <= kseg_hi;
        if (!__syncthreads_or(hit)) continue;
      }
      load_rows<D, BM>(q_s, q_h, (size_t)Hq * D, qq0, S, tid);
      load_rows<D, BM>(do_s, do_h, (size_t)Hq * D, qq0, S, tid);
      if (tid < BM) {
        const bool in = qq0 + tid < S;
        lse_s[tid] = in ? lse_h[qq0 + tid] : 0.f;
        dl_s[tid] = in ? dl_h[qq0 + tid] : 0.f;
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
          float x = st[nt][e] * scale, dx = 1.f;
          if (cap > 0.f) {
            const float th = tanhf(x / cap);
            x = cap * th;
            dx = 1.f - th * th;
          }
          const bool ok = allowed(qq0 + qi, key[i], S, causal, window,
                                  has_seg, has_seg ? qseg_s[qi] : 0, kseg[i]);
          const float p = ok ? __expf(x - lse_s[qi]) : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - dl_s[qi]) * dx;
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
      // dS^T -> smem [key][query] for dQ = dS K
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<uint32_t*>(
              ds_s + (warp * 16 + g + 8 * i) * LDS + nt * 8 + 2 * t) =
              pack_bf16(dpt[nt][2 * i], dpt[nt][2 * i + 1]);
      __syncthreads();
      {
        const int rg = warp % RG, dc0 = (warp / RG) * DW;
        float dqa[DW / 8][4];
#pragma unroll
        for (int dt = 0; dt < DW / 8; ++dt)
#pragma unroll
          for (int e = 0; e < 4; ++e) dqa[dt][e] = 0.f;
#pragma unroll
        for (int kc = 0; kc < kBN / 16; ++kc) {
          uint32_t a[4];
          ld_a_t(a, ds_s, LDS, rg * 16, kc * 16, g, t);
#pragma unroll
          for (int dt = 0; dt < DW / 8; ++dt) {
            uint32_t bk[2];
            ld_b_kn(bk, k_s, LD, kc * 16, dc0 + dt * 8, g, t);
            mma_bf16(dqa[dt], a, bk);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int qrow = qq0 + rg * 16 + g + 8 * i;
          if (qrow >= S) continue;
          float* dq_row = dq + (((size_t)b * S + qrow) * Hq + hq) * D;
#pragma unroll
          for (int dt = 0; dt < DW / 8; ++dt) {
            const int d = dc0 + dt * 8 + 2 * t;
            atomicAdd(dq_row + d, dqa[dt][2 * i] * scale);
            atomicAdd(dq_row + d + 1, dqa[dt][2 * i + 1] * scale);
          }
        }
      }
      __syncthreads();      // q_s / do_s / ds_s / qseg_s free for the next tile
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= S) continue;
    const size_t base = (((size_t)b * S + key[i]) * Hk + hk) * D;
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
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* delta, const int* seg,
           float* dq, void* dk, void* dv, int B, int S, int Hq, int Hk,
           float scale, float cap, int causal, int window,
           cudaStream_t stream) {
  const int rows = B * S * Hq;
  const int warps = kThreads / 32;
  flash_bwd_delta_kernel<<<(rows + warps - 1) / warps, kThreads, 0, stream>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), delta,
      rows, S, Hq, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int smem = BwdTile<D>::kSmemBytes;
  err = cudaFuncSetAttribute(flash_bwd_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBN - 1) / kBN, Hk, B);
  flash_bwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      seg, dq, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, Hq, Hk,
      scale, cap, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace flash

// Returns 0 on success, -1 for an unsupported head_dim, else the
// cudaError_t of a launch.  delta is fp32 scratch [B, Hq, S]; dq is the
// fp32 accumulator [B, S, Hq, D] and must be zero on entry.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* out, const void* dout,
                              const float* lse, float* delta, const int* seg,
                              float* dq, void* dk, void* dv, int B, int S,
                              int Hq, int Hk, int D, float scale, float cap,
                              int causal, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return flash::launch<64>(q, k, v, out, dout, lse, delta, seg, dq, dk, dv,
                             B, S, Hq, Hk, scale, cap, causal, window, st);
  if (D == 128)
    return flash::launch<128>(q, k, v, out, dout, lse, delta, seg, dq, dk,
                              dv, B, S, Hq, Hk, scale, cap, causal, window,
                              st);
  return -1;
}
