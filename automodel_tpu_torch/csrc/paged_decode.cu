// Paged-decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel automodel_tpu/ops/paged_attention_kernel.py:113
// (_decode_kernel, launched by paged_decode_pallas at :180).  It computes
// the same function: small-q attention of q [B, S, Hq, D] over block-paged
// pools [NB, 16, Hk, D] (bf16, fp32, or int8 with per-slot scale planes
// [NB, 16, Hk]) addressed through block tables [B, MB], with online softmax
// across pages, per-query causality, optional sliding window and soft-cap.
// The S query tokens fold into the group dim: a row of the folded
// [R = S * G, D] query block is query token r / G of query head
// h * G + r % G.  Per-query positions are read from positions[b, s] (the
// TPU kernel derives pos0 + s, :149): on every valid column the answer is
// the same, and on pad columns (which repeat the last valid position) it
// equals the plain PyTorch version, so the two compare on whole tensors.
//
// Bound: bytes.  Decode reads each key and value of the pages a row needs
// once (2 x 64 x 2 bytes a key and kv head at Llama-3.2-1B's head_dim) and
// does 4 D operations per key and query head, far below the ~295
// operations a byte that would make the tensor cores the limit; the least
// time is those bytes over 3.35 TB/s.
//
// Design: split-KV (flash-decoding).
//   * The keys of a row are cut into spans of `span` keys (whole pages);
//     the grid is (splits, Hk * row tiles, B) with splits = ceil(MB * 16 /
//     span), fixed by shapes alone (ops/paged_attention_kernel.py::
//     split_plan; the wrapper never reads the context lengths on the host).
//     A CTA whose span holds no key its rows may attend (past the context,
//     or wholly before every query's window) exits at once.
//   * Every warp works.  With few folded rows (decode, R = S * G <= 16) the
//     CTA takes a tile of rows and its 4 warps split the span's pages round
//     robin, each keeping its own online-softmax state for the tile; the
//     warps merge through shared memory at the end.  With more rows
//     (verify, chunked prefill) the warps split a larger tile of rows and
//     walk the span's pages together.
//   * bf16 q runs on the tensor cores (mma.sync m16n8k16, 16 rows a warp:
//     a 16-row tile when the warps split the keys, 64 rows when they split
//     the rows): scores Q K^T, the online softmax on the fragments, then P
//     (rounded to bf16) times V, fp32 sums.  int8 keys and values stay int8
//     in shared memory and are widened to bf16 (exact) as the fragments are
//     read; the key scale multiplies the score, the value scale multiplies
//     p.  fp32 q (a test dtype) runs fp32 FMAs: lane l scores key l % 16
//     over half the head dims (l / 16) against 4 rows, and p @ v gives each
//     lane D / 32 output dims (4-row tiles when the warps split the keys,
//     16 rows when they split the rows).
//   * Loads stay in flight.  The q rows and the span's block-table entries
//     are loaded first, beside the rows' positions; each page slice of head
//     h (16 rows of D elements at a stride of Hk * D, plus the int8 scales
//     of those 16 slots) comes into a ring of shared-memory stages by
//     cp.async (16 bytes a thread, 4 for a scale; rows past the context
//     zero-filled): a warp's own ring of 3-4 pages, or the CTA's of up to 8.
//   * Each split writes (m, l, unnormalised acc) in fp32 to scratch the
//     wrapper allocates; a second launch, paged_decode_merge (one warp a
//     row), combines a row's splits by the log-sum-exp rule and writes out
//     in q's dtype.  Where a tile's keys all lie in one split, that split
//     writes out itself and the merge passes the rows by.
//
// What is left: the page gathers are cp.async, not TMA; the score and
// value fragments are read with 32- and 16-bit shared loads, not ldmatrix;
// a fixed cost (about 7 us a call on an H100 at one page of context: the
// latency chain of positions, table entries, pages and the merge launch)
// dominates at short contexts.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kPage = 16;                      // keys per page
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kMaxSpanPages = 64;              // span <= 1024 keys
static_assert(kMaxSpanPages <= kThreads, "a thread a table entry");
constexpr int kMergeThreads = 256;
constexpr float kNegInf = -0.7f * 3.402823466e38f;   // as the JAX kernel

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };
// fp32 FMAs (fp32 q): warps split the keys of 4-row tiles / the rows of
// 16-row tiles; tensor cores (bf16 q): warps split the rows of 64-row tiles
// / the keys of 16-row tiles
enum Mode { kKeys = 0, kRows = 1, kMma = 2, kMmaKeys = 3 };
constexpr bool keys_split(int mode) {
  return mode == kKeys || mode == kMmaKeys;
}
constexpr bool tensor_cores(int mode) {
  return mode == kMma || mode == kMmaKeys;
}
constexpr int row_tile(int mode) {
  return mode == kKeys ? 4 : mode == kRows ? 16 : mode == kMma ? 64 : 16;
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

// 16 bytes of T -> floats
template <typename T> struct Unpack;
template <> struct Unpack<float> {
  static constexpr int N = 4;
  __device__ static void run(const uint4& r, float* o) {
    o[0] = __uint_as_float(r.x); o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z); o[3] = __uint_as_float(r.w);
  }
};
template <> struct Unpack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void run(const uint4& r, float* o) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};
template <> struct Unpack<int8_t> {
  static constexpr int N = 16;
  __device__ static void run(const uint4& r, float* o) {
    const int8_t* c = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = static_cast<float>(c[i]);
  }
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes 0 writes zeros instead (a key row
// past the context, whose slot may hold anything)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(saddr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One page slice of kv head h in shared memory: 16 key rows, 16 value rows
// (each padded by 16 bytes, so the 8 lanes of a quarter warp that read 8
// rows at one column hit 8 distinct bank groups), then 16 key and 16 value
// scales.
template <typename KT, int D>
struct Page {
  static constexpr int kRowBytes = D * sizeof(KT) + 16;
  static constexpr int kKBytes = kPage * kRowBytes;
  static constexpr int kBytes = 2 * kKBytes + 2 * kPage * 4;
  static constexpr int kChunks = D * static_cast<int>(sizeof(KT)) / 16;
};

template <int MODE, typename KT, int D>
struct Plan {
  using P = Page<KT, D>;
  static constexpr int WK = keys_split(MODE) ? kWarps : 1;  // page rings
  static constexpr int RT = row_tile(MODE);                // rows per CTA
  // a warp's own ring of 3-4 pages; a CTA's ring of up to 8 (its warps
  // spend less time on a page than a page takes to arrive)
  static constexpr int kStages =
      WK > 1 ? (WK * 4 * P::kBytes <= 80 * 1024 ? 4 : 3)
             : (8 * P::kBytes <= 80 * 1024 ? 8 : (80 * 1024) / P::kBytes);
  static constexpr int kRing = WK * kStages * P::kBytes;
  static constexpr int kQLd = D + 8;           // bf16 q rows (tensor cores)
  static constexpr int kQBytes =
      tensor_cores(MODE) ? RT * kQLd * 2 : RT * D * 4;
  static constexpr int kSmem = kRing + kQBytes + kMaxSpanPages * 4;
  static_assert(WK * RT * (D + 2) * 4 <= kRing || WK == 1,
                "merge scratch fits");
  static_assert(kSmem <= 227 * 1024 && kStages >= 3, "shared memory");
};

// DPL consecutive elements of a row -> floats
template <typename KT, int DPL>
__device__ __forceinline__ void load_vec(const uint8_t* p, float* o) {
  const KT* x = reinterpret_cast<const KT*>(p);
#pragma unroll
  for (int e = 0; e < DPL; ++e) o[e] = to_float(x[e]);
}

// The pages of one split a CTA's rows may attend: [pg0, pg0 + npages), and
// the key bounds of its rows (kv_end: past every row's last key; first:
// before every row's window).  Called by whole warps.
struct Range {
  int kv_end, first, pg0, npages;
};

__device__ __forceinline__ Range key_range(const int* pos_b, int G, int R,
                                           int row0, int rt, int ctx,
                                           int window, int split, int span) {
  // the tile's query tokens, read by the lanes of a (whole) warp at once
  const int lane = threadIdx.x & 31;
  const int t1 = (min(row0 + rt, R) - 1) / G;
  int lo = 0x7fffffff, hi = -1;
  for (int t = row0 / G + lane; t <= t1; t += 32) {
    const int p = pos_b[t];
    lo = min(lo, p);
    hi = max(hi, p);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  Range g;
  g.kv_end = min(ctx, hi + 1);
  g.first = window > 0 ? max(0, lo - window + 1) : 0;
  const int k0 = max(split * span, g.first);
  const int k1 = min((split + 1) * span, g.kv_end);
  g.pg0 = k0 / kPage;
  g.npages = k1 > k0 ? (k1 + kPage - 1) / kPage - g.pg0 : 0;
  return g;
}

// Splits with keys for the rows of a Range: [first / span, (kv_end - 1) /
// span], each of which writes the rows' partials (or, if it is the only
// one, their output)
__device__ __forceinline__ int live_splits(const Range& g, int span) {
  return (g.kv_end - 1) / span - g.first / span + 1;
}

// Issue the cp.async copies of page `blk` (global page index pg) of kv head
// h into stage `st`, thread gt of a group of `group` threads, and commit
// them as one group.  Key rows at or past kv_end are zero-filled.
template <typename KT, int D>
__device__ __forceinline__ void issue_page(
    uint8_t* st, const KT* __restrict__ k_pool, const KT* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    int blk, int pg, int kv_end, int h, int Hk, int gt, int group) {
  using PG = Page<KT, D>;
  constexpr int kCopies = 2 * kPage * PG::kChunks;
  for (int c = gt; c < kCopies; c += group) {
    const int kv = c / (kPage * PG::kChunks);
    const int rem = c % (kPage * PG::kChunks);
    const int j = rem / PG::kChunks, ch = rem % PG::kChunks;
    const size_t slot_id = ((size_t)blk * kPage + j) * Hk + h;
    const KT* src = (kv ? v_pool : k_pool) + slot_id * D +
                    ch * (16 / static_cast<int>(sizeof(KT)));
    cp_async16(st + kv * PG::kKBytes + j * PG::kRowBytes + ch * 16, src,
               pg * kPage + j < kv_end ? 16 : 0);
  }
  if (k_scale != nullptr && gt < 2 * kPage) {         // the page's scales
    const int kv = gt / kPage, j = gt % kPage;
    cp_async4(st + 2 * PG::kKBytes + gt * 4,
              (kv ? v_scale : k_scale) + ((size_t)blk * kPage + j) * Hk + h);
  }
  cp_commit();
}

template <typename QT, typename KT, int D, int MODE>
__global__ void __launch_bounds__(kThreads)
paged_decode_split(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                   const KT* __restrict__ v_pool,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ context_lens,
                   const int* __restrict__ positions, QT* __restrict__ out,
                   float* __restrict__ part_ml, float* __restrict__ part_acc,
                   int S, int Hq, int Hk, int MB, int span, int tiles,
                   float scale, float soft_cap, int window) {
  using PL = Plan<MODE, KT, D>;
  using PG = Page<KT, D>;
  constexpr int RT = PL::RT, NST = PL::kStages;
  constexpr int DPL = D / 32;                    // output dims per lane
  constexpr int DH = D / 2;                      // score dims per lane
  constexpr int VN = Unpack<KT>::N;
  static_assert(DH % VN == 0, "a half row is whole 16-byte chunks");

  extern __shared__ __align__(16) uint8_t smem[];
  float* q_s = reinterpret_cast<float*>(smem + PL::kRing);
  int* tbl = reinterpret_cast<int*>(q_s + RT * D);

  const int split = blockIdx.x, tile = blockIdx.y % tiles;
  const int h = blockIdx.y / tiles, b = blockIdx.z;
  const int splits = gridDim.x;
  const int G = Hq / Hk, R = S * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ctx = context_lens[b];
  const int* pos_b = positions + (size_t)b * S;
  const int row0 = tile * RT;
  const size_t bh = (size_t)b * Hk + h;

  // q rows and the span's table entries into registers first, so their
  // loads overlap those of the rows' positions
  constexpr int QN = RT * D / kThreads;          // q elements a thread
  static_assert(RT * D % kThreads == 0, "q splits evenly");
  float qv[QN];
#pragma unroll
  for (int n = 0; n < QN; ++n) {
    const int i = tid + n * kThreads, fr = row0 + i / D;
    qv[n] = fr < R ? to_float(q[(((size_t)b * S + fr / G) * Hq + h * G +
                                 fr % G) * D + i % D])
                   : 0.f;
  }
  const int sp0 = split * (span / kPage);        // the span's first page
  const int tb = tid < min(span / kPage, MB - sp0)
                     ? block_tables[(size_t)b * MB + sp0 + tid]
                     : 0;

  // the keys this CTA's rows may attend, cut to its span (whole pages)
  const Range rg = key_range(pos_b, G, R, row0, RT, ctx, window, split, span);
  const int kv_end = rg.kv_end, pg0 = rg.pg0, npages = rg.npages;
  // the only split with keys for these rows writes out itself
  const bool direct = live_splits(rg, span) == 1;

  auto emit = [&](int fr, int d, float m, float l, float a) {
    if (direct) {
      const int s = fr / G, g = fr % G;
      out[(((size_t)b * S + s) * Hq + h * G + g) * D + d] =
          from_float<QT>(a / (l == 0.f ? 1.f : l));
    } else {
      const size_t row = (bh * splits + split) * R + fr;
      part_acc[row * D + d] = a;
      if (d == 0) {
        part_ml[row * 2] = m;
        part_ml[row * 2 + 1] = l;
      }
    }
  };

  // no key here (every row has one in some split): nothing to write, the
  // merge does not read this split
  if (npages == 0) return;

#pragma unroll
  for (int n = 0; n < QN; ++n) q_s[tid + n * kThreads] = qv[n];
  if (tid < kMaxSpanPages) tbl[tid] = tb;
  __syncthreads();

  // the warp's rows (within the tile) and their positions
  const int wrow0 = MODE == kKeys ? 0 : warp * kRowsPerWarp;
  int qpos[kRowsPerWarp];
  bool any_row = false;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int fr = row0 + wrow0 + i;
    qpos[i] = fr < R ? pos_b[fr / G] : -1;     // -1: no key passes the mask
    any_row |= fr < R;
  }

  // this thread's ring: a warp's own (few rows) or the CTA's (many rows)
  const int ring_id = MODE == kKeys ? warp : 0;
  const int gt = MODE == kKeys ? lane : tid;          // index in the group
  constexpr int kGroup = MODE == kKeys ? 32 : kThreads;
  uint8_t* ring = smem + ring_id * NST * PG::kBytes;
  const int n_mine =
      npages > ring_id ? (npages - ring_id + PL::WK - 1) / PL::WK : 0;
  auto group_sync = [&]() {
    if constexpr (MODE == kKeys) __syncwarp();
    else __syncthreads();
  };

  // page i of the span (local index) into stage `slot`, one commit group
  auto issue = [&](int slot, int i) {
    issue_page<KT, D>(ring + slot * PG::kBytes, k_pool, v_pool, k_scale,
                      v_scale, tbl[pg0 - sp0 + i], pg0 + i, kv_end, h, Hk,
                      gt, kGroup);
  };

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  }

  const int j = lane & 15, hf = lane >> 4;
  auto compute = [&](const uint8_t* st, int pg) {
    const int kbase = pg * kPage;
    // scores: lane (j, hf) dots key j over dims [hf * DH, hf * DH + DH)
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const uint8_t* krow = st + j * PG::kRowBytes + hf * DH * sizeof(KT);
#pragma unroll
    for (int c = 0; c < DH / VN; ++c) {
      float kx[VN];
      Unpack<KT>::run(*reinterpret_cast<const uint4*>(krow + c * 16), kx);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4* qr = reinterpret_cast<const float4*>(
            q_s + (wrow0 + i) * D + hf * DH + c * VN);
#pragma unroll
        for (int e4 = 0; e4 < VN / 4; ++e4) {
          const float4 qv = qr[e4];
          s[i] += qv.x * kx[4 * e4] + qv.y * kx[4 * e4 + 1] +
                  qv.z * kx[4 * e4 + 2] + qv.w * kx[4 * e4 + 3];
        }
      }
    }
    const float* scl = reinterpret_cast<const float*>(st + 2 * PG::kKBytes);
    const float ks = k_scale != nullptr ? scl[j] : 1.f;
    const int kpos = kbase + j;
    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], 16);
      float x = s[i] * ks * scale;
      if (soft_cap > 0.f) x = soft_cap * tanhf(x / soft_cap);
      const bool ok = kpos < ctx && kpos <= qpos[i] &&
                      (window <= 0 || kpos > qpos[i] - window);
      x = ok ? x : kNegInf;
      float mx = x;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      p[i] = ok ? expf(x - m_new) : 0.f;
      float ps = p[i];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] *= alpha;
    }
    // p @ v: lane owns dims [lane * DPL, lane * DPL + DPL) (rows past the
    // context were zero-filled and have p = 0)
    const uint8_t* vrow = st + PG::kKBytes + lane * DPL * sizeof(KT);
#pragma unroll
    for (int jj = 0; jj < kPage; ++jj) {
      float vx[DPL];
      load_vec<KT, DPL>(vrow + jj * PG::kRowBytes, vx);
      const float vs = v_scale != nullptr ? scl[kPage + jj] : 1.f;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], jj) * vs;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] += pj * vx[e];
      }
    }
  };

  // the ring: NST - 1 pages ahead, one commit group per page (empty past
  // the last, so the wait counts stay uniform)
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < n_mine) issue(s, ring_id + s * PL::WK);
    else cp_commit();
  }
  for (int it = 0; it < n_mine; ++it) {
    cp_wait<NST - 2>();
    group_sync();            // page `it` landed; stage it - 1 is free
    const int nxt = it + NST - 1;
    if (nxt < n_mine) issue(nxt % NST, ring_id + nxt * PL::WK);
    else cp_commit();
    if (any_row)
      compute(ring + (it % NST) * PG::kBytes, pg0 + ring_id + it * PL::WK);
  }
  cp_wait<0>();

  if constexpr (MODE == kKeys) {
    // the 4 warps' states of the same 4 rows -> one, through shared memory
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);        // [WK][RT][D + 2]
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      float* o = red + (warp * RT + i) * (D + 2);
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[lane * DPL + e] = acc[i][e];
      if (lane == 0) {
        o[D] = m[i];
        o[D + 1] = l[i];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < RT * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      if (row0 + r >= R) continue;
      float M = kNegInf;
#pragma unroll
      for (int w = 0; w < PL::WK; ++w)
        M = fmaxf(M, red[(w * RT + r) * (D + 2) + D]);
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < PL::WK; ++w) {
        const float* o = red + (w * RT + r) * (D + 2);
        const float f = expf(o[D] - M);
        L += o[D + 1] * f;
        A += o[d] * f;
      }
      emit(row0 + r, d, M, L, A);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int fr = row0 + wrow0 + i;
      if (fr >= R) continue;
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        emit(fr, lane * DPL + e, m[i], l[i], acc[i][e]);
    }
  }
}

// bf16 fragments of mma.sync m16n8k16 (lane l, g = l / 4, t = l % 4):
//   A 16x16: a0 = (g, 2t..2t+1)  a1 = (g+8, 2t..)  a2 = (g, 2t+8..)
//            a3 = (g+8, 2t+8..)
//   B 16x8 (k x n): b0 = (k 2t..2t+1, n g)  b1 = (k 2t+8.., n g)
//   C 16x8: c0, c1 = (g, 2t..2t+1)  c2, c3 = (g+8, 2t..)
// (the lower k or column in the low half of each 32-bit register)
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
// two consecutive elements of a shared row as a bf16 pair (int8 values are
// exact in bf16)
__device__ __forceinline__ uint32_t row_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t row_pair(const int8_t* p) {
  return pack_bf16(static_cast<float>(p[0]), static_cast<float>(p[1]));
}
// element c of two consecutive shared rows (ld bytes apart) as a bf16 pair
__device__ __forceinline__ uint32_t col_pair(const __nv_bfloat16* p,
                                             int ld) {
  const uint32_t lo = __bfloat16_as_ushort(p[0]);
  const uint32_t hi = __bfloat16_as_ushort(
      *reinterpret_cast<const __nv_bfloat16*>(
          reinterpret_cast<const uint8_t*>(p) + ld));
  return lo | (hi << 16);
}
__device__ __forceinline__ uint32_t col_pair(const int8_t* p, int ld) {
  return pack_bf16(static_cast<float>(p[0]), static_cast<float>(p[ld]));
}

// bf16 q on the tensor cores: scores Q K^T and P V by mma.sync m16n8k16
// (fp32 sums; P rounded to bf16, times the value scales of int8 pools
// first), 16 rows a warp.  kMma: each warp runs 16 rows of a 64-row tile,
// all four on the CTA's ring of pages.  kMmaKeys: the four warps run the
// same 16 rows, each over its own pages and ring, and merge at the end.
template <typename KT, int D, int MODE>
__global__ void __launch_bounds__(kThreads)
paged_decode_mma(const __nv_bfloat16* __restrict__ q,
                 const KT* __restrict__ k_pool, const KT* __restrict__ v_pool,
                 const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale,
                 const int* __restrict__ block_tables,
                 const int* __restrict__ context_lens,
                 const int* __restrict__ positions,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ part_ml,
                 float* __restrict__ part_acc, int S, int Hq, int Hk, int MB,
                 int span, int tiles, float scale, float soft_cap,
                 int window) {
  using PL = Plan<MODE, KT, D>;
  using PG = Page<KT, D>;
  constexpr bool KEYS = MODE == kMmaKeys;
  constexpr int RT = PL::RT, NST = PL::kStages, QLD = PL::kQLd;
  constexpr int KS = D / 16;                     // k16 steps over D
  constexpr int ND = D / 8;                      // n8 tiles of the output
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + PL::kRing);
  int* tbl = reinterpret_cast<int*>(smem + PL::kRing + PL::kQBytes);

  const int split = blockIdx.x, tile = blockIdx.y % tiles;
  const int h = blockIdx.y / tiles, b = blockIdx.z;
  const int splits = gridDim.x;
  const int G = Hq / Hk, R = S * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ctx = context_lens[b];
  const int* pos_b = positions + (size_t)b * S;
  const int row0 = tile * RT;
  const size_t bh = (size_t)b * Hk + h;

  // q rows and the span's table entries into registers first, so their
  // loads overlap those of the rows' positions
  constexpr int QV = D / 8;                      // 16-byte vectors a row
  constexpr int QN = RT * QV / kThreads;
  static_assert(RT * QV % kThreads == 0, "q splits evenly");
  uint4 qv[QN];
#pragma unroll
  for (int n = 0; n < QN; ++n) {
    const int i = tid + n * kThreads, fr = row0 + i / QV;
    qv[n] = fr < R ? *reinterpret_cast<const uint4*>(
                         q + (((size_t)b * S + fr / G) * Hq + h * G +
                              fr % G) * D + (i % QV) * 8)
                   : make_uint4(0, 0, 0, 0);
  }
  const int sp0 = split * (span / kPage);        // the span's first page
  const int tb = tid < min(span / kPage, MB - sp0)
                     ? block_tables[(size_t)b * MB + sp0 + tid]
                     : 0;

  // the keys this CTA's rows may attend, cut to its span (whole pages)
  const Range rg = key_range(pos_b, G, R, row0, RT, ctx, window, split, span);
  const int kv_end = rg.kv_end, pg0 = rg.pg0, npages = rg.npages;
  // the only split with keys for these rows writes out itself
  const bool direct = live_splits(rg, span) == 1;

  // a row's D results: out (one split) or the split's partial
  auto emit_pair = [&](int fr, int d, float m, float l, float a0,
                       float a1) {
    if (direct) {
      const int s = fr / G, gg = fr % G;
      const float den = l == 0.f ? 1.f : l;
      *reinterpret_cast<uint32_t*>(
          out + (((size_t)b * S + s) * Hq + h * G + gg) * D + d) =
          pack_bf16(a0 / den, a1 / den);
    } else {
      const size_t row = (bh * splits + split) * R + fr;
      *reinterpret_cast<float2*>(part_acc + row * D + d) =
          make_float2(a0, a1);
      if (d == 0) {
        part_ml[row * 2] = m;
        part_ml[row * 2 + 1] = l;
      }
    }
  };

  // no key here (every row has one in some split): nothing to write, the
  // merge does not read this split
  if (npages == 0) return;

#pragma unroll
  for (int n = 0; n < QN; ++n) {
    const int i = tid + n * kThreads;
    *reinterpret_cast<uint4*>(q_s + (i / QV) * QLD + (i % QV) * 8) = qv[n];
  }
  if (tid < kMaxSpanPages) tbl[tid] = tb;
  __syncthreads();

  // the warp's rows g and g + 8 of its 16, their positions, its q fragments
  const int wr0 = KEYS ? 0 : warp * 16;
  const bool any_row = row0 + wr0 < R;
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int fr = row0 + wr0 + g + 8 * r;
    qpos[r] = fr < R ? pos_b[fr / G] : -1;
  }
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const __nv_bfloat16* qr = q_s + (wr0 + g) * QLD + kk * 16 + 2 * t;
    qa[kk][0] = row_pair(qr);
    qa[kk][1] = row_pair(qr + 8 * QLD);
    qa[kk][2] = row_pair(qr + 8);
    qa[kk][3] = row_pair(qr + 8 * QLD + 8);
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  auto compute = [&](const uint8_t* st, int pg) {
    const KT* ks_ = reinterpret_cast<const KT*>(st);
    const uint8_t* vs_ = st + PG::kKBytes;
    const float* scl = reinterpret_cast<const float*>(st + 2 * PG::kKBytes);
    constexpr int LDE = PG::kRowBytes / static_cast<int>(sizeof(KT));
    // scores of keys 8 nt + (0..7) against the warp's 16 rows
    float c[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const KT* kr = ks_ + (nt * 8 + g) * LDE + kk * 16 + 2 * t;
        const uint32_t bb[2] = {row_pair(kr), row_pair(kr + 8)};
        mma_bf16(c[nt], qa[kk], bb);
      }
    }
    const int kbase = pg * kPage;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + 2 * t + (e & 1), r = e >> 1;
        const int kpos = kbase + j;
        float x = c[nt][e] * (k_scale != nullptr ? scl[j] : 1.f) * scale;
        if (soft_cap > 0.f) x = soft_cap * tanhf(x / soft_cap);
        const bool ok = kpos < ctx && kpos <= qpos[r] &&
                        (window <= 0 || kpos > qpos[r] - window);
        c[nt][e] = ok ? x : kNegInf;
        mx[r] = fmaxf(mx[r], c[nt][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = c[nt][e] == kNegInf ? 0.f : expf(c[nt][e] - m[r]);
        rs[r] += p;
        c[nt][e] = v_scale != nullptr
                       ? p * scl[kPage + nt * 8 + 2 * t + (e & 1)]
                       : p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
    // P (16 x 16 keys, bf16) @ V page (16 keys x D)
    const uint32_t pa[4] = {pack_bf16(c[0][0], c[0][1]),
                            pack_bf16(c[0][2], c[0][3]),
                            pack_bf16(c[1][0], c[1][1]),
                            pack_bf16(c[1][2], c[1][3])};
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
      const KT* vc = reinterpret_cast<const KT*>(
          vs_ + (2 * t) * PG::kRowBytes) + n * 8 + g;
      const uint32_t bb[2] = {
          col_pair(vc, PG::kRowBytes),
          col_pair(reinterpret_cast<const KT*>(
                       reinterpret_cast<const uint8_t*>(vc) +
                       8 * PG::kRowBytes),
                   PG::kRowBytes)};
      mma_bf16(o[n], pa, bb);
    }
  };

  // this thread's ring (a warp's own, or the CTA's) and its pages: local
  // pages ring_id, ring_id + WK, ...
  const int ring_id = KEYS ? warp : 0;
  const int gt = KEYS ? lane : tid;
  constexpr int kGroup = KEYS ? 32 : kThreads;
  uint8_t* ring = smem + ring_id * NST * PG::kBytes;
  const int n_mine =
      npages > ring_id ? (npages - ring_id + PL::WK - 1) / PL::WK : 0;
  auto issue = [&](int slot, int i) {
    issue_page<KT, D>(ring + slot * PG::kBytes, k_pool, v_pool, k_scale,
                      v_scale, tbl[pg0 - sp0 + i], pg0 + i, kv_end, h, Hk,
                      gt, kGroup);
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < n_mine) issue(s, ring_id + s * PL::WK);
    else cp_commit();
  }
  for (int it = 0; it < n_mine; ++it) {
    cp_wait<NST - 2>();
    if constexpr (KEYS) __syncwarp();
    else __syncthreads();    // page `it` landed; stage it - 1 is free
    const int nxt = it + NST - 1;
    if (nxt < n_mine) issue(nxt % NST, ring_id + nxt * PL::WK);
    else cp_commit();
    if (any_row)
      compute(ring + (it % NST) * PG::kBytes, pg0 + ring_id + it * PL::WK);
  }
  cp_wait<0>();

  if constexpr (KEYS) {
    // the 4 warps' states of the same 16 rows -> one, through shared memory
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);        // [4][RT][D + 2]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* o_r = red + (warp * RT + g + 8 * r) * (D + 2);
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(o_r + n * 8 + 2 * t) =
            make_float2(o[n][2 * r], o[n][2 * r + 1]);
      if (t == 0) {
        o_r[D] = m[r];
        o_r[D + 1] = l[r];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < RT * D / 2; idx += kThreads) {
      const int r = (2 * idx) / D, d = (2 * idx) % D;
      if (row0 + r >= R) continue;
      float M = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        M = fmaxf(M, red[(w * RT + r) * (D + 2) + D]);
      float L = 0.f, A0 = 0.f, A1 = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* o_w = red + (w * RT + r) * (D + 2);
        const float f = expf(o_w[D] - M);
        L += o_w[D + 1] * f;
        A0 += o_w[d] * f;
        A1 += o_w[d + 1] * f;
      }
      emit_pair(row0 + r, d, M, L, A0, A1);
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int fr = row0 + wr0 + g + 8 * r;
      if (fr >= R) continue;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        emit_pair(fr, n * 8 + 2 * t, m[r], l[r], o[n][2 * r],
                  o[n][2 * r + 1]);
    }
  }
}

// out[b, s, h * G + g] = the log-sum-exp merge of a folded row's split
// partials: one warp a row.  The splits read are those the row's tile has
// keys in (live_splits, so every one of them wrote the row; a tile with one
// wrote its output already); a split where the row's own mask left no key
// has l = 0 and weight 0.
template <typename QT, int D>
__global__ void __launch_bounds__(kMergeThreads)
paged_decode_merge(const float* __restrict__ part_ml,
                   const float* __restrict__ part_acc, QT* __restrict__ out,
                   const int* __restrict__ context_lens,
                   const int* __restrict__ positions, int B, int S, int Hq,
                   int Hk, int splits, int span, int rt, int window) {
  constexpr int DPL = D / 32;
  const int G = Hq / Hk, R = S * G;
  const int lane = threadIdx.x & 31;
  const long long wid = (long long)blockIdx.x * (kMergeThreads / 32) +
                        (threadIdx.x >> 5);
  if (wid >= (long long)B * Hk * R) return;
  const int r = static_cast<int>(wid % R);
  const int h = static_cast<int>((wid / R) % Hk);
  const int b = static_cast<int>(wid / ((long long)R * Hk));
  const Range rg = key_range(positions + (size_t)b * S, G, R, r / rt * rt,
                             rt, context_lens[b], window, 0, 0x7fffffff);
  const int s_lo = rg.first / span;
  const int n = live_splits(rg, span);
  if (n == 1) return;                 // that split wrote the row itself
  const size_t row0 = ((size_t)b * Hk + h) * splits * R + r;  // split 0
  auto row_of = [&](int s) { return row0 + (size_t)(s_lo + s) * R; };

  float M = kNegInf;
  for (int s = lane; s < n; s += 32) {
    const float2 ml = *reinterpret_cast<const float2*>(part_ml + row_of(s) * 2);
    if (ml.y > 0.f) M = fmaxf(M, ml.x);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  float L = 0.f, acc[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc[e] = 0.f;
  for (int s0 = 0; s0 < n; s0 += 32) {
    float w = 0.f;
    if (s0 + lane < n) {
      const float2 ml =
          *reinterpret_cast<const float2*>(part_ml + row_of(s0 + lane) * 2);
      w = ml.y > 0.f ? expf(ml.x - M) : 0.f;
      L += ml.y * w;
    }
    // 8 splits' loads in flight at a time
    const int cnt = min(32, n - s0);
    for (int j0 = 0; j0 < cnt; j0 += 8) {
      float a[8][DPL];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < DPL; ++e)
          a[jj][e] = j0 + jj < cnt
                         ? part_acc[row_of(s0 + j0 + jj) * D + lane * DPL + e]
                         : 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float wj = __shfl_sync(0xffffffffu, w, (j0 + jj) & 31);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[e] += wj * a[jj][e];
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
  const int s = r / G, g = r % G;
  QT* o = out + (((size_t)b * S + s) * Hq + h * G + g) * D + lane * DPL;
#pragma unroll
  for (int e = 0; e < DPL; ++e)
    o[e] = from_float<QT>(L > 0.f ? acc[e] / L : 0.f);
}

struct Args {
  const void *q, *k_pool, *v_pool;
  const float *k_scale, *v_scale;
  const int *block_tables, *context_lens, *positions;
  void* out;
  float *part_ml, *part_acc;
  int B, S, Hq, Hk, MB, span, splits, tiles;
  float scale, soft_cap;
  int window;
  cudaStream_t stream;
};

template <typename QT, typename KT, int D, int MODE>
auto kernel_of() {
  if constexpr (tensor_cores(MODE)) return paged_decode_mma<KT, D, MODE>;
  else return paged_decode_split<QT, KT, D, MODE>;
}

template <typename QT, typename KT, int D, int MODE>
int launch(const Args& a) {
  using PL = Plan<MODE, KT, D>;
  const auto kernel = kernel_of<QT, KT, D, MODE>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PL::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(a.splits, a.Hk * a.tiles, a.B);
  kernel<<<grid, kThreads, PL::kSmem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k_pool),
      static_cast<const KT*>(a.v_pool), a.k_scale, a.v_scale, a.block_tables,
      a.context_lens, a.positions, static_cast<QT*>(a.out), a.part_ml,
      a.part_acc, a.S, a.Hq, a.Hk, a.MB, a.span, a.tiles, a.scale,
      a.soft_cap, a.window);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return static_cast<int>(e);
  const long long rows = (long long)a.B * a.Hk * a.S * (a.Hq / a.Hk);
  const long long blocks = (rows + kMergeThreads / 32 - 1) /
                           (kMergeThreads / 32);
  paged_decode_merge<QT, D><<<static_cast<unsigned>(blocks), kMergeThreads,
                              0, a.stream>>>(
      a.part_ml, a.part_acc, static_cast<QT*>(a.out), a.context_lens,
      a.positions, a.B, a.S, a.Hq, a.Hk, a.splits, a.span, PL::RT,
      a.window);
  return static_cast<int>(cudaGetLastError());
}

// the tensor-core mode takes bf16 q only
template <typename QT, typename KT, int D>
int by_mode(const Args& a, int mode) {
  if (mode == kKeys) return launch<QT, KT, D, kKeys>(a);
  if (mode == kRows) return launch<QT, KT, D, kRows>(a);
  if constexpr (std::is_same<QT, __nv_bfloat16>::value) {
    if (mode == kMma) return launch<QT, KT, D, kMma>(a);
    return launch<QT, KT, D, kMmaKeys>(a);
  }
  return -1;
}

template <int D>
int dispatch(const Args& a, int q_dtype, int kv_dtype, int mode) {
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return by_mode<__nv_bfloat16, __nv_bfloat16, D>(a, mode);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return by_mode<__nv_bfloat16, int8_t, D>(a, mode);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return by_mode<float, float, D>(a, mode);
  if (q_dtype == kF32 && kv_dtype == kI8)
    return by_mode<float, int8_t, D>(a, mode);
  return -1;
}

}  // namespace

// The plan comes from ops/paged_attention_kernel.py::split_plan: `span`
// keys per split (a multiple of 16, at most 1024), `splits` with
// (splits - 1) * span < MB * 16 <= splits * span, `mode` 0 (warps split the
// keys, 4-row tiles), 1 (warps split the rows, 16-row tiles) or 2 (the rows
// on the tensor cores, 64-row tiles; bf16 q), `tiles` the row tiles of R =
// S * Hq / Hk.  part_ml [B, Hk, splits, R, 2] and
// part_acc [B, Hk, splits, R, D] fp32 scratch (unused, and may be null,
// with one split).  Returns 0, -1 for a dtype / head_dim /
// plan the kernel does not take, else the cudaError_t of a launch.  The
// block size is 16.
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const float* k_scale,
                            const float* v_scale, const int* block_tables,
                            const int* context_lens, const int* positions,
                            void* out, float* part_ml, float* part_acc, int B,
                            int S, int Hq, int Hk, int D, int MB, int q_dtype,
                            int kv_dtype, float scale, float soft_cap,
                            int window, int span, int splits, int mode,
                            int tiles, void* stream) {
  if (Hk <= 0 || Hq % Hk || S <= 0 || B <= 0 || MB <= 0) return -1;
  if (span <= 0 || span % kPage || span > kMaxSpanPages * kPage) return -1;
  if ((long long)(splits - 1) * span >= (long long)MB * kPage ||
      (long long)splits * span < (long long)MB * kPage)
    return -1;
  if (mode < kKeys || mode > kMmaKeys) return -1;
  const int R = S * (Hq / Hk);
  if (tiles != (R + row_tile(mode) - 1) / row_tile(mode)) return -1;
  if (splits > 1 && (part_ml == nullptr || part_acc == nullptr)) return -1;
  const Args a{q, k_pool, v_pool, k_scale, v_scale, block_tables,
               context_lens, positions, out, part_ml, part_acc, B, S, Hq,
               Hk, MB, span, splits, tiles, scale, soft_cap, window,
               static_cast<cudaStream_t>(stream)};
  if (D == 64) return dispatch<64>(a, q_dtype, kv_dtype, mode);
  if (D == 128) return dispatch<128>(a, q_dtype, kv_dtype, mode);
  return -1;
}
