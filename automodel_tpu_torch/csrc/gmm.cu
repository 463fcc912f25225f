// Grouped matmuls of the sorted mixture-of-experts path, for Hopper
// (sm_90a); plain C interface for ctypes.
//
// Replaces the TPU kernels automodel_tpu/ops/gmm_kernel.py:187 (_gmm_kernel,
// launched at :225) and :256 (_tgmm_kernel, launched at :290).  The rows of
// lhs [m, K] are contiguous per-group segments sized by group_sizes [E]
// (segment g is rows [ends[g-1], ends[g]), ends the inclusive prefix sum,
// clipped to m):
//   gmm:   out[rows of g] = lhs[rows of g] @ rhs[g]      out [m, N]
//          rhs [E, K, N], or with trans_rhs its [E, N, K] storage read as
//          rhs[g]^T in place (the backward's dlhs = gmm(dout, rhs^T));
//          rows past ends[E-1] are written 0
//   tgmm:  out[g] = lhs[rows of g]^T @ dout[rows of g]   out [E, K, N]
//          an empty group's block is written 0
// bf16 operands, fp32 accumulate, bf16 out.
//
// Bound: 2 (sum of group sizes) K N operations on the bf16 tensor cores
// (0.41 TFLOP, 0.42 ms at 989 TFLOP/s for the routed rows of
// Qwen3-30B-A3B: 131072 x 2048 x 768); the bytes (lhs, the experts'
// weights and the output once) take most of that too, so the design keeps
// every operand read from device memory about once.
//
// Design.  The Pallas kernels enumerate (row tile, group) work items in one
// sequential grid axis and carry an fp32 VMEM accumulator from one item to
// the next.  Here both products run on wgmma_gemm.cuh's mainloop (TMA ring,
// mbarriers, a producer warp, two wgmma consumer warpgroups, 128 x 256
// output tiles, one persistent CTA per SM) over work items fixed by shapes
// alone, so the wrapper never reads the group sizes on the host.  Up to
// 1024 groups every CTA first copies `ends` into shared memory (tgmm: with
// its chunk plan, below); an item then finds its group there.  Past 1024
// groups the same plan lives in a global workspace the wrapper allocates,
// filled by a plan pass launched before the product (gmm: clip_ends; tgmm:
// plan_kernel, then rank_kernel), and the items read it from there: the
// same items in the same order.  One tensor map per operand is
// encoded per call: a group's weights or rows are reached through the
// item's storage-row offset (Tile::a_row / b_row), never a map of their own.
//
//   gmm (kernel 5), Cfg<bf16, bf16, K-major, MN-major> (rhs[g] [K][N] read
//   as 64 x 64 boxes of the [E K, N] map, row g K + k), with trans_rhs
//   Cfg<bf16, bf16, K-major, K-major> (rhs stored [E N, K], rows g N + n).
//   Items: gmm_items.cuh's grouped forward plan (shared with
//   gmm_quant.cu), n_n (n_m + E) of them for n_m, n_n the 128-row and
//   256-column tiles of out: one per output tile for the group holding the
//   tile's first row, one more per group that starts strictly inside a
//   tile; each item multiplies its whole row tile by its group's weights
//   and stores only its group's rows, and rows past the groups are written
//   0 by exactly one item.  The sorted path pads every segment to 128 rows
//   (ops/moe.py), so there no extra item is active and no tile meets two
//   groups.
//   Ragged K: A's map carries the true K, so TMA zero-fills A's columns at
//   or past K, and the rows of the next group's weights that a ragged last
//   K tile reads multiply zeros (no 3-D map).  Ragged N with trans_rhs:
//   the columns past N read the next group's rows and are not stored.  The
//   maps stay far inside TMA's 2^31 coordinates (the dlhs's [E N, K] map
//   has 262,144 rows at Qwen3-30B-A3B's 128 x 2048).
//
//   tgmm (kernel 6), Cfg<bf16, bf16, MN-major, MN-major> (lhs [m][K] gives A
//   with M = K, dout [m][N] gives B; both 64 x 64 boxes, K = the rows).
//   A group's rows are cut into chunks of C rows (the wrapper's
//   chunk_rows, a multiple of 64 fixed from shapes: ops/gmm_kernel.py::
//   tgmm_chunk_rows keeps two waves of items when one group takes every
//   row); an empty group has one chunk that writes zeros.  Items are
//   (chunk slot, output tile), the n_k n_n tiles of a chunk together (their
//   CTAs share the chunk's rows through L2): tiles x (E + m / C) items
//   bound every layout, and slots past the last chunk are idle.  The
//   slots run longest first: the full chunks of split groups (C rows) in
//   group order, then every group's last (or only) chunk by decreasing
//   rows, which every CTA ranks in shared memory (rank_last_chunks).  The
//   mainloop's round robin item i is item j of that list in snake order
//   (bands of one item per CTA, every other band reversed), so the CTAs
//   that drew the longest items of one band draw the shortest of the next
//   and no CTA ends more than one item's stages behind another
//   (tests/test_torch_gmm_plan.py).  Groups differ in size (a random
//   router sends 170-7,129 rows to Qwen3's experts in the first batch's
//   layer 0); in plain order one CTA could draw several long items.  A
//   chunk starts at row lo + c C (Tile::a_row = b_row); at a group's end
//   that is not on a 64-row stage, the consumers zero both operands' rows
//   past hi in shared memory (MASK), so rows of the next group or of
//   padding never reach the product, whatever they hold.  A
//   group of one chunk writes its bf16 block directly; the chunks of a
//   larger group write fp32 partials into the workspace (at most 2 m / C
//   [K, N] slots: a group of r > C rows has ceil(r / C) < 2 r / C chunks),
//   and a second launch, tgmm_reduce, adds them in chunk order and writes
//   bf16, so the result is the same run to run (no float atomics).  A call
//   makes that second launch whenever a group could split (m > C), one
//   launch otherwise.  The sorted path's groups (about 1,000 rows at
//   m 147,456, C 29,440) never split.
//
// Epilogues store 16 bytes a thread (8 columns of a row, gathered from the
// wgmma fragment by a quad transpose through shuffles), bounded by N and
// by the item's rows; fp32 partials go out as float2 pairs; a tile of
// zeros is written with 16-byte stores.

#include "gmm_items.cuh"

namespace gmmk {
namespace {

using gi::bf16;
using gi::kMaxGroups;
using gi::pack_bf16;

// forward: lhs [m][K] K-major, rhs[g] [K][N] MN-major
using FwdCfg = wg::Cfg<wg::kBF16, wg::kBF16, false, true, 256, false>;
// dlhs: rhs[g] stored [N][K], K-major
using TransCfg = wg::Cfg<wg::kBF16, wg::kBF16, false, false, 256, false>;
// tgmm: lhs [m][K] and dout [m][N], both MN-major
using TCfg = wg::Cfg<wg::kBF16, wg::kBF16, true, true, 256, false>;
constexpr int kBN = 256;
static_assert(FwdCfg::BN == kBN && TransCfg::BN == kBN && TCfg::BN == kBN,
              "one tile width");

// The group layout of a call.  ends: the clipped inclusive prefix sum;
// tgmm only: chunk0 (E + 1) the exclusive prefix of the chunk counts
// (chunk0[E] = all chunks), slot0 the first workspace slot of a split
// group, split the split groups in order (n_split of them), order the
// groups by decreasing rows of their last chunk.  Up to kMaxGroups groups
// it points into SharedPlan, past that into a global workspace of 5 E + 2
// ints (global_plan).
struct Plan {
  int* ends;
  int* chunk0;
  int* slot0;
  int* split;
  int* order;
  int* n_split;
};

struct SharedPlan {
  int ends[kMaxGroups];
  int chunk0[kMaxGroups + 1];
  int slot0[kMaxGroups];
  int split[kMaxGroups];
  int n_split;
  int order[kMaxGroups];

  __device__ Plan view() {
    return {ends, chunk0, slot0, split, order, &n_split};
  }
};

__device__ __forceinline__ Plan global_plan(int* ws, int E) {
  return {ws, ws + E, ws + 2 * E + 1, ws + 3 * E + 1, ws + 4 * E + 1,
          ws + 5 * E + 1};
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// Fill `pl` (all but order) from ends [E] (every thread of one block
// calls it; warp 0 scans the chunk counts).  The caller synchronises before
// reading.
__device__ void make_plan(const Plan& pl, const int* __restrict__ ends,
                          int E, int m, int chunk_rows) {
  for (int g = threadIdx.x; g < E; g += blockDim.x)
    pl.ends[g] = min(__ldg(ends + g), m);
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int c0 = 0, s0 = 0, f0 = 0;
  for (int b = 0; b < E; b += 32) {
    const int g = b + lane;
    int nc = 0, slots = 0, split = 0;
    if (g < E) {
      const int hi = min(__ldg(ends + g), m);
      const int lo = g ? min(__ldg(ends + g - 1), m) : 0;
      const int rows = max(hi - lo, 0);
      nc = rows > chunk_rows ? (rows + chunk_rows - 1) / chunk_rows : 1;
      split = nc > 1;
      slots = split ? nc : 0;
    }
    const int ci = warp_incl_scan(nc, lane);
    const int si = warp_incl_scan(slots, lane);
    const int fi = warp_incl_scan(split, lane);
    if (g < E) {
      pl.chunk0[g] = c0 + ci - nc;
      pl.slot0[g] = split ? s0 + si - slots : -1;
      if (split) pl.split[f0 + fi - 1] = g;
    }
    c0 += __shfl_sync(0xffffffffu, ci, 31);
    s0 += __shfl_sync(0xffffffffu, si, 31);
    f0 += __shfl_sync(0xffffffffu, fi, 31);
  }
  if (lane == 0) {
    pl.chunk0[E] = c0;
    *pl.n_split = f0;
  }
}

// tgmm: the groups by decreasing rows of their last chunk (ties by
// index), pl.order[r] the r-th, from a published plan; the calling threads
// rank groups first, first + step, ...  Up to kMaxGroups groups every CTA
// fills its shared copy (E^2 / 384 comparisons a thread), past that
// rank_kernel fills the workspace once.  The caller synchronises before
// reading.
__device__ void rank_last_chunks(const Plan& pl, int E, int chunk_rows,
                                 int first, int step) {
  int* order = pl.order;
  auto last = [&](int g) {
    return pl.ends[g] - (g ? pl.ends[g - 1] : 0) -
           (pl.chunk0[g + 1] - pl.chunk0[g] - 1) * chunk_rows;
  };
  for (int g = first; g < E; g += step) {
    const int rg = last(g);
    int r = 0;
    for (int h = 0; h < E; ++h) {
      const int rh = last(h);
      r += rh > rg || (rh == rg && h < g);
    }
    order[r] = g;
  }
}

// the group of full chunk s: first g with chunk0[g + 1] - (g + 1) > s
// (chunk0[g] - g counts the full chunks of the groups before g)
__device__ __forceinline__ int full_chunk_group(const int* chunk0, int E,
                                                int s) {
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (chunk0[mid + 1] - mid - 1 > s) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

// registers i and i + 1 of a tile of sums, as packed bf16
__device__ __forceinline__ auto sums(const float (&acc)[kBN / 2]) {
  return [&acc](int i) { return pack_bf16(acc[i], acc[i + 1]); };
}

struct GmmArgs {
  const int* ends;
  const int* plan;          // the clipped ends past kMaxGroups groups
  bf16* out;
  int m, K, N, E, kt, n_m, n_n;
};

template <class C, bool TRANS>
__global__ void __launch_bounds__(wg::kThreads, 1)
gmm_kernel(const __grid_constant__ CUtensorMap ta,
           const __grid_constant__ CUtensorMap tb, const GmmArgs p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ int ends_s[kMaxGroups];
  const int* ends = gi::plan_ends(ends_s, p.ends, p.plan, p.E, p.m);
  // (the mainloop's first __syncthreads publishes ends)
  auto tile = [&](int i) {
    return gi::fwd_item(i, ends, p.E, p.n_m, p.n_n, kBN, p.kt,
                        TRANS ? p.N : p.K);
  };
  // rows [r_lo, r_hi) get the item's sums, [r_hi, z_hi) zeros
  int r_lo = 0, r_hi = 0, z_hi = 0;
  auto pre = [&](int, const wg::Tile& t) {
    gi::fwd_rows(t, ends, p.E, p.m, r_lo, r_hi, z_hi);
  };
  auto epi = [&](int w, const wg::Tile& t, float (&acc)[C::BN / 2]) {
    if (t.nk == 0) {
      gi::store_zeros<kBN>(p.out, p.N, p.N, t.m0, t.n0, w, r_hi, z_hi);
      return;
    }
    gi::store_tile<kBN>(p.out, p.N, p.N, t.m0, t.n0, w, sums(acc), r_lo,
                        r_hi, z_hi);
  };
  wg::mainloop<C>(smem, &ta, &tb, p.n_n * (p.n_m + p.E), tile, epi, pre);
}

struct TgmmArgs {
  const int* ends;
  int* plan;                // the plan past kMaxGroups groups
  bf16* out;
  float* ws;
  int m, K, N, E, chunk_rows, n_k, n_n;
};

__global__ void __launch_bounds__(wg::kThreads, 1)
tgmm_kernel(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tb, const TgmmArgs p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ SharedPlan sp;
  Plan pl = global_plan(p.plan, p.E);
  if (p.E <= kMaxGroups) {
    pl = sp.view();
    make_plan(pl, p.ends, p.E, p.m, p.chunk_rows);
    __syncthreads();
    rank_last_chunks(pl, p.E, p.chunk_rows, threadIdx.x, blockDim.x);
  }
  // (the mainloop's first __syncthreads publishes the order)
  const int tiles = p.n_k * p.n_n;
  const int n_work = tiles * (p.E + p.m / p.chunk_rows);
  auto tile = [&](int i) {
    wg::Tile t;
    // item i is item j of the longest-first list, in snake order over
    // bands of gridDim.x (odd bands reversed within their length)
    const int G = gridDim.x, b = i / G, len = min(G, n_work - b * G);
    const int j = b * G + ((b & 1) ? len - 1 - i % G : i % G);
    const int slot = j / tiles, tt = j % tiles;
    t.m0 = (tt % p.n_k) * wg::kBM;
    t.n0 = (tt / p.n_k) * kBN;
    t.kt0 = 0;
    t.nk = 0;
    t.part = -1;                                         // idle
    const int full = pl.chunk0[p.E] - p.E;   // chunks of C rows, first
    if (slot < full + p.E) {
      int g, c;
      if (slot < full) {
        g = full_chunk_group(pl.chunk0, p.E, slot);
        c = slot - (pl.chunk0[g] - g);
      } else {
        g = pl.order[slot - full];
        c = pl.chunk0[g + 1] - pl.chunk0[g] - 1;
      }
      const int lo = g ? pl.ends[g - 1] : 0;
      const int r0 = lo + c * p.chunk_rows;
      const int rows = max(min(r0 + p.chunk_rows, pl.ends[g]) - r0, 0);
      t.part = g;
      t.nk = (rows + TCfg::BK - 1) / TCfg::BK;
      t.a_row = t.b_row = r0;
      t.k_valid = rows;
    }
    return t;
  };
  auto epi = [&](int w, const wg::Tile& t, float (&acc)[TCfg::BN / 2]) {
    const int g = t.part;
    if (g < 0) return;
    const size_t kn = (size_t)p.K * p.N;
    bf16* o = p.out + g * kn;
    if (t.nk == 0) {                                     // empty group
      gi::store_zeros<kBN>(o, p.N, p.N, t.m0, t.n0, w, 0, p.K);
      return;
    }
    const int slot0 = pl.slot0[g];
    if (slot0 < 0) {                                     // one chunk
      gi::store_tile<kBN>(o, p.N, p.N, t.m0, t.n0, w, sums(acc), 0, p.K,
                          p.K);
      return;
    }
    const int lo = g ? pl.ends[g - 1] : 0;
    float* part = p.ws + (slot0 + (t.a_row - lo) / p.chunk_rows) * kn;
#pragma unroll
    for (int i = 0; i < TCfg::BN / 2; i += 2) {
      const int kk = t.m0 + wg::acc_row(w, i);
      const int col = t.n0 + wg::acc_col(i);
      if (kk < p.K && col < p.N)                         // N % 8 == 0
        *reinterpret_cast<float2*>(part + (size_t)kk * p.N + col) =
            make_float2(acc[i], acc[i + 1]);
    }
  };
  wg::mainloop<TCfg, true>(smem, &ta, &tb, n_work, tile, epi);
}

// the global plan past kMaxGroups groups: all but the order (one block)
__global__ void __launch_bounds__(1024)
plan_kernel(int* ws, const int* __restrict__ ends, int E, int m,
            int chunk_rows) {
  make_plan(global_plan(ws, E), ends, E, m, chunk_rows);
}

// then the order, one group a thread
__global__ void __launch_bounds__(256)
rank_kernel(int* ws, int E, int chunk_rows) {
  rank_last_chunks(global_plan(ws, E), E, chunk_rows,
                   blockIdx.x * blockDim.x + threadIdx.x,
                   gridDim.x * blockDim.x);
}

// out[g] = the chunk partials of each split group g added in chunk order
__global__ void __launch_bounds__(256)
tgmm_reduce(const float* __restrict__ ws, bf16* __restrict__ out,
            const int* __restrict__ ends, int* plan, int m, int K, int N,
            int E, int chunk_rows) {
  __shared__ SharedPlan sp;
  Plan pl = global_plan(plan, E);
  if (E <= kMaxGroups) {
    pl = sp.view();
    make_plan(pl, ends, E, m, chunk_rows);
    __syncthreads();
  }
  const size_t kn = (size_t)K * N, vecs = kn / 4;        // N % 8 == 0
  for (int j = 0; j < *pl.n_split; ++j) {
    const int g = pl.split[j];
    const int nc = pl.chunk0[g + 1] - pl.chunk0[g];
    const float4* src = reinterpret_cast<const float4*>(ws + pl.slot0[g] * kn);
    uint2* dst = reinterpret_cast<uint2*>(out + g * kn);
    for (size_t v = blockIdx.x * (size_t)blockDim.x + threadIdx.x; v < vecs;
         v += (size_t)gridDim.x * blockDim.x) {
      float4 s = src[v];
      for (int c = 1; c < nc; ++c) {
        const float4 x = src[c * vecs + v];
        s.x += x.x;
        s.y += x.y;
        s.z += x.z;
        s.w += x.w;
      }
      dst[v] = make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
    }
  }
}

}  // namespace
}  // namespace gmmk

// Shapes both kernels take: K and N multiples of 8 (16-byte rows), m > 0,
// E > 0; `ends` [E] int32 the inclusive prefix sum of the group sizes;
// operands 16-byte aligned (TMA).  `plan`: an int32 workspace for the
// group plan past 1024 groups (gmm_fwd E ints, tgmm 5 E + 2; unused, may
// be null, at or below 1024).  Each returns 0, -1 for a shape it does not
// take, a tensor-map error (wgmma_gemm.cuh::make_map), else the
// cudaError_t of the first failed launch.

// out [m, N] bf16 <- lhs [m, K] (grouped rows) @ rhs [E, K, N], or with
// trans_rhs rhs stored [E, N, K] and read transposed
extern "C" int gmm_fwd(const void* lhs, const void* rhs, const int* ends,
                       int* plan, void* out, int m, int K, int N, int E,
                       int trans_rhs, void* stream) {
  using namespace gmmk;
  if (m <= 0 || E <= 0 || K % 8 || N % 8 || K <= 0 || N <= 0 ||
      (E > kMaxGroups && plan == nullptr))
    return -1;
  GmmArgs p{ends, plan, static_cast<bf16*>(out), m, K, N, E,
            (K + FwdCfg::BK - 1) / FwdCfg::BK, (m + wg::kBM - 1) / wg::kBM,
            (N + kBN - 1) / kBN};
  const int work = p.n_n * (p.n_m + E);
  const int grid = work < lce::num_sms() ? work : lce::num_sms();
  const auto s = static_cast<cudaStream_t>(stream);
  CUtensorMap ta, tb;
  int rc = gi::launch_clip_ends(plan, ends, E, m, s);
  if (rc) return rc;
  if (trans_rhs) {
    if ((rc = wg::operand_map<TransCfg, true>(&ta, lhs, m, K, K))) return rc;
    if ((rc = wg::operand_map<TransCfg, false>(&tb, rhs, (long long)E * N, K,
                                               K)))
      return rc;
    if ((rc = wg::prepare<TransCfg>(gmm_kernel<TransCfg, true>))) return rc;
    gmm_kernel<TransCfg, true>
        <<<grid, wg::kThreads, TransCfg::kSmemBytes, s>>>(ta, tb, p);
  } else {
    if ((rc = wg::operand_map<FwdCfg, true>(&ta, lhs, m, K, K))) return rc;
    if ((rc = wg::operand_map<FwdCfg, false>(&tb, rhs, N, (long long)E * K,
                                             N)))
      return rc;
    if ((rc = wg::prepare<FwdCfg>(gmm_kernel<FwdCfg, false>))) return rc;
    gmm_kernel<FwdCfg, false>
        <<<grid, wg::kThreads, FwdCfg::kSmemBytes, s>>>(ta, tb, p);
  }
  return static_cast<int>(cudaGetLastError());
}

// out [E, K, N] bf16 <- per group lhs[rows of g]^T @ dout[rows of g], with
// lhs [m, K] and dout [m, N]; chunk_rows (C) a positive multiple of 64; ws
// fp32 [2 m / C][K][N] when m > C (unused, may be null, otherwise)
extern "C" int tgmm(const void* lhs, const void* dout, const int* ends,
                    int* plan, void* out, void* ws, int m, int K, int N,
                    int E, int chunk_rows, void* stream) {
  using namespace gmmk;
  if (m <= 0 || E <= 0 || K % 8 || N % 8 || K <= 0 || N <= 0 ||
      chunk_rows <= 0 || chunk_rows % TCfg::BK ||
      (m > chunk_rows && ws == nullptr) ||
      (E > kMaxGroups && plan == nullptr))
    return -1;
  TgmmArgs p{ends, plan, static_cast<bf16*>(out), static_cast<float*>(ws), m,
             K, N, E, chunk_rows, (K + wg::kBM - 1) / wg::kBM,
             (N + kBN - 1) / kBN};
  const int work = p.n_k * p.n_n * (E + m / chunk_rows);
  const auto s = static_cast<cudaStream_t>(stream);
  if (E > kMaxGroups) {
    plan_kernel<<<1, 1024, 0, s>>>(plan, ends, E, m, chunk_rows);
    rank_kernel<<<(E + 255) / 256, 256, 0, s>>>(plan, E, chunk_rows);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  CUtensorMap ta, tb;
  int rc = wg::operand_map<TCfg, true>(&ta, lhs, K, m, K);
  if (rc) return rc;
  if ((rc = wg::operand_map<TCfg, false>(&tb, dout, N, m, N))) return rc;
  if ((rc = wg::prepare<TCfg>(tgmm_kernel))) return rc;
  const int sms = lce::num_sms();
  tgmm_kernel<<<work < sms ? work : sms, wg::kThreads, TCfg::kSmemBytes, s>>>(
      ta, tb, p);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  if (m > chunk_rows) {
    const long long vecs = (long long)K * N / 4;
    const long long want = (vecs + 255) / 256;
    tgmm_reduce<<<want < 4 * sms ? (int)want : 4 * sms, 256, 0, s>>>(
        static_cast<const float*>(ws), static_cast<bf16*>(out), ends, plan, m,
        K, N, E, chunk_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
