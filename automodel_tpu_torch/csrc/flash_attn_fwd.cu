// Training attention (the splash rung), forward, for Hopper (sm_90a);
// plain C interface for ctypes.
//
// Replaces the TPU kernel automodel_tpu/ops/splash_attention.py:129
// (_build_kernel: upstream Pallas splash attention, forward half), called
// by splash_attention_bshd (:183).  Same function, on the JAX package's
// layout: q [B, S, Hq, D], k/v [B, S, Hk, D] bf16 (Hq a multiple of Hk,
// no kv-head repeat), causal or full, packed-sequence segment ids [B, S]
// int32 (0 = padding: never attends, never attended), a static sliding
// window (attend [q - window + 1, q]), an optional logit soft cap
// cap * tanh(x / cap) and a softmax scale applied to the fp32 scores.
// Writes out [B, S, Hq, D] bf16 and the row log-sum-exp lse [B, Hq, S]
// fp32 that the backward needs; a query row with no key to attend
// (segment 0, or an empty window) gets out = 0 and lse = 0.
//
// Design: attn_core.cuh's forward (FlashAttention-3's shape): persistent
// CTAs over (128-row q tile, q head, batch row) items, the last q tiles
// first; a producer thread keeps TMA loads of 128-key K and V tiles in
// flight through a ring of mbarrier stages (4-D tensor maps over the
// layout as it lies); two consumer warpgroups of 64 query rows run S = Q
// K^T by wgmma from shared memory, the online softmax in fp32 registers
// (exp2, the scale and log2(e) folded into one multiply) and O += P V by
// wgmma with P from registers.  Tiles are classified once each from
// causality, the window, the ragged edge and per-64-row segment ranges
// (a tile_meta launch first): skipped tiles are never loaded, full tiles
// are not masked, partial tiles are masked per element.  The soft cap and
// the window are compiled in only when a call sets one.  A CTA holds one
// query head; the items of a kv head's Hq / Hk query heads run side by
// side (the head is the fastest index of the item order), so their K/V
// tiles come from device memory about once and from L2 after.  Stacking
// the group's heads in one CTA, to load each K/V tile once for all of
// them, was not built (PERF.md, PR 11).
//
// Bound at the SFT shape (sft_packed_d64: B 8, S 2048, Hq/Hk 32/8, D 64,
// packed segments; chip_smoke.py's attn_bound): the bytes -- q, k, v, out,
// lse and the segment ids read or written once, 50.7 us at 3.35 TB/s --
// above the 4 D Hq flops per attended pair on the bf16 tensor cores (the
// packing leaves few pairs); with pure causal rows (causal_d64) the
// operations bound it.  The design reads each operand tile once per CTA
// by TMA, skips whole tiles that no pair of the packing reaches and keeps
// the per-element mask off the tiles inside one segment.

// head_dim 192 (DeepSeek's MLA, sft_deepseek and generate()'s prefill):
// the same kernel with 64-key K / V tiles (a 128-key stage beside the 48 KB
// Q tile would not fit three times) and O's accumulator of 96 registers a
// thread; at Hq = Hk (MLA's broadcast rope head) each query head is its own
// kv head.

// head_dim 256 (Gemma-2 / Gemma-3): 64-key K / V tiles in two stages beside
// the 64 KB Q tile, and O's accumulator of 128 registers a thread (m64n256
// wgmma).

#include "attn_core.cuh"

namespace {

template <int D, bool EXTRAS>
struct Splash : attn::Rung<D, false, false, EXTRAS> {};

template <int D>
int run(const void* q, const void* k, const void* v, const attn::Args& p,
        bool extras, cudaStream_t s) {
  return extras ? attn::forward<Splash<D, true>>(q, k, v, p, s)
                : attn::forward<Splash<D, false>>(q, k, v, p, s);
}

}  // namespace

// Returns 0 on success, -1 for what the kernels do not take (head_dim
// other than 64 / 128 / 192 / 256, Hq not a multiple of Hk, a window without
// causal, segment ids without the meta workspace), else a tensor-map error
// (attn_core.cuh::map4) or the first failed launch's cudaError_t.  seg may
// be null (no segments); meta is int32 scratch [B, ceil(S / 64), 4] when
// seg is given; cap <= 0 is no soft cap; window <= 0 is no window.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const int* seg, void* meta, void* out,
                              float* lse, int B, int S, int Hq, int Hk, int D,
                              float scale, float cap, int causal, int window,
                              void* stream) {
  if ((D != 64 && D != 128 && D != 192 && D != 256) || B <= 0 || S <= 0 || Hk <= 0 ||
      Hq % Hk || (seg != nullptr && meta == nullptr) ||
      (window > 0 && !causal))
    return -1;
  attn::Args p = attn::make_args(false, seg, meta, B, S, Hq, Hk, D, scale,
                                 cap, causal, window);
  p.out = static_cast<attn::bf16*>(out);
  p.lse = lse;
  const bool extras = cap > 0.f || window > 0;
  const auto st = static_cast<cudaStream_t>(stream);
  return D == 64    ? run<64>(q, k, v, p, extras, st)
         : D == 128 ? run<128>(q, k, v, p, extras, st)
         : D == 192 ? run<192>(q, k, v, p, extras, st)
                    : run<256>(q, k, v, p, extras, st);
}
