// Training attention (the splash rung), backward, for Hopper (sm_90a);
// plain C interface for ctypes.
//
// Replaces the TPU kernel automodel_tpu/ops/splash_attention.py:129
// (_build_kernel: upstream Pallas splash attention, its fused dq/dkv
// backward, use_fused_bwd_kernel=True at :166-170), called by
// splash_attention_bshd (:183).  Inputs are the forward's operands and
// results: q [B, S, Hq, D], k/v [B, S, Hk, D], out and dout [B, S, Hq, D]
// (bf16), lse [B, Hq, S] fp32, the same mask arguments as the forward.
// Outputs dq [B, S, Hq, D], dk / dv [B, S, Hk, D], bf16.
//
// Design: attn_core.cuh's backward, in three passes on the caller's
// stream (after the tile_meta launch when there are segments):
//   1. delta = rowsum(dout * out), fp32;
//   2. dQ: persistent CTAs over (128-row q tile, q head, batch row); K and
//      V 64-key tiles by TMA through an mbarrier ring; S = Q K^T and dP =
//      dO V^T by wgmma, P = exp(S scale - lse), dS = P (dP - delta) dx
//      (dx the soft cap's derivative), dQ += dS K by wgmma with dS from
//      registers; dQ summed in registers and written once;
//   3. dK / dV: persistent CTAs over (128-key tile, kv head, batch row),
//      the first key tiles first; for each of the group's Hq / Hk query
//      heads and each 64-row q tile that can see the keys, Q, dO, lse and
//      delta by TMA through the ring; S^T = K Q^T and dP^T = V dO^T by
//      wgmma, dV += P^T dO and dK += dS^T Q by wgmma with P^T and dS^T
//      from registers; dK and dV summed over the whole group in registers
//      and written once.
// The fused Pallas backward sums dQ across kv tiles in VMEM; here the dQ
// pass recomputes S and dP instead (seven products a pair, not five) and
// no output is summed with atomics: every element is written by one thread
// once, so the backward gives the same bits run to run.  The other way to
// drop the earlier kernel's per-element atomics -- each warpgroup's dS^T K
// added into an fp32 dQ by bulk TMA reduce-adds from the dK / dV pass --
// was built and ran slower at every measured shape (PERF.md, PR 11).
// Tiles are classified as in the forward: skipped tiles are never loaded,
// full ones never masked.
//
// Bound at the SFT shape (sft_packed_d64; chip_smoke.py's attn_bound): the
// operations -- 10 D Hq flops per attended pair on the bf16 tensor cores,
// 109.7 us -- above the bytes of the operands, dout and the three
// gradients.  The design keeps every product on wgmma with operands fed by
// TMA, and spends its extra work (the dQ pass's recomputed S and dP) on
// the live tiles only.

// head_dim 192 (MLA): the dK / dV pass runs as two launches over the same
// items, dV then dK, each holding one 64 x 192 accumulator (the two together
// and the score tiles exceed a thread's registers); the dQ pass and both of
// those keep two ring stages.  The dV launch skips the dP product, so the
// pair costs one S^T product more than the fused pass.

// head_dim 256 (Gemma-2 / Gemma-3): the same two dK / dV launches, over
// 32-row q tiles (two stages beside the 128 KB K and V tiles), and a dQ
// pass over 32-key tiles (three stages beside the 128 KB Q and dO tiles),
// each pass with one 64 x 256 accumulator.

#include "attn_core.cuh"

namespace {

template <int D, bool EXTRAS>
struct Splash : attn::Rung<D, false, false, EXTRAS> {};

template <int D>
int run(const void* q, const void* k, const void* v, const attn::Args& p,
        bool extras, cudaStream_t s) {
  return extras ? attn::backward<Splash<D, true>>(q, k, v, p, s)
                : attn::backward<Splash<D, false>>(q, k, v, p, s);
}

}  // namespace

// Returns 0 on success, -1 for what the kernels do not take (as the
// forward), else a tensor-map error or the first failed launch's
// cudaError_t.  delta is fp32 scratch [B, Hq, S]; meta int32 scratch [B,
// ceil(S / 64), 4] when seg is given; seg_kv / meta_kv as the forward's
// (the keys' ids; lse is the merged one of the ring's rows).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* out, const void* dout,
                              float* lse, float* delta, const int* seg,
                              void* meta, const int* seg_kv, void* meta_kv,
                              void* dq, void* dk, void* dv, int B,
                              int S, int Hq, int Hk, int D, float scale,
                              float cap, int causal, int window,
                              void* stream) {
  if ((D != 64 && D != 128 && D != 192 && D != 256) || B <= 0 || S <= 0 || Hk <= 0 ||
      Hq % Hk || (seg != nullptr && meta == nullptr) ||
      (seg_kv != nullptr && (seg == nullptr || meta_kv == nullptr)) ||
      (window > 0 && !causal))
    return -1;
  attn::Args p = attn::make_args(false, seg, meta, B, S, Hq, Hk, D, scale,
                                 cap, causal, window);
  if (seg_kv != nullptr) {
    p.seg_kv = seg_kv;
    p.meta_kv = static_cast<int4*>(meta_kv);
    p.kv_ids = 1;
  }
  p.lse = lse;
  p.o_in = static_cast<const attn::bf16*>(out);
  p.dout = static_cast<const attn::bf16*>(dout);
  p.delta = delta;
  p.dq = static_cast<attn::bf16*>(dq);
  p.dk = static_cast<attn::bf16*>(dk);
  p.dv = static_cast<attn::bf16*>(dv);
  const bool extras = cap > 0.f || window > 0;
  const auto st = static_cast<cudaStream_t>(stream);
  return D == 64    ? run<64>(q, k, v, p, extras, st)
         : D == 128 ? run<128>(q, k, v, p, extras, st)
         : D == 192 ? run<192>(q, k, v, p, extras, st)
                    : run<256>(q, k, v, p, extras, st);
}
