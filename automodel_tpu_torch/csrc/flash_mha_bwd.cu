// Flash rung (MHA flash attention), backward, for Hopper (sm_90a); plain C
// interface for ctypes.
//
// Replaces the TPU kernel automodel_tpu/ops/flash_attention.py:66 (_flash:
// the upstream Pallas MHA flash kernel, its backward: separate dkv and dq
// passes), called by flash_attention_bshd (:90).  Inputs are the forward's
// operands and results: q, k, v, out, dout [B, H, S, D] bf16, lse [B, H, S]
// fp32, segment ids [B, S] (equality rule, flash_mha_fwd.cu).  Outputs dq,
// dk, dv [B, H, S, D] bf16.
//
// Design: the splash rung's backward (flash_attn_bwd.cu), from the same
// attn_core.cuh, instantiated for the [B, H, S, D] layout, the equality
// rule and no soft cap or window: delta, then a dQ pass over q tiles and a
// dK / dV pass over kv tiles (split, as the upstream kernel is), every
// product on wgmma with operands by TMA through mbarrier rings.  Every
// output element is written by one thread once (no atomics): the backward
// is deterministic, run to run bitwise equal.
//
// Bound at sft_flash's shape (chip_smoke.py's flash_case): the operations
// -- 10 D H flops per attended pair on the bf16 tensor cores, 163.8 us --
// above the bytes; the split recomputes S and dP in the dQ pass (14 flops
// where 10 are counted), on live tiles only.

#include "attn_core.cuh"

namespace {

template <int D>
struct Mha : attn::Rung<D, true, true, false> {};

}  // namespace

// Returns 0 on success, -1 for what the kernels do not take (as the
// forward), else a tensor-map error or the first failed launch's
// cudaError_t.  delta is fp32 scratch [B, H, S]; meta int32 scratch [B,
// ceil(S / 64), 4] when seg is given.
extern "C" int flash_mha_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* dout, float* lse,
                             float* delta, const int* seg, void* meta,
                             void* dq, void* dk, void* dv, int B, int S,
                             int H, int D, float scale, int causal,
                             void* stream) {
  if ((D != 64 && D != 128) || B <= 0 || S <= 0 || H <= 0 ||
      (seg != nullptr && meta == nullptr))
    return -1;
  attn::Args p = attn::make_args(true, seg, meta, B, S, H, H, D, scale, 0.f,
                                 causal, 0);
  p.lse = lse;
  p.o_in = static_cast<const attn::bf16*>(out);
  p.dout = static_cast<const attn::bf16*>(dout);
  p.delta = delta;
  p.dq = static_cast<attn::bf16*>(dq);
  p.dk = static_cast<attn::bf16*>(dk);
  p.dv = static_cast<attn::bf16*>(dv);
  const auto st = static_cast<cudaStream_t>(stream);
  return D == 64 ? attn::backward<Mha<64>>(q, k, v, p, st)
                 : attn::backward<Mha<128>>(q, k, v, p, st);
}
