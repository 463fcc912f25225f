// Flash rung (MHA flash attention), forward, for Hopper (sm_90a); plain C
// interface for ctypes.
//
// Replaces the TPU kernel automodel_tpu/ops/flash_attention.py:66 (_flash:
// the upstream Pallas MHA flash kernel, forward half), called by
// flash_attention_bshd (:90).  Same function: q, k, v [B, H, S, D] bf16
// (MHA: the wrapper repeats kv heads for GQA), softmax(scale * q k^T) v,
// causal or full, segment ids [B, S] int32 with the upstream equality rule
// (query i attends key j iff seg[i] == seg[j]: segment 0 attends segment
// 0, so every row attends at least itself).  Writes out [B, H, S, D] bf16
// and the row log-sum-exp lse [B, H, S] fp32 for the backward.
//
// Design: the splash rung's forward (flash_attn_fwd.cu), from the same
// attn_core.cuh, instantiated for the [B, H, S, D] layout, the equality
// rule, one query head per kv head, no soft cap and no window: TMA rings
// of K / V tiles, S = Q K^T and O += P V on wgmma, the online softmax in
// fp32 registers, skip / full / partial tiles from per-tile segment ranges.
//
// Bound at sft_flash's shape (B 8, S 2048, 32 heads, D 64, the bench
// YAML's packed rows, padding included; chip_smoke.py's flash_case): the
// bytes -- q, k, v (as MHA), out, lse and the segment ids moved once, 80.8
// us at 3.35 TB/s -- above the 4 D H flops per attended pair.  The design
// reads each operand tile once per CTA by TMA and skips the tiles no pair
// of the packing reaches.

#include "attn_core.cuh"

namespace {

template <int D>
struct Mha : attn::Rung<D, true, true, false> {};

}  // namespace

// Returns 0 on success, -1 for what the kernels do not take (head_dim
// other than 64 / 128, segment ids without the meta workspace), else a
// tensor-map error or the first failed launch's cudaError_t.  seg may be
// null; meta is int32 scratch [B, ceil(S / 64), 4] when seg is given.
extern "C" int flash_mha_fwd(const void* q, const void* k, const void* v,
                             const int* seg, void* meta, void* out,
                             float* lse, int B, int S, int H, int D,
                             float scale, int causal, void* stream) {
  if ((D != 64 && D != 128) || B <= 0 || S <= 0 || H <= 0 ||
      (seg != nullptr && meta == nullptr))
    return -1;
  attn::Args p = attn::make_args(true, seg, meta, B, S, H, H, D, scale, 0.f,
                                 causal, 0);
  p.out = static_cast<attn::bf16*>(out);
  p.lse = lse;
  const auto st = static_cast<cudaStream_t>(stream);
  return D == 64 ? attn::forward<Mha<64>>(q, k, v, p, st)
                 : attn::forward<Mha<128>>(q, k, v, p, st);
}
