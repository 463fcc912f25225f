// The attention core shared by both training-attention rungs, for Hopper
// (sm_90a): the forward and the two backward passes (dQ, then dK/dV) of
// softmax attention, built on TMA loads through mbarrier rings and wgmma
// tensor-core products (FlashAttention-3's shape).  Included by
// flash_attn_fwd.cu / flash_attn_bwd.cu (kernel 9, the splash rung) and
// flash_mha_fwd.cu / flash_mha_bwd.cu (kernel 10, the MHA flash rung);
// each instantiates the kernels with its own Rung: the layout, the segment
// rule, head_dim and whether the soft cap and the window are compiled in.
//
// head_dim 64 and 128 run on both rungs; 192 (MLA's qk_nope 128 + qk_rope
// 64, v padded to it by the model) on the splash rung, with three changes
// that keep shared memory and registers within a CTA's: the forward's kv
// tiles are 64 keys (FwdCfg), the dQ and dK / dV passes keep two stages,
// and the dK / dV pass runs twice, dV then dK (Part), each with one
// 96-register accumulator (the two together would not fit beside the score
// tiles).  Its products are m64n192 wgmma (mma_rs_n192) with three 64-column
// TMA boxes a row tile.
//
// head_dim 256 (Gemma-2 / Gemma-3) runs on the splash rung the same way,
// with narrower tiles where a 256-wide row would overflow shared memory or
// registers: the forward's kv tiles are 64 keys in two stages beside the
// 64 KB Q tile; the dQ pass walks 32-key tiles (three stages of K and V
// beside Q and dO, 128 KB) and the dK / dV passes 32-row q tiles (two
// stages of Q and dO beside K and V, 128 KB), each pass holding one
// 128-register accumulator (m64n256 wgmma, mma_rs_n256; the 32-wide score
// tiles are m64n32, mma_ss_n32).  A 32-row tile reads the segment meta of
// the 64-row tile it lies in, which is a superset of its own ids: such a
// tile is classified as its 64-row tile would be, never skipped wrongly.
//
// Operands: q [B, S, Hq, D] or [B, Hq, S, D] (Rung::BHSD), k and v the
// same with Hk heads (Hq a multiple of Hk: query head h reads kv head
// h / (Hq / Hk), no repeat), bf16, 16-byte aligned, contiguous.  Every
// operand tile comes in through one 4-D tensor map over the layout as it
// lies, dims (D, S, H, B), boxes of 64 columns (128 bytes, the swizzle
// span) by a tile's rows, 128-byte swizzle, so a tile of R rows x D is D /
// 64 boxes of R x 128 bytes; rows past S are zero-filled by TMA, so any S
// works.  lse and delta [B, Hq, S] fp32 come in (backward) through 1-D maps
// of 64-value boxes.
//
// Masks: causal or full; segment ids [B, S] int32 (may be null) under the
// splash rule (segment 0 never attends and is never attended) or the
// equality rule (Rung::SEG_EQ: segment 0 attends segment 0); with
// Rung::EXTRAS a trailing window (attend [q - window + 1, q]) and a logit
// soft cap cap * tanh(x / cap) on the scaled fp32 scores.
//
// Tiles are classified once per (q tile, kv tile) from causality, the
// window, the ragged edge and per-tile segment ranges (tile_meta: the
// lowest and highest id a 64-row tile holds under the rule, and whether it
// is one id on rows all inside S):
//   skip:    no pair can attend (no load, no product);
//   full:    every pair attends (no per-element mask);
//   partial: masked per element.
// The producer and the consumers walk the same tiles, each classifying
// them itself from the same metas, so they agree without talking.  A
// partial tile is masked from each row's attendable column range and the
// tile's column segment ids, which the producer stages with the tile.
// ops/attention_plan.py mirrors the classification and the item order.
//
// Every kernel: one persistent CTA per SM of 3 warpgroups over work items
// (the longest first); warpgroup 0's first thread is the producer (TMA
// loads, mbarrier "full" / "empty" rings that run on across items), the
// other two are consumers of 64 rows each; setmaxnreg moves registers from
// the producer (40) to the consumers (232).  The consumers take turns to
// issue their products (two named barriers), so one's elementwise work
// runs while the other's products hold the tensor cores; in the forward
// and the dQ pass each also issues a tile's last product together with
// the next tile's first (the FFMA / exp2 work of one tile overlaps the
// tensor work of the last).  The dK / dV pass has no such overlap: its two
// accumulators leave too few registers for a second tile's scores (tried
// at head_dim 64 too, it ran slower: PERF.md, PR 11).
//
//   forward (fwd_kernel): an item is a 128-row q tile of one (head, batch
//     row), the q tiles nearest the end first.  Q in one of kQBufs buffers,
//     K and V 128-key tiles through a ring of stages (K and V on barriers of
//     their own, so S = Q K^T starts before V lands).  Per live kv tile, in
//     descending order (the diagonal first): S = Q K^T by wgmma (both
//     operands K-major in shared memory, m64n128k16), the online softmax in
//     fp32 registers in the log2 domain (the scale times log2(e) folded
//     into the FFMA before ex2.approx; maxima and sums in four chains a
//     row), P rounded to bf16 in registers and O += P V by wgmma with A
//     from registers (the accumulator's layout is wgmma's A fragment) and
//     V read MN-major from the same shared tile, issued with the next
//     tile's S.  Writes out (bf16) and lse (fp32; 0 and out 0 for a row
//     with no key).
//   backward, delta (delta_kernel): delta = rowsum(dout * out), fp32,
//     D / 8 lanes a row, 16-byte loads.
//   backward, dQ (dq_kernel): items as the forward's; Q and dO once per
//     item, K and V 64-key tiles through the ring; S = Q K^T, dP = dO V^T
//     (SS), P = exp2(S scale log2e - lse log2e), dS = P (dP - delta) dx,
//     dQ += dS K (RS, K read MN-major); dQ summed in registers, written
//     once in bf16.
//   backward, dK/dV (dkv_kernel): an item is a 128-key tile of one (kv
//     head, batch row), the first key tiles first (they see the most causal
//     rows); K and V once per item, then for each of the Hq / Hk query
//     heads and each 64-row q tile that can see the keys, Q, dO, lse and
//     delta through the ring: S^T = K Q^T, dP^T = V dO^T (SS), P^T and dS^T
//     as above, dV += P^T dO and dK += dS^T Q (RS, Q and dO read MN-major);
//     dK and dV summed in registers over the whole group and written once.
// No output element is written by two threads or summed with atomics, so
// both passes give the same bits run to run.

#pragma once

#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_async.cuh"     // mbarriers, TMA, descriptors, fences
#include "linear_ce_gemm.cuh"   // bf16, pack_bf16, num_sms

namespace attn {

using lce::bf16;
using lce::pack_bf16;

constexpr int kThreads = 384;         // producer + 2 consumer warpgroups
constexpr int kTile = 64;             // rows of a segment meta; the q step
                                      // of dK/dV and the kv step of dQ
constexpr int kBox = 64;              // columns of a TMA box (128 bytes)
constexpr int kRowBytes = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

enum Cls : int { kSkip = 0, kPartial = 1, kFull = 2 };

// ---------------------------------------------------------------------------
// wgmma shapes attention needs: SS n32 / n64 / n128, RS n64 / n128 / n192 /
// n256 (bf16 in,
// fp32 sums; accumulator register i of a thread holds row 16 (warp % 4) + g
// + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t + (i % 2), g = lane / 4, t =
// lane % 4)
// ---------------------------------------------------------------------------
// D (m64n64, fp32) += A B over one K step of 16, A and B bf16 K-major in
// shared memory; scale_d 0: D = A B
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (m64n32, fp32) += A B over one K step of 16, A and B bf16 K-major in
// shared memory; scale_d 0: D = A B (head_dim 256's 32-row tiles)
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (m64n128, fp32) += A B over one K step of 16, A and B bf16 K-major in
// shared memory; scale_d 0: D = A B
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (m64n64, fp32) += A B over one K step of 16, A bf16 from registers
// (wgmma's A fragment a[4]), B bf16 in shared memory, MN-major (TRANS_B 1)
// or K-major (0); scale_d 0: D = A B
template <int TRANS_B>
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}

// D (m64n128, fp32) += A B over one K step of 16, A bf16 from registers
// (wgmma's A fragment a[4]), B bf16 in shared memory, MN-major (TRANS_B 1)
// or K-major (0); scale_d 0: D = A B
template <int TRANS_B>
__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}

// D (m64n192, fp32) += A B over one K step of 16, A bf16 from registers
// (wgmma's A fragment a[4]), B bf16 in shared memory, MN-major (TRANS_B 1)
// or K-major (0); scale_d 0: D = A B (head_dim 192: MLA's q/k width)
template <int TRANS_B>
__device__ __forceinline__ void mma_rs_n192(float (&d)[96],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95}"
      ", {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}

// D (m64n256, fp32) += A B over one K step of 16, A bf16 from registers
// (wgmma's A fragment a[4]), B bf16 in shared memory, MN-major (TRANS_B 1)
// or K-major (0); scale_d 0: D = A B (head_dim 256: Gemma's width)
template <int TRANS_B>
__device__ __forceinline__ void mma_rs_n256(float (&d)[128],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}"
      ", {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}

// ---------------------------------------------------------------------------
// rungs, arguments, maps
// ---------------------------------------------------------------------------
// D: head_dim (64, 128, or 192 (MLA's qk_nope + qk_rope) and 256 (Gemma),
// the splash rung only); BHSD: [B, H, S, D] operands, else [B, S, H, D];
// SEG_EQ: the equality segment rule, else splash's; EXTRAS: the window and
// the soft cap compiled in (else both off).  Each rung derives a named type
// from it (Splash<D, EXTRAS>, Mha<D>), so every kernel's name says its rung
// (the profiler's attention rows read it).
template <int D_, bool BHSD_, bool SEG_EQ_, bool EXTRAS_>
struct Rung {
  static constexpr int D = D_;
  static constexpr int NC = D / kBox;           // boxes across a row tile
  static constexpr bool BHSD = BHSD_, SEG_EQ = SEG_EQ_, EXTRAS = EXTRAS_;
  static_assert(D == 64 || D == 128 || D == 192 || D == 256,
                "head_dim 64, 128, 192 or 256");
};

// element strides of one operand: sequence, head, batch
struct Strides {
  long long s, h, b;
};

inline Strides strides_of(bool bhsd, int S, int H, int D) {
  if (bhsd) return {D, (long long)S * D, (long long)H * S * D};
  return {(long long)H * D, D, (long long)S * H * D};
}

struct Args {
  const int* seg;           // [B, S] or null
  int4* meta;               // [B, n_t] tile metas (tile_meta) when seg
  bf16* out;                // forward
  float* lse;               // forward writes, backward reads
  const bf16* o_in;         // backward: out and dout (delta_kernel)
  const bf16* dout;
  float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int B, S, Hq, Hk, n_t;    // n_t = ceil(S / 64)
  float scale, scale_log2, cap;
  int causal, window;
  Strides sq, sk;           // q / out / dout / dq and k / v / dk / dv
};

// A 4-D map over an operand (dims D, S, H, B) with boxes of 64 columns x
// `rows` rows; returns 0, -2 without the driver's entry point, or 10000 +
// the CUresult of a refused encoding.
inline int map4(CUtensorMap* map, const void* base, int D, int S, int H,
                int B, Strides st, int rows) {
  const wg::EncodeTiled fn = wg::encode_tiled();
  if (fn == nullptr) return -2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {kBox, (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(r);
}

// A 1-D map over n 4-byte values (fp32 lse / delta, or int32 segment ids)
// with boxes of `box`; zero fill past n
inline int map1(CUtensorMap* map, const void* base, long long n, bool i32,
                int box_len) {
  const wg::EncodeTiled fn = wg::encode_tiled();
  if (fn == nullptr) return -2;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {4};              // unused at rank 1
  const cuuint32_t box[1] = {(cuuint32_t)box_len};
  const cuuint32_t step[1] = {1};
  const CUresult r = fn(map, i32 ? CU_TENSOR_MAP_DATA_TYPE_INT32
                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        1, const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(r);
}

// ---------------------------------------------------------------------------
// tile classification
// ---------------------------------------------------------------------------
// The segment ids of a span of rows under the rule: the lowest and highest
// id that can attend (splash: ids >= 1; equality: every id; lo > hi when
// there is none) and whether every row is inside S and holds that one id.
struct Meta {
  int lo, hi, uni;
};

// meta[b n_t + t] of 64-row tile t of batch row b, one warp a tile
template <class R>
__global__ void __launch_bounds__(256)
tile_meta(const int* __restrict__ seg, int4* __restrict__ meta, int S,
          int n_t, int total) {
  constexpr bool SEG_EQ = R::SEG_EQ;
  const int wi = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wi >= total) return;
  const int b = wi / n_t, t = wi % n_t;
  int lo = INT_MAX, hi = -1, clean = 1;
#pragma unroll
  for (int r = lane; r < kTile; r += 32) {
    const int row = t * kTile + r;
    const int s = row < S ? __ldg(seg + (size_t)b * S + row) : -1;
    if (s < 0 || (!SEG_EQ && s == 0)) {
      clean = 0;
      continue;
    }
    lo = min(lo, s);
    hi = max(hi, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    clean &= __shfl_xor_sync(0xffffffffu, clean, o);
  }
  if (lane == 0) meta[wi] = make_int4(lo, hi, clean && lo == hi, 0);
}

// The merged meta of 64-row tiles t0 .. t0 + n - 1 of batch row b (tiles
// at or past n_t lie past S: they hold no id and spoil uniformity)
__device__ __forceinline__ Meta meta_of(const int4* meta, int b, int n_t,
                                        int t0, int n) {
  Meta m{INT_MAX, -1, 1};
  for (int i = 0; i < n; ++i) {
    if (t0 + i >= n_t) {
      m.uni = 0;
      continue;
    }
    const int4 x = __ldg(meta + (size_t)b * n_t + t0 + i);
    m.lo = min(m.lo, x.x);
    m.hi = max(m.hi, x.y);
    m.uni &= x.z;
  }
  m.uni = m.uni && m.lo == m.hi;
  return m;
}

// The class of q rows [q0, q0 + bm) against keys [k0, k0 + bn); window > 0
// only with causal (the wrappers check); qm / km read when has_seg.
__device__ __forceinline__ int classify(int q0, int bm, int k0, int bn,
                                        int S, int causal, int window,
                                        bool has_seg, const Meta& qm,
                                        const Meta& km) {
  if (q0 >= S || k0 >= S) return kSkip;
  const int q1 = min(q0 + bm, S), k1 = min(k0 + bn, S);
  if (causal && k0 > q1 - 1) return kSkip;
  if (window > 0 && q0 - (k1 - 1) >= window) return kSkip;
  if (has_seg && (qm.hi < km.lo || km.hi < qm.lo)) return kSkip;
  const bool full =
      q0 + bm <= S && k0 + bn <= S && (!causal || k0 + bn - 1 <= q0) &&
      (window <= 0 || q0 + bm - 1 - k0 < window) &&
      (!has_seg || (qm.uni && km.uni && qm.lo == km.lo));
  return full ? kFull : kPartial;
}

// the row of accumulator register i (0 or 1: g or g + 8) and its column
__device__ __forceinline__ int acc_h(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// The element mask of a partial tile, row by row: query qi attends key kj
// iff both lie inside S, kj <= qi when causal, qi - kj < window, and their
// segment ids are equal (splash: and not 0).  A row holds the columns
// [lo, hi] it may attend by position and the id a column must hold (-2,
// which no column holds, for a splash row of segment 0); columns past S
// read id 0 (TMA's fill), which only an equality row of segment 0 holds,
// and those lie past hi.
struct RowMask {
  int lo, hi, seg;

  __device__ __forceinline__ bool ok(int col, int col_seg) const {
    return col >= lo && col <= hi && col_seg == seg;
  }
};

template <bool SEG_EQ>
__device__ __forceinline__ int row_seg(int s) {
  return !SEG_EQ && s == 0 ? -2 : s;
}

// row: query qi of id sq; columns: keys
template <bool SEG_EQ>
__device__ __forceinline__ RowMask query_row(int qi, int sq, int S,
                                             int causal, int window) {
  return {window > 0 ? qi - window + 1 : 0,
          qi >= S ? -1 : (causal ? qi : S - 1), row_seg<SEG_EQ>(sq)};
}

// row: key kj of id sk; columns: queries
template <bool SEG_EQ>
__device__ __forceinline__ RowMask key_row(int kj, int sk, int S,
                                           int causal, int window) {
  return {causal ? kj : 0,
          kj >= S ? -1 : (window > 0 ? min(S - 1, kj + window - 1) : S - 1),
          row_seg<SEG_EQ>(sk)};
}

__device__ __forceinline__ int seg_at(const int* seg_b, int i, int S) {
  return seg_b == nullptr ? 0 : (i < S ? __ldg(seg_b + i) : 0);
}

// Mask a partial tile in place: element x of accumulators `a` and `b` (the
// same array when one is masked) gets `fill` where row acc_h(x) may not
// attend column c0 + acc_col(x); `cseg` holds the tile's column segment ids
// (shared memory; null without segments).
template <int R>
__device__ __forceinline__ void mask_tile(float (&a)[R], float (&b)[R],
                                          float fill, const RowMask (&rm)[2],
                                          int c0, const int* cseg) {
  if (cseg == nullptr) {
#pragma unroll
    for (int x = 0; x < R; ++x) {
      const int c = c0 + acc_col(x);
      const RowMask& m = rm[acc_h(x)];
      if (c < m.lo || c > m.hi) a[x] = b[x] = fill;
    }
  } else {
#pragma unroll
    for (int x = 0; x < R; ++x) {
      const int c = acc_col(x);
      if (!rm[acc_h(x)].ok(c0 + c, cseg[c])) a[x] = b[x] = fill;
    }
  }
}

// ---------------------------------------------------------------------------
// shared-memory operands
// ---------------------------------------------------------------------------
// A tile of `rows` rows x D held as D / 64 swizzled boxes of rows x 128
// bytes at `tile`.  As a K-major operand (K = D): K step kk (16 columns)
// for the 64 rows from row0 (a multiple of 8).  As an MN-major operand
// (K = the rows, N = D): K step kk (16 rows); the boxes are N's 64-column
// chunks, `rows` x 128 bytes apart.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int row0,
                                           int kk) {
  return wg::desc(tile + (kk >> 2) * rows * kRowBytes + row0 * kRowBytes +
                      (kk & 3) * 32,
                  16, 8 * kRowBytes);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kk) {
  return wg::desc(tile + kk * 16 * kRowBytes, rows * kRowBytes,
                  8 * kRowBytes);
}

// bf16 A fragments of K steps 0 .. R / 8 - 1 from fp32 accumulator
// registers: the columns of one product are the K of the next
template <int R>
__device__ __forceinline__ void to_frags(const float (&s)[R],
                                         uint32_t (&f)[R / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
  }
}

// O (m64nD) += A B over K steps 0 .. KS - 1, A from fragments, B MN-major
template <int D, int KS>
__device__ __forceinline__ void mma_rs(float (&o)[D / 2],
                                       const uint32_t (&f)[KS][4],
                                       uint32_t b_tile, int b_rows) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if constexpr (D == 64)
      mma_rs_n64<1>(o, f[kk], mnmajor(b_tile, b_rows, kk), 1);
    else if constexpr (D == 128)
      mma_rs_n128<1>(o, f[kk], mnmajor(b_tile, b_rows, kk), 1);
    else if constexpr (D == 192)
      mma_rs_n192<1>(o, f[kk], mnmajor(b_tile, b_rows, kk), 1);
    else
      mma_rs_n256<1>(o, f[kk], mnmajor(b_tile, b_rows, kk), 1);
  }
}

// S (m64nN) = A B^T over head_dim, A rows a_row0.. of a_tile, B all rows
template <int N, int D>
__device__ __forceinline__ void mma_ss(float (&s)[N / 2], uint32_t a_tile,
                                       int a_rows, int a_row0,
                                       uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = kmajor(a_tile, a_rows, a_row0, kk);
    const uint64_t db = kmajor(b_tile, N, 0, kk);
    if constexpr (N == 32) mma_ss_n32(s, da, db, kk > 0);
    else if constexpr (N == 64) mma_ss_n64(s, da, db, kk > 0);
    else mma_ss_n128(s, da, db, kk > 0);
  }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (wg::saddr(p) & 1023)) & 1023);
}

// 2^x on the special-function unit (flush to zero: exp2 of -inf is 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Scores enter the softmax as s * mult in the log2 domain, the multiply
// folded into the FFMA that subtracts the row's reference: without EXTRAS
// s is the raw product and mult = scale log2(e); with EXTRAS s is first
// made the scaled, soft-capped score (capped() below) and mult = log2(e).
template <bool EXTRAS>
__device__ __forceinline__ float score_mult(const Args& p) {
  return EXTRAS ? kLog2e : p.scale_log2;
}

// EXTRAS: raw product x -> the scaled score, soft-capped when a cap is set,
// and dx, its derivative by the scaled score (1 without a cap)
__device__ __forceinline__ float capped(float x, const Args& p, float& dx) {
  x *= p.scale;
  dx = 1.f;
  if (p.cap > 0.f) {
    const float th = tanhf(x / p.cap);
    x = p.cap * th;
    dx = 1.f - th * th;
  }
  return x;
}

// bf16 pairs of the accumulator rows of half h (times f) to `row`
template <int D>
__device__ __forceinline__ void store_row(bf16* row, const float (&o)[D / 2],
                                          int h, float f) {
#pragma unroll
  for (int a = 0; a < D / 8; ++a) {
    const int i = 4 * a + 2 * h;
    *reinterpret_cast<uint32_t*>(row + acc_col(i)) =
        pack_bf16(o[i] * f, o[i + 1] * f);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
// At head_dim 192 a 128-key K + V stage is 96 KB: BN 64 keeps three
// stages beside the 48 KB Q tile (194 KB), and O's accumulator (96
// registers a thread) beside a 64-key score tile.  At head_dim 256 a 64-key
// stage is 64 KB: two beside the 64 KB Q tile (193 KB), O's accumulator 128
// registers.
template <class R>
struct FwdCfg {
  static constexpr int BM = 128, BN = R::D >= 192 ? 64 : 128;
  static constexpr int kQBufs = R::D == 64 ? 2 : 1;
  static constexpr int kStages = R::D == 64 ? 4 : (R::D == 256 ? 2 : 3);
  static constexpr int kQBytes = BM * R::D * 2;
  static constexpr int kKVBytes = BN * R::D * 2;     // one of K, V
  static constexpr int kSegBytes = BN * 4;           // a K tile's ids
  static constexpr int kSmem = 1024 + kQBufs * kQBytes +
                               kStages * (2 * kKVBytes + kSegBytes) + 256;
  static_assert(kSmem <= 227 * 1024, "shared memory");
};

// item i: batch row b, q head h, first row q0 (the last tiles first)
__device__ __forceinline__ void q_item(int i, int n_qt, int bm, int H,
                                       int B, int& b, int& h, int& q0) {
  const int bh = i % (B * H);
  b = bh / H;
  h = bh % H;
  q0 = (n_qt - 1 - i / (B * H)) * bm;
}

// the kv tiles [lo, hi] of width bn that q rows [q0, q0 + bm) may reach
__device__ __forceinline__ void kv_range(int q0, int bm, int bn, int S,
                                         int causal, int window, int& lo,
                                         int& hi) {
  hi = causal ? (min(q0 + bm, S) - 1) / bn : (S - 1) / bn;
  lo = window > 0 ? max(0, q0 - window + 1) / bn : 0;
}

// Turns of the two consumer warpgroups (named barrier 1 + w is warpgroup
// w's; each counts both warpgroups): a warpgroup issues its products only
// on its turn and passes the turn to the other once they are issued, so
// one warpgroup's softmax runs while the other's products hold the tensor
// cores.  Warpgroup 1 hands warpgroup 0 the first turn (first_turn).
__device__ __forceinline__ void turn_wait(int w) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + w) : "memory");
}
__device__ __forceinline__ void turn_pass(int w) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - w) : "memory");
}
__device__ __forceinline__ void first_turn(int w) {
  if (w == 1) turn_pass(w);
}

// O += P V of the tile in stage use `use` (its V read MN-major, landed:
// the caller waited on its barrier before any product was in flight, so no
// wait loop lies between two products), committed
template <class C, int D>
__device__ __forceinline__ void pv_issue(float (&o)[D / 2],
                                         const uint32_t (&pf)[C::BN / 16][4],
                                         uint8_t* kv_s, int use) {
  const int s = use % C::kStages;
  mma_rs<D, C::BN / 16>(o, pf, wg::saddr(kv_s + s * 2 * C::kKVBytes) +
                                   C::kKVBytes, C::BN);
  wg::wg_commit();
}

template <class R>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const __grid_constant__ CUtensorMap tseg, const Args p) {
  using C = FwdCfg<R>;
  constexpr int D = R::D, NC = R::NC, BM = C::BM, BN = C::BN;
  constexpr int ST = C::kStages, QB = C::kQBufs;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* q_s = smem;
  uint8_t* kv_s = q_s + QB * C::kQBytes;
  int* seg_s = reinterpret_cast<int*>(kv_s + ST * 2 * C::kKVBytes);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(seg_s + ST * BN);
  uint64_t* q_empty = q_full + QB;
  uint64_t* k_full = q_empty + QB;
  uint64_t* v_full = k_full + ST;
  uint64_t* kv_empty = v_full + ST;
  const int tid = threadIdx.x, wgi = tid >> 7;
  if (tid == 0) {
    for (int i = 0; i < QB; ++i) {
      wg::bar_init(q_full + i, 1);
      wg::bar_init(q_empty + i, 8);
    }
    for (int s = 0; s < ST; ++s) {
      wg::bar_init(k_full + s, 1);
      wg::bar_init(v_full + s, 1);
      wg::bar_init(kv_empty + s, 8);     // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int S = p.S, G = p.Hq / p.Hk;
  const int window = R::EXTRAS ? p.window : 0;
  const bool has_seg = p.seg != nullptr;
  const int n_qt = (S + BM - 1) / BM;
  const int n_items = n_qt * p.B * p.Hq;

  if (wgi == 0) {                       // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 0) return;
    int it = 0, n = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
      int b, hq, q0, lo, hi;
      q_item(i, n_qt, BM, p.Hq, p.B, b, hq, q0);
      const int hk = hq / G;
      const Meta qm = has_seg ? meta_of(p.meta, b, p.n_t, q0 / kTile, 2)
                              : Meta{0, 0, 1};
      const int qb = n % QB;
      if (n >= QB) wg::bar_wait(q_empty + qb, ((n / QB) - 1) & 1);
      wg::bar_expect(q_full + qb, C::kQBytes);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        wg::tma_load_4d(q_s + qb * C::kQBytes + c * BM * kRowBytes, &tq,
                        q_full + qb, c * kBox, q0, hq, b);
      kv_range(q0, BM, BN, S, p.causal, window, lo, hi);
      for (int j = hi; j >= lo; --j) {
        const int k0 = j * BN;
        const Meta km = has_seg ? meta_of(p.meta, b, p.n_t, k0 / kTile,
                                          BN / kTile)
                                : Meta{0, 0, 1};
        if (classify(q0, BM, k0, BN, S, p.causal, window, has_seg, qm, km) ==
            kSkip)
          continue;
        const int s = it % ST;
        if (it >= ST) wg::bar_wait(kv_empty + s, ((it / ST) - 1) & 1);
        uint8_t* ks = kv_s + s * 2 * C::kKVBytes;
        wg::bar_expect(k_full + s, C::kKVBytes + (has_seg ? C::kSegBytes : 0));
#pragma unroll
        for (int c = 0; c < NC; ++c)
          wg::tma_load_4d(ks + c * BN * kRowBytes, &tk, k_full + s, c * kBox,
                          k0, hk, b);
        if (has_seg)
          wg::tma_load_1d(seg_s + s * BN, &tseg, k_full + s, b * S + k0);
        wg::bar_expect(v_full + s, C::kKVBytes);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          wg::tma_load_4d(ks + C::kKVBytes + c * BN * kRowBytes, &tv,
                          v_full + s, c * kBox, k0, hk, b);
        ++it;
      }
    }
    return;
  }

  // consumers: warpgroup w holds q rows 64 w .. 64 w + 63 of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int w = wgi - 1, lane = tid & 31;
  const float mult = score_mult<R::EXTRAS>(p);
  const int rl = 64 * w + 16 * ((tid >> 5) & 3) + (lane >> 2);
  first_turn(w);
  int it = 0, n = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
    int b, hq, q0, lo, hi;
    q_item(i, n_qt, BM, p.Hq, p.B, b, hq, q0);
    const Meta qm = has_seg ? meta_of(p.meta, b, p.n_t, q0 / kTile, 2)
                            : Meta{0, 0, 1};
    const int* seg_b = has_seg ? p.seg + (size_t)b * S : nullptr;
    const int row[2] = {q0 + rl, q0 + rl + 8};
    RowMask rm[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rm[h] = query_row<R::SEG_EQ>(row[h], seg_at(seg_b, row[h], S), S,
                                   p.causal, window);
    float o[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
    // m: the running row maxima of the scores as they enter the softmax
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const int qb = n % QB;
    wg::bar_wait(q_full + qb, (n / QB) & 1);
    const uint32_t qa = wg::saddr(q_s + qb * C::kQBytes);
    kv_range(q0, BM, BN, S, p.causal, window, lo, hi);
    // the first live kv tile at or below j (lo - 1 when none), its class
    auto next_live = [&](int j, int& cls) {
      for (; j >= lo; --j) {
        const Meta km = has_seg ? meta_of(p.meta, b, p.n_t, j * BN / kTile,
                                          BN / kTile)
                                : Meta{0, 0, 1};
        cls = classify(q0, BM, j * BN, BN, S, p.causal, window, has_seg, qm,
                       km);
        if (cls != kSkip) break;
      }
      return j;
    };
    // S = Q K^T of the tile in stage use `use`, issued on this warpgroup's
    // turn, with (after) the previous tile's O += P V when `pv`
    float sc[BN / 2];
    uint32_t pf[BN / 16][4];
    auto v_wait = [&](int use) {
      wg::bar_wait(v_full + use % ST, (use / ST) & 1);
    };
    auto issue = [&](int use, auto pv) {
      const int s = use % ST;
      if constexpr (decltype(pv)::value) v_wait(use - 1);
      wg::bar_wait(k_full + s, (use / ST) & 1);
      turn_wait(w);
      wg::wg_fence();
      mma_ss<BN, D>(sc, qa, BM, 64 * w,
                    wg::saddr(kv_s + s * 2 * C::kKVBytes));
      wg::wg_commit();
      if constexpr (decltype(pv)::value) pv_issue<C, D>(o, pf, kv_s, use - 1);
      turn_pass(w);
    };
    // the online softmax of tile (k0, cls) in stage use `use`, in sc:
    // masks it, updates m and l, leaves P in sc and the factor O must take
    // in alpha
    float alpha[2];
    auto softmax = [&](int use, int k0, int cls) {
      if constexpr (R::EXTRAS) {
#pragma unroll
        for (int x = 0; x < BN / 2; ++x) {
          float dx;
          sc[x] = capped(sc[x], p, dx);
        }
      }
      if (cls == kPartial)
        mask_tile(sc, sc, -INFINITY, rm, k0,
                  has_seg ? seg_s + (use % ST) * BN : nullptr);
      // rows g (h 0) and g + 8 (h 1), each held by the four lanes of a
      // quad; maxima and sums over four chains a row, so the dependent
      // operations run four abreast
      float mx[2][4], sm[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) mx[h][c] = -INFINITY;
#pragma unroll
      for (int x = 0; x < BN / 2; ++x)
        mx[acc_h(x)][(x >> 2) & 3] = fmaxf(mx[acc_h(x)][(x >> 2) & 3], sc[x]);
      float ref[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float r = fmaxf(fmaxf(mx[h][0], mx[h][1]), fmaxf(mx[h][2], mx[h][3]));
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
        const float m_new = fmaxf(m[h], r);
        // the reference in the log2 domain (0 while the row has no key)
        ref[h] = m_new == -INFINITY ? 0.f : m_new * mult;
        alpha[h] = ex2(m[h] * mult - ref[h]);
        m[h] = m_new;
        l[h] *= alpha[h];
#pragma unroll
        for (int c = 0; c < 4; ++c) sm[h][c] = 0.f;
      }
#pragma unroll
      for (int x = 0; x < BN / 2; ++x) {
        const float e = ex2(fmaf(sc[x], mult, -ref[acc_h(x)]));
        sc[x] = e;
        sm[acc_h(x)][(x >> 2) & 3] += e;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float r = (sm[h][0] + sm[h][1]) + (sm[h][2] + sm[h][3]);
        r += __shfl_xor_sync(0xffffffffu, r, 1);
        r += __shfl_xor_sync(0xffffffffu, r, 2);
        l[h] += r;
      }
    };
    // P of a tile waits in pf for its O += P V, which is issued with the
    // next live tile's S = Q K^T, so the tensor cores run it while this
    // warpgroup does that tile's softmax
    int cls;
    int j = next_live(hi, cls);
    if (j >= lo) {
      issue(it, std::false_type{});
      wg::wg_wait<0>();
      wg::pin(sc);
      softmax(it, j * BN, cls);
      to_frags(sc, pf);
      ++it;
      for (j = next_live(j - 1, cls); j >= lo; j = next_live(j - 1, cls)) {
        issue(it, std::true_type{});
        wg::wg_wait<1>();
        wg::pin(sc);
        softmax(it, j * BN, cls);
        wg::wg_wait<0>();               // the previous tile's P V is in
        wg::pin(o);
        if (lane == 0) wg::bar_arrive(kv_empty + (it - 1) % ST);
#pragma unroll
        for (int x = 0; x < D / 2; ++x) o[x] *= alpha[acc_h(x)];
        to_frags(sc, pf);
        ++it;
      }
      v_wait(it - 1);                   // the last tile's P V
      wg::wg_fence();
      pv_issue<C, D>(o, pf, kv_s, it - 1);
      wg::wg_wait<0>();
      wg::pin(o);
      if (lane == 0) wg::bar_arrive(kv_empty + (it - 1) % ST);
    }
    if (lane == 0) wg::bar_arrive(q_empty + qb);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= S) continue;
      const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
      store_row<D>(p.out + b * p.sq.b + row[h] * p.sq.s + hq * p.sq.h, o, h,
                   inv);
      if ((lane & 3) == 0)
        p.lse[((size_t)b * p.Hq + hq) * S + row[h]] =
            l[h] > 0.f ? (m[h] * mult + log2f(l[h])) * kLn2 : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
// delta[b, h, s] = sum_d dout * out (fp32), rows in delta's order: D / 8
// lanes a row, 16 bytes of each operand a lane, summed across the lanes
// by shuffles
// (head_dim 192: 8 lanes a row, 3 chunks of 16 bytes a lane; 256: a warp
// a row)
template <class R>
__global__ void __launch_bounds__(256)
delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
             float* __restrict__ delta, int B, int S, int H, Strides st) {
  constexpr int L = R::D == 192 ? 8 : R::D / 8;  // lanes a row
  constexpr int CH = R::D / 8 / L;               // 16-byte chunks a lane
  const long long r = (blockIdx.x * (long long)blockDim.x + threadIdx.x) / L;
  const int c = threadIdx.x % L;
  const bool in = r < (long long)B * H * S;
  float acc = 0.f;
  if (in) {
    const int s = r % S, h = (r / S) % H, b = r / ((long long)S * H);
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const long long off = b * st.b + s * st.s + h * st.h + 8 * (c + L * ch);
      const uint4 x = *reinterpret_cast<const uint4*>(out + off);
      const uint4 y = *reinterpret_cast<const uint4*>(dout + off);
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w},
                     ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
        const float2 d = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
        acc += a.x * d.x + a.y * d.y;
      }
    }
  }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (in && c == 0) delta[r] = acc;
}

// head_dim 192: Q and dO take 96 KB, so two 48 KB K + V stages.  256: Q
// and dO take 128 KB, so 32-key tiles, three 32 KB K + V stages (226 KB)
template <class R>
struct DqCfg {
  static constexpr int BM = 128, BN = R::D == 256 ? 32 : kTile;
  static constexpr int kQBufs = R::D == 64 ? 2 : 1;
  static constexpr int kStages = R::D == 192 ? 2 : (R::D == 256 ? 3 : 4);
  static constexpr int kQBytes = BM * R::D * 2;      // one of Q, dO
  static constexpr int kKVBytes = BN * R::D * 2;     // one of K, V
  static constexpr int kSegBytes = BN * 4;           // a K tile's ids
  static constexpr int kSmem = 1024 + kQBufs * 2 * kQBytes +
                               kStages * (2 * kKVBytes + kSegBytes) + 256;
  static_assert(kSmem <= 227 * 1024, "shared memory");
};

template <class R>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo,
          const __grid_constant__ CUtensorMap tseg, const Args p) {
  using C = DqCfg<R>;
  constexpr int D = R::D, NC = R::NC, BM = C::BM, BN = C::BN;
  constexpr int ST = C::kStages, QB = C::kQBufs;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* q_s = smem;                                 // Q, then dO
  uint8_t* kv_s = q_s + QB * 2 * C::kQBytes;
  int* seg_s = reinterpret_cast<int*>(kv_s + ST * 2 * C::kKVBytes);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(seg_s + ST * BN);
  uint64_t* q_empty = q_full + QB;
  uint64_t* full = q_empty + QB;
  uint64_t* empty = full + ST;
  const int tid = threadIdx.x, wgi = tid >> 7;
  if (tid == 0) {
    for (int i = 0; i < QB; ++i) {
      wg::bar_init(q_full + i, 1);
      wg::bar_init(q_empty + i, 8);
    }
    for (int s = 0; s < ST; ++s) {
      wg::bar_init(full + s, 1);
      wg::bar_init(empty + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int S = p.S, G = p.Hq / p.Hk;
  const int window = R::EXTRAS ? p.window : 0;
  const bool has_seg = p.seg != nullptr;
  const int n_qt = (S + BM - 1) / BM;
  const int n_items = n_qt * p.B * p.Hq;

  if (wgi == 0) {                       // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 0) return;
    int it = 0, n = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
      int b, hq, q0, lo, hi;
      q_item(i, n_qt, BM, p.Hq, p.B, b, hq, q0);
      const int hk = hq / G;
      const Meta qm = has_seg ? meta_of(p.meta, b, p.n_t, q0 / kTile, 2)
                              : Meta{0, 0, 1};
      const int qb = n % QB;
      if (n >= QB) wg::bar_wait(q_empty + qb, ((n / QB) - 1) & 1);
      uint8_t* qs = q_s + qb * 2 * C::kQBytes;
      wg::bar_expect(q_full + qb, 2 * C::kQBytes);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        wg::tma_load_4d(qs + c * BM * kRowBytes, &tq, q_full + qb, c * kBox,
                        q0, hq, b);
        wg::tma_load_4d(qs + C::kQBytes + c * BM * kRowBytes, &tdo,
                        q_full + qb, c * kBox, q0, hq, b);
      }
      kv_range(q0, BM, BN, S, p.causal, window, lo, hi);
      for (int j = hi; j >= lo; --j) {
        const int k0 = j * BN;
        const Meta km = has_seg ? meta_of(p.meta, b, p.n_t, k0 / kTile, 1)
                                : Meta{0, 0, 1};
        if (classify(q0, BM, k0, BN, S, p.causal, window, has_seg, qm, km) ==
            kSkip)
          continue;
        const int s = it % ST;
        if (it >= ST) wg::bar_wait(empty + s, ((it / ST) - 1) & 1);
        uint8_t* ks = kv_s + s * 2 * C::kKVBytes;
        wg::bar_expect(full + s,
                       2 * C::kKVBytes + (has_seg ? C::kSegBytes : 0));
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          wg::tma_load_4d(ks + c * BN * kRowBytes, &tk, full + s, c * kBox,
                          k0, hk, b);
          wg::tma_load_4d(ks + C::kKVBytes + c * BN * kRowBytes, &tv,
                          full + s, c * kBox, k0, hk, b);
        }
        if (has_seg)
          wg::tma_load_1d(seg_s + s * BN, &tseg, full + s, b * S + k0);
        ++it;
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int w = wgi - 1, lane = tid & 31;
  const int rl = 64 * w + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const float mult = score_mult<R::EXTRAS>(p);
  first_turn(w);
  int it = 0, n = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
    int b, hq, q0, lo, hi;
    q_item(i, n_qt, BM, p.Hq, p.B, b, hq, q0);
    const Meta qm = has_seg ? meta_of(p.meta, b, p.n_t, q0 / kTile, 2)
                            : Meta{0, 0, 1};
    const int* seg_b = has_seg ? p.seg + (size_t)b * S : nullptr;
    const int row[2] = {q0 + rl, q0 + rl + 8};
    RowMask rm[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rm[h] = query_row<R::SEG_EQ>(row[h], seg_at(seg_b, row[h], S), S,
                                   p.causal, window);
    float lse2[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t r = ((size_t)b * p.Hq + hq) * S + row[h];
      lse2[h] = row[h] < S ? p.lse[r] * kLog2e : 0.f;
      dl[h] = row[h] < S ? p.delta[r] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;
    const int qb = n % QB;
    wg::bar_wait(q_full + qb, (n / QB) & 1);
    const uint32_t qa = wg::saddr(q_s + qb * 2 * C::kQBytes);
    const uint32_t doa = qa + C::kQBytes;
    kv_range(q0, BM, BN, S, p.causal, window, lo, hi);
    // the first live kv tile at or below j (lo - 1 when none), its class
    auto next_live = [&](int j, int& cls) {
      for (; j >= lo; --j) {
        const Meta km = has_seg ? meta_of(p.meta, b, p.n_t, j * BN / kTile,
                                          1)
                                : Meta{0, 0, 1};
        cls = classify(q0, BM, j * BN, BN, S, p.causal, window, has_seg, qm,
                       km);
        if (cls != kSkip) break;
      }
      return j;
    };
    // S = Q K^T and dP = dO V^T of the tile in stage use `use`, on this
    // warpgroup's turn, with (after) the previous tile's dQ += dS K
    float sc[BN / 2], dp[BN / 2];
    uint32_t df[BN / 16][4];
    auto issue = [&](int use, auto prev) {
      const int s = use % ST;
      const uint32_t ka = wg::saddr(kv_s + s * 2 * C::kKVBytes);
      wg::bar_wait(full + s, (use / ST) & 1);
      turn_wait(w);
      wg::wg_fence();
      mma_ss<BN, D>(sc, qa, BM, 64 * w, ka);
      mma_ss<BN, D>(dp, doa, BM, 64 * w, ka + C::kKVBytes);
      wg::wg_commit();
      if constexpr (decltype(prev)::value) {
        mma_rs<D, BN / 16>(
            dq, df,
            wg::saddr(kv_s + ((use - 1) % ST) * 2 * C::kKVBytes), BN);
        wg::wg_commit();
      }
      turn_pass(w);
    };
    // dS of tile (k0, cls) in stage use `use`, from sc and dp, into dp
    auto grad = [&](int use, int k0, int cls) {
#pragma unroll
      for (int x = 0; x < BN / 2; ++x) {
        const int h = acc_h(x);
        float dx = 1.f, v = sc[x];
        if constexpr (R::EXTRAS) v = capped(v, p, dx);
        const float pr = ex2(fmaf(v, mult, -lse2[h]));
        dp[x] = pr * (dp[x] - dl[h]) * dx;
      }
      if (cls == kPartial)
        mask_tile(dp, dp, 0.f, rm, k0,
                  has_seg ? seg_s + (use % ST) * BN : nullptr);
    };
    int cls;
    int j = next_live(hi, cls);
    if (j >= lo) {
      issue(it, std::false_type{});
      wg::wg_wait<0>();
      wg::pin(sc);
      wg::pin(dp);
      grad(it, j * BN, cls);
      to_frags(dp, df);
      ++it;
      for (j = next_live(j - 1, cls); j >= lo; j = next_live(j - 1, cls)) {
        issue(it, std::true_type{});
        wg::wg_wait<1>();
        wg::pin(sc);
        wg::pin(dp);
        grad(it, j * BN, cls);
        wg::wg_wait<0>();               // the previous tile's dS K is in
        wg::pin(dq);
        if (lane == 0) wg::bar_arrive(empty + (it - 1) % ST);
        to_frags(dp, df);
        ++it;
      }
      wg::wg_fence();                   // the last tile's dS K
      mma_rs<D, BN / 16>(
          dq, df, wg::saddr(kv_s + ((it - 1) % ST) * 2 * C::kKVBytes), BN);
      wg::wg_commit();
      wg::wg_wait<0>();
      wg::pin(dq);
      if (lane == 0) wg::bar_arrive(empty + (it - 1) % ST);
    }
    if (lane == 0) wg::bar_arrive(q_empty + qb);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < S)
        store_row<D>(p.dq + b * p.sq.b + row[h] * p.sq.s + hq * p.sq.h, dq,
                     h, p.scale);
  }
}

// head_dim 192: K and V take 96 KB, so two 49 KB stages.  256: K and V
// take 128 KB, so 32-row q tiles, two 33 KB stages
template <class R>
struct DkvCfg {
  static constexpr int BN = 128, BM = R::D == 256 ? 32 : kTile;
  static constexpr int kKVBufs = R::D == 64 ? 2 : 1;
  static constexpr int kStages = R::D == 64 ? 4 : (R::D == 128 ? 3 : 2);
  static constexpr int kKVBytes = BN * R::D * 2;     // one of K, V
  static constexpr int kQBytes = BM * R::D * 2;      // one of Q, dO
  // Q, dO, lse, delta (and the q tile's segment ids, with segments)
  static constexpr int kLoadBytes = 2 * kQBytes + 2 * BM * 4;
  static constexpr int kSegBytes = BM * 4;
  static constexpr int kStageBytes =
      (kLoadBytes + kSegBytes + 1023) / 1024 * 1024;
  static constexpr int kSmem = 1024 + kKVBufs * 2 * kKVBytes +
                               kStages * kStageBytes + 256;
  static_assert(kSmem <= 227 * 1024, "shared memory");
};

// the q tiles [lo, hi] of width bm that keys [k0, k0 + bn) may be seen by
__device__ __forceinline__ void q_range(int k0, int bn, int bm, int S,
                                        int causal, int window, int& lo,
                                        int& hi) {
  lo = causal ? k0 / bm : 0;
  hi = (S - 1) / bm;
  if (window > 0) hi = min(hi, (min(k0 + bn, S) - 1 + window - 1) / bm);
}

// PART: which gradients the pass sums.  kBoth (head_dim 64 and 128): dK
// and dV together.  At head_dim 192 and 256 the two accumulators (96 or
// 128 registers a thread each) and the score tiles do not fit one thread's
// 232 registers, so the backward runs the pass twice: kDv (S^T, P^T, dV += P^T dO), then
// kDk (S^T, dP^T, dS^T, dK += dS^T Q), each with one accumulator.
enum Part : int { kBoth = 0, kDv = 1, kDk = 2 };

template <class R, int PART>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const __grid_constant__ CUtensorMap tdo,
           const __grid_constant__ CUtensorMap tlse,
           const __grid_constant__ CUtensorMap tdl,
           const __grid_constant__ CUtensorMap tseg, const Args p) {
  using C = DkvCfg<R>;
  constexpr int D = R::D, NC = R::NC, BM = C::BM, BN = C::BN;
  constexpr int ST = C::kStages, KB = C::kKVBufs;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* kv_s = smem;                                // K, then V
  uint8_t* st_s = kv_s + KB * 2 * C::kKVBytes;         // Q, dO, lse, delta
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(st_s + ST * C::kStageBytes);
  uint64_t* kv_empty = kv_full + KB;
  uint64_t* full = kv_empty + KB;
  uint64_t* empty = full + ST;
  const int tid = threadIdx.x, wgi = tid >> 7;
  if (tid == 0) {
    for (int i = 0; i < KB; ++i) {
      wg::bar_init(kv_full + i, 1);
      wg::bar_init(kv_empty + i, 8);
    }
    for (int s = 0; s < ST; ++s) {
      wg::bar_init(full + s, 1);
      wg::bar_init(empty + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int S = p.S, G = p.Hq / p.Hk;
  const int window = R::EXTRAS ? p.window : 0;
  const bool has_seg = p.seg != nullptr;
  const int n_kt = (S + BN - 1) / BN;
  const int n_items = n_kt * p.B * p.Hk;
  // item i: batch row b, kv head hk, first key k0 (the first tiles first)
  auto item = [&](int i, int& b, int& hk, int& k0) {
    const int bh = i % (p.B * p.Hk);
    b = bh / p.Hk;
    hk = bh % p.Hk;
    k0 = (i / (p.B * p.Hk)) * BN;
  };

  if (wgi == 0) {                       // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 0) return;
    int it = 0, n = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
      int b, hk, k0, lo, hi;
      item(i, b, hk, k0);
      const Meta km = has_seg ? meta_of(p.meta, b, p.n_t, k0 / kTile, 2)
                              : Meta{0, 0, 1};
      const int kb = n % KB;
      if (n >= KB) wg::bar_wait(kv_empty + kb, ((n / KB) - 1) & 1);
      uint8_t* ks = kv_s + kb * 2 * C::kKVBytes;
      wg::bar_expect(kv_full + kb, 2 * C::kKVBytes);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        wg::tma_load_4d(ks + c * BN * kRowBytes, &tk, kv_full + kb, c * kBox,
                        k0, hk, b);
        wg::tma_load_4d(ks + C::kKVBytes + c * BN * kRowBytes, &tv,
                        kv_full + kb, c * kBox, k0, hk, b);
      }
      q_range(k0, BN, BM, S, p.causal, window, lo, hi);
      for (int gq = 0; gq < G; ++gq) {
        const int hq = hk * G + gq;
        for (int qt = lo; qt <= hi; ++qt) {
          const int q0 = qt * BM;
          const Meta qm = has_seg ? meta_of(p.meta, b, p.n_t,
                                            q0 / kTile, 1)
                                  : Meta{0, 0, 1};
          if (classify(q0, BM, k0, BN, S, p.causal, window, has_seg, qm,
                       km) == kSkip)
            continue;
          const int s = it % ST;
          if (it >= ST) wg::bar_wait(empty + s, ((it / ST) - 1) & 1);
          uint8_t* st = st_s + s * C::kStageBytes;
          wg::bar_expect(full + s,
                         C::kLoadBytes + (has_seg ? C::kSegBytes : 0));
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            wg::tma_load_4d(st + c * BM * kRowBytes, &tq, full + s, c * kBox,
                            q0, hq, b);
            wg::tma_load_4d(st + C::kQBytes + c * BM * kRowBytes, &tdo,
                            full + s, c * kBox, q0, hq, b);
          }
          const int r0 = ((b * p.Hq) + hq) * S + q0;
          wg::tma_load_1d(st + 2 * C::kQBytes, &tlse, full + s, r0);
          wg::tma_load_1d(st + 2 * C::kQBytes + BM * 4, &tdl, full + s, r0);
          if (has_seg)
            wg::tma_load_1d(st + C::kLoadBytes, &tseg, full + s, b * S + q0);
          ++it;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  constexpr bool DV = PART != kDk, DK = PART != kDv;
  const int w = wgi - 1, lane = tid & 31;
  const int rl = 64 * w + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const float mult = score_mult<R::EXTRAS>(p);
  first_turn(w);
  int it = 0, n = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
    int b, hk, k0, lo, hi;
    item(i, b, hk, k0);
    const Meta km = has_seg ? meta_of(p.meta, b, p.n_t, k0 / kTile, 2)
                            : Meta{0, 0, 1};
    const int* seg_b = has_seg ? p.seg + (size_t)b * S : nullptr;
    const int key[2] = {k0 + rl, k0 + rl + 8};
    RowMask rm[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rm[h] = key_row<R::SEG_EQ>(key[h], seg_at(seg_b, key[h], S), S,
                                 p.causal, window);
    float dk[DK ? D / 2 : 1], dv[DV ? D / 2 : 1];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) {
      if constexpr (DK) dk[x] = 0.f;
      if constexpr (DV) dv[x] = 0.f;
    }
    const int kb = n % KB;
    wg::bar_wait(kv_full + kb, (n / KB) & 1);
    const uint32_t ka = wg::saddr(kv_s + kb * 2 * C::kKVBytes);
    const uint32_t va = ka + C::kKVBytes;
    q_range(k0, BN, BM, S, p.causal, window, lo, hi);
    for (int gq = 0; gq < G; ++gq) {
      for (int qt = lo; qt <= hi; ++qt) {
        const int q0 = qt * BM;
        const Meta qm = has_seg ? meta_of(p.meta, b, p.n_t, q0 / kTile, 1)
                                : Meta{0, 0, 1};
        const int cls =
            classify(q0, BM, k0, BN, S, p.causal, window, has_seg, qm, km);
        if (cls == kSkip) continue;
        const int s = it % ST;
        uint8_t* st = st_s + s * C::kStageBytes;
        const uint32_t qa = wg::saddr(st), doa = qa + C::kQBytes;
        const float* lse_s =
            reinterpret_cast<const float*>(st + 2 * C::kQBytes);
        const float* dl_s = lse_s + BM;
        wg::bar_wait(full + s, (it / ST) & 1);
        float sc[BM / 2], dp[DK ? BM / 2 : 1];
        turn_wait(w);
        wg::wg_fence();
        mma_ss<BM, D>(sc, ka, BN, 64 * w, qa);
        if constexpr (DK) mma_ss<BM, D>(dp, va, BN, 64 * w, doa);
        wg::wg_commit();
        turn_pass(w);
        wg::wg_wait<0>();
        wg::pin(sc);
        if constexpr (DK) wg::pin(dp);
#pragma unroll
        for (int x = 0; x < BM / 2; ++x) {
          const int qc = acc_col(x);
          float dx = 1.f, v = sc[x];
          if constexpr (R::EXTRAS) v = capped(v, p, dx);
          const float pr = ex2(fmaf(v, mult, -lse_s[qc] * kLog2e));
          if constexpr (DV) sc[x] = pr;
          if constexpr (DK) dp[x] = pr * (dp[x] - dl_s[qc]) * dx;
        }
        if (cls == kPartial) {
          const int* cseg =
              has_seg ? reinterpret_cast<const int*>(st + C::kLoadBytes)
                      : nullptr;
          if constexpr (!DK) mask_tile(sc, sc, 0.f, rm, q0, cseg);
          else if constexpr (!DV) mask_tile(dp, dp, 0.f, rm, q0, cseg);
          else mask_tile(sc, dp, 0.f, rm, q0, cseg);
        }
        uint32_t pf[DV ? BM / 16 : 1][4], df[DK ? BM / 16 : 1][4];
        if constexpr (DV) to_frags(sc, pf);
        if constexpr (DK) to_frags(dp, df);
        turn_wait(w);
        wg::wg_fence();
        if constexpr (DV) mma_rs<D, BM / 16>(dv, pf, doa, BM);
        if constexpr (DK) mma_rs<D, BM / 16>(dk, df, qa, BM);
        wg::wg_commit();
        turn_pass(w);
        wg::wg_wait<0>();
        if constexpr (DV) wg::pin(dv);
        if constexpr (DK) wg::pin(dk);
        if (lane == 0) wg::bar_arrive(empty + s);
        ++it;
      }
    }
    if (lane == 0) wg::bar_arrive(kv_empty + kb);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (key[h] >= S) continue;
      const long long off = b * p.sk.b + key[h] * p.sk.s + hk * p.sk.h;
      if constexpr (DK) store_row<D>(p.dk + off, dk, h, p.scale);
      if constexpr (DV) store_row<D>(p.dv + off, dv, h, 1.f);
    }
  }
}

// ---------------------------------------------------------------------------
// host: launches (each returns 0, a tensor-map error, or the first failed
// launch's cudaError_t)
// ---------------------------------------------------------------------------
template <class K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

inline int grid_for(int items) {
  const int sms = lce::num_sms();
  return items < sms ? items : sms;
}

// fill p.meta from p.seg (nothing without segments)
template <class R>
int launch_meta(const Args& p, cudaStream_t s) {
  if (p.seg == nullptr) return 0;
  const int total = p.B * p.n_t;
  tile_meta<R><<<(total * 32 + 255) / 256, 256, 0, s>>>(
      p.seg, p.meta, p.S, p.n_t, total);
  return static_cast<int>(cudaGetLastError());
}

template <class R>
int forward(const void* q, const void* k, const void* v, const Args& p,
            cudaStream_t s) {
  using C = FwdCfg<R>;
  CUtensorMap tq, tk, tv, tseg{};
  int rc;
  if ((rc = map4(&tq, q, R::D, p.S, p.Hq, p.B, p.sq, C::BM))) return rc;
  if ((rc = map4(&tk, k, R::D, p.S, p.Hk, p.B, p.sk, C::BN))) return rc;
  if ((rc = map4(&tv, v, R::D, p.S, p.Hk, p.B, p.sk, C::BN))) return rc;
  if (p.seg != nullptr &&
      (rc = map1(&tseg, p.seg, (long long)p.B * p.S, true, C::BN)))
    return rc;
  if ((rc = launch_meta<R>(p, s))) return rc;
  if ((rc = set_smem(fwd_kernel<R>, C::kSmem))) return rc;
  const int items = (p.S + C::BM - 1) / C::BM * p.B * p.Hq;
  fwd_kernel<R><<<grid_for(items), kThreads, C::kSmem, s>>>(tq, tk, tv, tseg,
                                                            p);
  return static_cast<int>(cudaGetLastError());
}

// delta, then dQ, then dK / dV
template <class R>
int backward(const void* q, const void* k, const void* v, const Args& p,
             cudaStream_t s) {
  using Q = DqCfg<R>;
  using KV = DkvCfg<R>;
  CUtensorMap tq, tdo, tk, tv, tq64, tdo64, tk128, tv128, tlse, tdl, tseg{};
  int rc;
  if ((rc = map4(&tq, q, R::D, p.S, p.Hq, p.B, p.sq, Q::BM))) return rc;
  if ((rc = map4(&tdo, p.dout, R::D, p.S, p.Hq, p.B, p.sq, Q::BM))) return rc;
  if ((rc = map4(&tk, k, R::D, p.S, p.Hk, p.B, p.sk, Q::BN))) return rc;
  if ((rc = map4(&tv, v, R::D, p.S, p.Hk, p.B, p.sk, Q::BN))) return rc;
  if ((rc = map4(&tq64, q, R::D, p.S, p.Hq, p.B, p.sq, KV::BM))) return rc;
  if ((rc = map4(&tdo64, p.dout, R::D, p.S, p.Hq, p.B, p.sq, KV::BM)))
    return rc;
  if ((rc = map4(&tk128, k, R::D, p.S, p.Hk, p.B, p.sk, KV::BN))) return rc;
  if ((rc = map4(&tv128, v, R::D, p.S, p.Hk, p.B, p.sk, KV::BN))) return rc;
  const long long rows = (long long)p.B * p.Hq * p.S;
  if ((rc = map1(&tlse, p.lse, rows, false, KV::BM))) return rc;
  if ((rc = map1(&tdl, p.delta, rows, false, KV::BM))) return rc;
  static_assert(Q::BN == KV::BM, "one segment-id box");
  if (p.seg != nullptr &&
      (rc = map1(&tseg, p.seg, (long long)p.B * p.S, true, Q::BN)))
    return rc;
  if ((rc = launch_meta<R>(p, s))) return rc;
  constexpr int kDeltaLanes = R::D == 192 ? 8 : R::D / 8;
  delta_kernel<R><<<(unsigned)((rows * kDeltaLanes + 255) / 256), 256, 0,
                     s>>>(
      p.o_in, p.dout, p.delta, p.B, p.S, p.Hq, p.sq);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  if ((rc = set_smem(dq_kernel<R>, Q::kSmem))) return rc;
  const int q_items = (p.S + Q::BM - 1) / Q::BM * p.B * p.Hq;
  dq_kernel<R><<<grid_for(q_items), kThreads, Q::kSmem, s>>>(tq, tk, tv, tdo,
                                                            tseg, p);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  const int kv_items = (p.S + KV::BN - 1) / KV::BN * p.B * p.Hk;
  auto dkv = [&](auto kernel) {
    int r = set_smem(kernel, KV::kSmem);
    if (r) return r;
    kernel<<<grid_for(kv_items), kThreads, KV::kSmem, s>>>(
        tq64, tk128, tv128, tdo64, tlse, tdl, tseg, p);
    return static_cast<int>(cudaGetLastError());
  };
  if constexpr (R::D >= 192) {       // dV, then dK (see Part)
    if ((rc = dkv(dkv_kernel<R, kDv>))) return rc;
    return dkv(dkv_kernel<R, kDk>);
  } else {
    return dkv(dkv_kernel<R, kBoth>);
  }
}

// the arguments of one call; scale applied to the fp32 scores, cap <= 0 no
// cap, window <= 0 no window
inline Args make_args(bool bhsd, const int* seg, void* meta, int B, int S,
                      int Hq, int Hk, int D, float scale, float cap,
                      int causal, int window) {
  Args p{};
  p.seg = seg;
  p.meta = static_cast<int4*>(meta);
  p.B = B;
  p.S = S;
  p.Hq = Hq;
  p.Hk = Hk;
  p.n_t = (S + kTile - 1) / kTile;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.cap = cap;
  p.causal = causal;
  p.window = window;
  p.sq = strides_of(bhsd, S, Hq, D);
  p.sk = strides_of(bhsd, S, Hk, D);
  return p;
}

}  // namespace attn
