// Shared Hopper (sm_90a) GEMM mainloop: TMA loads into a ring of
// shared-memory stages, mbarrier completion, wgmma consumer warpgroups.
// Used by qdot.cu and gmm_quant.cu (8-bit products), linear_ce_fwd.cu
// (the logits of the forward) and linear_ce_bwd.cu (the dlogits, dh and
// dW products), and gmm.cu (the bf16 grouped products); the kernels
// themselves live in those files, so each keeps its own name, and each
// orders its work items through its own tile functor and keeps its state
// in its own epilogue functor.
//
// One persistent CTA per SM, of 3 warpgroups, walks over work items (a
// 128 x BN output tile and a range of its K tiles):
//   warpgroup 0, the producer: one thread issues the TMA loads
//     (cp.async.bulk.tensor.2d) of each stage's A and B tiles and arms the
//     stage's "full" mbarrier with their byte count; it waits on the
//     stage's "empty" mbarrier before refilling it, and runs on into the
//     next item while the consumers finish the last;
//   warpgroups 1 and 2, the consumers: each waits on "full", runs 4 wgmma
//     (m64nBN, 32 bytes of K each) per stage over its 64 rows of the tile,
//     and releases the stage on "empty" (one arrive per warp) once its
//     wgmmas have read it; then the caller's epilogue writes the item's
//     sums from registers.
// setmaxnreg moves registers from the producer (40) to the consumers (232).
//
// Operand types: bf16 (k16, fp32 sums, each operand K-major or MN-major:
// the transpose bits of 16-bit wgmma read an MN-major tile as it lies),
// e4m3 / e5m2 in the pairings qdot makes (k32, fp32 sums) and s8 (k32, s32
// sums), 8-bit operands K-major only (wgmma takes no transposed 8-bit
// operand).  Tile widths built: BN 256 (m64n256) for bf16, s8 and e4m3 x
// e4m3, BN 128 (m64n128) for the fp8 pairs with promotion.  Tiles are
// swizzled by TMA with the 128-byte pattern, so a stage row is 128 bytes
// of K (64 bf16 or 128 8-bit values) for a K-major operand; an MN-major
// bf16 operand is loaded as 64 x 64 boxes (64 MN values = 128 bytes by 64
// K rows).
//
// Shared-memory descriptors (PTX ISA "matrix descriptor"; the same fields
// as CUTLASS's cute/arch/mma_sm90_desc.hpp GmmaDescriptor): start address
// >> 4 in bits 0-13, leading byte offset >> 4 in 16-29, stride byte offset
// >> 4 in 32-45, layout type 1 (128-byte swizzle) in 62-63.  K-major: SBO
// is the 1024 bytes between 8-row groups, LBO is unused, and a K step
// moves the start address by 32 bytes inside the swizzle atom (the swizzle
// is applied to the computed address, so the 1024-byte aligned tile needs
// no base offset).  MN-major: LBO is the stride between 64-wide MN boxes
// (8192 bytes), SBO the 1024 bytes between 8-row K groups, and a K step of
// 16 rows moves the start address by 2048 bytes.
//
// Ragged edges: the tensor maps carry the true extents and TMA zero-fills
// every element of a box outside them, so ragged M, N and K need no
// predicated loads; zeros past K add nothing.  The byte count armed on
// "full" is the whole box, which TMA counts in full even when it fills.
//
// Grouped products (gmm.cu, gmm_quant.cu) address one block of a larger
// map per item: Tile::a_row / b_row shift the storage-row coordinate of an
// operand (K of an MN-major operand, stored [k][mn]; M or N of a K-major
// one, stored [mn][k]), so one map encoded per call serves every group.
// An item may have no K tiles (nk 0): the producer loads nothing for it
// and the consumers hand epi registers that hold no sums (epi reads t.nk).
// With MASK (both operands MN-major bf16), Tile::k_valid K values of an
// item are valid: in the stage that holds the edge, consumer w zeroes the
// rows past it of its own A box and of B's boxes w, w + 2, ... (a
// 128-byte row is one K row under the 128-byte swizzle), fences the
// generic writes for the async proxy, and both consumer warpgroups meet on
// a named barrier before their wgmmas read the stage (each reads all of
// B).  So values past the edge (the next group's rows) never reach a
// product, even when they are not finite.
//
// Tensor maps are encoded on the host per call, by the driver's
// cuTensorMapEncodeTiled reached through cudaGetDriverEntryPoint (the
// runtime hands out the driver's entry point, so the build links no
// -lcuda), and passed to the kernel as __grid_constant__ CUtensorMap
// parameters.  Bases must be 16-byte aligned and row pitches multiples of
// 16 bytes (the wrappers check both).
//
// Accumulator layout (wgmma's D fragment): consumer warpgroup w (0, 1),
// warp q (0-3) of it, lane l (g = l / 4, t = l % 4); register i (0 to
// BN / 2 - 1) holds the tile element
//   row 64 w + 16 q + g + 8 ((i / 2) % 2),  col 8 (i / 4) + 2 t + (i % 2).

#pragma once

#include <cuda.h>            // CUtensorMap and its enums (declarations only)
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_async.cuh"     // mbarriers, TMA, descriptors, fences
#include "linear_ce_gemm.cuh"   // grouped_tile, num_sms

namespace wg {

enum Ty : int { kS8 = 0, kE4M3 = 1, kE5M2 = 2, kBF16 = 3 };

constexpr int kThreads = 384;          // producer + 2 consumer warpgroups
constexpr int kBM = 128;
constexpr int kRowBytes = 128;         // one swizzled stage row
constexpr int kBox = 64;               // MN-major box: 64 values x 64 rows
constexpr int kBoxBytes = kBox * kBox * 2;

// Tile configuration: operand types, majors (MN-major is bf16 only), tile
// width BN (128 or 256) and PROMOTE: add each stage's 128 K of wgmma sums
// into separate fp32 registers (fp8; see qdot.cu).
template <int TA_, int TB_, bool A_MN_, bool B_MN_, int BN_, bool PROMOTE_>
struct Cfg {
  static constexpr int TA = TA_, TB = TB_, BN = BN_;
  static constexpr bool A_MN = A_MN_, B_MN = B_MN_, PROMOTE = PROMOTE_;
  static constexpr bool kInt = TA == kS8;
  using Acc = typename std::conditional<kInt, int, float>::type;
  static constexpr int kEsz = TA == kBF16 ? 2 : 1;
  static constexpr int BK = kRowBytes / kEsz;    // K values per stage
  static constexpr int kSteps = 4;               // wgmma K steps per stage
  static constexpr int kABytes = kBM * kRowBytes;
  static constexpr int kBBytes = BN * kRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = (200 * 1024) / kStageBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024 +
                                    2 * kStages * 8;
  static_assert(BN == 128 || BN == 256, "BN is 128 or 256");
  static_assert((TA == kBF16) == (TB == kBF16), "bf16 pairs with bf16");
  static_assert((TA == kS8) == (TB == kS8), "s8 pairs with s8");
  static_assert(kEsz == 2 || (!A_MN && !B_MN), "8-bit operands are K-major");
  static_assert(!(PROMOTE && kInt), "s32 sums are exact");
  static_assert(kStages >= 4, "at least 4 stages");
};

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------
// A 2-D map over row-major storage of `rows` rows of `cols` values
// (`esize` bytes each, bf16 or bytes) with a row pitch of `ld` values,
// boxes of box_rows x box_cols, 128-byte swizzle, zero fill outside.
// Returns 0, or -2 without the driver's entry point, or 10000 + the
// CUresult of a refused encoding.
inline int make_map(CUtensorMap* map, const void* base, int esize,
                    long long cols, long long rows, long long ld,
                    int box_cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld * esize)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(
      map, esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(base), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(r);
}

// The map of operand A (IS_A) or B of configuration C: K-major storage
// [mn][ld] or MN-major storage [k][ld], with mn and k its true extents.
template <class C, bool IS_A>
int operand_map(CUtensorMap* map, const void* base, long long mn,
                long long k, long long ld) {
  constexpr bool MN = IS_A ? C::A_MN : C::B_MN;
  if (MN) return make_map(map, base, C::kEsz, mn, k, ld, kBox, kBox);
  return make_map(map, base, C::kEsz, k, mn, ld, C::BK,
                  IS_A ? kBM : C::BN);
}

template <class C, typename K>
int prepare(K kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes));
}

// ---------------------------------------------------------------------------
// device: wgmma (barriers, TMA, descriptors and fences: hopper_async.cuh)
// ---------------------------------------------------------------------------
// ---- wgmma m64nN, one K step (32 bytes of K): D += A B (scale_d 0: D =
// A B)
__device__ __forceinline__ void mma_e4m3_e4m3_n128(float (&d)[64], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1;\n}\n"
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

__device__ __forceinline__ void mma_e5m2_e4m3_n128(float (&d)[64], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f32.e5m2.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1;\n}\n"
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

__device__ __forceinline__ void mma_e4m3_e5m2_n128(float (&d)[64], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e5m2 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1;\n}\n"
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

template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void mma_bf16_n256(float (&d)[128], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
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
      ", %128, %129, p, 1, 1, %131, %132;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

__device__ __forceinline__ void mma_e4m3_e4m3_n256(float (&d)[128], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.f32.e4m3.e4m3 "
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
      ", %128, %129, p, 1, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_s8_n256(int (&d)[128], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
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
      ", %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}


template <class C>
__device__ __forceinline__ void mma(typename C::Acc (&d)[C::BN / 2],
                                    uint64_t da, uint64_t db, int scale_d) {
  constexpr int TA = C::A_MN ? 1 : 0, TB = C::B_MN ? 1 : 0;
  if constexpr (C::BN == 256) {
    static_assert(C::TA != kE5M2 && C::TB != kE5M2, "not built");
    if constexpr (C::TA == kBF16) mma_bf16_n256<TA, TB>(d, da, db, scale_d);
    else if constexpr (C::TA == kS8) mma_s8_n256(d, da, db, scale_d);
    else mma_e4m3_e4m3_n256(d, da, db, scale_d);
  } else {
    static_assert(C::TA != kBF16 && C::TA != kS8, "not built");
    if constexpr (C::TA == kE4M3 && C::TB == kE4M3)
      mma_e4m3_e4m3_n128(d, da, db, scale_d);
    else if constexpr (C::TA == kE5M2 && C::TB == kE4M3)
      mma_e5m2_e4m3_n128(d, da, db, scale_d);
    else
      mma_e4m3_e5m2_n128(d, da, db, scale_d);
  }
}

// Row and column inside the CTA tile of accumulator register i, for the
// calling thread of consumer warpgroup w.
__device__ __forceinline__ int acc_row(int w, int i) {
  return 64 * w + 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) +
         8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// A unit of work: the output tile at (m0, n0) over the K tiles [kt0, kt0 +
// nk) (nk >= 0, C::BK values each); `part` is the caller's (a split-K
// slice, a group).  a_row / b_row: storage-row offsets of the operands'
// blocks (header note); k_valid: the item's valid K values (MASK only).
struct Tile {
  int m0, n0, kt0, nk, part;
  int a_row = 0, b_row = 0;
  int k_valid = 0x7fffffff;
};

// The persistent CTA: it takes the work items blockIdx.x, blockIdx.x +
// gridDim.x, ... below n_work, tile(i) giving each one's Tile, and runs the
// producer and the two consumers of the header note over them.  The stage
// ring runs on across items, so the producer loads the next item's first
// stages while the consumers finish the last one's epilogue.  Each
// consumer calls epi(w, t, acc) after each item with its warpgroup index
// w, the item's Tile t and its sums acc[C::BN / 2] (s32, or fp32; with
// PROMOTE the fp32 registers the stages were added into; no sums when
// t.nk is 0, except PROMOTE's zeros), and pre(w, t) before the item's
// first K step (loads the epilogue will need, issued while the products
// run; no-op by default).  MASK: zero the operands' rows past t.k_valid
// (MN-major bf16 operands only; header note).  The kernel
// holds C::kSmemBytes of dynamic shared memory at `smem_raw`, launches
// kThreads threads, and must not touch shared memory or synchronise the
// whole CTA after this call (the producer warpgroup has left).
struct NoPre {
  __device__ void operator()(int, const Tile&) const {}
};

template <class C, bool MASK = false, class TileOf, class Epi,
          class Pre = NoPre>
__device__ __forceinline__ void mainloop(uint8_t* smem_raw,
                                         const CUtensorMap* ta,
                                         const CUtensorMap* tb, int n_work,
                                         TileOf&& tile, Epi&& epi,
                                         Pre&& pre = Pre{}) {
  uint8_t* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + C::kStages * C::kStageBytes);
  uint64_t* empty = full + C::kStages;
  const int tid = threadIdx.x, wgi = tid >> 7;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 8);          // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {                      // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 0) return;
    int it = 0;                        // stage uses so far
    for (int wi = blockIdx.x; wi < n_work; wi += gridDim.x) {
      const Tile t = tile(wi);
      for (int i = 0; i < t.nk; ++i, ++it) {
        const int s = it % C::kStages;
        if (it >= C::kStages) bar_wait(&empty[s], ((it / C::kStages) - 1) & 1);
        uint8_t* sa = smem + s * C::kStageBytes;
        uint8_t* sb = sa + C::kABytes;
        bar_expect(&full[s], C::kStageBytes);
        const int k0 = (t.kt0 + i) * C::BK;
        if constexpr (C::A_MN) {
#pragma unroll
          for (int j = 0; j < kBM / kBox; ++j)
            tma_load(sa + j * kBoxBytes, ta, &full[s], t.m0 + j * kBox,
                     t.a_row + k0);
        } else {
          tma_load(sa, ta, &full[s], k0, t.a_row + t.m0);
        }
        if constexpr (C::B_MN) {
#pragma unroll
          for (int j = 0; j < C::BN / kBox; ++j)
            tma_load(sb + j * kBoxBytes, tb, &full[s], t.n0 + j * kBox,
                     t.b_row + k0);
        } else {
          tma_load(sb, tb, &full[s], k0, t.b_row + t.n0);
        }
      }
    }
    return;
  }

  // consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int w = wgi - 1, lane = tid & 31;
  // no instruction but wgmma defines acc (the first K step of each item
  // writes it with scale-d 0), so ptxas keeps the wgmmas in flight
  typename C::Acc acc[C::BN / 2];
  float tot[C::PROMOTE ? C::BN / 2 : 1];
  int it = 0;
  for (int wi = blockIdx.x; wi < n_work; wi += gridDim.x) {
    const Tile t = tile(wi);
    pre(w, t);
    if constexpr (C::PROMOTE) {
#pragma unroll
      for (int j = 0; j < C::BN / 2; ++j) tot[j] = 0.f;
    }
    for (int i = 0; i < t.nk; ++i, ++it) {
      const int s = it % C::kStages;
      bar_wait(&full[s], (it / C::kStages) & 1);
      if constexpr (MASK) {
        static_assert(C::A_MN && C::B_MN && C::kEsz == 2,
                      "MASK: MN-major bf16 operands");
        const int valid = t.k_valid - i * C::BK;    // uniform per item
        if (valid < C::BK) {
          uint8_t* st = smem + s * C::kStageBytes;
          // A's box w, then B's boxes w, w + 2, ...
          for (int j = 0; j <= C::BN / kBox / 2; ++j) {
            uint8_t* box = j == 0 ? st + w * kBoxBytes
                                  : st + C::kABytes +
                                        (2 * (j - 1) + w) * kBoxBytes;
            for (int o = max(valid, 0) * kRowBytes + (tid & 127) * 16;
                 o < kBoxBytes; o += 128 * 16)
              *reinterpret_cast<uint4*>(box + o) = make_uint4(0, 0, 0, 0);
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync 1, 256;\n" ::: "memory");
        }
      }
      const uint32_t a0 = saddr(smem + s * C::kStageBytes);
      const uint32_t b0 = a0 + C::kABytes;
      pin(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < C::kSteps; ++kk) {
        const uint64_t da =
            C::A_MN ? desc(a0 + w * kBoxBytes + kk * 16 * kRowBytes,
                           kBoxBytes, 8 * kRowBytes)
                    : desc(a0 + w * 64 * kRowBytes + kk * 32, 16,
                           8 * kRowBytes);
        const uint64_t db =
            C::B_MN ? desc(b0 + kk * 16 * kRowBytes, kBoxBytes, 8 * kRowBytes)
                    : desc(b0 + kk * 32, 16, 8 * kRowBytes);
        // the first K step of a stage (PROMOTE) or of the item starts the
        // sums afresh
        mma<C>(acc, da, db, kk > 0 || (!C::PROMOTE && i > 0));
      }
      wg_commit();
      pin(acc);
      if constexpr (C::PROMOTE) {
        wg_wait<0>();
        pin(acc);
        if (lane == 0) bar_arrive(&empty[s]);
#pragma unroll
        for (int j = 0; j < C::BN / 2; ++j) tot[j] += acc[j];
      } else {
        wg_wait<1>();
        pin(acc);
        if (i > 0 && lane == 0)
          bar_arrive(&empty[(it - 1) % C::kStages]);
      }
    }
    if constexpr (C::PROMOTE) {
      epi(w, t, tot);
    } else {
      if (t.nk > 0) {
        wg_wait<0>();
        pin(acc);
        if (lane == 0) bar_arrive(&empty[(it - 1) % C::kStages]);
      }
      epi(w, t, acc);
    }
  }
}

// Work items for a grid of n_m x n_n output tiles times `parts` K ranges
// of kt_part K tiles (the last holds the rest of kt_total): item i is
// part i / (n_m n_n) of the tile lce::grouped_tile gives for i % (n_m
// n_n), so the CTAs resident at one time share B tiles through L2.
__device__ __forceinline__ Tile grid_tile(int i, int n_m, int n_n,
                                          int group_m, int bn, int kt_total,
                                          int kt_part) {
  const int tiles = n_m * n_n;
  int tm, tn;
  lce::grouped_tile(i % tiles, n_m, n_n, group_m, &tm, &tn);
  Tile t;
  t.m0 = tm * kBM;
  t.n0 = tn * bn;
  t.part = i / tiles;
  t.kt0 = t.part * kt_part;
  t.nk = min(kt_part, kt_total - t.kt0);
  return t;
}

// Row-tile groups for grid_tile: as many row tiles per group as keep the
// CTAs resident at one time (one per SM) on a few column tiles of each.
inline int group_rows(int n_m, int n_n) {
  const int g = lce::num_sms() / n_n;
  return g < 1 ? 1 : (g > n_m ? n_m : g);
}

}  // namespace wg
