// Helpers the kernels on wgmma_gemm.cuh share (the linear-CE forward and
// backward, gmm, gmm_quant, qdot): the bf16 type and pair packing, the
// grouped raster of output tiles and the device's SM count.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace lce {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (tile_m, tile_n) of CTA `id` over an n_m x n_n grid of output tiles, row
// tiles fastest inside groups of `group_m` row tiles: the CTAs resident at
// one time cover a few column tiles of every row tile of their group, so
// they share the B tiles they read (and the group's A rows) through L2.
__device__ __forceinline__ void grouped_tile(int id, int n_m, int n_n,
                                             int group_m, int* tm, int* tn) {
  const int per_group = group_m * n_n;
  const int first = (id / per_group) * group_m;
  const int size = min(n_m - first, group_m);
  const int in_group = id % per_group;
  *tm = first + in_group % size;
  *tn = in_group / size;
}

inline int num_sms() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 132;
}

}  // namespace lce
