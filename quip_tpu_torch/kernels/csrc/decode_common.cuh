// Device helpers shared by the two decode-size dequant-matmuls that read x
// themselves and add their fan-in splits through a thread-block cluster:
// dequant_matmul_decode.cu (K1-decode) and slabdot_matmul.cu (K1').
//   * bf16 pairs: packing two floats, the sum of a pair; two or eight
//     neighbouring elements of x (bf16 or f32) as bf16 pairs;
//   * the split-order cluster sum: four neighbouring f32 partials at the
//     same shared-memory offset of every block of the cluster, added in
//     split order (the same bits every run).
#pragma once

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float pair_sum(uint32_t v) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  return f.x + f.y;
}
__device__ __forceinline__ uint32_t ld_pair(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return pack_bf16(v.x, v.y);
}
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// 8 neighbouring elements as four bf16 pairs (p is 16-byte aligned for bf16,
// 32-byte for f32)
__device__ __forceinline__ uint4 ld_eight(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                    pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}
__device__ __forceinline__ uint4 ld_eight(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// The float4 at red + off in each of the cluster's `splits` blocks, added in
// split order, eight remote reads in flight.
__device__ __forceinline__ float4 split_sum4(
    cooperative_groups::cluster_group& cluster, float* red, int off,
    int splits) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int y0 = 0; y0 < splits; y0 += 8) {
    float4 pv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (y0 + u < splits)
        pv[u] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(red, y0 + u) + off);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (y0 + u < splits) {
        v.x += pv[u].x;
        v.y += pv[u].y;
        v.z += pv[u].z;
        v.w += pv[u].w;
      }
  }
  return v;
}

}  // namespace
