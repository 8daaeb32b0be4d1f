// Loads and stores of VW (4 or 2) consecutive values of a row, shared by the
// attention kernels' fp32 paths: a lane holds 4 channels at C >= 128 and 2 at
// C = 64.

#pragma once

#include <cuda_bf16.h>

template <int VW>
__device__ __forceinline__ void store_vw(float* p, const float* v) {
  if constexpr (VW == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

template <int VW>
__device__ __forceinline__ void store_vw(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < VW / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
}

template <int VW>
__device__ __forceinline__ void load_vw(const float* p, float* v) {
  if constexpr (VW == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x; v[1] = u.y;
  }
}
