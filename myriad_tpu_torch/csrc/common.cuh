// Small device helpers shared by the port's CUDA kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace myriad {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Reduction over the whole block; every thread gets the result.  `red` is a
// shared scratch of at least 32 floats.  All threads of the block must call it.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = (blockDim.x + 31) / 32;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // `red` may still be read by an earlier reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nwarps ? red[lane] : (kMax ? -INFINITY : 0.f);
  return kMax ? warp_max(v) : warp_sum(v);
}

__device__ __forceinline__ float to_float(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Four consecutive elements as floats.  int8: one 4-byte load; bf16: one
// 8-byte load.  The pointer must be aligned to the load width.
__device__ __forceinline__ void load4(const int8_t* p, float out[4]) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  out[0] = c.x;
  out[1] = c.y;
  out[2] = c.z;
  out[3] = c.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  out[0] = __low2float(lo);
  out[1] = __high2float(lo);
  out[2] = __low2float(hi);
  out[3] = __high2float(hi);
}

}  // namespace myriad
