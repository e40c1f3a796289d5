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

// Four int8 (one 32-bit word) as floats, exactly, without the conversion
// unit (a quarter of the FMA rate): each byte, offset by 128, becomes the
// low byte of the float 2^23 + byte, and subtracting 2^23 + 128 leaves the
// int8 value.
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float f[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// Two floats that are integers of at most 8 significant bits (so bf16
// holds them exactly: the low 16 bits are zero) as a bf16 pair, low first.
__device__ __forceinline__ uint32_t exact_bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Four consecutive bf16 as floats: one 8-byte load.  The pointer must be
// 8-byte aligned.
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  out[0] = __low2float(lo);
  out[1] = __high2float(lo);
  out[2] = __low2float(hi);
  out[3] = __high2float(hi);
}

// 16-byte asynchronous copy from global to shared memory; with `valid`
// false nothing is read and the 16 bytes are zero-filled.  Both addresses
// must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4-byte asynchronous copy from global to shared memory, zero-filled when
// `valid` is false.  Both addresses must be 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

// c += a b on the tensor cores: mma.sync m16n8k16, bf16 operands, fp32 sums.
// a: the four bf16x2 registers of A's (16 x 16, row-major) fragment; b0, b1:
// B's (16 x 8, column-major) fragment; c: the 16 x 8 fragment of C.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four (x4) or two (x2) 8 x 8 bf16 matrices from shared memory into the
// warp's fragments; lanes 8i to 8i + 7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Combines the partial results of `splits` key splits of one attention row,
// in split order, so that the result does not depend on how the blocks that
// wrote them were scheduled.  Split s left m[s * stride] (its running max
// score), l[s * stride] (the sum of exp(score - m)) and o + s * o_stride (its
// unnormalised output row, D floats).  Writes
//   out[d] = bf16(sum_s o_s[d] e^(m_s - M) / sum_s l_s e^(m_s - M)),  M = max_s m_s;
// a split that saw no key has m = -inf and weighs nothing, and a row that saw
// no key at all gets zeros when `zero_empty`.  The block's threads take the
// dims.
__device__ __forceinline__ void merge_splits(const float* m, const float* l, const float* o,
                                             int splits, int stride, long long o_stride, int D,
                                             bool zero_empty, __nv_bfloat16* out) {
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m[s * stride]);
  float den = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float ms = m[s * stride];
    if (ms != -INFINITY) den += l[s * stride] * expf(ms - mx);
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float ms = m[s * stride];
      if (ms != -INFINITY) acc += o[s * o_stride + d] * expf(ms - mx);
    }
    out[d] = __float2bfloat16(zero_empty && !(den > 0.f) ? 0.f : acc / den);
  }
}

}  // namespace myriad
