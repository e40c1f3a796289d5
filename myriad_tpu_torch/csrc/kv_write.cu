// In-place KV-cache writes at per-row start positions (kernel B4).
//
// Replaces myriad_tpu/ops/kv_write.py::_kv_write_kernel, reached through
// kv_cache_write -> _write_pallas (pallas_call).  The TPU kernel found each
// written block's place from a scalar-prefetched start idx[b] and copied
// (1, H, D) blocks into the aliased pool; it could not write D < 8 (the
// per-position scales went through vmap(dynamic_update_slice) instead).
//
// Two entry points, one block per (batch row, head, written position):
//   myriad_kv_write           copies a row of D elements of any type;
//   myriad_kv_quantize_write  quantizes a bf16 row of K or V as
//                             models/llama.py::quantize_kv does and writes
//                             the int8 payload and the fp16 scale, K and V in
//                             one launch (blockIdx.z = 2 * b + {0: K, 1: V}).
// The start of row b is idx[b] (or one start for every row when idx is
// null), clamped to [0, T - t] as the TPU kernel clamps it.
//
// What bounds it on the card: nothing but launch latency.  A verify round at
// B = 8, H = 32, t = 4, D = 128 writes 128 KB of int8 payload and reads twice
// that in bf16; the card moves it in well under a microsecond, and a launch
// costs a few.  So the design goal is few launches, not bandwidth: the int8
// cache's whole write (two quantizations, four buffers) is one launch where
// the plain version takes about ten.  Rows move as 16-byte vectors when the
// row and both addresses allow it, else element by element, so any D works.
//
// Bit-exactness with the plain version: the amax is a max (order-free); the
// scale is max(amax / 127, 1e-8) by an IEEE division (no fast math in the
// build), each value is rintf(x / scale) (round half to even, as torch.round)
// clamped to [-127, 127], and the fp32 scale is stored with __float2half_rn.

#include "common.cuh"

namespace {

constexpr int kThreads = 32;  // one warp per written row

__device__ __forceinline__ int clamped_start(const int* idx, int start, int b, int T, int t) {
  const int s = idx ? idx[b] : start;
  return min(max(s, 0), T - t);
}

__global__ void __launch_bounds__(kThreads)
kv_write_kernel(char* __restrict__ buf, const char* __restrict__ upd, const int* __restrict__ idx,
                int start, int t, int T, int row_bytes, long long buf_sb, long long buf_sh,
                long long buf_st, long long upd_sb, long long upd_sh, long long upd_st) {
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int pos = clamped_start(idx, start, b, T, t) + j;
  char* dst = buf + b * buf_sb + h * buf_sh + pos * buf_st;
  const char* src = upd + b * upd_sb + h * upd_sh + j * upd_st;
  if ((((uintptr_t)dst | (uintptr_t)src | (uintptr_t)row_bytes) & 15) == 0) {
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (int i = threadIdx.x; i < row_bytes / 16; i += kThreads) d4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < row_bytes; i += kThreads) dst[i] = src[i];
  }
}

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(x / scale), -127.f), 127.f));
}

__global__ void __launch_bounds__(kThreads)
kv_quantize_write_kernel(int8_t* __restrict__ k8, int8_t* __restrict__ v8,
                         __half* __restrict__ ks, __half* __restrict__ vs,
                         const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                         const int* __restrict__ idx, int start, int t, int T, int D,
                         long long c_sb, long long c_sh, long long c_st, long long s_sb,
                         long long s_sh, long long s_st, long long x_sb, long long x_sh,
                         long long x_st) {
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z / 2, which = blockIdx.z % 2;
  const int pos = clamped_start(idx, start, b, T, t) + j;
  const __nv_bfloat16* src = (which ? v : k) + b * x_sb + h * x_sh + j * x_st;
  int8_t* dst = (which ? v8 : k8) + b * c_sb + h * c_sh + pos * c_st;
  __half* sdst = (which ? vs : ks) + b * s_sb + h * s_sh + pos * s_st;
  // 8 values a lane: one 16-byte load of bf16, one 8-byte store of int8
  const bool vec = D % 8 == 0 && (((uintptr_t)src & 15) | ((uintptr_t)dst & 7)) == 0;

  float amax = 0.f;
  if (vec) {
    for (int i = threadIdx.x * 8; i < D; i += kThreads * 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + i);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        amax = fmaxf(amax, fabsf(__low2float(p[c])));
        amax = fmaxf(amax, fabsf(__high2float(p[c])));
      }
    }
  } else {
    for (int i = threadIdx.x; i < D; i += kThreads)
      amax = fmaxf(amax, fabsf(__bfloat162float(src[i])));
  }
  amax = myriad::warp_max(amax);
  const float scale = fmaxf(amax / 127.0f, 1e-8f);

  if (vec) {
    for (int i = threadIdx.x * 8; i < D; i += kThreads * 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + i);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
      char4 lo, hi;
      lo.x = quantize(__low2float(p[0]), scale);
      lo.y = quantize(__high2float(p[0]), scale);
      lo.z = quantize(__low2float(p[1]), scale);
      lo.w = quantize(__high2float(p[1]), scale);
      hi.x = quantize(__low2float(p[2]), scale);
      hi.y = quantize(__high2float(p[2]), scale);
      hi.z = quantize(__low2float(p[3]), scale);
      hi.w = quantize(__high2float(p[3]), scale);
      uint2 out;
      out.x = *reinterpret_cast<const unsigned int*>(&lo);
      out.y = *reinterpret_cast<const unsigned int*>(&hi);
      *reinterpret_cast<uint2*>(dst + i) = out;
    }
  } else {
    for (int i = threadIdx.x; i < D; i += kThreads)
      dst[i] = quantize(__bfloat162float(src[i]), scale);
  }
  if (threadIdx.x == 0) *sdst = __float2half_rn(scale);
}

}  // namespace

// buf (B, H, T, D) and upd (B, H, t, D) of one element type, given by their
// byte strides (sb, sh, st) and the row's bytes (D * element size); idx (B,)
// int32 per-row starts, or null to start every row at `start`.
extern "C" int myriad_kv_write(void* buf, const void* upd, const void* idx, int start, int B,
                               int H, int t, int T, int row_bytes, long long buf_sb,
                               long long buf_sh, long long buf_st, long long upd_sb,
                               long long upd_sh, long long upd_st, void* stream) {
  const dim3 grid(t, H, B);
  kv_write_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(buf), static_cast<const char*>(upd), static_cast<const int*>(idx),
      start, t, T, row_bytes, buf_sb, buf_sh, buf_st, upd_sb, upd_sh, upd_st);
  return static_cast<int>(cudaGetLastError());
}

// k8, v8 (B, H, T, D) int8 with element strides (c_sb, c_sh, c_st); ks, vs
// (B, H, T, 1) fp16 with strides (s_sb, s_sh, s_st); k, v (B, H, t, D) bf16
// with strides (x_sb, x_sh, x_st), last dims contiguous; idx as above.
extern "C" int myriad_kv_quantize_write(void* k8, void* v8, void* ks, void* vs, const void* k,
                                        const void* v, const void* idx, int start, int B, int H,
                                        int t, int T, int D, long long c_sb, long long c_sh,
                                        long long c_st, long long s_sb, long long s_sh,
                                        long long s_st, long long x_sb, long long x_sh,
                                        long long x_st, void* stream) {
  const dim3 grid(t, H, 2 * B);
  kv_quantize_write_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(k8), static_cast<int8_t*>(v8), static_cast<__half*>(ks),
      static_cast<__half*>(vs), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(idx), start, t, T, D, c_sb,
      c_sh, c_st, s_sb, s_sh, s_st, x_sb, x_sh, x_st);
  return static_cast<int>(cudaGetLastError());
}
