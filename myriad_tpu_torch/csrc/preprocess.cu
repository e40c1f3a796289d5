// uint8 image normalisation (kernel B6).
//
// Replaces myriad_tpu/ops/preprocess.py::_normalize_kernel, reached through
// u8_normalize_pallas (pallas_call).  Computes, element by element over the
// flattened uint8 (..., 3) images,
//   out[i] = (x[i] / 255 - mean[c]) / std[c],  c = i mod 3
// in fp32, written as fp32 or bf16 (round to nearest even).  The TPU kernel
// cut the flat array into rows of 128 lanes and gathered mean/std by the
// channel of each lane; here each thread takes 16 consecutive bytes (one
// 16-byte load) and computes their channels from the flat index.
//
// What bounds it on the card: 1 byte read and 4 (or 2) bytes written per
// element, a few operations each: the bytes.  Both divisions are IEEE
// divisions (the build uses no -use_fast_math), so the result is bit-exact
// with the plain version, which divides by tensors.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;

__device__ __forceinline__ float normalize(uint32_t v, long long i, float m0, float m1, float m2,
                                           float s0, float s1, float s2) {
  const int c = static_cast<int>(i % 3);
  const float m = c == 0 ? m0 : (c == 1 ? m1 : m2);
  const float s = c == 0 ? s0 : (c == 1 ? s1 : s2);
  return (static_cast<float>(v) / 255.0f - m) / s;
}

__device__ __forceinline__ void store(float* out, long long i, float v) { out[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* out, long long i, float v) {
  out[i] = __float2bfloat16(v);
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
u8_normalize_kernel(const uint8_t* __restrict__ x, Out* __restrict__ out, long long n, float m0,
                    float m1, float m2, float s0, float s1, float s2) {
  const long long stride = (long long)gridDim.x * kThreads * kPerThread;
  for (long long base = ((long long)blockIdx.x * kThreads + threadIdx.x) * kPerThread; base < n;
       base += stride) {
    if (base + kPerThread <= n) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + base);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int w = 0; w < 4; ++w)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const long long i = base + 4 * w + j;
          store(out, i, normalize((words[w] >> (8 * j)) & 0xffu, i, m0, m1, m2, s0, s1, s2));
        }
    } else {
      for (long long i = base; i < n; ++i)
        store(out, i, normalize(x[i], i, m0, m1, m2, s0, s1, s2));
    }
  }
}

template <typename Out>
int launch(const void* x, void* out, long long n, float m0, float m1, float m2, float s0,
           float s1, float s2, cudaStream_t stream) {
  const long long per_block = (long long)kThreads * kPerThread;
  const long long blocks = (n + per_block - 1) / per_block;
  const unsigned grid = static_cast<unsigned>(blocks < 65535 ? (blocks > 0 ? blocks : 1) : 65535);
  u8_normalize_kernel<Out><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<Out*>(out), n, m0, m1, m2, s0, s1, s2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: n uint8, 16-byte aligned, channel-last with 3 channels; out: n fp32
// (out_bf16 == 0) or bf16 values.
extern "C" int myriad_u8_normalize(const void* x, void* out, long long n, float m0, float m1,
                                   float m2, float s0, float s1, float s2, int out_bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) return launch<__nv_bfloat16>(x, out, n, m0, m1, m2, s0, s1, s2, s);
  return launch<float>(x, out, n, m0, m1, m2, s0, s1, s2, s);
}
