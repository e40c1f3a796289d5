// uint8 image normalisation (kernel B6).
//
// Replaces myriad_tpu/ops/preprocess.py::_normalize_kernel, reached through
// u8_normalize_pallas (pallas_call).  Computes, element by element over the
// flattened uint8 (..., 3) images,
//   out[i] = (x[i] / 255 - mean[c]) / std[c],  c = i mod 3
// in fp32, written as fp32 or bf16 (round to nearest even).  The TPU kernel
// cut the flat array into rows of 128 lanes and gathered mean/std by the
// channel of each lane.
//
// What bounds it on the card: 1 byte read and 4 (or 2) bytes written per
// element: the bytes.  So each element should cost a load's share, a
// store's share and little else:
// - the function has only 3 x 256 values.  Each block builds them in shared
//   memory (entry 256 c + v, by the plain version's two IEEE divisions in the
//   same order: the build has no -use_fast_math), while its loads are in
//   flight; an element is then one shared-memory read, bit-identical to the
//   plain version by construction;
// - a thread reads 4-byte words (4 elements) at consecutive addresses
//   across the warp and writes each word's 4 outputs as one 16-byte (fp32)
//   or 8-byte (bf16) store, also consecutive across the warp;
// - word i starts at element 4 i, of channel (4 i) mod 3 = i mod 3, which a
//   thread gets from 32-bit operations on its block and thread index.
// The last n mod 4 elements are written one by one.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 4;  // words a thread, kThreads apart
constexpr int kBlockWords = kThreads * kWords;

__device__ __forceinline__ void store4(float* out, long long word, const float v[4]) {
  reinterpret_cast<float4*>(out)[word] = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, long long word, const float v[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  reinterpret_cast<uint2*>(out)[word] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                   *reinterpret_cast<const uint32_t*>(&hi));
}

__device__ __forceinline__ void store1(float* out, long long i, float v) { out[i] = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, long long i, float v) {
  out[i] = __float2bfloat16(v);
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
u8_normalize_kernel(const uint8_t* __restrict__ x, Out* __restrict__ out, long long n, float m0,
                    float m1, float m2, float s0, float s1, float s2) {
  __shared__ float table[3 * 256];
  const long long words = n / 4;
  const long long first = (long long)blockIdx.x * kBlockWords + threadIdx.x;
  const uint32_t* x4 = reinterpret_cast<const uint32_t*>(x);
  uint32_t w[kWords];
#pragma unroll
  for (int u = 0; u < kWords; ++u) {
    const long long i = first + u * kThreads;
    w[u] = i < words ? __ldg(x4 + i) : 0u;
  }
  for (int e = threadIdx.x; e < 3 * 256; e += kThreads) {
    const int c = e >> 8;
    const float m = c == 0 ? m0 : (c == 1 ? m1 : m2);
    const float s = c == 0 ? s0 : (c == 1 ? s1 : s2);
    table[e] = (static_cast<float>(e & 255) / 255.0f - m) / s;
  }
  __syncthreads();

  // channel of word `first`: (blockIdx.x * kBlockWords + threadIdx.x) mod 3
  const unsigned block_c = (blockIdx.x % 3) * (kBlockWords % 3);
  const unsigned c0 = (block_c + threadIdx.x) % 3;
#pragma unroll
  for (int u = 0; u < kWords; ++u) {
    const long long i = first + u * kThreads;
    if (i < words) {
      const unsigned c = (c0 + u * (kThreads % 3)) % 3;
      const float* t0 = table + 256 * c;
      const float* t1 = table + 256 * (c == 2 ? 0 : c + 1);
      const float* t2 = table + 256 * (c == 0 ? 2 : c - 1);
      const float v[4] = {t0[w[u] & 255], t1[(w[u] >> 8) & 255], t2[(w[u] >> 16) & 255],
                          t0[w[u] >> 24]};
      store4(out, i, v);
    }
  }
  // the tail, in the last block: element 4 words + k, of channel (words + k) mod 3
  const int tail = static_cast<int>(n - 4 * words);
  if (blockIdx.x == gridDim.x - 1 && static_cast<int>(threadIdx.x) < tail) {
    const unsigned last_word = static_cast<unsigned>(words - (long long)blockIdx.x * kBlockWords);
    const unsigned c = (block_c + last_word + threadIdx.x) % 3;
    const long long i = 4 * words + threadIdx.x;
    store1(out, i, table[256 * c + x[i]]);
  }
}

template <typename Out>
int launch(const void* x, void* out, long long n, float m0, float m1, float m2, float s0,
           float s1, float s2, cudaStream_t stream) {
  if (n == 0) return 0;
  const long long blocks = (n / 4 + kBlockWords - 1) / kBlockWords;
  u8_normalize_kernel<Out><<<static_cast<unsigned>(blocks > 0 ? blocks : 1), kThreads, 0,
                             stream>>>(static_cast<const uint8_t*>(x), static_cast<Out*>(out), n,
                                       m0, m1, m2, s0, s1, s2);
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
