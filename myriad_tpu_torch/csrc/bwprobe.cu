// Streaming sums for the device-memory bandwidth probe (kernel B7).
//
// Replaces tools/bwprobe.py::_sum_kernel and ::_sum2_kernel (_stream_sum and
// _stream_sum2, pallas_call).  The operand is cut into n_blocks blocks of
// block_elems elements; block i computes, in fp32,
//   partial[i] = sum(x[block i]) (+ sum(y[block i])) + c
// and a second pass sums the partials in a fixed order, so the result is the
// TPU kernel's: sum(x) (+ sum(y)) + c * n_blocks.  The scalar c per call
// keeps a caller's repeated passes distinct, as in the TPU probe.
//
// What bounds it on the card: one byte (int8) or two (bf16) read per element
// and one add: the bytes, by far.  The TPU grid ran its blocks in order and
// carried the sum in its output block; here the blocks run in parallel, one
// CUDA block per operand block (2 MB at the probe's 512 x 4096 int8), every
// thread reading 16 bytes per load with 4 loads in flight, and the final
// sum of the partials is the second, tiny pass.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float sum16(uint4 raw, const int8_t*) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  int s = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s += static_cast<int8_t>((w[i] >> (8 * j)) & 0xffu);
  return static_cast<float>(s);
}

__device__ __forceinline__ float sum16(uint4 raw, const __nv_bfloat16*) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    s += __low2float(v) + __high2float(v);
  }
  return s;
}

// fp32 sum of n16 16-byte words at p, strided over the block's threads
template <typename T>
__device__ __forceinline__ float block_stream(const uint4* __restrict__ p, long long n16) {
  float acc = 0.f;
  long long i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < n16; i += kUnroll * kThreads) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = p[i + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += sum16(raw[u], static_cast<const T*>(nullptr));
  }
  for (; i < n16; i += kThreads) acc += sum16(p[i], static_cast<const T*>(nullptr));
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stream_sum_kernel(const T* __restrict__ x, const T* __restrict__ y, float* __restrict__ partial,
                  long long block_elems, float c) {
  __shared__ float red[32];
  const long long n16 = block_elems * (long long)sizeof(T) / 16;
  const size_t off = (size_t)blockIdx.x * block_elems;
  float acc = block_stream<T>(reinterpret_cast<const uint4*>(x + off), n16);
  if (y) acc += block_stream<T>(reinterpret_cast<const uint4*>(y + off), n16);
  acc = myriad::block_reduce<false>(acc, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc + c;
}

// one block: each thread sums a fixed strided slice in order, then a fixed
// reduction tree; the result does not depend on scheduling
__global__ void __launch_bounds__(kThreads)
sum_partials(const float* __restrict__ partial, long long n, float* __restrict__ out) {
  __shared__ float red[32];
  float acc = 0.f;
  for (long long i = threadIdx.x; i < n; i += kThreads) acc += partial[i];
  acc = myriad::block_reduce<false>(acc, red);
  if (threadIdx.x == 0) *out = acc;
}

template <typename T>
int launch(const void* x, const void* y, void* partial, void* out, long long n_blocks,
           long long block_elems, float c, cudaStream_t stream) {
  stream_sum_kernel<T><<<static_cast<unsigned>(n_blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<float*>(partial),
      block_elems, c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sum_partials<<<1, kThreads, 0, stream>>>(static_cast<const float*>(partial), n_blocks,
                                           static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (and y, or null): n_blocks * block_elems contiguous int8 (bf16 == 0) or
// bf16 elements, 16-byte aligned, block_elems * itemsize a multiple of 16;
// partial: n_blocks fp32 scratch; out: one fp32.
extern "C" int myriad_stream_sum(const void* x, const void* y, void* partial, void* out,
                                 long long n_blocks, long long block_elems, float c, int bf16,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(x, y, partial, out, n_blocks, block_elems, c, s);
  return launch<int8_t>(x, y, partial, out, n_blocks, block_elems, c, s);
}
