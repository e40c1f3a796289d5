// Int8 weight-only matrix product for small M (kernel B1).
//
// Replaces myriad_tpu/ops/quant.py::_int8_matmul_kernel, reached through
// int8_matmul -> _int8_pallas_matmul -> _int8_matmul_padded (pallas_call).
// Computes y = (x @ W) * scale[col]: x (M, K) bf16, W (K, N) int8 stored
// (in, out), scale (N,) fp32, y (M, N) bf16.  The sum is taken in fp32 and
// the per-column scale is applied after it, as the TPU kernel does.
//
// What bounds it on the card: at decode M is the batch, so each call does
// 2*M*K*N operations over K*N weight bytes -- 2*M operations a byte, far below
// the H100's ~295 a byte.  The bytes of the weight bound it.  The design
// therefore reads W exactly once per (column tile, K chunk): every thread
// reads 4 consecutive int8 columns of a row (a warp reads 128 contiguous
// bytes), the 8 rows of x that the block serves sit in shared memory, the
// products are summed in fp32 registers, and K is split over blocks so that
// even M = 1 fills the card.  A second, tiny pass sums the split-K partial
// rows in a fixed order (the result does not depend on scheduling) and
// applies the scale.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerThread = 4;
constexpr int kColGroups = 64;                       // threads along N
constexpr int kKGroups = kThreads / kColGroups;      // threads along K
constexpr int kTileN = kColGroups * kColsPerThread;  // 256 columns a block
constexpr int kTileM = 8;                            // rows of x a block
constexpr int kChunkK = 512;                         // K slice a block

__global__ void __launch_bounds__(kThreads)
int8_matmul_partial(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                    float* __restrict__ partial, int M, int K, int N) {
  __shared__ __nv_bfloat16 xs[kTileM][kChunkK];        // 8 KB
  __shared__ float red[kKGroups][kTileM][kTileN];       // 32 KB

  const int tx = threadIdx.x % kColGroups;
  const int ty = threadIdx.x / kColGroups;
  const int n0 = blockIdx.x * kTileN + tx * kColsPerThread;
  const int m0 = blockIdx.y * kTileM;
  const int k0 = blockIdx.z * kChunkK;
  const int kc = min(kChunkK, K - k0);
  const int mc = min(kTileM, M - m0);

  for (int i = threadIdx.x; i < kTileM * kChunkK; i += kThreads) {
    const int m = i / kChunkK, k = i % kChunkK;
    xs[m][k] = (m < mc && k < kc) ? x[(size_t)(m0 + m) * K + k0 + k] : __float2bfloat16(0.f);
  }
  __syncthreads();

  float acc[kTileM][kColsPerThread];
#pragma unroll
  for (int m = 0; m < kTileM; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[m][j] = 0.f;

  if (n0 < N) {
    const int8_t* wp = w + (size_t)k0 * N + n0;
#pragma unroll 4
    for (int k = ty; k < kc; k += kKGroups) {
      float wv[4];
      myriad::load4(wp + (size_t)k * N, wv);
#pragma unroll
      for (int m = 0; m < kTileM; ++m) {
        const float xv = __bfloat162float(xs[m][k]);
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) acc[m][j] += xv * wv[j];
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kTileM; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) red[ty][m][tx * kColsPerThread + j] = acc[m][j];
  __syncthreads();

  for (int i = threadIdx.x; i < kTileM * kTileN; i += kThreads) {
    const int m = i / kTileN, c = i % kTileN;
    const int n = blockIdx.x * kTileN + c;
    if (m < mc && n < N) {
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < kKGroups; ++g) s += red[g][m][c];
      partial[((size_t)blockIdx.z * M + m0 + m) * N + n] = s;
    }
  }
}

__global__ void int8_matmul_epilogue(const float* __restrict__ partial,
                                     const float* __restrict__ scale,
                                     __nv_bfloat16* __restrict__ out, int M, int N, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (i >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * total + i];
  out[i] = __float2bfloat16(s * scale[i % N]);
}

}  // namespace

extern "C" int myriad_int8_matmul_splits(int K) { return (K + kChunkK - 1) / kChunkK; }

// x (M, K) bf16, w (K, N) int8, scale (N,) fp32, partial (splits, M, N) fp32
// scratch, out (M, N) bf16; all contiguous, N a multiple of 4.
extern "C" int myriad_int8_matmul(const void* x, const void* w, const void* scale, void* partial,
                                  void* out, int M, int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = myriad_int8_matmul_splits(K);
  const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM, splits);
  int8_matmul_partial<<<grid, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                static_cast<const int8_t*>(w),
                                                static_cast<float*>(partial), M, K, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t total = (size_t)M * N;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  int8_matmul_epilogue<<<blocks, threads, 0, s>>>(static_cast<const float*>(partial),
                                                  static_cast<const float*>(scale),
                                                  static_cast<__nv_bfloat16*>(out), M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* myriad_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
