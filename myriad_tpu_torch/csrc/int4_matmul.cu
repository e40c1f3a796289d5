// Int4 group-wise weight-only matrix product for small M (kernel B5).
//
// Replaces myriad_tpu/ops/quant.py::_int4_matmul_kernel, reached through
// int4_matmul -> _int4_matmul_padded (pallas_call).  Computes, as the TPU
// kernel does,
//   y = sum_k x[k] * bf16(bf16(q[k]) * bf16(scale[k / group]))
// x (M, K) bf16; W packed (K/2, N) uint8, input row 2i in the low nibble of
// packed row i and row 2i+1 in the high one, each a two's-complement int4
// (sign by (v ^ 8) - 8); scale (K/group, N) fp32; y (M, N) bf16.  The scale
// applies BEFORE the dot and the dequantized weight is rounded to bf16, as
// the TPU kernel's bf16 nibble planes are; the sum is fp32.
//
// What bounds it on the card: at decode M is the batch, so a call does
// 2*M*K*N operations over K*N/2 weight bytes (plus K*N/32 scale bytes at
// group 128): 4*M operations a byte, far below the H100's ~295.  The weight
// bytes bound it, half of kernel B1's.  The design is B1's: every thread
// reads 4 packed bytes (4 output columns x 2 input rows) per load, so a warp
// reads 128 contiguous bytes of a packed row; the 8 rows of x that a block
// serves sit in shared memory as (even, odd) bf16 pairs; the group scales of
// a thread's 4 columns are one 16-byte load per group; products sum in fp32
// registers; K is split over blocks in chunks of 512 input rows (4 groups of
// 128, so a chunk never splits a group at group 128; any even group works),
// and the last chunk is short where K is not a multiple of 512 (11008 = 21.5
// chunks): no padded copy of the weight.  A second, tiny pass sums the
// split-K partials in a fixed order.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerThread = 4;
constexpr int kColGroups = 64;                       // threads along N
constexpr int kKGroups = kThreads / kColGroups;      // threads along packed K
constexpr int kTileN = kColGroups * kColsPerThread;  // 256 columns a block
constexpr int kTileM = 8;                            // rows of x a block
constexpr int kChunkK = 512;                         // input rows a block
constexpr int kChunkP = kChunkK / 2;                 // packed rows a block

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// two's-complement nibble -> float in [-8, 7]
__device__ __forceinline__ float nibble(uint32_t v) {
  return static_cast<float>(static_cast<int>((v & 15u) ^ 8u) - 8);
}

__global__ void __launch_bounds__(kThreads)
int4_matmul_partial(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                    const float* __restrict__ scale, float* __restrict__ partial, int M, int K,
                    int N, int group) {
  __shared__ __nv_bfloat162 xs[kTileM][kChunkP];  // (x[2p], x[2p+1]): 8 KB
  __shared__ float red[kKGroups][kTileM][kTileN];  // 32 KB

  const int tx = threadIdx.x % kColGroups;
  const int ty = threadIdx.x / kColGroups;  // one value per warp
  const int n0 = blockIdx.x * kTileN + tx * kColsPerThread;
  const int m0 = blockIdx.y * kTileM;
  const int k0 = blockIdx.z * kChunkK;
  const int pc = min(kChunkK, K - k0) / 2;
  const int mc = min(kTileM, M - m0);

  for (int i = threadIdx.x; i < kTileM * kChunkP; i += kThreads) {
    const int m = i / kChunkP, p = i % kChunkP;
    if (m < mc && p < pc)
      xs[m][p] = *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)(m0 + m) * K + k0 + 2 * p);
    else
      xs[m][p] = __floats2bfloat162_rn(0.f, 0.f);
  }
  __syncthreads();

  float acc[kTileM][kColsPerThread];
#pragma unroll
  for (int m = 0; m < kTileM; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[m][j] = 0.f;

  if (n0 < N) {
    const uint8_t* wp = w + (size_t)(k0 / 2) * N + n0;
    int group_end = 0;  // first input row past the current group
    float s[kColsPerThread];
#pragma unroll 4
    for (int p = ty; p < pc; p += kKGroups) {
      const int row = k0 + 2 * p;  // both nibbles of a byte share its group
      if (row >= group_end) {      // a division per group, not per row
        const int grp = row / group;
        group_end = (grp + 1) * group;
        const float4 sv = *reinterpret_cast<const float4*>(scale + (size_t)grp * N + n0);
        s[0] = bf16_round(sv.x);
        s[1] = bf16_round(sv.y);
        s[2] = bf16_round(sv.z);
        s[3] = bf16_round(sv.w);
      }
      const uint32_t raw = *reinterpret_cast<const uint32_t*>(wp + (size_t)p * N);
      float lo[kColsPerThread], hi[kColsPerThread];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const uint32_t byte = raw >> (8 * j);
        lo[j] = bf16_round(nibble(byte) * s[j]);
        hi[j] = bf16_round(nibble(byte >> 4) * s[j]);
      }
#pragma unroll
      for (int m = 0; m < kTileM; ++m) {
        const float2 xv = __bfloat1622float2(xs[m][p]);
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) acc[m][j] += xv.x * lo[j] + xv.y * hi[j];
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
      float sum = 0.f;
#pragma unroll
      for (int g = 0; g < kKGroups; ++g) sum += red[g][m][c];
      partial[((size_t)blockIdx.z * M + m0 + m) * N + n] = sum;
    }
  }
}

__global__ void int4_matmul_epilogue(const float* __restrict__ partial,
                                     __nv_bfloat16* __restrict__ out, int M, int N, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (i >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * total + i];
  out[i] = __float2bfloat16(s);
}

}  // namespace

extern "C" int myriad_int4_matmul_splits(int K) { return (K + kChunkK - 1) / kChunkK; }

// x (M, K) bf16, 4-byte aligned; w (K/2, N) uint8 and scale (K/group, N) fp32,
// 16-byte aligned; partial (splits, M, N) fp32 scratch; out (M, N) bf16; all
// contiguous, K and group even, N a multiple of 4.
extern "C" int myriad_int4_matmul(const void* x, const void* w, const void* scale, void* partial,
                                  void* out, int M, int K, int N, int group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = myriad_int4_matmul_splits(K);
  const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM, splits);
  int4_matmul_partial<<<grid, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                static_cast<const uint8_t*>(w),
                                                static_cast<const float*>(scale),
                                                static_cast<float*>(partial), M, K, N, group);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t total = (size_t)M * N;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  int4_matmul_epilogue<<<blocks, threads, 0, s>>>(static_cast<const float*>(partial),
                                                  static_cast<__nv_bfloat16*>(out), M, N, splits);
  return static_cast<int>(cudaGetLastError());
}
