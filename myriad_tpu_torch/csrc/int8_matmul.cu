// Int8 weight-only matrix product for small M (kernel B1), on the tensor
// cores.
//
// Replaces myriad_tpu/ops/quant.py::_int8_matmul_kernel, reached through
// int8_matmul -> _int8_pallas_matmul -> _int8_matmul_padded (pallas_call).
// Computes, as the TPU kernel does,
//   y = bf16((x @ bf16(W)) * scale[col])
// x (M, K) bf16; W (K, N) int8 stored (in, out); scale (N,) fp32; y (M, N)
// bf16.  The sum is fp32 and the per-column scale applies AFTER it.
//
// What bounds it on the card: a call does 2*M*K*N operations over K*N
// weight bytes, 2*M operations a byte, far below the H100's ~295 at M <= 32:
// the weight bytes bound it.  Each byte also costs about three integer and
// one float operation to become bf16, so the design reads and converts every
// weight byte once a call for up to 32 rows of x, keeps each warp's chain of
// dependent steps short, and keeps the split-K partials out of device memory:
//
// - The product runs swapped, y^T = W^T x^T, on mma.sync m16n8k16 (bf16
//   operands, fp32 sums): 16 output columns x 16 input rows of the converted
//   weight are operand A, 16 input rows x 8 rows of x operand B.  One A
//   fragment serves every 8-row tile of x.  In A's fragment a thread holds
//   input rows (2t, 2t+1) and (2t+8, 2t+9) of a column; those sit N bytes
//   apart, so a thread reads its consecutive columns of each of the four
//   rows with one 4- or 8-byte load and pairs the rows' bytes.
// - A byte becomes bf16 exactly without the conversion unit: one byte
//   permute puts (byte ^ 0x80) in the mantissa of the float 2^23, one
//   subtract of 2^23 + 128 leaves the int8 value, and one more permute packs
//   the high halves of two such floats (integers of at most 8 significant
//   bits: the low halves are zero) into a bf16x2 register of A.
// - A block owns 128 output columns and has 8 warps.  Up to 16 rows a warp
//   owns 64 columns (four A tiles) and one of four k-groups, which take
//   alternate 16-row steps of a stage; from 17 to 32 rows a warp owns 32
//   columns (two A tiles: half the accumulators) and one of two k-groups.
//   Up to 32 rows three blocks share an SM, to hide each warp's chain of
//   loads, conversions and tensor core steps (kernel B5's finding).
// - Stages of 128 input rows stream through a ring of 2 to 4 slots: the
//   weight tile (128 rows x 128 bytes, 128-byte swizzle) by one 2-D tensor
//   copy of the tensor memory accelerator, which zero-fills past N and K;
//   x's rows by 16-byte cp.async copies, zero-filled past K; both complete
//   on the slot's mbarrier.  The weight tiles of the ring lie together
//   (1024-byte aligned, as the swizzle wants), x's tiles after them.  Warp 0
//   refills a slot as soon as every warp has released it (a second mbarrier
//   a slot), so no barrier spans the block before the epilogue.  Where
//   N % 16, K % 8 or x's alignment rules the tensor copy out, 4-byte
//   cp.async copies of the weight and element copies of x zero-fill what
//   lies past K or N.  Nothing reads past the buffers.
// - K is split over the blocks of a thread-block cluster (at most 8), so
//   that about three blocks an SM are launched.  Each block sums its
//   k-groups in order in shared memory; after a cluster barrier every rank
//   sums its share of the tile over the ranks' shared memory in rank order,
//   multiplies by the column's scale and rounds to bf16 once.  One launch,
//   no scratch in device memory, and two runs give the same bits.
// - Above 32 rows the warps split x's 32-row slabs (and fewer k-groups) over
//   the stage's weight tile, which is loaded once: up to 256 rows, each warp
//   keeps the accumulators of one or two slabs.

#include <cooperative_groups.h>

#include "common.cuh"
#include "tma.cuh"

namespace {

constexpr int kThreads = 256;               // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 128;                 // output columns a block: a weight row's bytes
constexpr int kStageK = 128;                // input rows a stage
constexpr int kSteps = kStageK / 16;        // k16 steps a stage
constexpr int kSlab = 32;                   // rows of x a slab
constexpr int kXRow = kStageK + 8;          // bf16 a row of x's tile (272 bytes)
constexpr int kOutRow = kTileN + 4;         // floats a row of a partial
constexpr int kWBytes = kStageK * kTileN;   // 16 KB, 128-byte swizzled rows
constexpr int kMaxSplits = 8;               // the portable cluster size
constexpr int kSMs = 132;                   // an H100's streaming multiprocessors

struct Args {
  const __nv_bfloat16* x;
  const int8_t* w;
  const float* scale;
  __nv_bfloat16* out;
  int M, K, N;
  int rows;    // rows of x a stage holds: 8, 16 or 32, or 32 a slab above 32
  int splits;  // blocks of the cluster that split K
  int stages;  // stages of the whole K
  int vec;     // the tensor copy and 16-byte cp.async: N % 16 == 0, K % 8 == 0, x 16-byte aligned
};

// Rows r0 and r1 of four consecutive weight columns (a 32-bit word each) as
// four bf16x2 A registers, (row r0, row r1) of one column each, exactly.
__device__ __forceinline__ void int8_pairs(uint32_t r0, uint32_t r1, uint32_t out[4]) {
  float lo[4], hi[4];
  myriad::int8x4_to_float(r0, lo);
  myriad::int8x4_to_float(r1, hi);
#pragma unroll
  for (int b = 0; b < 4; ++b) out[b] = myriad::exact_bf16x2(lo[b], hi[b]);
}

// Byte offset of 16-byte chunk c of row r in a weight tile: the tensor
// copy's 128-byte swizzle.
__device__ __forceinline__ int wchunk(int r, int c) { return r * kTileN + 16 * (c ^ (r & 7)); }

// Issue the copies of K stage `st` into one ring slot (`wdst` its weight
// tile, `xs` its x tile), completing on `full` (one whole warp).  The weight
// tile: one tensor copy, zero-filled past N and K by the hardware.  x:
// 16-byte cp.async copies, zero-filled past K.  Other shapes: 4-byte
// cp.async copies of the weight, zero-filled past K or N, and element copies
// of x, which lane 0's arrival releases after the warp's barrier.  x's rows
// past M are not copied: they reach only output rows that are not written.
// `full` counts lane 0's arrival (announcing the tensor copy's bytes) and
// each lane's arrival once its cp.async copies have landed.
__device__ void issue_stage(const Args& a, const CUtensorMap& map, unsigned char* wdst,
                            __nv_bfloat16* xs, uint64_t* full, int st, int n0, int lane) {
  const int k0 = st * kStageK;
  if (a.vec) {
    if (lane == 0) {
      myriad::mbar_arrive_expect_tx(full, kWBytes);
      myriad::tma_load_2d(wdst, &map, n0, k0, full);
    }
    for (int i = lane; i < a.M * (kStageK / 8); i += 32) {
      const int m = i / (kStageK / 8), c = i % (kStageK / 8);
      const int gk = k0 + 8 * c;
      const bool ok = gk < a.K;
      myriad::cp_async16(xs + m * kXRow + 8 * c, ok ? a.x + (size_t)m * a.K + gk : a.x, ok);
    }
  } else {
    for (int i = lane; i < kStageK * (kTileN / 4); i += 32) {
      const int r = i / (kTileN / 4), c4 = i % (kTileN / 4);
      const int gk = k0 + r, gn = n0 + 4 * c4;
      const bool ok = gk < a.K && gn < a.N;
      myriad::cp_async4(wdst + wchunk(r, c4 / 4) + 4 * (c4 % 4),
                        ok ? a.w + (size_t)gk * a.N + gn : a.w, ok);
    }
    for (int i = lane; i < a.M * kStageK; i += 32) {
      const int m = i / kStageK, c = i % kStageK;
      const int gk = k0 + c;
      xs[m * kXRow + c] = gk < a.K ? a.x[(size_t)m * a.K + gk] : __float2bfloat16(0.f);
    }
    __syncwarp();
    if (lane == 0) myriad::mbar_arrive_expect_tx(full, 0);
  }
  myriad::mbar_arrive_cp_async(full);
}

// kNT: 8-row tiles of x a slab holds (1, 2 or 4); kTiles: 16-column A tiles
// a warp owns (4 or 2); kKG: k-groups; kSPW: slabs a warp accumulates (1 or
// 2); kStages: the ring's depth.  Up to 32 rows, three blocks share an SM.
//
// The ring: a slot's `full` barrier completes when its copies have landed,
// and its `empty` barrier when every warp is done with it.  Warp 0 issues
// the first kStages stages, and at each later stage first refills the slot
// that every warp has just left.
template <int kNT, int kTiles, int kKG, int kSPW, int kStages>
__global__ void __launch_bounds__(kThreads, (8 / kTiles) * kKG == kWarps ? 3 : 1)
int8_matmul_tc_kernel(const __grid_constant__ CUtensorMap map, const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  constexpr int kCG = 8 / kTiles;               // column groups of the tile
  constexpr int kSG = kWarps / (kCG * kKG);     // slab groups
  constexpr int kCols = 2 * kTiles;             // a thread's columns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int cg = warp % kCG;                // which columns of the tile
  const int kg = (warp / kCG) % kKG;        // which k16 steps of a stage
  const int sg = warp / (kCG * kKG);        // which slabs of x
  const int rank = blockIdx.x;              // the split of K, the cluster's rank
  const int n0 = blockIdx.y * kTileN;
  const int s_begin = rank * a.stages / a.splits;
  const int nst = (rank + 1) * a.stages / a.splits - s_begin;
  const int col0 = cg * 16 * kTiles + kCols * g;  // the thread's first column in the tile
  // offsets of the thread's bytes in rows 2t and 2t + 1 of a step's 16 rows;
  // rows 2t + 8 and 2t + 9 lie 8 rows on, with the same swizzle
  const int w0_off = wchunk(2 * t, col0 / 16) + (col0 & 15);
  const int w1_off = wchunk(2 * t + 1, col0 / 16) + (col0 & 15);
  unsigned char* smem = smem_raw + ((1024 - myriad::smem_addr(smem_raw) % 1024) % 1024);
  __nv_bfloat16* xring = reinterpret_cast<__nv_bfloat16*>(smem + kStages * kWBytes);
  const int xslot = a.rows * kXRow;  // bf16 of a slot's x tile

  if (threadIdx.x < kStages) {
    myriad::mbar_init(&full[threadIdx.x], 33);
    myriad::mbar_init(&empty[threadIdx.x], kWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  if (warp == 0)
    for (int s = 0; s < kStages && s < nst; ++s)
      issue_stage(a, map, smem + s * kWBytes, xring + s * xslot, &full[s], s_begin + s, n0,
                  lane);

  float acc[kSPW][kTiles][kNT][4];
#pragma unroll
  for (int si = 0; si < kSPW; ++si)
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[si][j][nt][e] = 0.f;

  for (int it = 0; it < nst; ++it) {
    const int slot = it % kStages;
    if (warp == 0 && it > 0 && it - 1 + kStages < nst) {  // refill the slot of stage it - 1
      const int prev = (it - 1) % kStages;
      myriad::mbar_wait(&empty[prev], ((it - 1) / kStages) & 1);
      issue_stage(a, map, smem + prev * kWBytes, xring + prev * xslot, &full[prev],
                  s_begin + it - 1 + kStages, n0, lane);
    }
    myriad::mbar_wait(&full[slot], (it / kStages) & 1);
    const unsigned char* wt = smem + slot * kWBytes;
    const __nv_bfloat16* xs = xring + slot * xslot;
#pragma unroll
    for (int i = 0; i < kSteps / kKG; ++i) {
      const int step = kg + kKG * i;
      const unsigned char* ws = wt + 16 * step * kTileN;
      uint32_t r0[kCols / 4], r1[kCols / 4], r8[kCols / 4], r9[kCols / 4];
      if constexpr (kTiles == 4) {
        const uint2 v0 = *reinterpret_cast<const uint2*>(ws + w0_off);
        const uint2 v1 = *reinterpret_cast<const uint2*>(ws + w1_off);
        const uint2 v8 = *reinterpret_cast<const uint2*>(ws + 8 * kTileN + w0_off);
        const uint2 v9 = *reinterpret_cast<const uint2*>(ws + 8 * kTileN + w1_off);
        r0[0] = v0.x, r0[1] = v0.y, r1[0] = v1.x, r1[1] = v1.y;
        r8[0] = v8.x, r8[1] = v8.y, r9[0] = v9.x, r9[1] = v9.y;
      } else {
        r0[0] = *reinterpret_cast<const uint32_t*>(ws + w0_off);
        r1[0] = *reinterpret_cast<const uint32_t*>(ws + w1_off);
        r8[0] = *reinterpret_cast<const uint32_t*>(ws + 8 * kTileN + w0_off);
        r9[0] = *reinterpret_cast<const uint32_t*>(ws + 8 * kTileN + w1_off);
      }
      uint32_t lo[kCols], hi[kCols];
#pragma unroll
      for (int q = 0; q < kCols / 4; ++q) {
        int8_pairs(r0[q], r1[q], lo + 4 * q);
        int8_pairs(r8[q], r9[q], hi + 4 * q);
      }
#pragma unroll
      for (int si = 0; si < kSPW; ++si) {
        const int slab = sg + kSG * si;
        if (slab * kSlab >= a.rows) continue;
        const __nv_bfloat16* xr = xs + slab * kSlab * kXRow + 16 * step;
#pragma unroll
        for (int nt = 0; nt < kNT; nt += 2) {
          uint32_t b[4];
          if constexpr (kNT == 1)
            myriad::ldmatrix_x2(b, xr + (lane & 7) * kXRow + 8 * ((lane >> 3) & 1));
          else
            myriad::ldmatrix_x4(
                b, xr + (8 * nt + (lane & 7) + 8 * (lane >> 4)) * kXRow + 8 * ((lane >> 3) & 1));
#pragma unroll
          for (int j = 0; j < kTiles; ++j) {
            const uint32_t af[4] = {lo[2 * j], lo[2 * j + 1], hi[2 * j], hi[2 * j + 1]};
            myriad::mma_bf16(acc[si][j][nt], af, b[0], b[1]);
            if constexpr (kNT > 1) myriad::mma_bf16(acc[si][j][nt + 1], af, b[2], b[3]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) myriad::mbar_arrive(&empty[slot]);
  }
  __syncthreads();  // every stage has landed and been read: the ring's memory holds the partials

  // k-group kg's partial: rows x 128 fp32, row stride kOutRow.  A thread's
  // C fragment of (tile j, 8-row tile nt) is columns col0 + 2j (+1) by rows
  // 8 nt + 2t (+1) of its slab.
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int si = 0; si < kSPW; ++si) {
    const int slab = sg + kSG * si;
    if (slab * kSlab >= a.rows) continue;
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        float* d = part + (kg * a.rows + slab * kSlab + 8 * nt + 2 * t) * kOutRow + col0 + 2 * j;
        *reinterpret_cast<float2*>(d) = make_float2(acc[si][j][nt][0], acc[si][j][nt][2]);
        *reinterpret_cast<float2*>(d + kOutRow) =
            make_float2(acc[si][j][nt][1], acc[si][j][nt][3]);
      }
  }
  __syncthreads();
  if (kKG > 1) {  // the k-groups, summed in order into k-group 0's partial
    for (int e = threadIdx.x; e < a.M * kTileN; e += kThreads) {
      const int r = e / kTileN, c = e % kTileN;
      float s = part[r * kOutRow + c];
#pragma unroll
      for (int q = 1; q < kKG; ++q) s += part[(q * a.rows + r) * kOutRow + c];
      part[r * kOutRow + c] = s;
    }
  }
  // the splits, summed in rank order, then the column's scale and one
  // rounding: rank r writes every splits-th share of the tile's elements,
  // reading each rank's partial through the cluster
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  if (a.splits > 1)
    cluster.sync();  // every rank's partial is complete and visible
  else
    __syncthreads();
  for (int e = rank * kThreads + threadIdx.x; e < a.M * kTileN; e += a.splits * kThreads) {
    const int r = e / kTileN, c = e % kTileN;
    if (n0 + c >= a.N) continue;
    float s = 0.f;
    for (int q = 0; q < a.splits; ++q)
      s += (a.splits > 1 ? cluster.map_shared_rank(part, q) : part)[r * kOutRow + c];
    a.out[(size_t)r * a.N + n0 + c] = __float2bfloat16(s * __ldg(a.scale + n0 + c));
  }
  if (a.splits > 1) cluster.sync();  // no rank leaves while another reads it
}

using Kernel = void (*)(CUtensorMap, Args);

struct Plan {
  Kernel kernel;
  int smem;    // dynamic shared memory of a block, bytes
  int tiles;   // column tiles
  Args args;
};

template <int kNT, int kTiles, int kKG, int kSPW, int kStages>
void pick(int rows, Plan* p) {
  p->kernel = &int8_matmul_tc_kernel<kNT, kTiles, kKG, kSPW, kStages>;
  const int ring = kStages * (kWBytes + rows * kXRow * 2);
  const int parts = kKG * rows * kOutRow * 4;
  p->smem = (ring > parts ? ring : parts) + 1024;  // and the slack to align the ring
}

Plan plan(const void* x, const void* w, const void* scale, void* out, int M, int K, int N) {
  Plan p;
  const int slabs = (M + kSlab - 1) / kSlab;
  int rows;
  if (M <= kSlab) {  // three blocks an SM, each under 76 KB of shared memory
    rows = M <= 8 ? 8 : M <= 16 ? 16 : 32;
    if (rows == 8)
      pick<1, 4, 4, 1, 4>(rows, &p);
    else if (rows == 16)
      pick<2, 4, 4, 1, 3>(rows, &p);
    else  // 32 columns a warp: half the accumulators
      pick<4, 2, 2, 1, 3>(rows, &p);
  } else {
    rows = slabs * kSlab;
    if (slabs == 2)
      pick<4, 4, 2, 1, 4>(rows, &p);
    else if (slabs <= 4)
      pick<4, 4, 1, 1, 3>(rows, &p);
    else
      pick<4, 4, 1, 2, 2>(rows, &p);
  }
  p.tiles = (N + kTileN - 1) / kTileN;
  const int stages = (K + kStageK - 1) / kStageK;
  int splits = 3 * kSMs / p.tiles;
  splits = splits < 1 ? 1 : splits > kMaxSplits ? kMaxSplits : splits;
  splits = splits > stages ? stages : splits;
  const bool vec = N % 16 == 0 && K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.args = Args{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
                static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
                M, K, N, rows, splits, stages, vec ? 1 : 0};
  return p;
}

cudaError_t configure(Plan& p, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  if (p.smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(p.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return e;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.args.splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(p.args.splits, p.tiles, 1);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = p.smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = p.args.splits > 1 ? 1 : 0;
  return cudaSuccess;
}

}  // namespace

// x (M, K) bf16, 2-byte aligned; w (K, N) int8, 16-byte aligned; scale (N,)
// fp32; out (M, N) bf16; all contiguous, 1 <= M <= 256, K >= 1, N a
// multiple of 4.  One launch.
extern "C" int myriad_int8_matmul(const void* x, const void* w, const void* scale, void* out,
                                  int M, int K, int N, void* stream) {
  if (M < 1 || M > 8 * kSlab || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  Plan p = plan(x, w, scale, out, M, K, N);
  CUtensorMap map{};
  // the weight in boxes of 128 rows x 128 bytes, 128-byte swizzle
  cudaError_t e = p.args.vec ? myriad::tensor_map_2d(&map, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, N,
                                                     N, kStageK, kTileN,
                                                     CU_TENSOR_MAP_SWIZZLE_128B,
                                                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B)
                             : cudaSuccess;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (e == cudaSuccess) e = configure(p, static_cast<cudaStream_t>(stream), &cfg, &attr);
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, p.kernel, map, p.args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// B1's launch at these widths: out[0] the splits of K (the cluster's
// blocks), out[1] the column tiles, out[2] a block's dynamic shared memory,
// bytes, out[3] how many such clusters the card holds at once
// (cudaOccupancyMaxActiveClusters; 0 with one split: no cluster), out[4]
// how many of its blocks an SM holds at once.  Returns a CUDA error.
extern "C" int myriad_int8_matmul_launch_info(int M, int K, int N, int* out) {
  if (M < 1 || M > 8 * kSlab || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  Plan p = plan(nullptr, nullptr, nullptr, nullptr, M, K, N);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(p, nullptr, &cfg, &attr);
  out[0] = p.args.splits;
  out[1] = p.tiles;
  out[2] = p.smem;
  out[3] = 0;
  out[4] = 0;
  if (e == cudaSuccess && p.args.splits > 1)
    e = cudaOccupancyMaxActiveClusters(&out[3], p.kernel, &cfg);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], p.kernel, kThreads, p.smem);
  return static_cast<int>(e);
}

extern "C" const char* myriad_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
