// Int4 group-wise weight-only matrix product for small M (kernel B5), on the
// tensor cores.
//
// Replaces myriad_tpu/ops/quant.py::_int4_matmul_kernel, reached through
// int4_matmul -> _int4_matmul_padded (pallas_call).  Computes, as the TPU
// kernel does,
//   y = sum_k x[k] * bf16(bf16(q[k]) * bf16(scale[k / group]))
// x (M, K) bf16; W packed (K/2, N) uint8, input row 2i in the low nibble of
// packed row i and row 2i+1 in the high one, each a two's-complement int4;
// scale (K/group, N) fp32; y (M, N) bf16.  The scale applies BEFORE the dot
// and the dequantized weight is rounded to bf16; the sum is fp32.
//
// What bounds it on the card: a call does 2*M*K*N operations over K*N/2
// weight bytes (plus K*N/32 scale bytes at group 128), 4*M operations a
// byte, far below the H100's ~295 at M <= 32: the weight bytes bound it.
// But each byte also costs about four bit and bf16 operations to
// dequantize, so the design reads and dequantizes every weight byte once a
// call for up to 32 rows of x, keeps each warp's chain of dependent steps
// short, and keeps the split-K partials out of device memory:
//
// - The product runs swapped, y^T = W^T x^T, on mma.sync m16n8k16 (bf16
//   operands, fp32 sums): 16 output columns x 16 input rows of the
//   dequantized weight are operand A, 16 input rows x 8 rows of x operand B.
//   In A's fragment a thread holds two consecutive input rows of one column,
//   which are the two nibbles of one packed byte: one byte becomes one
//   bf16x2 register of A.  One A fragment serves every 8-row tile of x.
// - A nibble becomes bf16 by bit operations: one byte permute and one lop3
//   give 0x4300 | (v ^ 8) a half, the bf16 of 128 + (q + 8).  Subtracting
//   136 is exact, and the product with bf16(scale) is exact before its one
//   rounding (a 4-bit integer times an 8-bit mantissa), so the dequantized
//   weight equals the plain version's bit for bit; only the order of the
//   fp32 sums differs.
// - A block owns 128 output columns and has 8 warps.  Up to 16 rows a warp
//   owns 64 columns (four A tiles) and one of four k-groups, which take
//   alternate 16-row steps of a stage; from 17 to 32 rows a warp owns 32
//   columns (two A tiles: half the accumulators) and one of two k-groups.
//   A thread's columns are consecutive (A's rows g and g+8 of tile j are
//   its columns 2j and 2j+1), so it reads its bytes of a packed row with
//   one 8- or 4-byte load.  Up to 32 rows three blocks share an SM: each
//   warp's stage is a chain of dependent loads, bit operations and tensor
//   core steps, and more warps hide it (on an H100, three blocks an SM ran
//   faster than two, and four no faster than three).
// - Stages of 128 input rows (the weight tile, the group's scale row, x's
//   rows) stream through a ring of 2 to 6 slots in shared memory.  The
//   weight tile (64 packed rows x 128 bytes, 128-byte swizzle) and the scale
//   row each come by one 2-D tensor copy of the tensor memory accelerator,
//   which zero-fills past N and K; x's rows come by 16-byte cp.async copies,
//   zero-filled past K; all complete on the slot's mbarrier.  Warp 0 refills
//   a slot as soon as every warp has released it (a second mbarrier a slot),
//   so no barrier spans the block before the epilogue.  Where N % 16, K % 8
//   or x's alignment rules the tensor copies out, 4-byte cp.async copies
//   zero-fill what lies past K or N.  Nothing reads past the buffers.
// - K is split over the blocks of a thread-block cluster (at most 8), so
//   that about three blocks an SM are launched.  Each block sums its
//   k-groups in order in shared memory; after a cluster barrier every rank
//   sums its share of the tile over the ranks' shared memory in rank order
//   and writes bf16.  One launch, no scratch in device memory, and two runs
//   give the same bits.
// - Above 32 rows the warps split x's 32-row slabs (and fewer k-groups) over
//   the stage's weight tile, which is loaded once: up to 256 rows, each warp
//   keeps the accumulators of one or two slabs.

#include <cooperative_groups.h>

#include "common.cuh"
#include "tma.cuh"

namespace {

constexpr int kThreads = 256;                  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 128;                    // output columns a block
constexpr int kStageK = 128;                   // input rows a stage
constexpr int kStageP = kStageK / 2;           // packed rows a stage
constexpr int kSteps = kStageK / 16;           // k16 steps a stage
constexpr int kSlab = 32;                      // rows of x a slab
constexpr int kXRow = kStageK + 8;             // bf16 a row of x's tile (272 bytes)
constexpr int kOutRow = kTileN + 4;            // floats a row of a partial
constexpr int kWBytes = kStageP * kTileN;      // 8 KB, 128-byte swizzled rows
constexpr int kScaleBytes = kTileN * 4;
constexpr int kMaxSplits = 8;                  // the portable cluster size
constexpr int kSMs = 132;                      // an H100's streaming multiprocessors
constexpr uint32_t kMagic = 0x43084308u;       // bf16x2 (136, 136)

struct Args {
  const __nv_bfloat16* x;
  const uint8_t* w;
  const float* scale;
  __nv_bfloat16* out;
  int M, K, N, group;
  int rows;    // rows of x a stage holds: 8, 16 or 32, or 32 a slab above 32
  int splits;  // blocks of the cluster that split K
  int stages;  // stages of the whole K
  int vec;     // tensor copies and 16-byte cp.async: N % 16 == 0, K % 8 == 0, x 16-byte aligned
};

// The weight's and the scales' tensor maps (the tensor memory accelerator's
// descriptors of a 2-D tile copy).
struct alignas(64) Maps {
  CUtensorMap w;      // packed weight (K/2, N) uint8: boxes of 64 rows x 128 bytes, swizzled
  CUtensorMap scale;  // scales (K/group, N) fp32: boxes of 1 row x 128
};

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 as_bf16x2(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// The four bytes of `word` (four columns, one packed row) as four bf16x2 A
// registers, (low nibble, high nibble) each, times the columns' bf16 scales.
__device__ __forceinline__ void dequant4(uint32_t word, const uint32_t s[4], uint32_t out[4]) {
  const uint32_t w4 = word >> 4;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    // byte b's low nibble to bits 0-3 and its high nibble to bits 16-19, then
    // (that & 0x000F000F) ^ 0x43084308 in one lop3: 0x4300 | (v ^ 8) a half
    const uint32_t r = __byte_perm(word, w4, b | (b << 4) | ((b + 4) << 8) | ((b + 4) << 12));
    uint32_t h;
    asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(h) : "r"(r), "r"(0x000F000Fu), "r"(kMagic));
    out[b] = bf16x2_bits(__hmul2(__hsub2(as_bf16x2(h), as_bf16x2(kMagic)), as_bf16x2(s[b])));
  }
}

// A ring slot: the weight tile (1024-byte aligned, as the swizzle wants),
// the scale row, x's rows.
__host__ __device__ __forceinline__ int stage_bytes(int rows) {
  return (kWBytes + kScaleBytes + rows * kXRow * 2 + 1023) / 1024 * 1024;
}

// Byte offset of 16-byte chunk c of packed row p in a weight tile: the
// tensor copy's 128-byte swizzle.
__device__ __forceinline__ int wchunk(int p, int c) { return p * kTileN + 16 * (c ^ (p & 7)); }

// Issue the copies of K stage `st` into the ring slot at `base`, completing
// on `full` (one whole warp).  The weight tile and the scale row: one tensor
// copy each, zero-filled past N and K by the hardware.  x: 16-byte cp.async
// copies, zero-filled past K.  Other shapes: 4-byte cp.async copies of
// everything, zero-filled past K or N.  x's rows past M are not copied: they
// reach only output rows that are not written.  `full` counts lane 0's arrival
// (announcing the tensor copies' bytes) and each lane's arrival once its
// cp.async copies have landed.
template <bool kUniform>
__device__ void issue_stage(const Args& a, const Maps& maps, unsigned char* base, uint64_t* full,
                            int st, int n0, int lane) {
  const int k0 = st * kStageK;
  const int p0 = k0 / 2;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base + kWBytes + kScaleBytes);
  if (a.vec) {
    if (lane == 0) {
      myriad::mbar_arrive_expect_tx(full, kWBytes + (kUniform ? kScaleBytes : 0));
      myriad::tma_load_2d(base, &maps.w, n0, p0, full);
      if (kUniform) myriad::tma_load_2d(base + kWBytes, &maps.scale, n0, k0 / a.group, full);
    }
    for (int i = lane; i < a.M * (kStageK / 8); i += 32) {
      const int m = i / (kStageK / 8), c = i % (kStageK / 8);
      const int gk = k0 + 8 * c;
      const bool ok = gk < a.K;
      myriad::cp_async16(xs + m * kXRow + 8 * c, ok ? a.x + (size_t)m * a.K + gk : a.x, ok);
    }
  } else {
    if (lane == 0) myriad::mbar_arrive_expect_tx(full, 0);
    for (int i = lane; i < kStageP * (kTileN / 4); i += 32) {
      const int p = i / (kTileN / 4), c4 = i % (kTileN / 4);
      const int gn = n0 + 4 * c4;
      const bool ok = 2 * (p0 + p) < a.K && gn < a.N;
      myriad::cp_async4(base + wchunk(p, c4 / 4) + 4 * (c4 % 4),
                        ok ? a.w + (size_t)(p0 + p) * a.N + gn : a.w, ok);
    }
    if (kUniform) {
      const int gn = n0 + 4 * lane;
      const bool ok = gn < a.N;
      myriad::cp_async16(base + kWBytes + 16 * lane,
                         ok ? a.scale + (size_t)(k0 / a.group) * a.N + gn : a.scale, ok);
    }
    for (int i = lane; i < a.M * (kStageK / 2); i += 32) {
      const int m = i / (kStageK / 2), c = i % (kStageK / 2);
      const int gk = k0 + 2 * c;
      const bool ok = gk < a.K;
      myriad::cp_async4(xs + m * kXRow + 2 * c, ok ? a.x + (size_t)m * a.K + gk : a.x, ok);
    }
  }
  myriad::mbar_arrive_cp_async(full);
}

// The bf16x2 (s, s) scales of the thread's kCols columns for input row k,
// read from device memory: the path of a group that does not hold whole
// stages.
template <int kCols>
__device__ __forceinline__ void lookup_scales(const Args& a, int k, int n, uint32_t s[kCols]) {
  const int grp = min(k, a.K - 1) / a.group;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const float v = n + c < a.N ? __ldg(a.scale + (size_t)grp * a.N + n + c) : 0.f;
    s[c] = bf16x2_bits(__floats2bfloat162_rn(v, v));
  }
}

// kNT: 8-row tiles of x a slab holds (1, 2 or 4); kTiles: 16-column A tiles
// a warp owns (4 or 2); kKG: k-groups; kSPW: slabs a warp accumulates (1 or
// 2); kStages: the ring's depth; kUniform: every stage lies in one group
// (its scales come with the stage).  Up to 32 rows, three blocks share an
// SM: the kernel is bound by each warp's latency, and more warps hide it.
//
// The ring: a slot's `full` barrier completes when its copies have landed,
// and its `empty` barrier when every warp is done with it.  Warp 0 issues
// the first kStages stages, and at each later stage first refills the slot
// that every warp has just left.  No barrier spans the block before the
// epilogue.
template <int kNT, int kTiles, int kKG, int kSPW, int kStages, bool kUniform>
__global__ void __launch_bounds__(kThreads, (8 / kTiles) * kKG == kWarps ? 3 : 1)
int4_matmul_tc_kernel(const __grid_constant__ Maps maps, const Args a) {
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
  const int sbytes = stage_bytes(a.rows);
  const int col0 = cg * 16 * kTiles + kCols * g;  // the thread's first column in the tile
  // offsets of the thread's bytes in packed rows t and t + 4 of a weight tile
  const int wlo_off = wchunk(t, col0 / 16) + (col0 & 15);
  const int whi_off = wchunk(t + 4, col0 / 16) + (col0 & 15);
  unsigned char* smem = smem_raw + ((1024 - myriad::smem_addr(smem_raw) % 1024) % 1024);

  if (threadIdx.x < kStages) {
    myriad::mbar_init(&full[threadIdx.x], 33);
    myriad::mbar_init(&empty[threadIdx.x], kWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  if (warp == 0)
    for (int s = 0; s < kStages && s < nst; ++s)
      issue_stage<kUniform>(a, maps, smem + s * sbytes, &full[s], s_begin + s, n0, lane);

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
    unsigned char* base = smem + slot * sbytes;
    if (warp == 0 && it > 0 && it - 1 + kStages < nst) {  // refill the slot of stage it - 1
      const int prev = (it - 1) % kStages;
      myriad::mbar_wait(&empty[prev], ((it - 1) / kStages) & 1);
      issue_stage<kUniform>(a, maps, smem + prev * sbytes, &full[prev],
                            s_begin + it - 1 + kStages, n0, lane);
    }
    myriad::mbar_wait(&full[slot], (it / kStages) & 1);
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(base + kWBytes + kScaleBytes);
    const int k0 = (s_begin + it) * kStageK;
    uint32_t slo[kCols], shi[kCols];
    if constexpr (kUniform) {
      const float* sc = reinterpret_cast<const float*>(base + kWBytes) + col0;
#pragma unroll
      for (int c = 0; c < kCols; c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(sc + c);
        slo[c] = shi[c] = bf16x2_bits(__floats2bfloat162_rn(v.x, v.x));
        slo[c + 1] = shi[c + 1] = bf16x2_bits(__floats2bfloat162_rn(v.y, v.y));
        slo[c + 2] = shi[c + 2] = bf16x2_bits(__floats2bfloat162_rn(v.z, v.z));
        slo[c + 3] = shi[c + 3] = bf16x2_bits(__floats2bfloat162_rn(v.w, v.w));
      }
    }
#pragma unroll
    for (int i = 0; i < kSteps / kKG; ++i) {
      const int step = kg + kKG * i;
      const int p = 8 * step + t;  // the thread's packed rows p and p + 4
      uint32_t wl[kCols / 4], wh[kCols / 4];
      if constexpr (kTiles == 4) {
        const uint2 l = *reinterpret_cast<const uint2*>(base + 8 * step * kTileN + wlo_off);
        const uint2 h = *reinterpret_cast<const uint2*>(base + 8 * step * kTileN + whi_off);
        wl[0] = l.x, wl[1] = l.y, wh[0] = h.x, wh[1] = h.y;
      } else {
        wl[0] = *reinterpret_cast<const uint32_t*>(base + 8 * step * kTileN + wlo_off);
        wh[0] = *reinterpret_cast<const uint32_t*>(base + 8 * step * kTileN + whi_off);
      }
      if constexpr (!kUniform) {
        lookup_scales<kCols>(a, k0 + 2 * p, n0 + col0, slo);
        lookup_scales<kCols>(a, k0 + 2 * p + 8, n0 + col0, shi);
      }
      uint32_t lo[kCols], hi[kCols];
#pragma unroll
      for (int q = 0; q < kCols / 4; ++q) {
        dequant4(wl[q], slo + 4 * q, lo + 4 * q);
        dequant4(wh[q], shi + 4 * q, hi + 4 * q);
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
  // the splits, summed in rank order: rank r writes every splits-th share
  // of the tile's elements, reading each rank's partial through the cluster
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  if (a.splits > 1)
    cluster.sync();  // every rank's partial is complete and visible
  else
    __syncthreads();
  for (int e = rank * kThreads + threadIdx.x; e < a.M * kTileN; e += a.splits * kThreads) {
    const int r = e / kTileN, c = e % kTileN;
    float s = 0.f;
    for (int q = 0; q < a.splits; ++q)
      s += (a.splits > 1 ? cluster.map_shared_rank(part, q) : part)[r * kOutRow + c];
    if (n0 + c < a.N) a.out[(size_t)r * a.N + n0 + c] = __float2bfloat16(s);
  }
  if (a.splits > 1) cluster.sync();  // no rank leaves while another reads it
}

using Kernel = void (*)(Maps, Args);

struct Plan {
  Kernel kernel;
  int smem;    // dynamic shared memory of a block, bytes
  int tiles;   // column tiles
  Args args;
};

template <int kNT, int kTiles, int kKG, int kSPW, int kStages>
void pick(bool uniform, int rows, Plan* p) {
  p->kernel = uniform ? &int4_matmul_tc_kernel<kNT, kTiles, kKG, kSPW, kStages, true>
                      : &int4_matmul_tc_kernel<kNT, kTiles, kKG, kSPW, kStages, false>;
  const int ring = kStages * stage_bytes(rows);
  const int parts = kKG * rows * kOutRow * 4;
  p->smem = (ring > parts ? ring : parts) + 1024;  // and the slack to align the ring
}

Plan plan(const void* x, const void* w, const void* scale, void* out, int M, int K, int N,
          int group) {
  Plan p;
  const bool uniform = group % kStageK == 0 || group == K;
  const int slabs = (M + kSlab - 1) / kSlab;
  int rows;
  if (M <= kSlab) {  // three blocks an SM, each under 76 KB of shared memory
    rows = M <= 8 ? 8 : M <= 16 ? 16 : 32;
    if (rows == 8)
      pick<1, 4, 4, 1, 6>(uniform, rows, &p);
    else if (rows == 16)
      pick<2, 4, 4, 1, 5>(uniform, rows, &p);
    else  // 32 columns a warp: half the accumulators
      pick<4, 2, 2, 1, 4>(uniform, rows, &p);
  } else {
    rows = slabs * kSlab;
    if (slabs == 2)
      pick<4, 4, 2, 1, 4>(uniform, rows, &p);
    else if (slabs <= 4)
      pick<4, 4, 1, 1, 3>(uniform, rows, &p);
    else
      pick<4, 4, 1, 2, 2>(uniform, rows, &p);
  }
  p.tiles = (N + kTileN - 1) / kTileN;
  const int stages = (K + kStageK - 1) / kStageK;
  int splits = 3 * kSMs / p.tiles;
  splits = splits < 1 ? 1 : splits > kMaxSplits ? kMaxSplits : splits;
  splits = splits > stages ? stages : splits;
  const bool vec = N % 16 == 0 && K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.args = Args{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
                static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
                M, K, N, group, rows, splits, stages, vec ? 1 : 0};
  return p;
}

// The weight's and the scales' tensor maps (cached in `myriad::tensor_map_2d`).
cudaError_t tensor_maps(const void* w, const void* scale, int K, int N, int group, Maps* out) {
  cudaError_t e = myriad::tensor_map_2d(&out->w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, K / 2, N, N,
                                        kStageP, kTileN, CU_TENSOR_MAP_SWIZZLE_128B,
                                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (e != cudaSuccess) return e;
  return myriad::tensor_map_2d(&out->scale, scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, K / group, N,
                               static_cast<uint64_t>(N) * 4, 1, kTileN,
                               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE);
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

// x (M, K) bf16, 4-byte aligned; w (K/2, N) uint8 and scale (K/group, N)
// fp32, 16-byte aligned; out (M, N) bf16; all contiguous, 1 <= M <= 256, K
// and group even, group dividing K, N a multiple of 4.  One launch.
extern "C" int myriad_int4_matmul(const void* x, const void* w, const void* scale, void* out,
                                  int M, int K, int N, int group, void* stream) {
  if (M < 1 || M > 8 * kSlab) return static_cast<int>(cudaErrorInvalidValue);
  Plan p = plan(x, w, scale, out, M, K, N, group);
  Maps maps{};
  cudaError_t e = p.args.vec ? tensor_maps(w, scale, K, N, group, &maps) : cudaSuccess;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (e == cudaSuccess) e = configure(p, static_cast<cudaStream_t>(stream), &cfg, &attr);
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, p.kernel, maps, p.args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// B5's launch at these widths: out[0] the splits of K (the cluster's
// blocks), out[1] the column tiles, out[2] a block's dynamic shared memory,
// bytes, out[3] how many such clusters the card holds at once
// (cudaOccupancyMaxActiveClusters; 0 with one split: no cluster).  Returns
// a CUDA error.
extern "C" int myriad_int4_matmul_launch_info(int M, int K, int N, int group, int* out) {
  if (M < 1 || M > 8 * kSlab) return static_cast<int>(cudaErrorInvalidValue);
  Plan p = plan(nullptr, nullptr, nullptr, nullptr, M, K, N, group);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(p, nullptr, &cfg, &attr);
  out[0] = p.args.splits;
  out[1] = p.tiles;
  out[2] = p.smem;
  out[3] = 0;
  if (e == cudaSuccess && p.args.splits > 1)
    e = cudaOccupancyMaxActiveClusters(&out[3], p.kernel, &cfg);
  return static_cast<int>(e);
}
