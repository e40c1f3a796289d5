// Key-split attention for a few query rows: the body that kernel B2' (row
// decode, decode_attention.cu) and kernel B3 below 16 query rows (the
// speculative verify chunk, prefill_attention.cu) share.
//
// One block takes one (split, head, batch row): the keys [split *
// keys_per_split, ...) of that (b, h), for R <= kMaxR query rows at once.
// It walks its keys in tiles of kKeyTile.  Each tile of K and V is copied
// into a two-stage ring in shared memory with 16-byte cp.async loads (the
// next tile is in flight while this one is used), so every key row is read
// from device memory once, coalesced, whatever R is.  Per tile:
//   scores   thread (key j, half) dots key j with rows r = half, half + 2, ...
//            (q in shared memory as fp32, broadcast to the warp);
//   softmax  warp w keeps the running max m and sum l of rows w, w + 4, ...
//            and rescales by exp(m_old - m_new);
//   p.V      warp w takes 16 keys of the tile, each lane 4 output dims, for
//            every row; the rows' accumulators stay in registers.
// At the end the four warps' rows are summed in a fixed order.  With one
// split the block writes bf16(o / l).  With more, the splits combine in split
// order (myriad::merge_splits), so a result does not depend on scheduling:
// either each block writes its partial (m, l, o) to a scratch tensor and a
// second launch merges them (B2', B3), or the splits of one (b, h) form a
// thread-block cluster, each block writes its partial into the shared memory
// of the cluster's rank 0 (distributed shared memory), and rank 0 merges
// them after a cluster barrier (kClusterMerge, B2; merge_cluster_splits).
//
// kCausal selects the function:
//   false (B2'): s = (q . k) * k_scale * scale + mask[b, t];  p * v_scale in
//                fp32; out = (sum p v_scale V) / l.
//   true  (B3):  s = (q . k) * k_scale * scale where t <= positions[b, r],
//                else -inf; bf16(p * v_scale) . V with fp32 sums; a row that
//                sees no key writes zeros.

#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace myriad {

constexpr int kSplitThreads = 128;  // 4 warps
constexpr int kKeyTile = 64;        // keys a tile
constexpr int kHeadDim = 128;       // the widest head the kernels take
constexpr int kSMs = 132;  // an H100's streaming multiprocessors
constexpr int kMaxClusterSplits = 8;  // the portable cluster size

// Shared-memory row of a K or V tile: the row's bytes plus 16, so that
// consecutive rows start in different bank groups.
template <typename KV>
__host__ __device__ constexpr int tile_row_bytes() {
  return kHeadDim * static_cast<int>(sizeof(KV)) + 16;
}

struct SplitPlan {
  int splits, keys_per_split;
};

// How many blocks share the n_keys of one (b, h) when bh such pairs run:
// enough to reach `target` blocks, at least one tile each, in whole tiles,
// and at most `max_splits`.
inline SplitPlan split_plan(int bh, int n_keys, int target, int max_splits = 1 << 30) {
  const int tiles = std::max(1, (n_keys + kKeyTile - 1) / kKeyTile);
  const int want = std::max(1, std::min({tiles, (target + bh - 1) / bh, max_splits}));
  const int per = (tiles + want - 1) / want;
  return {(tiles + per - 1) / per, per * kKeyTile};
}

struct SplitArgs {
  const __nv_bfloat16* q;  // (B, H, R, D)
  const void* k;           // (B, H, T, D) int8 or bf16, element strides below
  const void* v;
  const __half* k_scale;  // (B, H, T, 1) or null
  const __half* v_scale;
  const float* mask;     // (B, n_keys) additive (kCausal false), or null: none
  const int* positions;  // (B, R) absolute (kCausal true)
  __nv_bfloat16* out;    // (B, H, R, D)
  float* part;           // scratch of (m, l, o) partials, null with one split or a cluster
  int B, H, R, D, n_keys, splits, keys_per_split;
  long long kv_sb, kv_sh, kv_st, sc_sb, sc_sh, sc_st;
  float scale;
};

template <typename KV>
__device__ __forceinline__ KV zero_of();
template <>
__device__ __forceinline__ int8_t zero_of<int8_t>() { return 0; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Copies keys [t0, t0 + kKeyTile) of one (b, h)'s K or V (rows `st` elements
// apart) into a tile of tile_row_bytes<KV>() rows; keys at or past `end` are
// zero-filled.  kVec: 16-byte cp.async (rows and D * sizeof(KV) 16-byte
// aligned); else element by element.  Columns at or past D are not written.
template <typename KV, bool kVec>
__device__ __forceinline__ void stage_tile(char* dst, const KV* src, long long st, int t0,
                                           int end, int D) {
  constexpr int kRow = tile_row_bytes<KV>();
  if constexpr (kVec) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(KV));
    const int chunks = D / kPer;
    for (int i = threadIdx.x; i < kKeyTile * chunks; i += blockDim.x) {
      const int r = i / chunks, c = i - r * chunks, t = t0 + r;
      cp_async16(dst + r * kRow + c * 16, t < end ? src + t * st + c * kPer : src, t < end);
    }
  } else {
    for (int i = threadIdx.x; i < kKeyTile * D; i += blockDim.x) {
      const int r = i / D, d = i - r * D, t = t0 + r;
      reinterpret_cast<KV*>(dst + r * kRow)[d] = t < end ? src[t * st + d] : zero_of<KV>();
    }
  }
}

// Zeroes `bytes` (a multiple of 16) of shared memory; all threads take part.
__device__ __forceinline__ void zero_shared(char* p, int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(0, 0, 0, 0);
}

// 16 bytes of a shared-memory tile row as floats: 16 int8 or 8 bf16.
__device__ __forceinline__ void load16(const char* p, const int8_t*, float out[16]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  int8x4_to_float(raw.x, out);
  int8x4_to_float(raw.y, out + 4);
  int8x4_to_float(raw.z, out + 8);
  int8x4_to_float(raw.w, out + 12);
}

__device__ __forceinline__ void load16(const char* p, const __nv_bfloat16*, float out[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    out[2 * e] = __low2float(h[e]);
    out[2 * e + 1] = __high2float(h[e]);
  }
}

// Four consecutive elements of a shared-memory tile row as floats.
__device__ __forceinline__ void load4_tile(const int8_t* p, float out[4]) {
  int8x4_to_float(*reinterpret_cast<const uint32_t*>(p), out);
}

__device__ __forceinline__ void load4_tile(const __nv_bfloat16* p, float out[4]) { load4(p, out); }

template <typename KV, int kMaxR>
__host__ __device__ constexpr int split_smem_bytes() {
  return (4 * kKeyTile * tile_row_bytes<KV>()  // two stages of K and V
          + 4 * (kMaxR * kHeadDim              // q rows, fp32
                 + kMaxR * kKeyTile            // scores, then probabilities
                 + 6 * kKeyTile                // k_scale, v_scale, mask of two tiles
                 + 3 * kMaxR                   // per row: correction, m, l
                 + kMaxR)                      // positions
          + 15) / 16 * 16;
}

// A cluster merge's inbox, in the shared memory of rank 0 past what
// split_attention uses: one slot a split of its partial rows, o (kMaxR,
// kHeadDim), then m (kMaxR) and l (kMaxR), padded to 16 bytes.
template <int kMaxR>
__host__ __device__ constexpr int inbox_slot_floats() {
  return kMaxR * kHeadDim + (2 * kMaxR + 3) / 4 * 4;
}

template <int kMaxR>
__host__ __device__ constexpr int inbox_bytes() {
  return 4 * kMaxClusterSplits * inbox_slot_floats<kMaxR>();
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename KV, int kMaxR, bool kCausal, bool kVec, bool kClusterMerge = false>
__device__ __forceinline__ void split_attention(const SplitArgs& a) {
  constexpr int kRow = tile_row_bytes<KV>();
  constexpr int kStage = 2 * kKeyTile * kRow;  // K tile, then V tile
  constexpr int kPer = 16 / static_cast<int>(sizeof(KV));
  constexpr int kRowsPerWarp = (kMaxR + 3) / 4;
  constexpr int kRowsPerHalf = (kMaxR + 1) / 2;
  static_assert(kSplitThreads == 2 * kKeyTile, "scores: two threads a key");
  static_assert(4 * kMaxR * kHeadDim * 4 <= 2 * kStage, "the warps' rows fit the ring");
  extern __shared__ __align__(16) char smem[];
  float* qs = reinterpret_cast<float*>(smem + 2 * kStage);
  float* sc = qs + kMaxR * kHeadDim;
  float* ksc = sc + kMaxR * kKeyTile;  // [2][kKeyTile], by stage
  float* vsc = ksc + 2 * kKeyTile;
  float* msk = vsc + 2 * kKeyTile;
  float* corr_s = msk + 2 * kKeyTile;
  float* m_s = corr_s + kMaxR;
  float* l_s = m_s + kMaxR;
  int* pos = reinterpret_cast<int*>(l_s + kMaxR);

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = a.R, D = a.D;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const KV* kp = static_cast<const KV*>(a.k) + b * a.kv_sb + h * a.kv_sh;
  const KV* vp = static_cast<const KV*>(a.v) + b * a.kv_sb + h * a.kv_sh;
  const __half* ksp = a.k_scale ? a.k_scale + b * a.sc_sb + h * a.sc_sh : nullptr;
  const __half* vsp = a.v_scale ? a.v_scale + b * a.sc_sb + h * a.sc_sh : nullptr;
  const float* mp =
      kCausal || !a.mask ? nullptr : a.mask + static_cast<long long>(b) * a.n_keys;

  // a cluster merge writes into rank 0's shared memory, which exists once
  // every block of the cluster has started: arrive now, wait before writing
  const bool keep = kClusterMerge && a.splits > 1;
  if (keep) cluster_arrive_relaxed();

  const int begin = split * a.keys_per_split;
  const int stop = min(a.n_keys, begin + a.keys_per_split);  // this split's keys
  float nks = 1.f, nvs = 1.f, nmk = 0.f;  // a tile's scales and mask in flight, thread j < 64
  auto load_scales = [&](int t0) {
    const int t = t0 + tid;
    nks = ksp && t < stop ? __half2float(ksp[t * a.sc_st]) : 1.f;
    nvs = vsp && t < stop ? __half2float(vsp[t * a.sc_st]) : 1.f;
    if constexpr (!kCausal) nmk = mp && t < stop ? mp[t] : 0.f;
  };
  auto store_scales = [&](int stage) {
    ksc[stage * kKeyTile + tid] = nks;
    vsc[stage * kKeyTile + tid] = nvs;
    msk[stage * kKeyTile + tid] = nmk;
  };

  // columns at or past D are never staged: they must read as zeros
  if (D < kHeadDim) {
    zero_shared(smem, 2 * kStage);
    __syncthreads();
  }
  // the first tile, its scales, q and the positions load together
  if (begin < stop) {
    stage_tile<KV, kVec>(smem, kp, a.kv_st, begin, stop, D);
    stage_tile<KV, kVec>(smem + kKeyTile * kRow, vp, a.kv_st, begin, stop, D);
    cp_async_commit();
    if (tid < kKeyTile) load_scales(begin);
  }
  static_assert(kSplitThreads == kHeadDim, "thread d loads dim d of every q row");
  float qv[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r)
    qv[r] = r < R && tid < D ? __bfloat162float(a.q[(bh * R + r) * D + tid]) : 0.f;
  const int pv = kCausal && tid < R ? a.positions[static_cast<long long>(b) * R + tid] : -1;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) qs[r * kHeadDim + tid] = qv[r];
  if (tid < kMaxR) pos[tid] = pv;
  if (begin < stop && tid < kKeyTile) store_scales(0);
  __syncthreads();

  int end = stop;  // keys this block reads: the causal rows see no key past the last position
  if constexpr (kCausal) {
    int last = -1;
    for (int r = 0; r < R; ++r) last = max(last, pos[r]);
    end = min(end, last + 1);
  }
  const int n_tiles = end > begin ? (end - begin + kKeyTile - 1) / kKeyTile : 0;

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  float o[kMaxR][4];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[r][e] = 0.f;
  const int d0 = lane * 4;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = begin + it * kKeyTile, cur = it & 1;
    const char* kt = smem + cur * kStage;
    const char* vt = kt + kKeyTile * kRow;
    // this tile's scales, loaded while the previous tile was used (a load
    // that had to land by the end of that tile would stall every tile)
    if (it > 0 && tid < kKeyTile) store_scales(cur);
    if (it + 1 < n_tiles) {
      char* nxt = smem + (cur ^ 1) * kStage;
      stage_tile<KV, kVec>(nxt, kp, a.kv_st, t0 + kKeyTile, stop, D);
      stage_tile<KV, kVec>(nxt + kKeyTile * kRow, vp, a.kv_st, t0 + kKeyTile, stop, D);
      cp_async_commit();
      if (tid < kKeyTile) load_scales(t0 + kKeyTile);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` is in shared memory for every thread
    const float* ks_t = ksc + cur * kKeyTile;
    const float* vs_t = vsc + cur * kKeyTile;
    const float* mk_t = msk + cur * kKeyTile;

    {  // scores: thread (j, half) takes key j for rows half, half + 2, ...
      const int j = tid & (kKeyTile - 1), half = tid >> 6, t = t0 + j;
      if (half < R) {
        float acc[kRowsPerHalf];
#pragma unroll
        for (int i = 0; i < kRowsPerHalf; ++i) acc[i] = 0.f;
        const char* krow = kt + j * kRow;
        for (int c = 0; c < D; c += kPer) {
          float kf[kPer];
          load16(krow + c * static_cast<int>(sizeof(KV)), static_cast<const KV*>(nullptr), kf);
#pragma unroll
          for (int i = 0; i < kRowsPerHalf; ++i) {
            const int r = half + 2 * i;
            if (r < R) {
              const float4* qr = reinterpret_cast<const float4*>(qs + r * kHeadDim + c);
#pragma unroll
              for (int e = 0; e < kPer / 4; ++e) {
                const float4 qv = qr[e];
                acc[i] += qv.x * kf[4 * e] + qv.y * kf[4 * e + 1] + qv.z * kf[4 * e + 2] +
                          qv.w * kf[4 * e + 3];
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kRowsPerHalf; ++i) {
          const int r = half + 2 * i;
          if (r < R) {
            float s;
            if constexpr (kCausal)
              s = t < end && t <= pos[r] ? acc[i] * ks_t[j] * a.scale : -INFINITY;
            else
              s = t < end ? acc[i] * ks_t[j] * a.scale + mk_t[j] : -INFINITY;
            sc[r * kKeyTile + j] = s;
          }
        }
      }
    }
    __syncthreads();

    // online softmax: warp w keeps rows w, w + 4, ...
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + 4 * i;
      if (r < R) {
        float* srow = sc + r * kKeyTile;
        const float s0 = srow[lane], s1 = srow[lane + 32];
        const float m_new = fmaxf(m_run[i], warp_max(fmaxf(s0, s1)));
        const float base = m_new == -INFINITY ? 0.f : m_new;
        const float p0 = expf(s0 - base), p1 = expf(s1 - base);
        const float corr = expf(m_run[i] - base);
        l_run[i] = l_run[i] * corr + warp_sum(p0 + p1);
        m_run[i] = m_new;
        float pv0 = p0 * vs_t[lane], pv1 = p1 * vs_t[lane + 32];
        if constexpr (kCausal) {  // the TPU kernel feeds p to p.V in bf16
          pv0 = round_bf16(pv0);
          pv1 = round_bf16(pv1);
        }
        srow[lane] = pv0;
        srow[lane + 32] = pv1;
        if (lane == 0) corr_s[r] = corr;
      }
    }
    __syncthreads();

    // p.V: warp w takes keys 16w .. 16w + 15, lane 4 output dims, every row
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r < R) {
        const float c = corr_s[r];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[r][e] *= c;
      }
    }
    if (d0 < D) {
#pragma unroll 4
      for (int jj = 0; jj < kKeyTile / 4; ++jj) {
        const int j = warp * (kKeyTile / 4) + jj;
        if (t0 + j >= end) break;  // past the keys read: the rest may be unwritten cache
        float vf[4];
        load4_tile(reinterpret_cast<const KV*>(vt + j * kRow) + d0, vf);
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
          if (r < R) {
            const float p = sc[r * kKeyTile + j];
#pragma unroll
            for (int e = 0; e < 4; ++e) o[r][e] += p * vf[e];
          }
        }
      }
    }
    __syncthreads();  // stage `cur`, the scores and the corrections are free again
  }
  if (n_tiles == 0) cp_async_wait<0>();  // the first tile was issued but is not needed

  // the four warps' rows, summed in warp order
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + 4 * i;
    if (r < R && lane == 0) {
      m_s[r] = m_run[i];
      l_s[r] = l_run[i];
    }
  }
  float* red = reinterpret_cast<float*>(smem);  // 4 x kMaxR x kHeadDim, over the ring
  if (d0 < D) {
#pragma unroll
    for (int r = 0; r < kMaxR; ++r)
      if (r < R)
        *reinterpret_cast<float4*>(red + (warp * kMaxR + r) * kHeadDim + d0) =
            make_float4(o[r][0], o[r][1], o[r][2], o[r][3]);
  }
  __syncthreads();
  const long long row0 = (bh * a.splits + split) * R;  // this split's first partial row
  float* kept = nullptr;  // this split's slot in rank 0's inbox
  if (keep) {
    cluster_wait();
    float* inbox = reinterpret_cast<float*>(smem + split_smem_bytes<KV, kMaxR>());
    kept = cooperative_groups::this_cluster().map_shared_rank(inbox, 0) +
           split * inbox_slot_floats<kMaxR>();
  }
  for (int i = tid; i < R * D; i += kSplitThreads) {
    const int r = i / D, d = i - r * D;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) s += red[(w * kMaxR + r) * kHeadDim + d];
    if (keep) {
      kept[i] = s;
    } else if (a.part) {
      a.part[2LL * a.B * a.H * a.splits * R + (row0 + r) * D + d] = s;
    } else {
      const float l = l_s[r];
      a.out[(bh * R + r) * D + d] = __float2bfloat16(kCausal && !(l > 0.f) ? 0.f : s / l);
    }
  }
  if (keep && tid < R) {
    kept[kMaxR * kHeadDim + tid] = m_s[tid];
    kept[kMaxR * kHeadDim + kMaxR + tid] = l_s[tid];
  }
  if (a.part && tid < R) {
    a.part[row0 + tid] = m_s[tid];
    a.part[static_cast<long long>(a.B) * a.H * a.splits * R + row0 + tid] = l_s[tid];
  }
}

// The merge of a split launch: block bh combines the splits of its R rows.
// Scratch layout: m (BH, S, R), then l (BH, S, R), then o (BH, S, R, D).
__device__ __forceinline__ void merge_split_rows(const SplitArgs& a, bool zero_empty) {
  const long long bh = blockIdx.x, n = static_cast<long long>(a.B) * a.H * a.splits * a.R;
  for (int r = 0; r < a.R; ++r) {
    const long long row = bh * a.splits * a.R + r;
    merge_splits(a.part + row, a.part + n + row, a.part + 2 * n + row * a.D, a.splits, a.R,
                 static_cast<long long>(a.R) * a.D, a.D, zero_empty, a.out + (bh * a.R + r) * a.D);
  }
}

// The merge of a cluster launch, called by every block after
// split_attention<KV, kMaxR, ..., kClusterMerge = true> when a.splits > 1:
// the cluster is the a.splits blocks of one (b, h), block rank = split, and
// each block has written its partial rows into its slot of rank 0's inbox.
// After the cluster barrier (which makes those writes visible to rank 0)
// every block but rank 0 exits, and rank 0 merges the slots in rank order
// as merge_split_rows does.
template <typename KV, int kMaxR>
__device__ __forceinline__ void merge_cluster_splits(const SplitArgs& a, bool zero_empty) {
  extern __shared__ __align__(16) char smem[];
  cooperative_groups::this_cluster().sync();
  if (blockIdx.x != 0) return;
  constexpr int kSlot = inbox_slot_floats<kMaxR>();
  const float* inbox = reinterpret_cast<const float*>(smem + split_smem_bytes<KV, kMaxR>());
  const long long bh = static_cast<long long>(blockIdx.z) * a.H + blockIdx.y;
  for (int r = 0; r < a.R; ++r)
    merge_splits(inbox + kMaxR * kHeadDim + r, inbox + kMaxR * kHeadDim + kMaxR + r,
                 inbox + r * a.D, a.splits, kSlot, kSlot, a.D, zero_empty,
                 a.out + (bh * a.R + r) * a.D);
}

// Whether the 16-byte loads apply: D * sizeof(KV) and every cache stride a
// multiple of 16 bytes, and K and V 16-byte aligned.
template <typename KV>
inline bool vec_ok(const void* k, const void* v, int D, long long sb, long long sh, long long st) {
  const long long e = sizeof(KV);
  return (D * e) % 16 == 0 && (sb * e) % 16 == 0 && (sh * e) % 16 == 0 && (st * e) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(k) % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
}

// Launches the split kernel and, with more than one split, the merge.
// `split_kernel` and `merge_kernel` take a SplitArgs.
template <typename SplitKernel, typename MergeKernel>
int launch_split(SplitKernel split_kernel, MergeKernel merge_kernel, size_t smem, SplitArgs a,
                 cudaStream_t stream) {
  static_assert(sizeof(SplitArgs) < 4096, "kernel parameters");
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (a.splits > 1 && a.part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (a.splits == 1) a.part = nullptr;
  split_kernel<<<dim3(a.splits, a.H, a.B), kSplitThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return static_cast<int>(e);
  merge_kernel<<<a.B * a.H, kSplitThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Floats of scratch a split launch needs: (m, l, o) per split and row, none
// with one split.
inline long long split_scratch_floats(int B, int H, int R, int D, int n_keys, int target) {
  const SplitPlan p = split_plan(B * H, n_keys, target);
  return p.splits > 1 ? static_cast<long long>(B) * H * p.splits * R * (D + 2) : 0;
}

}  // namespace myriad
