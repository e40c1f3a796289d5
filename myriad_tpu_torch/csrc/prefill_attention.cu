// Causal attention of a prefill chunk over the KV cache (kernel B3).
//
// Replaces myriad_tpu/ops/prefill_attention.py::_kernel, reached through
// prefill_attention -> _local_call (pallas_call).  Per (batch row, head):
//   s = (q . k) * k_scale[key] * scale, kept where key <= positions[b, query]
//   p = softmax(s) * v_scale[key];  out = bf16(p) . v   (fp32 sums)
// positions are absolute, so a later prefill chunk sees the earlier chunks
// already in the cache, and cache slots at or past the write frontier are
// excluded with no mask tensor.  K/V are int8 (fp16 scales applied per key as
// the TPU kernel applies them) or bf16; q and out are bf16.  q . k is taken
// on bf16 q and bf16(k), which is exact for int8 k.
//
// The TPU kernel held all of K and V in VMEM for one pass; a Hopper block
// has far less fast memory, so both regimes below are the online-softmax
// form of the same function, chosen by the launcher from the chunk length:
//
// 16 query rows or more (a prefill chunk, a chat delta, a re-prefill):
// operations bound it -- a (b, h) of a 297-row chunk over a 416-slot cache
// does ~4 * tq * Tk * D operations on ~2 * Tk * D cache bytes -- so the two
// products run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulators).  A block takes 64 query rows (16 a warp, their q fragments
// in registers) and walks the keys in tiles of 64: K and V arrive through a
// two-stage shared-memory ring of 16-byte cp.async loads, an int8 tile is
// converted once to bf16 in shared memory, and ldmatrix feeds the fragments.
// The running max and sum of a row live with the four lanes that hold it;
// the score accumulators become the A operand of p.V in registers.  A block
// stops at the last key any of its rows can see, a warp skips the tiles
// past its own rows, and the heaviest query tiles are scheduled first.
// What holds it back now is latency, not the tensor cores: a thread's q
// fragments and output accumulators take most of its 168 registers, so
// three blocks (12 warps) share an SM, and at the prefill's few key tiles a
// block the prologue (q, positions, first tile) and three barriers a tile
// weigh as much as the products.
//
// Fewer than 16 rows (the K + 1 = 4-row speculative verify chunk, with
// ragged per-row positions): bytes bound it, and a 16-row tile would be
// mostly padding.  The keys of each (b, h) are split over warps and over
// blocks (split_attention.cuh, shared with kernel B2'), each key row read
// once with 16-byte loads for all the chunk's rows, and a second launch
// merges the splits in a fixed order.  Its few hundred keys a (b, h) make
// it latency-bound too: a block's prologue and one tile's memory round trip
// take most of its time.

#include "common.cuh"
#include "split_attention.cuh"

namespace {

using myriad::kHeadDim;
using myriad::kKeyTile;
using myriad::ldmatrix_x4;
using myriad::mma_bf16;

constexpr int kSplitBelow = 16;  // chunks shorter than this take the split kernel
// Blocks a split launch aims at, four for each SM: the verify chunk's keys
// end well before its cache does, so more splits add empty blocks and
// partials to merge (eight a SM ran slower at the 4-row verify chunk).
constexpr int kSplitTargetBlocks = 4 * myriad::kSMs;
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 16 * kTcWarps;  // query rows a block
constexpr int kOpRow = kHeadDim + 8;    // bf16 operand row, elements (272 bytes)

// Shared memory of the tensor-core kernel.  bf16 cache: two stages of (K, V)
// operand tiles.  int8 cache: two stages of raw (K, V) tiles, then one bf16
// (K, V) operand tile.  Then k_scale and v_scale of two tiles, and the block's
// query positions.
template <typename KV>
struct TcLayout {
  static constexpr bool kInt8 = sizeof(KV) == 1;
  static constexpr int kRawTile = kKeyTile * myriad::tile_row_bytes<KV>();
  static constexpr int kOpTile = kKeyTile * kOpRow * 2;
  static constexpr int kStage = 2 * (kInt8 ? kRawTile : kOpTile);
  static constexpr int kOp = 2 * kStage;  // int8: the converted tiles
  static constexpr int kScales = kOp + (kInt8 ? 2 * kOpTile : 0);
  static constexpr int kPos = kScales + 4 * 4 * kKeyTile;
  static constexpr int kBytes = kPos + 4 * kTcRows;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Two consecutive bf16 of a q row, packed; zero past D or past the chunk.
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* row, int d, int D, bool valid) {
  const unsigned lo = valid && d < D ? __bfloat16_as_ushort(row[d]) : 0u;
  const unsigned hi = valid && d + 1 < D ? __bfloat16_as_ushort(row[d + 1]) : 0u;
  return lo | (hi << 16);
}

// At most 168 registers a thread (ptxas spills a few bytes), so that three
// blocks share an SM: at 215 registers two did, and the kernel was ~12%
// slower at the 297-row prefill.
template <typename KV, bool kVec>
__global__ void __launch_bounds__(kTcThreads, 3)
prefill_attention_tc_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
                            const KV* __restrict__ v, const __half* __restrict__ k_scale,
                            const __half* __restrict__ v_scale, const int* __restrict__ positions,
                            __nv_bfloat16* __restrict__ out, int H, int tq, int Tk, int D,
                            long long kv_sb, long long kv_sh, long long kv_st, long long sc_sb,
                            long long sc_sh, long long sc_st, float scale) {
  using L = TcLayout<KV>;
  constexpr int kRaw = myriad::tile_row_bytes<KV>();
  extern __shared__ __align__(16) char smem[];
  float* ksc = reinterpret_cast<float*>(smem + L::kScales);  // [2][kKeyTile], by stage
  float* vsc = ksc + 2 * kKeyTile;
  int* pos = reinterpret_cast<int*>(smem + L::kPos);

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcRows;  // heaviest query tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;

  // columns at or past D are never staged: they must read as zeros
  if (D < kHeadDim) myriad::zero_shared(smem, L::kScales);
  if (tid < kTcRows)
    pos[tid] = q0 + tid < tq ? positions[static_cast<long long>(b) * tq + q0 + tid] : -1;

  // this warp's 16 query rows as A fragments, for the 8 k-steps of D = 128
  const int wr = q0 + 16 * warp;  // the warp's first row in the chunk
  const __nv_bfloat16* qrow = q + ((static_cast<long long>(b) * H + h) * tq + wr) * D;
  uint32_t qa[kHeadDim / 16][4];
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = gid + 8 * (i & 1), d = 16 * kk + 2 * tig + 8 * (i >> 1);
      qa[kk][i] = q_pair(qrow + static_cast<long long>(r) * D, d, D, wr + r < tq);
    }
  __syncthreads();

  // the last position of the warp's 16 rows, and of the block's 64
  int wlast = pos[16 * warp + (lane & 15)], last = max(pos[lane], pos[lane + 32]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wlast = max(wlast, __shfl_xor_sync(0xffffffffu, wlast, o));
    last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  }
  const int kend = min(Tk, last + 1);  // no row of this block sees keys past it
  const int p0 = pos[16 * warp + gid], p1 = pos[16 * warp + gid + 8];

  const KV* kp = k + b * kv_sb + h * kv_sh;
  const KV* vp = v + b * kv_sb + h * kv_sh;
  const __half* ksp = k_scale ? k_scale + b * sc_sb + h * sc_sh : nullptr;
  const __half* vsp = v_scale ? v_scale + b * sc_sb + h * sc_sh : nullptr;
  float nks = 1.f, nvs = 1.f;  // a tile's scales in flight, thread j < kKeyTile
  auto load_scales = [&](int t0) {
    const int t = t0 + tid;
    nks = ksp && t < kend ? __half2float(ksp[t * sc_st]) : 1.f;
    nvs = vsp && t < kend ? __half2float(vsp[t * sc_st]) : 1.f;
  };
  auto stage = [&](int s, int t0) {
    char* base = smem + s * L::kStage;
    myriad::stage_tile<KV, kVec>(base, kp, kv_st, t0, kend, D);
    myriad::stage_tile<KV, kVec>(base + L::kStage / 2, vp, kv_st, t0, kend, D);
    myriad::cp_async_commit();
  };

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // rows gid, gid + 8
  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_tiles = kend > 0 ? (kend + kKeyTile - 1) / kKeyTile : 0;
  if (n_tiles > 0) {
    stage(0, 0);
    if (tid < kKeyTile) {
      load_scales(0);
      ksc[tid] = nks;
      vsc[tid] = nvs;
    }
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * kKeyTile, cur = it & 1;
    if (it > 0 && tid < kKeyTile) {  // this tile's scales, loaded during the previous one
      ksc[cur * kKeyTile + tid] = nks;
      vsc[cur * kKeyTile + tid] = nvs;
    }
    if (it + 1 < n_tiles) {
      stage(cur ^ 1, t0 + kKeyTile);
      if (tid < kKeyTile) load_scales(t0 + kKeyTile);
      myriad::cp_async_wait<1>();
    } else {
      myriad::cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` is in shared memory for every thread

    const __nv_bfloat16* kop;
    const __nv_bfloat16* vop;
    if constexpr (L::kInt8) {
      // int8 -> bf16 (exact, by bit operations), once per tile: 16 bytes a
      // step, the threads of a step on 8 consecutive rows (no bank
      // conflicts either side)
      const char* raw = smem + cur * L::kStage;
      char* op = smem + L::kOp;
      for (int i = tid; i < 2 * kKeyTile * (kHeadDim / 16); i += kTcThreads) {
        const int r = i & (kKeyTile - 1), c = (i >> 6) & (kHeadDim / 16 - 1), which = i >> 9;
        const uint4 w =
            *reinterpret_cast<const uint4*>(raw + which * L::kRawTile + r * kRaw + c * 16);
        float x[16];
        myriad::int8x4_to_float(w.x, x);
        myriad::int8x4_to_float(w.y, x + 4);
        myriad::int8x4_to_float(w.z, x + 8);
        myriad::int8x4_to_float(w.w, x + 12);
        uint4 lo, hi;
        lo.x = myriad::exact_bf16x2(x[0], x[1]);
        lo.y = myriad::exact_bf16x2(x[2], x[3]);
        lo.z = myriad::exact_bf16x2(x[4], x[5]);
        lo.w = myriad::exact_bf16x2(x[6], x[7]);
        hi.x = myriad::exact_bf16x2(x[8], x[9]);
        hi.y = myriad::exact_bf16x2(x[10], x[11]);
        hi.z = myriad::exact_bf16x2(x[12], x[13]);
        hi.w = myriad::exact_bf16x2(x[14], x[15]);
        uint4* dst = reinterpret_cast<uint4*>(op + which * L::kOpTile + r * kOpRow * 2 + c * 32);
        dst[0] = lo;
        dst[1] = hi;
      }
      __syncthreads();
      kop = reinterpret_cast<const __nv_bfloat16*>(op);
      vop = reinterpret_cast<const __nv_bfloat16*>(op + L::kOpTile);
    } else {
      kop = reinterpret_cast<const __nv_bfloat16*>(smem + cur * L::kStage);
      vop = reinterpret_cast<const __nv_bfloat16*>(smem + cur * L::kStage + L::kOpTile);
    }
    const float* ks_t = ksc + cur * kKeyTile;
    const float* vs_t = vsc + cur * kKeyTile;

    if (t0 <= wlast) {  // else no row of this warp sees the tile
      // s = q . k^T: 8 key blocks of 8, 8 k-steps of 16 dims
      float s[kKeyTile / 8][4];
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; kk += 2)
#pragma unroll
        for (int j = 0; j < kKeyTile / 8; ++j) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kop + (8 * j + (lane & 7)) * kOpRow + 16 * kk + 8 * (lane >> 3));
          mma_bf16(s[j], qa[kk], bk[0], bk[1]);
          mma_bf16(s[j], qa[kk + 1], bk[2], bk[3]);
        }

      // k_scale, scale and the causal mask; the tile's max of each row
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * tig + (e & 1), key = t0 + c;
          const bool seen = key < kend && key <= (e < 2 ? p0 : p1);
          s[j][e] = seen ? s[j][e] * ks_t[c] * scale : -INFINITY;
        }
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      const float mn0 = fmaxf(m_run[0], mx0), mn1 = fmaxf(m_run[1], mx1);
      const float b0 = mn0 == -INFINITY ? 0.f : mn0, b1 = mn1 == -INFINITY ? 0.f : mn1;
      const float c0 = expf(m_run[0] - b0), c1 = expf(m_run[1] - b1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j) {
        s[j][0] = expf(s[j][0] - b0);
        s[j][1] = expf(s[j][1] - b0);
        s[j][2] = expf(s[j][2] - b1);
        s[j][3] = expf(s[j][3] - b1);
        sum0 += s[j][0] + s[j][1];
        sum1 += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
      }
      l_run[0] = l_run[0] * c0 + sum0;
      l_run[1] = l_run[1] * c1 + sum1;
      m_run[0] = mn0;
      m_run[1] = mn1;
#pragma unroll
      for (int n = 0; n < kHeadDim / 8; ++n) {
        acc[n][0] *= c0;
        acc[n][1] *= c0;
        acc[n][2] *= c1;
        acc[n][3] *= c1;
      }

      // out += bf16(p * v_scale) . V: the score accumulators of key blocks
      // 2kk and 2kk + 1 are the A fragment of k-step kk
#pragma unroll
      for (int kk = 0; kk < kKeyTile / 16; ++kk) {
        const int ca = 16 * kk + 2 * tig, cb = ca + 8;
        const float va0 = vs_t[ca], va1 = vs_t[ca + 1], vb0 = vs_t[cb], vb1 = vs_t[cb + 1];
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0] * va0, s[2 * kk][1] * va1),
            pack_bf16(s[2 * kk][2] * va0, s[2 * kk][3] * va1),
            pack_bf16(s[2 * kk + 1][0] * vb0, s[2 * kk + 1][1] * vb1),
            pack_bf16(s[2 * kk + 1][2] * vb0, s[2 * kk + 1][3] * vb1)};
#pragma unroll
        for (int n = 0; n < kHeadDim / 8; n += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vop + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * kOpRow +
                                    8 * n + 8 * (lane >> 4));
          mma_bf16(acc[n], pa, bv[0], bv[1]);
          mma_bf16(acc[n + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // stage `cur` (and the int8 operand tile) is free again
  }

  // a row that sees no key (negative position) has l == 0: write zeros
  const float inv0 = l_run[0] > 0.f ? 1.f / l_run[0] : 0.f;
  const float inv1 = l_run[1] > 0.f ? 1.f / l_run[1] : 0.f;
  __nv_bfloat16* orow = out + ((static_cast<long long>(b) * H + h) * tq + wr) * D;
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n) {
    const int d = 8 * n + 2 * tig;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = gid + 8 * (e >> 1), dd = d + (e & 1);
      if (wr + r < tq && dd < D)
        orow[static_cast<long long>(r) * D + dd] =
            __float2bfloat16(acc[n][e] * (e < 2 ? inv0 : inv1));
    }
  }
}

template <typename KV>
int launch_tc(const void* q, const void* k, const void* v, const void* ks, const void* vs,
              const void* positions, void* out, int B, int H, int tq, int Tk, int D,
              long long kv_sb, long long kv_sh, long long kv_st, long long sc_sb, long long sc_sh,
              long long sc_st, float scale, cudaStream_t stream) {
  constexpr int smem = TcLayout<KV>::kBytes;
  const bool vec = myriad::vec_ok<KV>(k, v, D, kv_sb, kv_sh, kv_st);
  auto kernel =
      vec ? &prefill_attention_tc_kernel<KV, true> : &prefill_attention_tc_kernel<KV, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H, B, (tq + kTcRows - 1) / kTcRows);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const __half*>(ks), static_cast<const __half*>(vs),
      static_cast<const int*>(positions), static_cast<__nv_bfloat16*>(out), H, tq, Tk, D, kv_sb,
      kv_sh, kv_st, sc_sb, sc_sh, sc_st, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV, int kMaxR, bool kVec>
__global__ void __launch_bounds__(myriad::kSplitThreads)
prefill_attention_split_kernel(const myriad::SplitArgs a) {
  myriad::split_attention<KV, kMaxR, true, kVec>(a);
}

__global__ void __launch_bounds__(myriad::kSplitThreads)
prefill_attention_merge_kernel(const myriad::SplitArgs a) {
  myriad::merge_split_rows(a, true);
}

template <typename KV, int kMaxR>
int launch_split_kernel(const myriad::SplitArgs& a, cudaStream_t stream) {
  const bool vec = myriad::vec_ok<KV>(a.k, a.v, a.D, a.kv_sb, a.kv_sh, a.kv_st);
  return myriad::launch_split(vec ? &prefill_attention_split_kernel<KV, kMaxR, true>
                                  : &prefill_attention_split_kernel<KV, kMaxR, false>,
                              &prefill_attention_merge_kernel,
                              myriad::split_smem_bytes<KV, kMaxR>(), a, stream);
}

template <typename KV>
int launch_split_rows(const myriad::SplitArgs& a, cudaStream_t stream) {
  if (a.R <= 4) return launch_split_kernel<KV, 4>(a, stream);
  if (a.R <= 8) return launch_split_kernel<KV, 8>(a, stream);
  return launch_split_kernel<KV, kSplitBelow>(a, stream);
}

}  // namespace

// Floats of scratch kernel B3 needs for these widths (0: none; only chunks
// of fewer than 16 rows split their keys).
extern "C" long long myriad_prefill_attention_scratch(int B, int H, int tq, int Tk, int D) {
  return tq < kSplitBelow
             ? myriad::split_scratch_floats(B, H, tq, D, Tk, kSplitTargetBlocks)
             : 0;
}

// q (B, H, tq, D) bf16 contiguous; k, v (B, H, Tk, D) int8 or bf16 with element
// strides (kv_sb, kv_sh, kv_st) and a contiguous last dim; k_scale, v_scale
// (B, H, Tk, 1) fp16 with strides (sc_sb, sc_sh, sc_st), or null for a bf16
// cache; positions (B, tq) int32; out (B, H, tq, D) bf16.  D <= 128.
// `scratch`: myriad_prefill_attention_scratch floats (null when that is 0).
extern "C" int myriad_prefill_attention(const void* q, const void* k, const void* v,
                                        const void* k_scale, const void* v_scale,
                                        const void* positions, void* out, int B, int H, int tq,
                                        int Tk, int D, long long kv_sb, long long kv_sh,
                                        long long kv_st, long long sc_sb, long long sc_sh,
                                        long long sc_st, int kv_int8, float scale, void* scratch,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tq < kSplitBelow) {
    const myriad::SplitPlan plan = myriad::split_plan(B * H, Tk, kSplitTargetBlocks);
    const myriad::SplitArgs a{static_cast<const __nv_bfloat16*>(q), k, v,
                              static_cast<const __half*>(k_scale),
                              static_cast<const __half*>(v_scale), nullptr,
                              static_cast<const int*>(positions), static_cast<__nv_bfloat16*>(out),
                              static_cast<float*>(scratch), B, H, tq, D, Tk, plan.splits,
                              plan.keys_per_split, kv_sb, kv_sh, kv_st, sc_sb, sc_sh, sc_st, scale};
    return kv_int8 ? launch_split_rows<int8_t>(a, s) : launch_split_rows<__nv_bfloat16>(a, s);
  }
  if (kv_int8)
    return launch_tc<int8_t>(q, k, v, k_scale, v_scale, positions, out, B, H, tq, Tk, D, kv_sb,
                             kv_sh, kv_st, sc_sb, sc_sh, sc_st, scale, s);
  return launch_tc<__nv_bfloat16>(q, k, v, k_scale, v_scale, positions, out, B, H, tq, Tk, D,
                                  kv_sb, kv_sh, kv_st, sc_sb, sc_sh, sc_st, scale, s);
}
