// Causal attention of a prefill chunk over the KV cache (kernel B3).
//
// Replaces myriad_tpu/ops/prefill_attention.py::_kernel, reached through
// prefill_attention -> _local_call (pallas_call).  Per (batch row, head):
//   s = (q . k) * k_scale[key] * scale, kept where key <= positions[b, query]
//   p = softmax(s) * v_scale[key];  out = bf16(p) . v   (fp32 sums)
// positions are absolute, so a later prefill chunk sees the earlier chunks
// already in the cache, and cache slots at or past the write frontier are
// excluded with no mask tensor.  K/V are int8 (cast up, fp16 scales applied
// per key as the TPU kernel applies them) or bf16; q and out are bf16.
//
// What bounds it on the card: a (b, h) of a 297-row chunk over a 416-slot
// cache does ~4 * tq * Tk * D operations on ~2 * Tk * D cache bytes, hundreds
// of operations a byte, so operations bound it.  The TPU kernel held all of K
// and V in VMEM for one pass; a Hopper block has far less fast memory, so this
// kernel is the online-softmax form of the same function: one block per
// (b, h, 16-query tile) walks the keys in tiles of 32 that sit in shared
// memory, keeps a running max and sum per query row, and rescales its fp32
// accumulators as the max grows.  It has no limit on the cache length and
// stops at the last key that any of its rows can see.  The products run on
// the FMA units in fp32; moving them to the tensor cores is later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;              // 4 warps
constexpr int kRowsPerWarp = 4;
constexpr int kTileQ = (kThreads / 32) * kRowsPerWarp;  // 16 query rows
constexpr int kTileK = 32;                 // keys a tile: one per lane
constexpr int kMaxD = 128;
constexpr int kDPerLane = kMaxD / 32;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename KV>
__global__ void __launch_bounds__(kThreads)
prefill_attention_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
                         const KV* __restrict__ v, const __half* __restrict__ k_scale,
                         const __half* __restrict__ v_scale, const int* __restrict__ positions,
                         __nv_bfloat16* __restrict__ out, int H, int tq, int Tk, int D,
                         long long kv_sb, long long kv_sh, long long kv_st, long long sc_sb,
                         long long sc_sh, long long sc_st, float scale) {
  __shared__ float qs[kTileQ][kMaxD];
  __shared__ float ks[kTileK][kMaxD + 1];  // +1: lanes read different rows
  __shared__ float vs[kTileK][kMaxD];
  __shared__ float ps[kTileQ][kTileK];
  __shared__ float kscale[kTileK], vscale[kTileK];
  __shared__ int pos[kTileQ];

  const int q0 = blockIdx.x * kTileQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t qrow0 = ((size_t)b * H + h) * tq + q0;

  for (int i = tid; i < kTileQ * kMaxD; i += kThreads) {
    const int r = i / kMaxD, d = i % kMaxD;
    qs[r][d] = (q0 + r < tq && d < D) ? __bfloat162float(q[(qrow0 + r) * D + d]) : 0.f;
  }
  if (tid < kTileQ) pos[tid] = (q0 + tid < tq) ? positions[(size_t)b * tq + q0 + tid] : -1;
  __syncthreads();

  int last = -1;
#pragma unroll
  for (int r = 0; r < kTileQ; ++r) last = max(last, pos[r]);
  const int kend = min(Tk, last + 1);  // no row of this tile sees keys past it

  const KV* kp = k + b * kv_sb + h * kv_sh;
  const KV* vp = v + b * kv_sb + h * kv_sh;
  const __half* ksp = k_scale ? k_scale + b * sc_sb + h * sc_sh : nullptr;
  const __half* vsp = v_scale ? v_scale + b * sc_sb + h * sc_sh : nullptr;

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp], acc[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < kend; kt += kTileK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kTileK * kMaxD; i += kThreads) {
      const int j = i / kMaxD, d = i % kMaxD, t = kt + j;
      float kv = 0.f, vv = 0.f;
      if (t < kend && d < D) {
        kv = myriad::to_float(kp[t * kv_st + d]);
        vv = myriad::to_float(vp[t * kv_st + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    if (tid < kTileK) {
      const int t = kt + tid;
      kscale[tid] = (ksp && t < kend) ? __half2float(ksp[t * sc_st]) : 1.f;
      vscale[tid] = (vsp && t < kend) ? __half2float(vsp[t * sc_st]) : 1.f;
    }
    __syncthreads();

    // scores: lane j takes key kt + j for the warp's rows
    const int j = lane, t = kt + lane;
    float sc[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sc[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = ks[j][d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) sc[i] += qs[warp * kRowsPerWarp + i][d] * kd;
    }

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const bool seen = t < kend && t <= pos[r];
      const float s = seen ? sc[i] * kscale[j] * scale : -INFINITY;
      const float m_new = fmaxf(m_run[i], myriad::warp_max(s));
      const float p = seen ? expf(s - m_new) : 0.f;
      const float corr = m_run[i] == -INFINITY ? 0.f : expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * corr + myriad::warp_sum(p);
      m_run[i] = m_new;
      // the TPU kernel feeds p to the p.V product in bf16
      ps[r][j] = round_bf16(p * vscale[j]);
#pragma unroll
      for (int c = 0; c < kDPerLane; ++c) acc[i][c] *= corr;
    }
    __syncwarp();

    // p.V over this tile: the warp reads only its own rows of ps
    for (int jj = 0; jj < kTileK; ++jj) {
      float vv[kDPerLane];
#pragma unroll
      for (int c = 0; c < kDPerLane; ++c) vv[c] = vs[jj][lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float p = ps[warp * kRowsPerWarp + i][jj];
#pragma unroll
        for (int c = 0; c < kDPerLane; ++c) acc[i][c] += p * vv[c];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    if (q0 + r >= tq) continue;
    // a row that sees no key (negative position) has l == 0: write zeros
    const float inv = l_run[i] > 0.f ? 1.f / l_run[i] : 0.f;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) out[(qrow0 + r) * D + d] = __float2bfloat16(acc[i][c] * inv);
    }
  }
}

template <typename KV>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* positions, void* out, int B, int H, int tq, int Tk, int D, long long kv_sb,
           long long kv_sh, long long kv_st, long long sc_sb, long long sc_sh, long long sc_st,
           float scale, cudaStream_t stream) {
  const dim3 grid((tq + kTileQ - 1) / kTileQ, H, B);
  prefill_attention_kernel<KV><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const __half*>(ks), static_cast<const __half*>(vs),
      static_cast<const int*>(positions), static_cast<__nv_bfloat16*>(out), H, tq, Tk, D, kv_sb,
      kv_sh, kv_st, sc_sb, sc_sh, sc_st, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, tq, D) bf16 contiguous; k, v (B, H, Tk, D) int8 or bf16 with element
// strides (kv_sb, kv_sh, kv_st) and a contiguous last dim; k_scale, v_scale
// (B, H, Tk, 1) fp16 with strides (sc_sb, sc_sh, sc_st), or null for a bf16
// cache; positions (B, tq) int32; out (B, H, tq, D) bf16.  D <= 128.
extern "C" int myriad_prefill_attention(const void* q, const void* k, const void* v,
                                        const void* k_scale, const void* v_scale,
                                        const void* positions, void* out, int B, int H, int tq,
                                        int Tk, int D, long long kv_sb, long long kv_sh,
                                        long long kv_st, long long sc_sb, long long sc_sh,
                                        long long sc_st, int kv_int8, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_int8)
    return launch<int8_t>(q, k, v, k_scale, v_scale, positions, out, B, H, tq, Tk, D, kv_sb,
                          kv_sh, kv_st, sc_sb, sc_sh, sc_st, scale, s);
  return launch<__nv_bfloat16>(q, k, v, k_scale, v_scale, positions, out, B, H, tq, Tk, D,
                               kv_sb, kv_sh, kv_st, sc_sb, sc_sh, sc_st, scale, s);
}
