// Single-query attention over the KV cache for one decode step (kernel B2).
//
// Replaces myriad_tpu/ops/decode_attention.py::_decode_kernel, reached
// through decode_attention -> _decode_attention_padded (pallas_call).  One
// block per (batch row, head) computes, as the TPU kernel does:
//   s[t] = (q . K[t]) * k_scale[t] * scale + mask[b, t]        (fp32)
//   p[t] = exp(s[t] - max s);  denom = sum p
//   out  = (sum_t p[t] * v_scale[t] * V[t]) / denom
// over the first kv_len cache positions only, so a staged decode step reads
// the valid prefix of the cache with no slice copy.  K/V are int8 (with fp16
// per-position scales) or bf16; q and out are bf16.
//
// What bounds it on the card: each (b, h) reads 2 * kv_len * D cache bytes and
// does about 4 * kv_len * D operations, so the bytes of the cache bound it.
// Warps split the positions and each lane reads 4 consecutive elements, so a
// warp reads one whole K row (128 bytes at int8, D = 128) per load; the scores
// stay in shared memory, and p.V splits the positions over the warps again and
// sums the partial rows in shared memory.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename KV>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
                        const KV* __restrict__ v, const __half* __restrict__ k_scale,
                        const __half* __restrict__ v_scale, const float* __restrict__ mask,
                        __nv_bfloat16* __restrict__ out, int H, int D, int kv_len,
                        long long kv_sb, long long kv_sh, long long kv_st, long long sc_sb,
                        long long sc_sh, long long sc_st, float scale) {
  extern __shared__ float smem[];
  float* s = smem;           // kv_len scores, then probabilities
  float* qs = s + kv_len;    // D
  float* part = qs + D;      // kWarps * D partial output rows
  __shared__ float red[32];

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row = (size_t)b * H + h;

  for (int d = threadIdx.x; d < D; d += kThreads) qs[d] = __bfloat162float(q[row * D + d]);
  __syncthreads();

  const KV* kp = k + b * kv_sb + h * kv_sh;
  const KV* vp = v + b * kv_sb + h * kv_sh;
  const __half* ksp = k_scale ? k_scale + b * sc_sb + h * sc_sh : nullptr;
  const __half* vsp = v_scale ? v_scale + b * sc_sb + h * sc_sh : nullptr;
  const float* mp = mask + (size_t)b * kv_len;

  for (int t = warp; t < kv_len; t += kWarps) {
    const KV* kr = kp + t * kv_st;
    float acc = 0.f;
    for (int d = lane * 4; d < D; d += 128) {
      float kv4[4];
      myriad::load4(kr + d, kv4);
      acc += qs[d] * kv4[0] + qs[d + 1] * kv4[1] + qs[d + 2] * kv4[2] + qs[d + 3] * kv4[3];
    }
    acc = myriad::warp_sum(acc);
    if (lane == 0) {
      if (ksp) acc *= __half2float(ksp[t * sc_st]);
      s[t] = acc * scale + mp[t];
    }
  }
  __syncthreads();

  float mx = -INFINITY;
  for (int t = threadIdx.x; t < kv_len; t += kThreads) mx = fmaxf(mx, s[t]);
  mx = myriad::block_reduce<true>(mx, red);

  float denom = 0.f;
  for (int t = threadIdx.x; t < kv_len; t += kThreads) {
    const float p = expf(s[t] - mx);
    denom += p;
    s[t] = vsp ? p * __half2float(vsp[t * sc_st]) : p;
  }
  denom = myriad::block_reduce<false>(denom, red);  // its barriers publish s[]

  float o[4] = {0.f, 0.f, 0.f, 0.f};
  const int d0 = lane * 4;
  if (d0 < D) {
    for (int t = warp; t < kv_len; t += kWarps) {
      const float p = s[t];
      float vv[4];
      myriad::load4(vp + t * kv_st + d0, vv);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] += p * vv[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) part[warp * D + d0 + j] = o[j];
  }
  __syncthreads();

  for (int d = threadIdx.x; d < D; d += kThreads) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += part[w * D + d];
    out[row * D + d] = __float2bfloat16(acc / denom);
  }
}

template <typename KV>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* mask, void* out, int B, int H, int D, int kv_len, long long kv_sb,
           long long kv_sh, long long kv_st, long long sc_sb, long long sc_sh, long long sc_st,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kv_len + D + (size_t)kWarps * D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_attention_kernel<KV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_attention_kernel<KV><<<B * H, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const __half*>(ks), static_cast<const __half*>(vs),
      static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(out), H, D, kv_len, kv_sb,
      kv_sh, kv_st, sc_sb, sc_sh, sc_st, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, 1, D) bf16 contiguous; k, v (B, H, T, D) int8 or bf16 with element
// strides (kv_sb, kv_sh, kv_st) and a contiguous last dim, of which the first
// kv_len positions are read; k_scale, v_scale (B, H, T, 1) fp16 with strides
// (sc_sb, sc_sh, sc_st), or null for a bf16 cache; mask (B, kv_len) fp32
// additive; out (B, H, 1, D) bf16.  D <= 128 and a multiple of 4.
extern "C" int myriad_decode_attention(const void* q, const void* k, const void* v,
                                       const void* k_scale, const void* v_scale,
                                       const void* mask, void* out, int B, int H, int D,
                                       int kv_len, long long kv_sb, long long kv_sh,
                                       long long kv_st, long long sc_sb, long long sc_sh,
                                       long long sc_st, int kv_int8, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_int8)
    return launch<int8_t>(q, k, v, k_scale, v_scale, mask, out, B, H, D, kv_len, kv_sb, kv_sh,
                          kv_st, sc_sb, sc_sh, sc_st, scale, s);
  return launch<__nv_bfloat16>(q, k, v, k_scale, v_scale, mask, out, B, H, D, kv_len, kv_sb,
                               kv_sh, kv_st, sc_sb, sc_sh, sc_st, scale, s);
}
