// In-place KV-cache writes at per-row start positions (kernel B4).
//
// Replaces myriad_tpu/ops/kv_write.py::_kv_write_kernel, reached through
// kv_cache_write -> _write_pallas (pallas_call).  The TPU kernel found each
// written block's place from a scalar-prefetched start idx[b] and copied
// (1, H, D) blocks into the aliased pool; it could not write D < 8 (the
// per-position scales went through vmap(dynamic_update_slice) instead).
//
// Two entry points over the B * H * t written rows (batch row b, head h,
// written position j):
//   myriad_kv_write           copies a row of D elements of any type;
//   myriad_kv_quantize_write  quantizes a bf16 row of K or V as
//                             models/llama.py::quantize_kv does and writes
//                             the int8 payload and the fp16 scale, K and V in
//                             one launch (blockIdx.y = 0: K, 1: V).
// The start of row b is idx[b] (or one start for every row when idx is
// null), clamped to [0, T - t] as the TPU kernel clamps it.
//
// What bounds it on the card: nothing but latency.  A verify round at B = 8,
// H = 32, t = 4, D = 128 writes 128 KB of int8 payload and reads twice that
// in bf16; the card moves it in under a microsecond, and a launch costs a
// few.  So the design pays as few latencies as it can:
// - several rows a block: a row takes G lanes (a power of two, G = D / 8 at
//   D = 128: two rows a warp), a block of four warps 128 / G rows, so a
//   decode step's 512 rows (B = 8, H = 32, K and V) are 64 blocks, not 512
//   one-warp blocks with half their lanes idle;
// - one read of the source: each lane loads its 8 values (16 bytes) once,
//   before the row's start idx[b], so that the two loads overlap, keeps them
//   in registers through the amax (a __shfl_xor_sync reduction over the
//   row's G lanes) and the quantization, and writes 8 int8 in one 8-byte
//   store; the row's first lane writes the scale;
// - programmatic dependent launch: the launch may begin while the previous
//   kernel of the stream runs, and each thread waits for that kernel's
//   writes (griddepcontrol.wait) before its first read.
// The copy packs rows the same way, in 16-byte units where the row and every
// address allow them (a bf16 or int8 row of 128) and in single bytes
// otherwise (the fp16 scales: 2 bytes a row, a lane each, 64 rows a block).
// The quantization falls back to one warp a row, reading the row twice, when
// D is not a multiple of 8, is above 256, or an address is not aligned.
//
// Bit-exactness with the plain version: the amax is a max (order-free); the
// scale is max(amax / 127, 1e-8) by an IEEE division (no fast math in the
// build), each value is rintf(x / scale) (round half to even, as torch.round)
// clamped to [-127, 127], and the fp32 scale is stored with __float2half_rn.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // four warps; a block holds kThreads / G rows

__device__ __forceinline__ void wait_for_previous_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ int clamped_start(int s, int T, int t) {
  return min(max(s, 0), T - t);
}

// ---------------------------------------------------------------------------
// Copy: rows of `units` units of type U each, 1 << log_g lanes a row.
// ---------------------------------------------------------------------------
struct CopyArgs {
  char* buf;        // (B, H, T, D), a position row_bytes further than the last
  const char* upd;  // (B, H, t, D)
  const int* idx;
  int start, rows, H, t, T, units, log_g;
  long long buf_sb, buf_sh, upd_sb, upd_sh, upd_st;  // bytes
  long long row_bytes;
};

template <typename U>
__global__ void __launch_bounds__(kThreads) kv_write_kernel(const CopyArgs a) {
  const int g = threadIdx.x & ((1 << a.log_g) - 1);
  const int r = blockIdx.x * (kThreads >> a.log_g) + (threadIdx.x >> a.log_g);
  if (r >= a.rows || g >= a.units) return;
  const int j = r % a.t, bh = r / a.t, h = bh % a.H, b = bh / a.H;
  const U* src = reinterpret_cast<const U*>(a.upd + b * a.upd_sb + h * a.upd_sh + j * a.upd_st);
  wait_for_previous_grid();
  const U first = __ldg(src + g);
  const int pos = clamped_start(a.idx ? __ldg(a.idx + b) : a.start, a.T, a.t) + j;
  U* dst = reinterpret_cast<U*>(a.buf + b * a.buf_sb + h * a.buf_sh + pos * a.row_bytes);
  dst[g] = first;
  for (int i = g + (1 << a.log_g); i < a.units; i += 1 << a.log_g) dst[i] = __ldg(src + i);
}

// ---------------------------------------------------------------------------
// Quantize and write.
// ---------------------------------------------------------------------------
struct QuantArgs {
  int8_t* k8;
  int8_t* v8;
  __half* ks;
  __half* vs;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* idx;
  int start, rows, H, t, T, D;
  long long c_sb, c_sh;        // payload element strides; a position is D further
  long long s_sb, s_sh;        // the scales' (c_sb / D, c_sh / D); a position is 1 further
  long long x_sb, x_sh, x_st;  // K's and V's element strides
};

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(x / scale), -127.f), 127.f));
}

__device__ __forceinline__ uint32_t quantize4(const float x[4], float scale) {
  const uint32_t b0 = static_cast<uint8_t>(quantize(x[0], scale));
  const uint32_t b1 = static_cast<uint8_t>(quantize(x[1], scale));
  const uint32_t b2 = static_cast<uint8_t>(quantize(x[2], scale));
  const uint32_t b3 = static_cast<uint8_t>(quantize(x[3], scale));
  return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
}

// G lanes a row, 8 values a lane: 8 * G >= D > 4 * G (or G = 1).
template <int G>
__global__ void __launch_bounds__(kThreads) kv_quantize_write_kernel(const QuantArgs a) {
  const int which = blockIdx.y;
  const int g = threadIdx.x % G;
  const int r = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const bool row = r < a.rows;
  const bool lane = row && g * 8 < a.D;
  const int j = r % a.t, bh = r / a.t, h = bh % a.H, b = bh / a.H;
  const __nv_bfloat16* src = (which ? a.v : a.k) + b * a.x_sb + h * a.x_sh + j * a.x_st + g * 8;
  wait_for_previous_grid();
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if (lane) raw = __ldg(reinterpret_cast<const uint4*>(src));
  const int s = row ? (a.idx ? __ldg(a.idx + b) : a.start) : 0;

  // bf16 to fp32 exactly: the bf16 bits are the float's high half
  const float x[8] = {__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                      __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u),
                      __uint_as_float(raw.z << 16), __uint_as_float(raw.z & 0xffff0000u),
                      __uint_as_float(raw.w << 16), __uint_as_float(raw.w & 0xffff0000u)};
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) amax = fmaxf(amax, fabsf(x[c]));
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (!lane) return;

  const float scale = fmaxf(amax / 127.0f, 1e-8f);
  const int pos = clamped_start(s, a.T, a.t) + j;
  int8_t* dst = (which ? a.v8 : a.k8) + b * a.c_sb + h * a.c_sh + (long long)pos * a.D + g * 8;
  *reinterpret_cast<uint2*>(dst) = make_uint2(quantize4(x, scale), quantize4(x + 4, scale));
  if (g == 0) (which ? a.vs : a.ks)[b * a.s_sb + h * a.s_sh + pos] = __float2half_rn(scale);
}

// Any D and alignment: one warp a row, the row read twice.
__global__ void __launch_bounds__(kThreads) kv_quantize_write_rows_kernel(const QuantArgs a) {
  const int which = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (r >= a.rows) return;  // the whole warp: r is the warp's
  const int j = r % a.t, bh = r / a.t, h = bh % a.H, b = bh / a.H;
  const __nv_bfloat16* src = (which ? a.v : a.k) + b * a.x_sb + h * a.x_sh + j * a.x_st;
  wait_for_previous_grid();
  float amax = 0.f;
  for (int i = lane; i < a.D; i += 32) amax = fmaxf(amax, fabsf(__bfloat162float(src[i])));
  amax = myriad::warp_max(amax);
  const float scale = fmaxf(amax / 127.0f, 1e-8f);
  const int pos = clamped_start(a.idx ? a.idx[b] : a.start, a.T, a.t) + j;
  int8_t* dst = (which ? a.v8 : a.k8) + b * a.c_sb + h * a.c_sh + (long long)pos * a.D;
  for (int i = lane; i < a.D; i += 32) dst[i] = quantize(__bfloat162float(src[i]), scale);
  if (lane == 0) (which ? a.vs : a.ks)[b * a.s_sb + h * a.s_sh + pos] = __float2half_rn(scale);
}

template <typename Args>
int launch(void (*kernel)(Args), unsigned blocks, unsigned y, const Args& a, void* stream) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, y, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

unsigned blocks_for(int rows, int rows_per_block) {
  return static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block);
}

template <int G>
int launch_quantize(const QuantArgs& a, void* stream) {
  return launch(kv_quantize_write_kernel<G>, blocks_for(a.rows, kThreads / G), 2, a, stream);
}

}  // namespace

// buf (B, H, T, D) and upd (B, H, t, D) of one element type of `elem` bytes,
// given by their element strides; buf's positions are rows of D elements one
// after the other (stride D, last dim contiguous), upd's last dim is
// contiguous.  idx (B,) int32 per-row starts, or null to start every row at
// `start`.
extern "C" int myriad_kv_write(void* buf, const void* upd, const void* idx, int start, int B,
                               int H, int t, int T, int D, int elem, long long buf_sb,
                               long long buf_sh, long long upd_sb, long long upd_sh,
                               long long upd_st, void* stream) {
  const long long e = elem, row_bytes = (long long)D * e;
  if (B * H * t == 0 || row_bytes == 0) return 0;
  CopyArgs a = {static_cast<char*>(buf), static_cast<const char*>(upd),
                static_cast<const int*>(idx), start, B * H * t, H, t, T, 0, 0, buf_sb * e,
                buf_sh * e, upd_sb * e, upd_sh * e, upd_st * e, row_bytes};
  // 16-byte units where the row and every address allow them, else bytes
  const bool vec = ((reinterpret_cast<uintptr_t>(buf) | reinterpret_cast<uintptr_t>(upd) |
                     a.buf_sb | a.buf_sh | a.upd_sb | a.upd_sh | a.upd_st | row_bytes) &
                    15) == 0;
  a.units = static_cast<int>(vec ? row_bytes / 16 : row_bytes);
  while ((1 << a.log_g) < a.units && a.log_g < 5) ++a.log_g;
  const unsigned blocks = blocks_for(a.rows, kThreads >> a.log_g);
  return vec ? launch(kv_write_kernel<uint4>, blocks, 1, a, stream)
             : launch(kv_write_kernel<uint8_t>, blocks, 1, a, stream);
}

// k8, v8 (B, H, T, D) int8 with element strides (c_sb, c_sh, D, 1); ks, vs
// (B, H, T, 1) fp16 with strides (c_sb / D, c_sh / D, 1); k, v (B, H, t, D)
// bf16 with strides (x_sb, x_sh, x_st, 1); idx as above.
extern "C" int myriad_kv_quantize_write(void* k8, void* v8, void* ks, void* vs, const void* k,
                                        const void* v, const void* idx, int start, int B, int H,
                                        int t, int T, int D, long long c_sb, long long c_sh,
                                        long long x_sb, long long x_sh, long long x_st,
                                        void* stream) {
  if (B * H * t == 0 || D == 0) return 0;
  const QuantArgs a = {static_cast<int8_t*>(k8), static_cast<int8_t*>(v8),
                       static_cast<__half*>(ks), static_cast<__half*>(vs),
                       static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
                       static_cast<const int*>(idx), start, B * H * t, H, t, T, D, c_sb, c_sh,
                       c_sb / D, c_sh / D, x_sb, x_sh, x_st};
  // 16-byte loads of K and V, 8-byte stores of the payload
  const bool vec = D % 8 == 0 && D <= 256 &&
                   ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15) == 0 &&
                   ((reinterpret_cast<uintptr_t>(k8) | reinterpret_cast<uintptr_t>(v8)) & 7) == 0 &&
                   ((x_sb | x_sh | x_st | c_sb | c_sh) & 7) == 0;
  if (!vec) {
    return launch(kv_quantize_write_rows_kernel, blocks_for(a.rows, kThreads / 32), 2, a, stream);
  }
  const int lanes = D / 8;
  if (lanes <= 1) return launch_quantize<1>(a, stream);
  if (lanes <= 2) return launch_quantize<2>(a, stream);
  if (lanes <= 4) return launch_quantize<4>(a, stream);
  if (lanes <= 8) return launch_quantize<8>(a, stream);
  if (lanes <= 16) return launch_quantize<16>(a, stream);
  return launch_quantize<32>(a, stream);
}
