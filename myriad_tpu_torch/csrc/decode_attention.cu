// Single-query attention over the KV cache for one decode step: kernel B2,
// and kernel B2', the same function with the splits merged by a second
// launch.
//
// Replaces myriad_tpu/ops/decode_attention.py::_decode_kernel, reached
// through decode_attention -> _decode_attention_padded (pallas_call).  For
// each (batch row, head) it computes, as the TPU kernel does:
//   s[t] = (q . K[t]) * k_scale[t] * scale + mask[b, t]        (fp32)
//   p[t] = exp(s[t] - max s);  denom = sum p
//   out  = (sum_t p[t] * v_scale[t] * V[t]) / denom
// over the first kv_len cache positions only, read through strides, so a
// staged decode step reads the valid prefix of the cache with no slice copy.
// K/V are int8 (with fp16 per-position scales) or bf16; q and out are bf16;
// v_scale multiplies p before p.V, everything is fp32, and the division by
// the denominator comes last.  A null mask adds nothing.
//
// What bounds it on the card: each (b, h) reads 2 * kv_len * D cache bytes
// and does about 4 * kv_len * D operations, so the bytes of the cache bound
// it.  One block per (b, h) gives 256 blocks at batch 8, too few loads in
// flight to stream the cache.  So B2 splits the positions of every (b, h)
// over blocks: grid (split, head, batch row), split count from
// myriad::split_plan for a target of two blocks an SM
// (kClusterTargetBlocks), at least one 64-position tile a split.  Each
// block runs the body of B2' (split_attention.cuh: 16-byte cp.async loads
// into a two-stage ring, a running max and sum, the exact int8
// byte-permute).  The splits of one (b, h) are one thread-block cluster,
// launched in one cudaLaunchKernelEx: each block writes its partial (m, l,
// o) into its slot of rank 0's shared memory (distributed shared memory)
// and leaves after a cluster barrier; rank 0 then merges the slots in rank
// order and writes bf16(o / l) (merge_cluster_splits), so two runs give the
// same bits, with no scratch tensor and no second launch.  With one split
// (kv_len <= 64) the block writes its output directly and the launch has no
// cluster.  At B=8, H=32, kv_len=320: 2 splits of 3 and 2 tiles, 512 blocks.
//
// The cluster caps the splits at 8, the portable cluster size.  The cap
// binds where fewer than 33 (b, h) pairs run (batch 1 at H = 32) and the
// cache is longer than 8 tiles.  At batch 1 and kv_len 8192, B2' splits
// each pair 33 ways, 1,056 blocks, where B2 makes 256 blocks of 16 tiles
// each: two blocks an SM with at most two tiles in flight a block, so a long
// cache at batch 1 streams at a fraction of the card's rate (chip_smoke.py
// phase 2 times it beside B2').
//
// Kernel B2' replaces myriad_tpu/ops/decode_attention.py::_decode_rows_kernel
// (decode_attention_rows -> _rows_local_call, pallas_call): the same math
// with one program per batch row and all heads resident, which the TPU used
// to turn many small per-(b, h) DMAs into two large ones.  That reason does
// not exist on the card.  B2' runs the same (split, head, batch row) blocks
// as B2 without a cluster: each block writes its partial (m, l, o) to a
// scratch tensor, and a second launch merges the splits in split order
// (myriad::merge_splits).  Shared memory holds two 64-position tiles, not
// the scores of the whole cache, so both take any kv_len.  B2' stays an
// opt-in dispatch (MYRIAD_DECODE_ATTN=row).

#include "common.cuh"
#include "split_attention.cuh"

namespace {

// Blocks a B2 launch aims at, two for each SM.  The blocks of a cluster
// wait for each other at the merge, so a launch that needs a second wave of
// blocks waits on the slowest of the first: at two an SM every block of the
// launch is resident at once (the card holds five of these blocks an SM),
// whatever the batch.  On an H100 this ran faster than four or eight an SM
// at batch 8 for kv_len 320 and 8192.
constexpr int kClusterTargetBlocks = 2 * myriad::kSMs;
// Blocks a B2' launch aims at, eight for each SM: one query row leaves a
// block little work a tile, and on an H100 eight a SM ran faster than four
// at batch 8 for kv_len 320 and 8192.
constexpr int kRowsTargetBlocks = 8 * myriad::kSMs;

template <typename KV, bool kVec>
__global__ void __launch_bounds__(myriad::kSplitThreads)
decode_attention_cluster_kernel(const myriad::SplitArgs a) {
  myriad::split_attention<KV, 1, false, kVec, true>(a);
  if (a.splits > 1) myriad::merge_cluster_splits<KV, 1>(a, false);
}

// B2's kernel and launch configuration for `a`: grid (splits, H, B), and a
// cluster of the splits when there is more than one.  `attr` holds the
// cluster's dimension for the configuration.
template <typename KV>
cudaError_t configure(const myriad::SplitArgs& a, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr, void (**kernel)(myriad::SplitArgs)) {
  const size_t smem =
      myriad::split_smem_bytes<KV, 1>() + (a.splits > 1 ? myriad::inbox_bytes<1>() : 0);
  *kernel = myriad::vec_ok<KV>(a.k, a.v, a.D, a.kv_sb, a.kv_sh, a.kv_st)
                ? &decode_attention_cluster_kernel<KV, true>
                : &decode_attention_cluster_kernel<KV, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = a.splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(a.splits, a.H, a.B);
  cfg->blockDim = dim3(myriad::kSplitThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = a.splits > 1 ? 1 : 0;
  return cudaSuccess;
}

template <typename KV>
int launch(const myriad::SplitArgs& a, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  void (*kernel)(myriad::SplitArgs);
  cudaError_t e = configure<KV>(a, stream, &cfg, &attr, &kernel);
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

myriad::SplitArgs decode_args(const void* q, const void* k, const void* v, const void* k_scale,
                              const void* v_scale, const void* mask, void* out, int B, int H,
                              int D, int kv_len, long long kv_sb, long long kv_sh,
                              long long kv_st, long long sc_sb, long long sc_sh,
                              long long sc_st, float scale) {
  const myriad::SplitPlan plan =
      myriad::split_plan(B * H, kv_len, kClusterTargetBlocks, myriad::kMaxClusterSplits);
  return {static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const __half*>(k_scale),
          static_cast<const __half*>(v_scale), static_cast<const float*>(mask), nullptr,
          static_cast<__nv_bfloat16*>(out), nullptr, B, H, 1, D, kv_len, plan.splits,
          plan.keys_per_split, kv_sb, kv_sh, kv_st, sc_sb, sc_sh, sc_st, scale};
}

template <typename KV, bool kVec>
__global__ void __launch_bounds__(myriad::kSplitThreads)
decode_attention_rows_split_kernel(const myriad::SplitArgs a) {
  myriad::split_attention<KV, 1, false, kVec>(a);
}

__global__ void __launch_bounds__(myriad::kSplitThreads)
decode_attention_rows_merge_kernel(const myriad::SplitArgs a) {
  myriad::merge_split_rows(a, false);
}

template <typename KV>
int launch_rows(myriad::SplitArgs a, cudaStream_t stream) {
  constexpr size_t smem = myriad::split_smem_bytes<KV, 1>();
  const bool vec = myriad::vec_ok<KV>(a.k, a.v, a.D, a.kv_sb, a.kv_sh, a.kv_st);
  return myriad::launch_split(vec ? &decode_attention_rows_split_kernel<KV, true>
                                  : &decode_attention_rows_split_kernel<KV, false>,
                              &decode_attention_rows_merge_kernel, smem, a, stream);
}

}  // namespace

// Floats of scratch kernel B2' needs for these widths (0: none).
extern "C" long long myriad_decode_attention_rows_scratch(int B, int H, int D, int kv_len) {
  return myriad::split_scratch_floats(B, H, 1, D, kv_len, kRowsTargetBlocks);
}

// Kernel B2': the arguments of myriad_decode_attention below, plus `scratch`
// of myriad_decode_attention_rows_scratch floats (null when that is 0).
extern "C" int myriad_decode_attention_rows(const void* q, const void* k, const void* v,
                                            const void* k_scale, const void* v_scale,
                                            const void* mask, void* out, int B, int H, int D,
                                            int kv_len, long long kv_sb, long long kv_sh,
                                            long long kv_st, long long sc_sb, long long sc_sh,
                                            long long sc_st, int kv_int8, float scale,
                                            void* scratch, void* stream) {
  const myriad::SplitPlan plan = myriad::split_plan(B * H, kv_len, kRowsTargetBlocks);
  myriad::SplitArgs a{static_cast<const __nv_bfloat16*>(q), k, v,
                      static_cast<const __half*>(k_scale), static_cast<const __half*>(v_scale),
                      static_cast<const float*>(mask), nullptr,
                      static_cast<__nv_bfloat16*>(out), static_cast<float*>(scratch),
                      B, H, 1, D, kv_len, plan.splits, plan.keys_per_split,
                      kv_sb, kv_sh, kv_st, sc_sb, sc_sh, sc_st, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kv_int8 ? launch_rows<int8_t>(a, s) : launch_rows<__nv_bfloat16>(a, s);
}

// q (B, H, 1, D) bf16 contiguous; k, v (B, H, T, D) int8 or bf16 with element
// strides (kv_sb, kv_sh, kv_st) and a contiguous last dim, of which the first
// kv_len positions are read; k_scale, v_scale (B, H, T, 1) fp16 with strides
// (sc_sb, sc_sh, sc_st), or null for a bf16 cache; mask (B, kv_len) fp32
// additive, or null; out (B, H, 1, D) bf16.  D <= 128 and a multiple of 4.
// One launch; a launch the card refuses returns its error.
extern "C" int myriad_decode_attention(const void* q, const void* k, const void* v,
                                       const void* k_scale, const void* v_scale,
                                       const void* mask, void* out, int B, int H, int D,
                                       int kv_len, long long kv_sb, long long kv_sh,
                                       long long kv_st, long long sc_sb, long long sc_sh,
                                       long long sc_st, int kv_int8, float scale, void* stream) {
  const myriad::SplitArgs a = decode_args(q, k, v, k_scale, v_scale, mask, out, B, H, D, kv_len,
                                          kv_sb, kv_sh, kv_st, sc_sb, sc_sh, sc_st, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kv_int8 ? launch<int8_t>(a, s) : launch<__nv_bfloat16>(a, s);
}

// What a B2 launch at these widths (a contiguous cache of kv_len positions,
// D = 128) looks like: out[0] the splits of one (b, h), the blocks of a
// cluster; out[1] the dynamic shared memory of a block, bytes; out[2] how
// many such clusters the card holds at once (cudaOccupancyMaxActiveClusters,
// 0 with one split: no cluster).  Returns a CUDA error.
extern "C" int myriad_decode_attention_launch_info(int B, int H, int kv_len, int kv_int8,
                                                   int* out) {
  const long long st = myriad::kHeadDim;
  const myriad::SplitArgs a = decode_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                          nullptr, B, H, myriad::kHeadDim, kv_len, H * kv_len * st,
                                          kv_len * st, st, 0, 0, 0, 1.f);
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr;
  void (*kernel)(myriad::SplitArgs);
  cudaError_t e = kv_int8 ? configure<int8_t>(a, nullptr, &cfg, &attr, &kernel)
                          : configure<__nv_bfloat16>(a, nullptr, &cfg, &attr, &kernel);
  out[0] = a.splits;
  out[1] = static_cast<int>(cfg.dynamicSmemBytes);
  out[2] = 0;
  if (e == cudaSuccess && a.splits > 1) e = cudaOccupancyMaxActiveClusters(&out[2], kernel, &cfg);
  return static_cast<int>(e);
}
