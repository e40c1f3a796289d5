// The tensor memory accelerator's tile copies and the mbarriers they complete
// on, shared by the weight-only matrix products (B1, B5).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

namespace myriad {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// The issuing thread's arrival, announcing `bytes` of tensor copies.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// An arrival once the calling thread's earlier cp.async copies have landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One 2-D tile copy of the tensor memory accelerator into this block's
// shared memory, at column c0 and row c1 of `map`, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// The 2-D tensor map of a row-major (rows, cols) array at `base`, rows
// `row_bytes` apart, copied in boxes of box_rows x box_cols elements;
// encoded once for each set of these arguments and cached, since a map is
// a function of them alone and a model holds a few hundred weights.
inline cudaError_t tensor_map_2d(CUtensorMap* out, const void* base, CUtensorMapDataType type,
                                 uint64_t rows, uint64_t cols, uint64_t row_bytes,
                                 uint32_t box_rows, uint32_t box_cols,
                                 CUtensorMapSwizzle swizzle, CUtensorMapL2promotion l2) {
  struct Key {
    const void* base;
    uint64_t rows, cols, row_bytes;
    int type, box_rows, box_cols, swizzle, l2;
    bool operator==(const Key& o) const {
      return base == o.base && rows == o.rows && cols == o.cols && row_bytes == o.row_bytes &&
             type == o.type && box_rows == o.box_rows && box_cols == o.box_cols &&
             swizzle == o.swizzle && l2 == o.l2;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      return std::hash<const void*>()(k.base) ^ static_cast<size_t>(k.rows << 20) ^
             static_cast<size_t>(k.cols);
    }
  };
  static std::mutex mu;
  static std::unordered_map<Key, CUtensorMap, Hash> cache;
  const Key key{base, rows, cols, row_bytes, static_cast<int>(type), static_cast<int>(box_rows),
                static_cast<int>(box_cols), static_cast<int>(swizzle), static_cast<int>(l2)};
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  // the driver's encoder, looked up once through the runtime (no link
  // against libcuda); null where the driver has none
  static const PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t one[2] = {1, 1};
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t stride[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  CUtensorMap m;
  if (encode(&m, type, 2, const_cast<void*>(base), dims, stride, box, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, l2,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, m);
  *out = m;
  return cudaSuccess;
}

}  // namespace myriad
