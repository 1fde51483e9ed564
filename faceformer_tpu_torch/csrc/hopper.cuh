// Hopper's asynchronous copy machinery, shared by the kernels that use it
// (the fused decode step's GEMM, the pointer argmax): mbarriers, TMA tile
// loads into shared memory and stores out of it, and the host-side encoding
// of TMA tensor maps.
// Every map here uses the 128-byte swizzle: in each 1,024-byte block of 8
// rows of 128 bytes, the 16-byte chunk c of row r is stored at chunk
// c ^ (r % 8), so 8 rows read at one column hit 8 different bank groups.
// The destination of a load must be 1,024-byte aligned.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the header only; no -lcuda)

#include <initializer_list>

#include "common.cuh"

namespace ff {

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// after mbar_init, before any thread of the block uses the barriers
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Waits for the phase of `parity` to complete. A wait of more than ~2^33
// cycles (seconds) can only be a broken ring: it traps, so the launch fails
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 33)) __trap();
  } while (!done);
}

// TMA: the box at (c0 innermost, c1[, c2]) of `map` into shared memory at
// dst; its bytes complete a transaction on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// TMA: the box of shared memory at src into `map` at (c0 innermost, c1);
// elements past the tensor's edges are not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0), "r"(c1)
               : "memory");
}
// the stores issued so far by this thread: committed, and read out of
// shared memory before the thread goes on (the block may then exit)
__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// cuTensorMapEncodeTiled, from the driver the runtime already loaded
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A tensor of bf16 or fp32 as a TMA map: dims innermost first, the strides
// of the outer dims in elements, boxes of `box`, 128-byte swizzle (box[0]
// must span 128 bytes at most), zeros outside the tensor.
template <typename T, int RANK>
inline bool tma_map(CUtensorMap* map, const T* base, std::initializer_list<uint64_t> dims,
                    std::initializer_list<uint64_t> strides, std::initializer_list<uint32_t> box) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr || dims.size() != RANK || strides.size() != RANK - 1 ||
      box.size() != RANK)
    return false;
  cuuint64_t d[RANK], st[RANK > 1 ? RANK - 1 : 1];
  cuuint32_t b[RANK], unit[RANK];
  for (int i = 0; i < RANK; ++i) {
    d[i] = dims.begin()[i];
    b[i] = box.begin()[i];
    unit[i] = 1;
    if (i < RANK - 1) st[i] = strides.begin()[i] * sizeof(T);
  }
  const CUtensorMapDataType type = std::is_same<T, float>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, RANK, const_cast<T*>(base), d, st, b, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace ff
