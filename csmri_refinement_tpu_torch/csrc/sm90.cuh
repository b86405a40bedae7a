// Hopper (sm_90a) building blocks of the wgmma conv kernels (conv_chain.cu,
// conv_int8.cu): the SAME-padding source index, cp.async, proxy and wgmma
// fences, mbarriers, 2-D TMA loads with their tensor-map encoder, and the
// shared-memory descriptors of the planar halo (A) and of a 128-byte
// swizzled weight stage (B). Both kernels stage 16-byte pixel rows and
// 128-byte weight rows, so the descriptors are the same for bf16 and s8.

#pragma once

#include <cuda.h>  // CUtensorMap; the encoder is looked up at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

enum PadMode { kZero = 0, kReflect = 1, kReplicate = 2 };

// Source index of padded position i along an axis of length n, or -1 for a
// zero. Positions more than one pad beyond the image feed only outputs
// outside it (tile overhang); the clamp keeps their reads in bounds.
__device__ __forceinline__ int pad_index(int i, int n, int mode) {
  if (i >= 0 && i < n) return i;
  if (mode == kZero) return -1;
  if (mode == kReflect) i = i < 0 ? -i : 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16-byte copy; `bytes` < 16 zero-fills the rest (0: all zeros).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// cp.async and thread stores are generic-proxy writes; wgmma reads its
// operands through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// mbarriers and TMA tile loads: a TMA load copies a box of a tensor and
// counts its bytes on an mbarrier.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(map), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Descriptor of a K-major B tile with the 128-byte swizzle: rows of 128
// bytes of K (64 bf16 or 128 s8) for one output channel, 8-row groups 1024
// bytes apart (SBO), the leading offset unused (a 32-byte k step lies in
// one row). Also K5's s8 product's (probes/int8_prims.py::
// mma_descriptors).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// Descriptor of a K-major A tile without swizzle, read from the halo: 8 x
// 16-byte core matrices, row m (pixel m) 16 bytes after row m - 1, so
// 8-row groups 128 bytes apart (SBO); the second 16 bytes of a 32-byte k
// step are the next channel-group plane, `plane` bytes on (LBO).
__device__ __forceinline__ uint64_t a_desc(uint32_t addr, uint32_t plane) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((plane >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (the libraries link only the runtime); null if it is missing.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// The tensor map of a (rows, row_bytes) K-major weight operand, loaded a
// box of (box_bytes, box_rows) at a time with the 128-byte swizzle that
// b_desc names. Returns false if the encoder refuses it.
inline bool weight_map(CUtensorMap* map, const void* w, int row_bytes,
                       int rows, int box_bytes, int box_rows,
                       CUtensorMapDataType type, int elem_bytes) {
  const cuuint64_t dims[2] = {(cuuint64_t)(row_bytes / elem_bytes),
                              (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(box_bytes / elem_bytes),
                             (cuuint32_t)box_rows};
  const cuuint32_t ones[2] = {1, 1};
  const EncodeTiled enc = encode_tiled();
  return enc != nullptr &&
         enc(map, type, 2, const_cast<void*>(w), dims, stride, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
