// What the matmul library's kernels share (matmul.cu, matmul_wgmma.cu,
// matmul_narrow.cu): mbarrier waits that trap instead of hanging, 4-D TMA
// loads, and tensor maps encoded through the driver entry point, so the
// library does not link libcuda.

#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

// One operand as a 4-D f32 tensor map: dims[0] the contiguous axis, then the
// other three in the order of their strides (strides in bytes of dims 1-3),
// the box one copy brings, and perm: the map dim (1-3) of the first logical
// axis in bits 0-1 and of the second in bits 2-3 (the third takes the dim
// left).  Logical axes: for A (row within a row block, K block, row block),
// for B (row within a K block, column block, K block).  ops.py's TmaMap.spec
// gives the 12 values in this order.
struct MmMapSpec {
  long long dims[4];
  long long strides[3];
  int box[4];
  int perm;
};

constexpr int kEncodeError = 1000;                // + CUresult of cuTensorMapEncodeTiled

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// A consumer thread's release of a stage it has read with ordinary loads to
// the producer that refills it by TMA: the proxy fence orders this thread's
// reads (generic proxy) before the TMA's writes (async proxy), and the
// arrive releases them.  Every consumer thread arrives.
__device__ __forceinline__ void mbar_release_to_tma(uint32_t bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_arrive(bar);
}

// Wait for the phase of `bar` with this parity.  A copy that never lands (a
// tensor map that does not fit the expected bytes) traps after ~10 s of
// clock instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > 20000000000ll) __trap();
  }
}

// One box of a 4-D tensor map into shared memory, completion to `bar`: c0
// along the contiguous dim, x1..x3 along the logical axes placed by perm.
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                          int x1, int x2, int x3, int perm) {
  const int d1 = perm & 3, d2 = (perm >> 2) & 3;
  const int c1 = d1 == 1 ? x1 : (d2 == 1 ? x2 : x3);
  const int c2 = d1 == 2 ? x1 : (d2 == 2 ? x2 : x3);
  const int c3 = d1 == 3 ? x1 : (d2 == 3 ? x2 : x3);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A map spec from its 12 flat values (dims, strides, box, perm).
inline MmMapSpec map_spec(const long long* d) {
  MmMapSpec m;
  for (int j = 0; j < 4; ++j) m.dims[j] = d[j];
  for (int j = 0; j < 3; ++j) m.strides[j] = d[4 + j];
  for (int j = 0; j < 4; ++j) m.box[j] = static_cast<int>(d[7 + j]);
  m.perm = static_cast<int>(d[11]);
  return m;
}

// 0, or kEncodeError + the CUresult of a refused map.  f32, out-of-bounds
// elements read as zeros.
inline int make_map(CUtensorMap* map, const void* ptr, const MmMapSpec& m,
                    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kEncodeError + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], elem_strides[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dims[i] = static_cast<cuuint64_t>(m.dims[i]);
    box[i] = static_cast<cuuint32_t>(m.box[i]);
  }
  for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(m.strides[i]);
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims,
                            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}
