// Flash attention forward for Hopper (sm_90a) on the tensor cores, bf16:
// O = softmax(mask(cap(s·QKᵀ)))·V.
//
// Replaces, for bf16 q, k, v, the TPU kernel src/repro/kernels/flash_attention/
// kernel.py::flash_attention_pallas (_flash_kernel); f32 stays on the FFMA
// kernel of flash_attention.cu.  Same function as that kernel and as ref.py's
// attention_ref: q (B,Hq,Sq,D), k (B,Hkv,Skv,D), v (B,Hkv,Skv,Dv) in bf16, an
// online softmax with f32 statistics and f32 accumulators; query head h reads
// KV head h / (Hq/Hkv) (GQA by index, no copy); per score: scale, then the
// tanh soft-cap (accurate tanhf), then the mask — causal with the ends aligned
// (row i stands at key position i + Skv - Sq) and the sliding window
// rows - cols < window.  A row with no unmasked key gives exactly 0.  KV tiles
// wholly above the diagonal or outside the window are never loaded; ragged
// Sq/Skv are masked here; Dv may differ from D (both at most 256).
//
// What bounds it: at the gemma2-2b prefill (B=2, Hq=8, Hkv=4, S=8192,
// D=Dv=256) ~5.5e11 FLOP per global layer against ~67 MB of I/O, so the
// tensor cores' bf16 rate bounds it (0.556 ms at 989 TFLOP/s).  Only wgmma
// reaches that rate.
//
// Design:
// * One CTA of 256 threads per (128 query rows, head, batch): two consumer
//   warpgroups of 64 rows share each K/V tile of 64 keys.  Query blocks run
//   last-first, so the causal blocks with the most tiles start first.
// * TMA loads Q once and keeps a 2-stage K/V ring: while the warpgroups work
//   on tile t, tile t + 1 is in flight.  One elected thread issues the copies;
//   each stage has one mbarrier (expect_tx), and a __syncthreads() after the
//   last read of a stage frees it for tile t + 2.  The 4-D tensor maps (d and
//   the caller's s/h/b strides, built on the host for each call) read the
//   model's transposed views in place.  D and Dv are padded in shared memory
//   to DP, a multiple of 64, by TMA's zero fill of out-of-bounds columns; the
//   128-byte swizzle (64 bf16 columns a box) matches the wgmma descriptors.
//   Shared memory at DP = 256: Q 64 KB + 2 × (K 32 KB + V 32 KB) = 192 KB.
// * S = Q·Kᵀ: wgmma m64n64k16, A = Q and B = K (K-major) from shared memory,
//   f32 accumulators.  Scale, soft-cap, mask and the online softmax run on the
//   accumulator fragment in registers; a row lies in the 4 threads of a quad,
//   so its max is two shuffles.
// * O += P·V: wgmma m64nDPk16, A = P from registers (the f32 S fragment maps
//   onto the bf16 A fragment as it is), B = the V tile read MN-major.  One
//   bf16 P would round each probability to 2^-9: at gemma2's shapes that moves
//   outputs near 1 by one bf16 step (7.8e-3), past the smoke's 6e-3.  So P
//   goes in as three bf16 terms, hi + mid + lo (exact to ~2^-24, as f32), and
//   PV costs three products: the kernel does 2x the tensor work of one-term
//   flash attention.  The tensor cores' f32 accumulation still leaves its
//   outputs off the exact ones ~1.6x as often as an f32 computation's
//   (chip_smoke.py allows 2x).  Chained onto the running O in the tensor
//   cores' accumulator, the tile's 12 products put outputs up to 1.1e-5
//   past half a bf16 step from the exact attention on zamba2-7b's real
//   inputs (D 112; the smoke's gate allows 5.6e-6).  So where the registers
//   allow (DP <= 128) they go into an accumulator of the tile's own, the
//   smallest terms first, and O = O·alpha + tile is taken on the CUDA
//   cores: 3.0e-7 past half a step at most, at the same speed (chip_smoke.py
//   on an H100).  At DP 192 and 256 a second accumulator of DP/2 floats a
//   thread does not fit beside O's in 255 registers: there the products
//   chain onto O, and gemma2-2b's shapes stay within the gate.
// * Epilogue: each row divides by its sum l (l == 0 divides by 1: 0), rounds
//   to bf16 and stores by strides, rows past Sq masked.
// No warp specialisation, no persistent CTAs, no clusters: one
// __syncthreads() per tile keeps the two warpgroups in step, so little
// tensor work runs under either one's softmax.
//
// Plain C interface (built with nvcc into the flash_attention library,
// loaded with ctypes): the caller owns every allocation and the stream; one
// call launches one kernel.  cuTensorMapEncodeTiled is reached through
// cudaGetDriverEntryPoint, so the library does not link libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// The caller's layout of one of q, k, v as a tensor map: dims[0] = d, then
// s, h, b in the order of their strides (perm: the map dim of s in bits 0-1
// and of h in bits 2-3; b has the third), strides in bytes of dims 1-3, and
// the box (64 columns, rows along s, 1 along h and b).
// (Outside the unnamed namespace: the extern "C" entry point takes it.)
struct MapSpec {
  long long dims[4];
  long long strides[3];
  int box[4];
  int perm;
};

namespace {

constexpr int BQ = 128;         // query rows per CTA (two warpgroups of 64)
constexpr int BKV = 64;         // keys per tile
constexpr int THREADS = 256;
constexpr int BOX_COLS = 64;    // bf16 columns per TMA box: one 128-byte swizzle row
constexpr int MAX_DIM = 256;
constexpr int kEncodeError = 1000;   // + CUresult of cuTensorMapEncodeTiled

struct Params {
  void* o;
  long long o_b, o_h, o_s, o_d;  // element strides of the output
  int sq, skv, dv, group;        // group = Hq / Hkv
  int causal, window;
  float scale, softcap, inv_cap;
  int q_perm, k_perm, v_perm;
};

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

// Wait for the phase of `bar` with this parity.  A copy that never lands
// (a tensor map that does not fit the expected bytes) traps after ~10 s of
// clock instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > 20000000000ll) __trap();
  }
}

// One box of a 4-D tensor map into shared memory; completion to `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int col,
                                         int s, int h, int b, int perm) {
  const int ps = perm & 3, ph = (perm >> 2) & 3;
  const int c1 = ps == 1 ? s : (ph == 1 ? h : b);
  const int c2 = ps == 2 ? s : (ph == 2 ? h : b);
  const int c3 = ps == 3 ? s : (ph == 3 ? h : b);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (in 16-byte units), layout type 1 (SW128).  The
// swizzle atom (8 rows of 128 bytes) must sit on a 1024-byte boundary.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses to wgmma's registers across the
// asynchronous window between issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 64, f32) {+}= A (64 x 16, smem desc) * B (64 x 16 K-major, smem desc)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64 MN-major, smem desc)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128 MN-major, smem desc)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 192, f32) += A (64 x 16, bf16 registers) * B (16 x 192 MN-major, smem desc)
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, f32) += A (64 x 16, bf16 registers) * B (16 x 256 MN-major, smem desc)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&acc)[DP / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DP == 64) {
    wgmma_rs_n64(acc, a, db);
  } else if constexpr (DP == 128) {
    wgmma_rs_n128(acc, a, db);
  } else if constexpr (DP == 192) {
    wgmma_rs_n192(acc, a, db);
  } else {
    wgmma_rs_n256(acc, a, db);
  }
}

// p ≈ hi + mid + lo, each a bf16 pair (the A fragment's packing: the lower
// column in the low half); exact to ~2^-24 of p.
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  float2 f = __bfloat1622float2(h);
  a -= f.x;
  b -= f.y;
  __nv_bfloat162 m = __floats2bfloat162_rn(a, b);
  f = __bfloat1622float2(m);
  __nv_bfloat162 l = __floats2bfloat162_rn(a - f.x, b - f.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  mid = *reinterpret_cast<uint32_t*>(&m);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

constexpr int Q_BLOCK = BQ * 128;     // bytes of one 64-column block of the Q tile
constexpr int KV_BLOCK = BKV * 128;   // bytes of one 64-column block of a K or V tile

template <int DP>
__host__ __device__ constexpr int smem_bytes() {
  // Q, two stages of K and V, three mbarriers, and slack to align to 1024
  return DP / 64 * Q_BLOCK + 2 * 2 * (DP / 64) * KV_BLOCK + 64 + 1024;
}

// The K and V tiles of keys kv0 .. kv0 + 63 into one stage of the ring (K's
// NB column blocks, then V's), completing on that stage's mbarrier.
template <int NB>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                        uint32_t bar, uint32_t dst, int kv0, int hk, int b,
                                        int k_perm, int v_perm) {
  mbar_expect_tx(bar, 2 * NB * KV_BLOCK);
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    tma_load(dst + c * KV_BLOCK, tk, bar, c * BOX_COLS, kv0, hk, b, k_perm);
    tma_load(dst + (NB + c) * KV_BLOCK, tv, bar, c * BOX_COLS, kv0, hk, b, v_perm);
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int NB = DP / 64;                       // 64-column blocks of each tile
  constexpr int STAGE = 2 * NB * KV_BLOCK;          // K blocks, then V blocks
  constexpr uint32_t Q_BYTES = NB * Q_BLOCK;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + Q_BYTES;              // stage st at kv_s + st * STAGE
  const uint32_t bar_q = kv_s + 2 * STAGE;          // then bar_kv[st] at bar_q + 8 + 8 st

  const int tid = threadIdx.x;
  const int wg = tid >> 7;                          // consumer warpgroup: rows 64 wg ..
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int qblk = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int q0 = qblk * BQ;
  const int nrows = min(BQ, p.sq - q0);
  const int off = p.skv - p.sq;                     // row i stands at key position i + off

  // keys this block can see: [kv_lo, kv_hi), kv_lo on a tile boundary
  int kv_hi = p.skv;
  if (p.causal) kv_hi = min(kv_hi, q0 + nrows + off);
  int kv_lo = 0;
  if (p.window > 0) kv_lo = max(0, q0 + off - p.window + 1);
  kv_lo = (kv_lo / BKV) * BKV;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BKV - 1) / BKV : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q + 8, 1);
    mbar_init(bar_q + 16, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, Q_BYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      tma_load(q_s + c * Q_BLOCK, &tq, bar_q, c * BOX_COLS, q0, h, b, p.q_perm);
    for (int t = 0; t < 2 && t < n_tiles; ++t)
      load_kv<NB>(&tk, &tv, bar_q + 8 + 8 * (t & 1), kv_s + (t & 1) * STAGE, kv_lo + t * BKV,
                  hk, b, p.k_perm, p.v_perm);
  }

  // This thread's accumulator rows r0 and r0 + 8, and the column of its first
  // value in each 8-column group of a fragment.
  const int r0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
  const int pos0 = r0 + off, pos1 = pos0 + 8;
  const int cq = 2 * (lane & 3);
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  const uint32_t q_wg = q_s + wg * 64 * 128;        // this warpgroup's rows of each Q block
  // the rows of this warpgroup, for skipping the mask on interior tiles
  const int wg_pos_lo = q0 + wg * 64 + off, wg_pos_hi = wg_pos_lo + 63;

  mbar_wait(bar_q, 0);
  __syncwarp();
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1, kv0 = kv_lo + t * BKV;
    const uint32_t k_st = kv_s + st * STAGE, v_st = k_st + NB * KV_BLOCK;
    mbar_wait(bar_q + 8 + 8 * st, (t >> 1) & 1);
    __syncwarp();

    // S = Q Kᵀ for this warpgroup's 64 rows and the tile's 64 keys
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t da = sw128_desc(q_wg + (kk >> 2) * Q_BLOCK + (kk & 3) * 32, 16, 1024);
      const uint64_t db = sw128_desc(k_st + (kk >> 2) * KV_BLOCK + (kk & 3) * 32, 16, 1024);
      wgmma_ss_n64(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale, soft-cap, mask; the tile's row maxima.  s[v] is row r0 + 8·((v>>1)&1),
    // key kv0 + 8·(v>>2) + cq + (v&1).
    const bool interior = kv0 + BKV <= p.skv &&
                          (!p.causal || kv0 + BKV - 1 <= wg_pos_lo) &&
                          (p.window <= 0 || wg_pos_hi - kv0 < p.window);
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      float x = s[v] * p.scale;
      if (p.softcap > 0.f) x = p.softcap * tanhf(x * p.inv_cap);
      if (!interior) {
        const int col = kv0 + 8 * (v >> 2) + cq + (v & 1);
        const int pos = (v & 2) ? pos1 : pos0;
        bool ok = col < p.skv;
        if (p.causal) ok = ok && pos >= col;
        if (p.window > 0) ok = ok && pos - col < p.window;
        if (!ok) x = -CUDART_INF_F;
      }
      s[v] = x;
      if (v & 2) mx1 = fmaxf(mx1, x);
      else mx0 = fmaxf(mx0, x);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // alpha = 0 while m is still -inf; a row with nothing unmasked yet keeps p = 0
    const float alpha0 = mn0 == -CUDART_INF_F ? 1.f : exp2f((m0 - mn0) * LOG2E);
    const float alpha1 = mn1 == -CUDART_INF_F ? 1.f : exp2f((m1 - mn1) * LOG2E);
    m0 = mn0;
    m1 = mn1;

    // P in three bf16 terms; pair i is s[2i], s[2i+1], row r0 + 8·(i&1)
    uint32_t phi[16], pmid[16], plo[16];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float mr = (i & 1) ? mn1 : mn0;
      const float a = mr == -CUDART_INF_F ? 0.f : exp2f((s[2 * i] - mr) * LOG2E);
      const float c = mr == -CUDART_INF_F ? 0.f : exp2f((s[2 * i + 1] - mr) * LOG2E);
      if (i & 1) rs1 += a + c;
      else rs0 += a + c;
      split3(a, c, phi[i], pmid[i], plo[i]);
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;

    // O += P V: keys 16 kk .. 16 kk + 15 of the V tile, read MN-major (rows of
    // 128 bytes, 8-row groups 1024 bytes apart, 64-column blocks KV_BLOCK apart)
    fence_regs(phi);
    fence_regs(pmid);
    fence_regs(plo);
    if constexpr (DP <= 128) {
      // the tile's 12 products into registers of their own, the smallest
      // terms first, then acc = acc·alpha + tile on the CUDA cores
      float tile[DP / 2];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) tile[i] = 0.f;
      fence_regs(tile);
      wgmma_fence();
#pragma unroll
      for (int term = 2; term >= 0; --term)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t* pt = term == 0 ? phi : (term == 1 ? pmid : plo);
          const uint32_t a[4] = {pt[4 * kk], pt[4 * kk + 1], pt[4 * kk + 2], pt[4 * kk + 3]};
          wgmma_pv<DP>(tile, a, sw128_desc(v_st + kk * 16 * 128, KV_BLOCK, 1024));
        }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(tile);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j] = fmaf(acc[4 * j], alpha0, tile[4 * j]);
        acc[4 * j + 1] = fmaf(acc[4 * j + 1], alpha0, tile[4 * j + 1]);
        acc[4 * j + 2] = fmaf(acc[4 * j + 2], alpha1, tile[4 * j + 2]);
        acc[4 * j + 3] = fmaf(acc[4 * j + 3], alpha1, tile[4 * j + 3]);
      }
    } else {
      // no room for a second accumulator: the products chain onto acc
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j] *= alpha0;
        acc[4 * j + 1] *= alpha0;
        acc[4 * j + 2] *= alpha1;
        acc[4 * j + 3] *= alpha1;
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = sw128_desc(v_st + kk * 16 * 128, KV_BLOCK, 1024);
        const uint32_t a_hi[4] = {phi[4 * kk], phi[4 * kk + 1], phi[4 * kk + 2], phi[4 * kk + 3]};
        const uint32_t a_mid[4] = {pmid[4 * kk], pmid[4 * kk + 1], pmid[4 * kk + 2],
                                   pmid[4 * kk + 3]};
        const uint32_t a_lo[4] = {plo[4 * kk], plo[4 * kk + 1], plo[4 * kk + 2], plo[4 * kk + 3]};
        wgmma_pv<DP>(acc, a_hi, db);
        wgmma_pv<DP>(acc, a_mid, db);
        wgmma_pv<DP>(acc, a_lo, db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }

    __syncthreads();                                // both warpgroups are done with stage st
    if (tid == 0 && t + 2 < n_tiles)
      load_kv<NB>(&tk, &tv, bar_q + 8 + 8 * st, kv_s + st * STAGE, kv_lo + (t + 2) * BKV, hk, b,
                  p.k_perm, p.v_perm);
  }

  // epilogue: the row sums over the quad, O / l (l == 0: a fully masked row, 0)
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_b + h * p.o_h;
  if (r0 < p.sq) {
    __nv_bfloat16* row = og + r0 * p.o_s;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + cq + e;
        if (col < p.dv) row[col * p.o_d] = __float2bfloat16(acc[4 * j + e] / d0);
      }
  }
  if (r0 + 8 < p.sq) {
    __nv_bfloat16* row = og + (r0 + 8) * p.o_s;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + cq + e;
        if (col < p.dv) row[col * p.o_d] = __float2bfloat16(acc[4 * j + 2 + e] / d1);
      }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
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

// 0, or kEncodeError + the CUresult of a refused map.
int make_map(CUtensorMap* map, const void* ptr, const MapSpec& m) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kEncodeError + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], elem_strides[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dims[i] = static_cast<cuuint64_t>(m.dims[i]);
    box[i] = static_cast<cuuint32_t>(m.box[i]);
  }
  for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(m.strides[i]);
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <int DP>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const Params& p,
           int batch, int hq, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel_wgmma<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + BQ - 1) / BQ, hq, batch);
  flash_attention_kernel_wgmma<DP><<<grid, THREADS, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Enqueue bf16 attention on the tensor cores on `stream`.  q, k, v are
// described by their tensor maps (qm, km, vm: see MapSpec; ops.py's
// tma_plan builds them); o is a bf16 device array addressed by element
// strides os (o[b][h][s][d] at b*os[0] + h*os[1] + s*os[2] + d*os[3]).  dp is
// the padded head dim (64, 128, 192 or 256, at least max(d, dv)).  Requires
// hq % hkv == 0, sq, skv >= 1, batch and hq < 65536.  `window` <= 0 means no
// window, `softcap` <= 0 no soft-cap.  Returns 0 when the kernel was launched,
// else a cudaError_t, or kEncodeError + the CUresult of a refused tensor map.
int repro_flash_attention_tc(const void* q, const void* k, const void* v, void* o,
                             const MapSpec* qm, const MapSpec* km, const MapSpec* vm,
                             const long long* os, int batch, int hq, int hkv, int sq, int skv,
                             int d, int dv, int dp, int causal, int window, float softcap,
                             float scale, void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 || d < 1 || dv < 1 ||
      d > MAX_DIM || dv > MAX_DIM || batch > 65535 || hq > 65535 || dp % 64 != 0 || dp < d ||
      dp < dv || dp > MAX_DIM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, *qm);
  if (rc == 0) rc = make_map(&tk, k, *km);
  if (rc == 0) rc = make_map(&tv, v, *vm);
  if (rc != 0) return rc;
  Params p;
  p.o = o;
  p.o_b = os[0]; p.o_h = os[1]; p.o_s = os[2]; p.o_d = os[3];
  p.sq = sq; p.skv = skv; p.dv = dv; p.group = hq / hkv;
  p.causal = causal; p.window = window;
  p.scale = scale; p.softcap = softcap; p.inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  p.q_perm = qm->perm; p.k_perm = km->perm; p.v_perm = vm->perm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dp == 64) return launch<64>(tq, tk, tv, p, batch, hq, s);
  if (dp == 128) return launch<128>(tq, tk, tv, p, batch, hq, s);
  if (dp == 192) return launch<192>(tq, tk, tv, p, batch, hq, s);
  return launch<256>(tq, tk, tv, p, batch, hq, s);
}

const char* repro_flash_tc_error_string(int code) {
  if (code >= kEncodeError) return "cuTensorMapEncodeTiled refused the tensor map (code - 1000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
