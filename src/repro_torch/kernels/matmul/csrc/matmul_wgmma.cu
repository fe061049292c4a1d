// f32 matmul on Hopper's tensor cores (sm_90a): C = A @ B, accurate to f32,
// as three TF32 products ("3xTF32").
//
// Replaces, for f32 A (M,K) with M > 16 rows and B (K,N) with N > 32 columns,
// the TPU kernel src/repro/kernels/matmul/kernel.py::matmul_pallas
// (_matmul_kernel): the same function, f32 operands summed in f32, C in f32
// (or bf16).  Fewer rows stay on matmul_skinny_kernel, fewer columns and bf16
// on matmul_tile_kernel (matmul.cu); ops.py::route decides.  On the main path
// it is the FFNN train step's first product, z1 = X·W1, at speech-100k:
// (10000 x 1600) @ (1600 x 100000).
//
// What bounds it there: 3.2 TFLOP of f32 work.  f32 FFMA (67 TFLOP/s) needs
// 47.8 ms.  One TF32 product keeps 11 bits of each operand, and its z1
// crosses the limit the train path holds z1 to (atol 4e-4 + rtol 1e-5;
// a CPU model in tests/test_torch_matmul_tensor_cores.py).  Split each
// operand into a TF32 "big" term and a TF32 "small" term, x = big + small
// + O(2^-22 |x|); then a·b = big·big + big·small + small·big +
// O(2^-22 |a b|), three TF32 products of exact products summed in f32:
// 3 x 3.2 TFLOP at 495 TFLOP/s, 19.4 ms (the operations bound; the 4.7 GB
// of operands and output take 1.4 ms at 3.35 TB/s).
//
// Two kernels, each launched by its own entry point:
//
// * tf32_split_kernel: one operand into its two terms, as a (2, R, Kp) f32
//   array: [0] big, [1] small, each R rows of Kp values along K, K padded to
//   a multiple of 32 with zeros.  Both terms come from cvt.rna.tf32.f32
//   (round to nearest, ties away; the tensor cores would otherwise truncate
//   the low 13 bits), with the low 13 bits cleared.  tf32 wgmma takes K-major
//   operands only (the transpose bits exist for 16-bit types), so B (K,N) is
//   written transposed, as Bᵀ (N rows of K).  The pass reads an operand where
//   it lies, by the strides of its (rows | columns) view as four axes
//   (ops.py::blocked_view): the engine's blocked X and W1 are not copied.
//   32 x 32 tiles through shared memory, so reads and writes both coalesce.
//   Bound: bytes (the operand read once, two terms written).
// * matmul_tc_kernel: C = As·Bb + Ab·Bs + Ab·Bb from the two split arrays.
//   A block of 288 threads computes a 128 x 128 tile of C.  One producer
//   warp, one elected thread, streams the four 128 x 32 tiles of a K step (A
//   big and small, Bᵀ big and small: 64 KB) by TMA into a ring of 3 stages,
//   128-byte swizzled, with full/empty mbarriers and expect_tx.  Two
//   consumer warpgroups, 64 rows each, run wgmma.m64n128k8.f32.tf32.tf32
//   from shared memory, four k-steps of 8 a stage, in each k-step the two
//   small products first (as CUTLASS's 3xTF32 does), then big·big.  The
//   tensor cores add in f32 but truncate (round toward zero): chained over
//   all of K, an accumulator drifts toward zero by about half an ulp a
//   step: at K 1600 (600 steps), with N(0, 1) operands, 3.9% of a 300 x
//   1000 product's outputs lay outside the f32 limit (rtol 1e-5, atol
//   1e-5·√K), up to 2.3e-3 off (tests/test_torch_kernels_gpu.py on an
//   H100).  So a stage's 12 products go into an accumulator of their own
//   (64 registers a thread), and after wait_group 0 the stage's sum is added
//   into the f32 total (64 more) on the CUDA cores, which round to nearest;
//   the stage is freed as soon as its products are done, and the other
//   warpgroup's products run under the adds.
//   Tiles run in groups of 8 row tiles that walk the columns, so a wave of
//   blocks shares its A and Bᵀ panels in the 50 MB L2.  Ragged M, N come
//   back as zeros from TMA; ragged K is the split pass's zero padding.
//   Epilogue: masked stores from the accumulator (float2 where N is even: a
//   row pitch of 10 or 50 floats is off 16 bytes, so no TMA store).
//   Every mbarrier wait traps after ~10 s of clock instead of hanging.
//   Deterministic: a fixed order of products and k-steps, no atomics, so a
//   second launch is bit-identical, and so is the same matrix split from a
//   blocked view or a contiguous tensor.
//   Not here (later work, if the times call for it): a persistent grid that
//   overlaps one tile's epilogue with the next tile's loads, ping-pong
//   warpgroups, clusters.
//
// Plain C interface (built with nvcc into the matmul library with
// matmul.cu, loaded with ctypes): the caller owns every allocation and the
// stream; one call launches one kernel.  The mbarrier and tensor-map
// helpers are in tma.cuh.  Error codes follow matmul.cu's: a cudaError_t, or kEncodeError + the
// CUresult of a refused tensor map (repro_cuda_error_string there names
// both).

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"

// One operand of the split pass: element (i, j) of its (rows, cols) matrix at
// (i / r1)·s_r0 + (i % r1)·s_r1 + (j / c1)·s_c0 + (j % c1)·s_c1 elements
// from the base (rows = r0·r1, cols = c0·c1).
struct SplitArgs {
  long long r0, r1, c0, c1;
  long long s_r0, s_r1, s_c0, s_c1;
  long long kp;        // values a term row holds (K padded to a multiple of 32)
  long long transpose; // 0: term rows are the operand's rows; 1: its columns
};

namespace {

constexpr int SPLIT_TILE = 32;
constexpr int SPLIT_ROWS = 8;                   // threadIdx.y: rows read at a time
constexpr int TC_BM = 128;                      // rows of a C tile (2 warpgroups)
constexpr int TC_BN = 128;                      // columns of a C tile
constexpr int TC_BK = 32;                       // K a stage: one 128-byte swizzle row
constexpr int TC_STAGES = 3;
constexpr int TC_GROUP_M = 8;                   // row tiles a group walks the columns with
constexpr int TC_CONSUMERS = 256;
constexpr int TC_THREADS = TC_CONSUMERS + 32;   // and one producer warp
constexpr int TC_TILE_BYTES = TC_BM * TC_BK * 4;       // 16 KB (TC_BN == TC_BM)
constexpr int TC_STAGE_BYTES = 4 * TC_TILE_BYTES;      // A big, A small, Bᵀ big, Bᵀ small
constexpr int TC_SMEM = TC_STAGES * TC_STAGE_BYTES + 2 * 8 * TC_STAGES + 1024;

static_assert(TC_BN == TC_BM, "one box shape for A and Bᵀ tiles");

struct TcParams {
  void* c;
  int m, n;
  int ktiles;          // K steps: Kp / TC_BK
  int m_tiles, n_tiles;
  int out_bf16;
};

// x rounded to TF32 (nearest, ties away from zero), low 13 bits cleared.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

__device__ __forceinline__ long long axis_offset(long long i, long long n1, long long s0,
                                                 long long s1) {
  return (i / n1) * s0 + (i % n1) * s1;
}

// Block (x, y) writes term rows 32x .. 32x + 31, values 32y .. 32y + 31 of
// both terms.  Threads read with threadIdx.x along the operand's columns and
// write with threadIdx.x along the term row; values past the operand (the K
// padding) are zeros.
__global__ void __launch_bounds__(SPLIT_TILE * SPLIT_ROWS)
    tf32_split_kernel(const float* __restrict__ src, float* __restrict__ dst, const SplitArgs s) {
  __shared__ float tile[SPLIT_TILE][SPLIT_TILE + 1];  // [operand row][operand column]
  const long long rows = s.r0 * s.r1, cols = s.c0 * s.c1;
  const long long nrows = s.transpose ? cols : rows;  // term rows
  const long long i0 = static_cast<long long>(blockIdx.x) * SPLIT_TILE;
  const long long j0 = static_cast<long long>(blockIdx.y) * SPLIT_TILE;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long row0 = s.transpose ? j0 : i0, col0 = s.transpose ? i0 : j0;
  const long long col = col0 + tx;
  const bool col_in = col < cols;
  const long long col_off = col_in ? axis_offset(col, s.c1, s.s_c0, s.s_c1) : 0;
#pragma unroll
  for (int r = ty; r < SPLIT_TILE; r += SPLIT_ROWS) {
    const long long row = row0 + r;
    float v = 0.f;
    if (col_in && row < rows) v = src[axis_offset(row, s.r1, s.s_r0, s.s_r1) + col_off];
    tile[r][tx] = v;
  }
  __syncthreads();
  const long long plane = nrows * s.kp;
  const long long j = j0 + tx;
#pragma unroll
  for (int r = ty; r < SPLIT_TILE; r += SPLIT_ROWS) {
    const long long i = i0 + r;
    if (i >= nrows) continue;
    const float x = s.transpose ? tile[tx][r] : tile[r][tx];
    const float big = tf32_rna(x);
    const float small = tf32_rna(x - big);
    dst[i * s.kp + j] = big;
    dst[plane + i * s.kp + j] = small;
  }
}

// One box of a 3-D tensor map (values along K, rows, term) into shared
// memory; completion to `bar`.
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, uint32_t bar, int k,
                                          int row, int term) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row), "r"(term)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (in 16-byte units), layout type 1 (SW128).  The
// swizzle atom (8 rows of 128 bytes) sits on a 1024-byte boundary; a k-step
// of 8 tf32 values is 32 bytes into it.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
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

// Keep the compiler from moving accesses to wgmma's registers across the
// asynchronous window between issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 128, f32) {+}= A (64 x 8, tf32, K-major smem desc) * B (128 x 8,
// tf32, K-major smem desc); scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void store2(const TcParams& p, long long row, int col, float x,
                                       float y) {
  const long long i = row * p.n + col;
  if (p.out_bf16) {
    __nv_bfloat16* c = static_cast<__nv_bfloat16*>(p.c);
    if (col + 1 < p.n && (p.n & 1) == 0) {
      *reinterpret_cast<__nv_bfloat162*>(c + i) = __floats2bfloat162_rn(x, y);
    } else {
      c[i] = __float2bfloat16(x);
      if (col + 1 < p.n) c[i + 1] = __float2bfloat16(y);
    }
  } else {
    float* c = static_cast<float*>(p.c);
    if (col + 1 < p.n && (p.n & 1) == 0) {
      *reinterpret_cast<float2*>(c + i) = make_float2(x, y);
    } else {
      c[i] = x;
      if (col + 1 < p.n) c[i + 1] = y;
    }
  }
}

__global__ void __launch_bounds__(TC_THREADS, 1)
    matmul_tc_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                     const TcParams p) {
  extern __shared__ uint8_t tc_smem[];
  const uint32_t base = (smem_u32(tc_smem) + 1023) & ~1023u;
  const uint32_t full0 = base + TC_STAGES * TC_STAGE_BYTES;  // full[st] at full0 + 8 st
  const uint32_t empty0 = full0 + 8 * TC_STAGES;              // empty[st] at empty0 + 8 st
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // this block's tile: groups of TC_GROUP_M row tiles walk the columns
  const int per_group = TC_GROUP_M * p.n_tiles;
  const int group = blockIdx.x / per_group, in_group = blockIdx.x % per_group;
  const int first_m = group * TC_GROUP_M;
  const int gm = min(p.m_tiles - first_m, TC_GROUP_M);
  const int mt = first_m + in_group % gm, nt = in_group / gm;

  if (tid == 0) {
    for (int st = 0; st < TC_STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, TC_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == TC_CONSUMERS / 32) {
    // Producer: one thread issues every copy, each stage once the consumer
    // warps have released its last use.
    if (lane != 0) return;
    for (int kt = 0; kt < p.ktiles; ++kt) {
      const int st = kt % TC_STAGES, use = kt / TC_STAGES;
      if (use > 0) mbar_wait(empty0 + 8 * st, (use - 1) & 1);
      const uint32_t full = full0 + 8 * st, dst = base + st * TC_STAGE_BYTES;
      mbar_expect_tx(full, TC_STAGE_BYTES);
      tma_load3(dst, &ta, full, kt * TC_BK, mt * TC_BM, 0);
      tma_load3(dst + TC_TILE_BYTES, &ta, full, kt * TC_BK, mt * TC_BM, 1);
      tma_load3(dst + 2 * TC_TILE_BYTES, &tb, full, kt * TC_BK, nt * TC_BN, 0);
      tma_load3(dst + 3 * TC_TILE_BYTES, &tb, full, kt * TC_BK, nt * TC_BN, 1);
    }
    return;
  }

  // Consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of the tile.  A
  // stage's 12 products go into `part`, which the tensor cores sum with
  // truncation; `acc` adds the stages' parts in K order on the CUDA cores.
  const int wg = tid >> 7, w = warp & 3;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  for (int kt = 0; kt < p.ktiles; ++kt) {
    const int st = kt % TC_STAGES;
    mbar_wait(full0 + 8 * st, (kt / TC_STAGES) & 1);
    __syncwarp();
    const uint32_t a_big = base + st * TC_STAGE_BYTES + wg * 64 * 128;
    const uint32_t a_small = a_big + TC_TILE_BYTES;
    const uint32_t b_big = base + st * TC_STAGE_BYTES + 2 * TC_TILE_BYTES;
    const uint32_t b_small = b_big + TC_TILE_BYTES;
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 8; ++kk) {
      const uint32_t k = kk * 32;
      wgmma_tf32_n128(part, sw128_desc(a_small + k), sw128_desc(b_big + k), kk > 0);
      wgmma_tf32_n128(part, sw128_desc(a_big + k), sw128_desc(b_small + k), 1);
      wgmma_tf32_n128(part, sw128_desc(a_big + k), sw128_desc(b_big + k), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    if (lane == 0) mbar_arrive(empty0 + 8 * st);     // the stage is free
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }

  // acc[4j + e]: row r (e < 2) or r + 8, column 8j + 2(lane % 4) + (e & 1)
  const long long r = static_cast<long long>(mt) * TC_BM + wg * 64 + w * 16 + (lane >> 2);
  const int c0 = nt * TC_BN + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < TC_BN / 8; ++j) {
    const int col = c0 + 8 * j;
    if (col >= p.n) continue;
    if (r < p.m) store2(p, r, col, acc[4 * j], acc[4 * j + 1]);
    if (r + 8 < p.m) store2(p, r + 8, col, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// The map of a split array (2, rows, kp) f32: boxes of 32 values x 128 rows
// of one term, 128-byte swizzled; rows past the end read as zeros.  0, or
// kEncodeError + the CUresult of a refused map.
int split_map(CUtensorMap* map, const void* ptr, long long rows, long long kp) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kEncodeError + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kp), static_cast<cuuint64_t>(rows), 2};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(kp * 4),
                                 static_cast<cuuint64_t>(rows * kp * 4)};
  const cuuint32_t box[3] = {TC_BK, TC_BM, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
                            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

}  // namespace

extern "C" {

// Enqueue the split pass on `stream`: the operand at `src`, read by the four
// axes of `s`, into dst (2, R, s.kp) f32 — R its rows (transpose 0) or its
// columns (transpose 1), K its columns or rows, s.kp >= K a multiple of 32.
// Returns the launch's cudaGetLastError() as an int (0 = launched).
int repro_tf32_split(const void* src, void* dst, const SplitArgs* s, void* stream) {
  const long long rows = s->r0 * s->r1, cols = s->c0 * s->c1;
  const long long nrows = s->transpose ? cols : rows, k = s->transpose ? rows : cols;
  if (rows <= 0 || cols <= 0 || s->kp < k || s->kp % 32 != 0 || s->r1 <= 0 || s->c1 <= 0 ||
      s->kp / SPLIT_TILE > 65535 || (nrows + SPLIT_TILE - 1) / SPLIT_TILE > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((nrows + SPLIT_TILE - 1) / SPLIT_TILE),
                  static_cast<unsigned>(s->kp / SPLIT_TILE));
  tf32_split_kernel<<<grid, dim3(SPLIT_TILE, SPLIT_ROWS), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), *s);
  return static_cast<int>(cudaGetLastError());
}

// Enqueue C = A @ B on `stream` from the split arrays a2 (2, m, kp) and b2
// (2, n, kp) of repro_tf32_split (B's transposed); C an m x n contiguous
// array in f32 (out_bf16 0) or bf16 (1).  kp a multiple of 32.  Returns 0
// when the kernel was launched, else a cudaError_t, or kEncodeError + the
// CUresult of a refused tensor map.
int repro_matmul_tc(const void* a2, const void* b2, void* c, int m, int n, int kp, int out_bf16,
                    void* stream) {
  if (m <= 0 || n <= 0 || kp <= 0 || kp % TC_BK != 0 || (out_bf16 != 0 && out_bf16 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long m_tiles = (m + TC_BM - 1) / TC_BM, n_tiles = (n + TC_BN - 1) / TC_BN;
  if (m_tiles * n_tiles > 0x7fffffffll || TC_GROUP_M * n_tiles > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  int rc = split_map(&ta, a2, m, kp);
  if (rc == 0) rc = split_map(&tb, b2, n, kp);
  if (rc != 0) return rc;
  cudaError_t err =
      cudaFuncSetAttribute(matmul_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  TcParams p;
  p.c = c;
  p.m = m;
  p.n = n;
  p.ktiles = kp / TC_BK;
  p.m_tiles = static_cast<int>(m_tiles);
  p.n_tiles = static_cast<int>(n_tiles);
  p.out_bf16 = out_bf16;
  matmul_tc_kernel<<<static_cast<unsigned>(m_tiles * n_tiles), TC_THREADS, TC_SMEM,
                     static_cast<cudaStream_t>(stream)>>>(ta, tb, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
