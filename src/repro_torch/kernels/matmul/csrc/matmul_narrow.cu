// f32 matmul of many rows into few columns on Hopper (sm_90a): C = A @ B for
// f32 A (M,K) with M > 16 rows and B (K,N) with N <= 32 columns, summed in
// f32, C in f32 (or bf16).
//
// Replaces, at those shapes, the TPU kernel
// src/repro/kernels/matmul/kernel.py::matmul_pallas (_matmul_kernel): the
// same function.  Fewer rows stay on matmul_skinny_kernel, more columns go
// to the tensor-core route (matmul_wgmma.cu), bf16 to matmul_tile_kernel
// (matmul.cu); ops.py::route decides.  On the main path it is the FFNN train
// step's second product, a1·W2, at speech-100k: (10000 x 100000) @
// (100000 x 10).
//
// What bounds it there: bytes.  a1 is 4.0 GB of f32, read once: 1.195 ms at
// 3.35 TB/s.  The work is 2·10^4·10^5·10 = 20 GFLOP, 0.30 ms of FFMA at
// 67 TFLOP/s: 5 FLOP a byte, far below the FFMA ridge (~20), so FFMA
// reaches the byte bound and keeps exact f32 products; tensor cores (and a
// TF32 split of the operands) would buy nothing.  Design:
//   * A streams once, through a TMA ring.  A block owns a tile of 128 rows
//     over one split of K.  One producer thread keeps 4-6 stages in flight,
//     each a 128-row x 32-K box of A (16 KB, 128-byte swizzled) and the
//     matching 32 x N slice of B, with full/empty mbarriers and expect_tx:
//     up to 2 x 6 x 17 KB in flight on each SM at two blocks an SM.
//   * Operands are read where they lie, through 4-D tensor maps of their
//     (rows | columns) views as ops.py::plan_operands builds them for the
//     skinny kernel: a box never crosses a row block or a K block, and rows
//     or K past a block's extent come back from TMA as zeros, which masks
//     ragged edges with no pad.  B rows whose pitch is off 16 bytes (W2's
//     40-byte rows) are read g rows to a TMA row, packed.
//   * Four consumer warps.  Warp w takes K columns 8w .. 8w + 7 of each
//     stage, lane l rows l, l + 32, l + 64, l + 96, each with all N columns
//     in registers (4 x N accumulators): per K column 4 A values and N B
//     values (a broadcast read) for 4N FMAs, so no FMA acts on a column past
//     N.  One instance per N, 1 ... 32, not N padded to 4, 8, 16 or 32: at
//     the train shape a padded build (B read as 0 past a runtime N by a
//     select, stores guarded; W2's packed rows hold the next row's values
//     past N, so TMA cannot zero them) took 1.626 ms at N 10 (on NP 16)
//     against 1.395, and 3.62 ms at N 17 (on NP 32, which spilled) against
//     1.40 (tools/narrow_ab.py, NVIDIA H100 80GB HBM3 at 700 W): the
//     selects and the padded FMAs cost instructions the kernel has not to
//     spare (at N 32 even the exact instance takes 2.23 ms, past its byte
//     bound).  The 32 instances cost ~10 s more of the matmul library's
//     cold build (20.7 s against 10.5).  A's rows are
//     read as float4 along K; the 128-byte swizzle puts the eight lanes of
//     each quarter-warp on eight distinct bank groups (rows l and l + 8 of
//     one chunk would otherwise share them).
//   * Split K, folded in the same launch.  K is split only as far as fills
//     two blocks an SM in one wave (79 row tiles x 3 splits at the train
//     shape: a fourth split would leave a second wave of 52 blocks).  At the
//     end the four warps' sums are added in warp order; a split writes its
//     f32 partial tile to a workspace and takes an integer ticket for its
//     row tile (no float atomics).  The block that draws the tile's last
//     ticket adds the partials in split order — bit-equal to
//     ref.splitk_reduce_ref on the same partials — writes C, and sets the
//     ticket back to 0, as matmul_skinny_kernel's fold does.  So a launch is
//     deterministic: bit-identical from run to run, and between a blocked
//     view and a contiguous copy of the same values where the view's K
//     blocks are whole 32-deep steps (each output's sum runs over the same
//     K steps in the same order; a row's sum does not depend on its tile).
//     splitk_reduce_kernel is not launched on this route.
//   * A stage is read with ordinary loads (the generic proxy) and refilled
//     by TMA (the async proxy), so every consumer thread fences the proxies
//     before it releases the stage (tma.cuh::mbar_release_to_tma).  Without
//     the fence the refill overwrote B values not yet read: at N 32 the last
//     columns of a split came from the next stage in most launches (the
//     gpu tests' repeated launches now hold every launch to the first).
//   * Every mbarrier wait traps after ~10 s of clock instead of hanging.
//   Not here: persistent blocks, clusters, bf16 operands.
//
// Plain C interface (built with nvcc into the matmul library with
// matmul.cu, loaded with ctypes): the caller owns every allocation and the
// stream; one call launches one kernel.  The mbarrier, TMA and tensor-map
// helpers are in tma.cuh.  Error codes follow matmul.cu's: a cudaError_t,
// or kEncodeError + the CUresult of a refused tensor map
// (repro_cuda_error_string there names both).

#include <cstdint>
#include <utility>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"

// The narrow kernel's launch plan (ops.py::plan_narrow builds it).
struct NarrowArgs {
  int m, n;            // C is m x n, contiguous row-major
  int bpitch;          // B slice's row pitch in shared memory, in floats
  int bg;              // B rows per TMA row (packed rows of a short pitch), else 1
  int a_r1;            // A's rows: m / a_r1 blocks of a_r1 rows
  int rtpb, rtiles;    // row tiles per row block, and in all
  int kblock;          // K values per K block (B's rows per K block)
  int ktpb, ktiles;    // K tiles per K block, and in all
  int kts, splits;     // K tiles per split, and splits
  int stages;          // depth of the ring
  int a_perm, b_perm;  // MmMapSpec::perm of A's and of B's map (tma.cuh)
  int out_bf16;        // C in bf16 (1) or f32 (0)
};

namespace {

constexpr int NW_BM = 128;                        // rows of a tile
constexpr int NW_BK = 32;                         // K of a stage: one 128-byte row
constexpr int NW_CONSUMERS = 128;                 // four consumer warps
constexpr int NW_THREADS = NW_CONSUMERS + 32;     // and one producer warp
constexpr int NW_A_STAGE = NW_BM * NW_BK * 4;     // bytes of A's box: 16 KB
constexpr int NW_MIN_STAGES = 4, NW_MAX_STAGES = 6;
constexpr int NW_MAX_COLS = 32;
constexpr int NW_MAX_SMEM = 232448;               // a block's shared memory on sm_90

// Byte offsets into a block's 1024-byte aligned shared memory (the 128-byte
// swizzle repeats every 1024 bytes): the A ring, the B ring, then the
// mbarriers and the fold's flag.  The warps' sums are staged over the A ring
// once every stage has been read.
struct NwLayout {
  int b, b_stage, bars, total;
};

__host__ __device__ inline NwLayout nw_layout(const NarrowArgs& s) {
  NwLayout l;
  l.b = s.stages * NW_A_STAGE;
  l.b_stage = NW_BK * s.bpitch * 4;               // a multiple of 128
  l.bars = l.b + s.stages * l.b_stage;
  l.total = l.bars + 128 + 1024;                  // barriers and flag; alignment slack
  return l;
}

// The four consumer warps only: the producer warp never joins.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NW_CONSUMERS) : "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int N>
__device__ __forceinline__ void store_row(void* c, long long row, const float (&v)[N], int out_bf16) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (out_bf16) {
      static_cast<__nv_bfloat16*>(c)[row * N + n] = __float2bfloat16(v[n]);
    } else {
      static_cast<float*>(c)[row * N + n] = v[n];
    }
  }
}

struct NwParams {
  void* c;
  float* ws;         // partial tiles [row tile][split][NW_BM][N], f32 (splits > 1)
  int* tickets;      // one per row tile: 0 at launch, 0 again at exit
  NarrowArgs s;
};

// C = A @ B in f32 for N columns.  Block b takes row tile b % rtiles over K
// split b / rtiles (the blocks of one split run side by side and share its
// slice of B in L2).
template <int N>
__global__ void __launch_bounds__(NW_THREADS, 2)
    matmul_narrow_kernel(const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap tb, const NwParams p) {
  const NarrowArgs& s = p.s;
  const NwLayout l = nw_layout(s);
  extern __shared__ uint8_t nw_smem[];
  uint8_t* base = nw_smem + ((1024u - (smem_u32(nw_smem) & 1023u)) & 1023u);
  const uint32_t base_s = smem_u32(base);
  const uint32_t full0 = base_s + l.bars;         // full[st] at full0 + 8 st
  const uint32_t empty0 = full0 + 8 * s.stages;   // empty[st] at empty0 + 8 st
  volatile int* last = reinterpret_cast<volatile int*>(base + l.bars + 16 * s.stages);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x / s.rtiles, tile = blockIdx.x % s.rtiles;
  const int rb = tile / s.rtpb, rw = (tile % s.rtpb) * NW_BM;
  const int kt0 = split * s.kts, nt = min(s.kts, s.ktiles - kt0);

  if (tid == 0) {
    for (int st = 0; st < s.stages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, NW_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NW_CONSUMERS / 32) {
    // Producer: one thread issues every copy, each stage once the consumers
    // have released its last use.
    if (lane != 0) return;
    const uint32_t bytes = static_cast<uint32_t>(NW_A_STAGE + l.b_stage);
    int st = 0, use = 0;
    for (int j = 0; j < nt; ++j) {
      if (use > 0) mbar_wait(empty0 + 8 * st, (use - 1) & 1);
      mbar_expect_tx(full0 + 8 * st, bytes);
      const int kt = kt0 + j, kb = kt / s.ktpb, k1 = (kt % s.ktpb) * NW_BK;
      tma_load4(base_s + st * NW_A_STAGE, &ta, full0 + 8 * st, k1, rw, kb, rb, s.a_perm);
      tma_load4(base_s + l.b + st * l.b_stage, &tb, full0 + 8 * st, 0, k1 / s.bg, 0, kb,
                s.b_perm);
      if (++st == s.stages) {
        st = 0;
        ++use;
      }
    }
    return;
  }

  // Consumers: warp w, K columns 8w .. 8w + 7 (16-byte chunks 2w, 2w + 1 of
  // each 128-byte row), lane l rows l + 32 i.  Chunk c of row r lies at chunk
  // c ^ (r & 7) of the row: the 128-byte swizzle; r & 7 = l & 7.
  float acc[4][N];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n) acc[i][n] = 0.f;
  const int sw = lane & 7;
  int st = 0, phase = 0;
  for (int j = 0; j < nt; ++j) {
    mbar_wait(full0 + 8 * st, phase);
    const float* at = reinterpret_cast<const float*>(base + st * NW_A_STAGE);
    const float* bt = reinterpret_cast<const float*>(base + l.b + st * l.b_stage);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int chunk = 2 * warp + h;
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(at + (lane + 32 * i) * NW_BK + ((chunk ^ sw) << 2));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = bt + (4 * chunk + kk) * s.bpitch;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float b = brow[n];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][n] = fmaf(lane_of(a[i], kk), b, acc[i][n]);
        }
      }
    }
    mbar_release_to_tma(empty0 + 8 * st);
    if (++st == s.stages) {
      st = 0;
      phase ^= 1;
    }
  }

  // The warps' sums, added in warp order: thread t takes row t of the tile.
  consumers_sync();                               // every stage is read
  float* red = reinterpret_cast<float*>(base);    // [warp][row][N]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n) red[(warp * NW_BM + lane + 32 * i) * N + n] = acc[i][n];
  consumers_sync();
  float v[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    v[n] = red[tid * N + n];
#pragma unroll
    for (int w = 1; w < NW_CONSUMERS / 32; ++w) v[n] += red[(w * NW_BM + tid) * N + n];
  }
  const bool valid = rw + tid < s.a_r1;
  const long long row = static_cast<long long>(rb) * s.a_r1 + rw + tid;
  if (s.splits == 1) {
    if (valid) store_row<N>(p.c, row, v, s.out_bf16);
    return;
  }

  // The fold: the block that draws the tile's last ticket adds every
  // split's partial tile, in split order, into C.
  float* part = p.ws + (static_cast<long long>(tile) * s.splits + split) * NW_BM * N;
#pragma unroll
  for (int n = 0; n < N; ++n) part[tid * N + n] = v[n];
  __threadfence();
  consumers_sync();
  if (tid == 0) *last = atomicAdd(p.tickets + tile, 1) == s.splits - 1;
  consumers_sync();
  if (!*last) return;
  __threadfence();
  if (valid) {
    const float* src = p.ws + static_cast<long long>(tile) * s.splits * NW_BM * N + tid * N;
    float sum[N];
#pragma unroll
    for (int n = 0; n < N; ++n) sum[n] = 0.f;
    for (int z = 0; z < s.splits; ++z) {
#pragma unroll
      for (int n = 0; n < N; ++n) sum[n] += __ldcg(src + static_cast<long long>(z) * NW_BM * N + n);
    }
    store_row<N>(p.c, row, sum, s.out_bf16);
  }
  if (tid == 0) p.tickets[tile] = 0;
}

typedef void (*NarrowKernel)(CUtensorMap, CUtensorMap, NwParams);

template <int... I>
NarrowKernel narrow_kernel(int n, std::integer_sequence<int, I...>) {
  static const NarrowKernel fns[] = {matmul_narrow_kernel<I + 1>...};
  return fns[n - 1];
}

}  // namespace

extern "C" {

// Enqueue C = A @ B on `stream` through the narrow kernel: f32 A and B read
// in place through their tensor maps, C an m x n contiguous array in f32 or
// bf16.  desc holds, flat, A's and B's map specs (dims, strides, box, perm:
// 12 values each; ops.py's plan_operands builds them, A's box 32 x 128) and
// the NarrowArgs (16 values, in their order; ops.py's plan_narrow).  With
// splits > 1, ws holds rtiles * splits * 128 * n floats and tickets rtiles
// ints, all 0 (the kernel leaves them 0).  Returns 0 when the kernel was
// launched, else a cudaError_t, or kEncodeError + the CUresult of a refused
// tensor map.
int repro_matmul_narrow(const void* a, const void* b, void* c, void* ws, void* tickets,
                        const long long* desc, void* stream) {
  NarrowArgs s;
  int* fields = &s.m;
  static_assert(sizeof(NarrowArgs) == 16 * sizeof(int), "NarrowArgs: 16 ints");
  for (int j = 0; j < 16; ++j) fields[j] = static_cast<int>(desc[24 + j]);
  const bool shapes_ok =
      s.n >= 1 && s.n <= NW_MAX_COLS && s.bpitch >= s.n && s.bpitch <= NW_MAX_COLS &&
      s.bg >= 1 && NW_BK % s.bg == 0 && s.a_r1 >= 1 && s.m >= 1 && s.m % s.a_r1 == 0 &&
      s.rtpb == (s.a_r1 + NW_BM - 1) / NW_BM && s.rtiles == s.m / s.a_r1 * s.rtpb &&
      s.kblock >= 1 && s.ktpb == (s.kblock + NW_BK - 1) / NW_BK && s.ktiles >= 1 &&
      s.ktiles % s.ktpb == 0 && s.kts >= 1 && s.splits >= 1 &&
      (s.splits - 1) * s.kts < s.ktiles && s.splits * s.kts >= s.ktiles &&
      s.stages >= NW_MIN_STAGES && s.stages <= NW_MAX_STAGES &&
      (s.out_bf16 == 0 || s.out_bf16 == 1) &&
      static_cast<long long>(s.rtiles) * s.splits <= 0x7fffffffll;
  if (!shapes_ok || (s.splits > 1 && (ws == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = nw_layout(s).total;
  if (smem > NW_MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  int rc = make_map(&ta, a, map_spec(desc), CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0) rc = make_map(&tb, b, map_spec(desc + 12));
  if (rc != 0) return rc;
  NarrowKernel fn = narrow_kernel(s.n, std::make_integer_sequence<int, NW_MAX_COLS>{});
  static int smem_set[NW_MAX_COLS + 1] = {0};
  if (smem > smem_set[s.n]) {
    cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[s.n] = smem;
  }
  NwParams p;
  p.c = c;
  p.ws = static_cast<float*>(ws);
  p.tickets = static_cast<int*>(tickets);
  p.s = s;
  fn<<<static_cast<unsigned>(s.rtiles * s.splits), NW_THREADS, smem,
       static_cast<cudaStream_t>(stream)>>>(ta, tb, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
