// Blocked matmul for Hopper (sm_90a): C = A @ B with f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/matmul/kernel.py::matmul_pallas
// (_matmul_kernel): the Sigma∘Join contraction that tra._fused_matmul_2d
// collapses an unmasked (matMul, matAdd) pair into.  Same function:
// A (M,K) and B (K,N) in f32 or bf16, summed in f32, written in f32 or bf16.
// Three kernels, routed by ops.py::route:
//
// * matmul_skinny_kernel: f32 with M <= 16 — the FFNN scorer's buckets, the
//   main path.  Below.
// * matmul_tile_kernel: bf16, or M > 16.  One output tile per block, BK-deep
//   tiles of A and B staged in shared memory as f32 through registers (B as
//   float4 where the layout allows), each thread owning a TM x TN register
//   tile, FFMA in true f32; ragged edges masked in the kernel.  Contiguous
//   row-major operands only.
// * splitk_reduce_kernel: the tile kernel's second pass when it splits K —
//   the partial sums added in split order (deterministic, no float atomics).
//
// matmul_skinny_kernel.  What bounds it at the scorer's shapes (speech-100k,
// bucket b <= 8): (b x 1600) @ (1600 x 100000) reads 640 MB of f32 B for
// 2*b*1600*100000 <= 2.6 GFLOP, so the card's memory rate is the whole
// bound; (b x 100000) @ (100000 x 10) moves 7 MB into one (b x 10) tile, so
// its K must spread over the card, and launches and the cross-block sum are
// most of its time.  Design:
//   * Operands are read where they lie.  The host (ops.py::plan_operands)
//     describes each as four strided axes — rows (R0, R1), columns (C0, C1)
//     — and builds a 4-D TMA tensor map of it ordered by stride: the
//     scorer's blocked W1, (db, bd, hb, bh) viewed out of (db, hb, bd, bh),
//     goes in place.  A box never crosses a block edge: the K loop walks
//     K blocks, and columns or rows past a block's extent come back as
//     zeros (TMA fills each dimension at its own extent), which masks ragged
//     edges with no pad.  B rows whose pitch is not a multiple of 16 bytes
//     (the scorer's W2, 10 f32 columns) are read g rows to a TMA row.
//   * A persistent grid (as many blocks as fit, each walking work items of
//     one column tile x one K split) with warp specialisation: a producer
//     warp, one elected thread, streams B tiles through a 4-stage ring of
//     shared-memory buffers (full/empty mbarriers, expect_tx), while four
//     consumer warps multiply.  So B streams once from device memory with
//     up to 64 KB in flight per SM, and an item's epilogue overlaps the next
//     item's loads.
//   * A's K slice (b x K f32, the split's share of K) is loaded by TMA into
//     shared memory once and stays there: once per block when K is not split.
//   * FFMA in true f32 (never TF32).  Wide tiles (128 columns): each consumer
//     thread owns 4 columns x all rows and a quarter of each 32-row B tile,
//     reading B as float4 and A as broadcast float4 along K; narrow tiles
//     (N <= 32, one tile): threads split a 128-row B tile by column and row.
//     The four (or more) row groups are added in a fixed order.
//   * Split-K folded into the kernel: each split writes its f32 partial tile
//     to a workspace, then takes an integer ticket for its column tile
//     (atomicAdd on an int; no float atomics).  The block that draws the
//     last ticket adds the partials in split order — bit-equal to
//     ref.splitk_reduce_ref on the same partials, so served results are
//     bit-identical from run to run — writes C, and sets the ticket back to
//     0.  So every launch leaves its ticket buffer zeroed for the next launch
//     on its stream; ops.py keeps one buffer per stream, so two launches in
//     flight on different streams never share one.
//   * B's ring and A's slice are read with ordinary loads and refilled by
//     TMA: every consumer thread fences the proxies before it releases them
//     (tma.cuh::mbar_release_to_tma), as the narrow kernel must.
//   * Every mbarrier wait traps after ~10 s of clock instead of hanging.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): the caller owns every allocation and the stream.  Each entry point
// launches one kernel, so the caller counts every launch: repro_matmul the
// tile kernel, repro_splitk_reduce the reduction pass, repro_matmul_skinny
// the skinny kernel.  The mbarrier, TMA and tensor-map helpers are in
// tma.cuh, shared with matmul_wgmma.cu and matmul_narrow.cu.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"

// The skinny kernel's launch plan (ops.py::plan_skinny builds it).
struct SkinnyArgs {
  int m, n;            // C is m x n, contiguous row-major
  int mp;              // rows padded to 4, 8 or 16
  int wide;            // 1: 128-column tiles; 0: one narrow tile of all N
  int tc;              // columns of a tile in shared memory (the B tile's pitch)
  int g;               // B rows per TMA row (narrow tiles of a short pitch), else 1
  int n1;              // columns per column block (of B and of C)
  int ntpb, ntiles;    // column tiles per column block, and in all
  int ktpb, ktiles;    // K tiles per K block, and in all
  int kts, splits;     // K tiles per split, and splits
  int a_r0, a_r1;      // A's rows: a_r0 blocks of a_r1 rows (m = a_r0 * a_r1)
  int a_perm, b_perm;  // MmMapSpec::perm of A's and of B's map
  int out_bf16;        // C in bf16 (1) or f32 (0)
};

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One block computes a BM x BN tile of C over the K range of split blockIdx.z.
// Threads form a (BM/TM) x (BN/TN) grid; thread (ty, tx) owns rows
// ty*TM .. ty*TM+TM-1 and columns tx, tx + BN/TN, ... so that neighbouring
// threads read neighbouring B columns and write neighbouring C columns.
// The next K tile is loaded into registers while the current one is
// multiplied out of shared memory, so global loads overlap the FMAs.  With
// VEC, B is read as float4 (f32 B, N % 4 == 0, 16-byte aligned base).
// With partial != nullptr the tile is written as f32 into
// partial[split][M][N] for the reduction pass instead of into C.
template <int BM, int BN, int BK, int TM, int TN, bool VEC, typename TIn,
          typename TOut>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
matmul_tile_kernel(const TIn* __restrict__ A, const TIn* __restrict__ B,
                   TOut* __restrict__ C, float* __restrict__ partial,
                   int M, int N, int K, int kchunk) {
  constexpr int COLS = BN / TN;
  constexpr int THREADS = (BM / TM) * COLS;
  constexpr int BV = VEC ? 4 : 1;                 // B values per load
  constexpr int A_PER = BM * BK / THREADS;        // A loads per thread
  constexpr int B_PER = BK * BN / (THREADS * BV); // B loads per thread
  static_assert(A_PER * THREADS == BM * BK, "A tile must split evenly");
  static_assert(B_PER * THREADS * BV == BK * BN, "B tile must split evenly");
  static_assert(!VEC || sizeof(TIn) == 4, "vector B loads are f32 only");
  __shared__ float As[BK][BM];                    // A tile, transposed
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % COLS;
  const int ty = tid / COLS;
  const long long row0 = static_cast<long long>(blockIdx.y) * BM;
  const long long col0 = static_cast<long long>(blockIdx.x) * BN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);

  float ra[A_PER];
  float rb[B_PER][BV];
  // A: consecutive threads read consecutive k of one row; B: consecutive
  // threads read consecutive n of one row.  Out-of-range values are 0.
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * THREADS;
      const long long gr = row0 + e / BK;
      const int gk = k0 + e % BK;
      ra[i] = (gr < M && gk < kend) ? to_f32(A[gr * K + gk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * THREADS;
      const int gk = k0 + e / (BN / BV);
      const long long gc = col0 + (e % (BN / BV)) * BV;
      const long long off = static_cast<long long>(gk) * N + gc;
      if constexpr (VEC) {
        if (gk < kend && gc + 3 < N) {
          const float4 v = *reinterpret_cast<const float4*>(B + off);
          rb[i][0] = v.x; rb[i][1] = v.y; rb[i][2] = v.z; rb[i][3] = v.w;
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < BV; ++j)
        rb[i][j] = (gk < kend && gc + j < N) ? to_f32(B[off + j]) : 0.f;
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * THREADS;
      As[e % BK][e / BK] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * THREADS;
#pragma unroll
      for (int j = 0; j < BV; ++j)
        Bs[e / (BN / BV)][(e % (BN / BV)) * BV + j] = rb[i][j];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (kbeg < kend) load_tile(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    store_tile();
    __syncthreads();
    if (k0 + BK < kend) load_tile(k0 + BK);   // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * COLS];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = row0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long c = col0 + tx + j * COLS;
      if (c >= N) continue;
      if (partial != nullptr) {
        partial[(static_cast<long long>(blockIdx.z) * M + r) * N + c] = acc[i][j];
      } else {
        C[r * N + c] = from_f32<TOut>(acc[i][j]);
      }
    }
  }
}

// Second split-K pass: C[i] = sum over splits of partial[s][i], in split order.
template <typename TOut>
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     TOut* __restrict__ C, long long mn, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[z * mn + i];
  C[i] = from_f32<TOut>(s);
}

template <int BM, int BN, int BK, int TM, int TN, typename TIn, typename TOut>
void launch(const void* a, const void* b, void* c, float* workspace, int m, int n,
            int k, int splits, int kchunk, cudaStream_t stream) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
  float* partial = splits > 1 ? workspace : nullptr;
  const bool vec = sizeof(TIn) == 4 && n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (vec) {
    matmul_tile_kernel<BM, BN, BK, TM, TN, sizeof(TIn) == 4, TIn, TOut>
        <<<grid, THREADS, 0, stream>>>(
            static_cast<const TIn*>(a), static_cast<const TIn*>(b),
            static_cast<TOut*>(c), partial, m, n, k, kchunk);
  } else {
    matmul_tile_kernel<BM, BN, BK, TM, TN, false, TIn, TOut>
        <<<grid, THREADS, 0, stream>>>(
            static_cast<const TIn*>(a), static_cast<const TIn*>(b),
            static_cast<TOut*>(c), partial, m, n, k, kchunk);
  }
}

// Tile configurations, chosen by the caller (ops.py::plan_launch):
//   0: 8 x 128 tiles for skinny A (the scorer's buckets, M <= 16);
//   1: 64 x 64 tiles otherwise.
template <typename TIn, typename TOut>
int dispatch_config(int config, const void* a, const void* b, void* c, float* ws,
                    int m, int n, int k, int splits, int kchunk, cudaStream_t stream) {
  switch (config) {
    case 0:
      launch<8, 128, 32, 1, 4, TIn, TOut>(a, b, c, ws, m, n, k, splits, kchunk, stream);
      return 0;
    case 1:
      launch<64, 64, 16, 4, 4, TIn, TOut>(a, b, c, ws, m, n, k, splits, kchunk, stream);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---------------------------------------------------------------- skinny

constexpr int SK_CONSUMERS = 128;                 // four consumer warps
constexpr int SK_THREADS = SK_CONSUMERS + 32;     // and one producer warp
constexpr int SK_STAGES = 4;                      // B tiles in the ring
constexpr int SK_WIDE_COLS = 128;                 // columns of a wide tile
constexpr int SK_MAX_SMEM = 232448;               // a block's shared memory on sm_90

__host__ __device__ constexpr int sk_bk(bool wide) { return wide ? 32 : 128; }

// Byte offsets into a block's 128-byte aligned shared memory: the B ring,
// A's K slice (kts tiles of mp x BK), the row groups' sums, then the
// mbarriers and the fold's flag.  The fold stages partial tiles over A's
// slice and the sums (a .. bars).
struct SkLayout {
  int stage, a, a_tile, red, bars, total;
};

__host__ __device__ inline SkLayout sk_layout(const SkinnyArgs& s) {
  const int bk = sk_bk(s.wide != 0);
  const int groups = s.wide ? SK_CONSUMERS / 32 : SK_CONSUMERS / s.tc;
  SkLayout l;
  l.stage = bk * s.tc * 4;
  l.a = SK_STAGES * l.stage;
  l.a_tile = s.mp * bk * 4;
  l.red = l.a + s.kts * l.a_tile;
  l.bars = l.red + (groups * s.mp * s.tc * 4 + 127) / 128 * 128;
  l.total = l.bars + 128 + 128;                   // barriers and flag; alignment slack
  return l;
}


// The four consumer warps only: the producer warp never joins.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(SK_CONSUMERS) : "memory");
}


__device__ __forceinline__ void fma4(float (&acc)[4], float a, const float4& b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

__device__ __forceinline__ void store_out(void* c, long long i, float v, int out_bf16) {
  if (out_bf16) {
    static_cast<__nv_bfloat16*>(c)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(c)[i] = v;
  }
}

struct SkParams {
  void* c;
  float* ws;         // partial tiles [tile][split][mp][tc], f32 (splits > 1)
  int* tickets;      // one per column tile: 0 at launch, 0 again at exit
  SkinnyArgs s;
};

// C = A @ B in f32 for M <= MP.  Work item i is column tile i / splits over
// K split i % splits; block b walks items b, b + gridDim.x, ...
template <int MP, bool WIDE>
__global__ void __launch_bounds__(SK_THREADS, 1)
    matmul_skinny_kernel(const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap tb, const SkParams p) {
  constexpr int BK = sk_bk(WIDE);
  const SkinnyArgs& s = p.s;
  const SkLayout l = sk_layout(s);
  extern __shared__ uint8_t sk_smem[];
  uint8_t* base = sk_smem + ((128u - (smem_u32(sk_smem) & 127u)) & 127u);
  const uint32_t base_s = smem_u32(base);
  const uint32_t full0 = base_s + l.bars;         // full[st] at full0 + 8 st
  const uint32_t empty0 = full0 + 8 * SK_STAGES;  // empty[st] at empty0 + 8 st
  const uint32_t a_full = empty0 + 8 * SK_STAGES;
  const uint32_t a_empty = a_full + 8;
  volatile int* last = reinterpret_cast<volatile int*>(base + l.bars + 16 * SK_STAGES + 16);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tc = WIDE ? SK_WIDE_COLS : s.tc;
  const int items = s.ntiles * s.splits;

  if (tid == 0) {
    for (int st = 0; st < SK_STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, SK_CONSUMERS);
    }
    mbar_init(a_full, 1);
    mbar_init(a_empty, SK_CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == SK_CONSUMERS / 32) {
    // Producer: one thread issues every copy.  A's slice whenever the split
    // changes (once per block without split-K), after the consumers have
    // released the last one; then the item's B tiles into the ring, each
    // stage once the consumers have released its last use.
    if (lane != 0) return;
    int q = 0, a_loads = 0, resident = -1;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int split = item % s.splits, tile = item / s.splits;
      const int kt0 = split * s.kts, nt = min(s.kts, s.ktiles - kt0);
      if (s.splits > 1 || split != resident) {
        if (a_loads > 0) mbar_wait(a_empty, (a_loads - 1) & 1);
        mbar_expect_tx(a_full, static_cast<uint32_t>(nt * s.a_r0 * s.a_r1 * BK * 4));
        for (int j = 0; j < nt; ++j) {
          const int kt = kt0 + j, kb = kt / s.ktpb, k1 = (kt % s.ktpb) * BK;
          for (int r0 = 0; r0 < s.a_r0; ++r0)
            tma_load4(base_s + l.a + j * l.a_tile + r0 * s.a_r1 * BK * 4, &ta, a_full, k1, 0, kb,
                      r0, s.a_perm);
        }
        ++a_loads;
        resident = split;
      }
      const int c0 = tile / s.ntpb, col0 = (tile % s.ntpb) * tc;
      for (int j = 0; j < nt; ++j, ++q) {
        const int st = q % SK_STAGES, use = q / SK_STAGES;
        if (use > 0) mbar_wait(empty0 + 8 * st, (use - 1) & 1);
        mbar_expect_tx(full0 + 8 * st, static_cast<uint32_t>(l.stage));
        const int kt = kt0 + j, kb = kt / s.ktpb, k1 = (kt % s.ktpb) * BK;
        tma_load4(base_s + st * l.stage, &tb, full0 + 8 * st, col0, k1 / s.g, c0, kb, s.b_perm);
      }
    }
    return;
  }

  // Consumers.  Wide: warp w takes rows 8w .. 8w + 7 of each 32-row B tile,
  // lane l columns 4l .. 4l + 3, all MP rows of A.  Narrow: thread t takes
  // column t % tc and rows t / tc + i * groups of each 128-row tile.
  const int groups = WIDE ? SK_CONSUMERS / 32 : SK_CONSUMERS / tc;
  const int grp = WIDE ? warp : tid / tc;
  const int col = WIDE ? lane * 4 : tid % tc;
  const int per = MP * tc;                        // values of one partial tile
  float* red = reinterpret_cast<float*>(base + l.red);
  int q = 0, a_uses = 0, resident = -1;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int split = item % s.splits, tile = item / s.splits;
    const int kt0 = split * s.kts, nt = min(s.kts, s.ktiles - kt0);
    if (s.splits > 1 || split != resident) {
      mbar_wait(a_full, a_uses & 1);
      ++a_uses;
      resident = split;
    }
    float acc[MP][4];
#pragma unroll
    for (int r = 0; r < MP; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
    for (int j = 0; j < nt; ++j, ++q) {
      const int st = q % SK_STAGES;
      mbar_wait(full0 + 8 * st, (q / SK_STAGES) & 1);
      const float* bt = reinterpret_cast<const float*>(base + st * l.stage);
      const float* at = reinterpret_cast<const float*>(base + l.a + j * l.a_tile);
      if constexpr (WIDE) {
#pragma unroll
        for (int kk = 0; kk < 8; kk += 4) {
          const int k = warp * 8 + kk;
          float4 b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            b[i] = *reinterpret_cast<const float4*>(bt + (k + i) * SK_WIDE_COLS + col);
#pragma unroll
          for (int r = 0; r < MP; ++r) {
            const float4 a = *reinterpret_cast<const float4*>(at + r * BK + k);
            fma4(acc[r], a.x, b[0]);
            fma4(acc[r], a.y, b[1]);
            fma4(acc[r], a.z, b[2]);
            fma4(acc[r], a.w, b[3]);
          }
        }
      } else if (grp < groups) {
        for (int k = grp; k < BK; k += groups) {
          const float b = bt[k * tc + col];
#pragma unroll
          for (int r = 0; r < MP; ++r) acc[r][0] = fmaf(at[r * BK + k], b, acc[r][0]);
        }
      }
      mbar_release_to_tma(empty0 + 8 * st);
    }

    // The row groups' sums, added in group order.
    if (WIDE || grp < groups) {
#pragma unroll
      for (int r = 0; r < MP; ++r) {
        float* dst = red + (grp * MP + r) * tc + col;
        if constexpr (WIDE) {
          *reinterpret_cast<float4*>(dst) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        } else {
          *dst = acc[r][0];
        }
      }
    }
    consumers_sync();
    const int c0 = tile / s.ntpb, col0 = (tile % s.ntpb) * tc;
    float* part = p.ws + (static_cast<long long>(tile) * s.splits + split) * per;
    for (int o = tid; o < per; o += SK_CONSUMERS) {
      float v = red[o];
      for (int gi = 1; gi < groups; ++gi) v += red[gi * per + o];
      const int r = o / tc, lc = col0 + o % tc;
      if (s.splits > 1) {
        part[o] = v;
      } else if (r < s.m && lc < s.n1) {
        store_out(p.c, static_cast<long long>(r) * s.n + static_cast<long long>(c0) * s.n1 + lc, v,
                  s.out_bf16);
      }
    }
    if (s.splits == 1) {
      consumers_sync();                           // the sums are read before reuse
      continue;
    }

    // The fold: the block that draws the tile's last ticket adds every
    // split's partial tile, in split order, into C.
    __threadfence();
    consumers_sync();
    if (tid == 0) *last = atomicAdd(p.tickets + tile, 1) == s.splits - 1;
    consumers_sync();
    if (*last) {
      __threadfence();
      const float* blk = p.ws + static_cast<long long>(tile) * s.splits * per;
      float* stage = reinterpret_cast<float*>(base + l.a);
      const int cap = (l.bars - l.a) / (per * 4);  // partial tiles staged at once
      float sum[MP];
#pragma unroll
      for (int i = 0; i < MP; ++i) sum[i] = 0.f;
      for (int z0 = 0; z0 < s.splits; z0 += cap) {
        const int zc = min(cap, s.splits - z0);
        const float4* src = reinterpret_cast<const float4*>(blk + static_cast<long long>(z0) * per);
        float4* dst = reinterpret_cast<float4*>(stage);
        const int n4 = zc * per / 4;
        for (int e0 = tid; e0 < n4; e0 += 8 * SK_CONSUMERS) {
          float4 v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int e = e0 + u * SK_CONSUMERS;
            if (e < n4) v[u] = __ldcg(src + e);
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int e = e0 + u * SK_CONSUMERS;
            if (e < n4) dst[e] = v[u];
          }
        }
        consumers_sync();
#pragma unroll
        for (int i = 0; i < MP; ++i) {
          const int o = tid + i * SK_CONSUMERS;
          if (o < per)
            for (int z = 0; z < zc; ++z) sum[i] += stage[z * per + o];
        }
        consumers_sync();
      }
#pragma unroll
      for (int i = 0; i < MP; ++i) {
        const int o = tid + i * SK_CONSUMERS;
        const int r = o / tc, lc = col0 + o % tc;
        if (o < per && r < s.m && lc < s.n1)
          store_out(p.c, static_cast<long long>(r) * s.n + static_cast<long long>(c0) * s.n1 + lc,
                    sum[i], s.out_bf16);
      }
      if (tid == 0) p.tickets[tile] = 0;
    }
    consumers_sync();                             // A's slice and the stage are free
    mbar_release_to_tma(a_empty);
  }
}

typedef void (*SkinnyKernel)(CUtensorMap, CUtensorMap, SkParams);

template <int MP>
SkinnyKernel skinny_kernel(bool wide) {
  return wide ? matmul_skinny_kernel<MP, true> : matmul_skinny_kernel<MP, false>;
}

// Blocks of 160 threads that fit on one SM at this shared memory, per
// kernel instance (cached: the occupancy query costs host time).
int blocks_per_sm(SkinnyKernel fn, int index, int smem) {
  static int cached_smem[6] = {-1, -1, -1, -1, -1, -1};
  static int cached_blocks[6];
  static int max_smem_set[6] = {0, 0, 0, 0, 0, 0};
  if (cached_smem[index] == smem) return cached_blocks[index];
  if (smem > max_smem_set[index]) {
    cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return -static_cast<int>(err);
    max_smem_set[index] = smem;
  }
  int blocks = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, reinterpret_cast<const void*>(fn), SK_THREADS, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cached_smem[index] = smem;
  cached_blocks[index] = blocks;
  return blocks;
}

}  // namespace

extern "C" {

// Enqueue C = A @ B on `stream`.  A (m,k), B (k,n), C (m,n) are contiguous
// row-major device arrays; in_dtype / out_dtype are 0 (f32) or 1 (bf16).
// With splits > 1, split s covers kchunk values of K and writes its partial
// sums as f32 into workspace[s][m][n] (splits*m*n floats) instead of C; the
// caller then enqueues repro_splitk_reduce.  Returns the launch's
// cudaGetLastError() as an int (0 = launched); faults during the run surface
// at the next synchronize.
int repro_matmul(const void* a, const void* b, void* c, void* workspace, int m,
                 int n, int k, int in_dtype, int out_dtype, int config, int splits,
                 int kchunk, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || splits < 1 || kchunk <= 0 ||
      (splits > 1 && workspace == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  int rc;
  if (in_dtype == kF32 && out_dtype == kF32) {
    rc = dispatch_config<float, float>(config, a, b, c, ws, m, n, k, splits, kchunk, s);
  } else if (in_dtype == kF32 && out_dtype == kBF16) {
    rc = dispatch_config<float, __nv_bfloat16>(config, a, b, c, ws, m, n, k, splits,
                                               kchunk, s);
  } else if (in_dtype == kBF16 && out_dtype == kF32) {
    rc = dispatch_config<__nv_bfloat16, float>(config, a, b, c, ws, m, n, k, splits,
                                               kchunk, s);
  } else if (in_dtype == kBF16 && out_dtype == kBF16) {
    rc = dispatch_config<__nv_bfloat16, __nv_bfloat16>(config, a, b, c, ws, m, n, k,
                                                       splits, kchunk, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// Enqueue C[i] = sum over s < splits of partial[s][i], in split order, for
// i < mn.  partial is f32; C is f32 (out_dtype 0) or bf16 (1).  Returns the
// launch's cudaGetLastError() as an int.
int repro_splitk_reduce(const void* partial, void* c, long long mn, int splits,
                        int out_dtype, void* stream) {
  if (mn <= 0 || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(partial);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((mn + threads - 1) / threads);
  if (out_dtype == kF32) {
    splitk_reduce_kernel<float><<<blocks, threads, 0, s>>>(
        p, static_cast<float*>(c), mn, splits);
  } else if (out_dtype == kBF16) {
    splitk_reduce_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        p, static_cast<__nv_bfloat16*>(c), mn, splits);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}


// Enqueue C = A @ B on `stream` through the skinny kernel: f32 A and B read
// in place through their tensor maps, C an m x n contiguous array in f32 or
// bf16.  desc holds, flat, A's and B's MmMapSpec (dims, strides, box, perm:
// 12 values each; ops.py's plan_operands builds them) and the SkinnyArgs
// (18 values, in their order; ops.py's plan_skinny).  With splits > 1, ws
// holds ntiles * splits * mp * tc floats and tickets ntiles ints, all 0 (the
// kernel leaves them 0).  Returns 0 when the kernel was launched, else a
// cudaError_t, or kEncodeError + the CUresult of a refused tensor map.
int repro_matmul_skinny(const void* a, const void* b, void* c, void* ws, void* tickets,
                        const long long* desc, void* stream) {
  SkinnyArgs s;
  int* fields = &s.m;
  static_assert(sizeof(SkinnyArgs) == 18 * sizeof(int), "SkinnyArgs: 18 ints");
  for (int j = 0; j < 18; ++j) fields[j] = static_cast<int>(desc[24 + j]);
  const bool shapes_ok = s.m >= 1 && s.m <= s.mp && (s.mp == 4 || s.mp == 8 || s.mp == 16) &&
                         s.n >= 1 && s.tc >= 1 && s.g >= 1 && s.ntiles >= 1 && s.ktiles >= 1 &&
                         s.kts >= 1 && s.splits >= 1 && (s.splits - 1) * s.kts < s.ktiles &&
                         s.a_r0 * s.a_r1 == s.m &&
                         (s.wide ? s.tc == SK_WIDE_COLS : s.tc <= 32 && s.ntiles == 1);
  if (!shapes_ok || (s.splits > 1 && (ws == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = sk_layout(s).total;
  if (smem > SK_MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  int rc = make_map(&ta, a, map_spec(desc));
  if (rc == 0) rc = make_map(&tb, b, map_spec(desc + 12));
  if (rc != 0) return rc;
  const int index = (s.mp == 4 ? 0 : s.mp == 8 ? 2 : 4) + (s.wide ? 1 : 0);
  SkinnyKernel fn = s.mp == 4 ? skinny_kernel<4>(s.wide != 0)
                  : s.mp == 8 ? skinny_kernel<8>(s.wide != 0)
                              : skinny_kernel<16>(s.wide != 0);
  const int per_sm = blocks_per_sm(fn, index, smem);
  if (per_sm < 0) return -per_sm;
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  static int sm_count[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && sm_count[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long items = static_cast<long long>(s.ntiles) * s.splits;
  const long long room = static_cast<long long>(per_sm) * (dev < 64 ? sm_count[dev] : 132);
  const unsigned grid = static_cast<unsigned>(items < room ? items : room);
  SkParams p;
  p.c = c;
  p.ws = static_cast<float*>(ws);
  p.tickets = static_cast<int*>(tickets);
  p.s = s;
  fn<<<grid, SK_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(ta, tb, p);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  if (code >= kEncodeError)
    return "cuTensorMapEncodeTiled refused the tensor map (code - 1000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
