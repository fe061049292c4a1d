// The chunk kernel of the SSD backward on Hopper's tensor cores (sm_90a),
// bf16 x, B, C, dy: ssd_scan_bwd_chunk_kernel_wgmma.
//
// Replaces, for bf16, the FFMA chunk kernel of ssd_scan_bwd.cu (f32 stays
// there) in the gradient of the TPU kernel src/repro/kernels/ssd_scan/
// kernel.py::ssd_scan_pallas; the JAX package has no backward kernel (it
// differentiates its chunked jnp route, src/repro/kernels/ssd_scan/ops.py:
// 18-62).  It computes what the FFMA chunk kernel computes (the formulas at
// the head of ssd_scan_bwd.cu): dx and ddt, each chunk's part of dA, and dB
// and dC summed over the heads a block serves, from the state S_in entering
// each chunk and the cotangent G of the state leaving it, which the two
// unchanged state passes write.  Per head, in a chunk of L rows with
// a_i = Σ_{k<=i} dt_k·A, D_ij = exp(a_i - a_j) (j <= i, else 0),
// w_j = exp(a_{L-1} - a_j) and the f32 L x L matrices
//   W1 = (C·Bᵀ)∘D,  W2 = D∘(dy·xᵀ),  P = (C·Bᵀ)∘W2:
//   dx = dt∘(W1ᵀ·dy + w∘(B·G))                      (rows j)
//   dB = Σ_h dt∘(W2ᵀ·C + w∘(x·Gᵀ))                  (rows j)
//   dC = Σ_h (W2∘dtᵀ)·B + exp(a)∘(dy·S_inᵀ)          (rows i)
// and ddt, da from P's row and column sums and the state terms.
//
// What bounds it: at mamba2-130m's train layer (B 8, S 2048, H 24, P 64,
// N 128, L 128) the function's own bytes are ~0.16 GB (0.05 ms at the HBM
// rate) and its products ~39 GFLOP (0.04 ms at the bf16 peak); this design
// issues ~140 GFLOP of wgmma (three-term operands, the diagonal tiles
// whole), 0.14 ms at the peak.  The FFMA kernel took 7.7 ms there: f32 FFMA
// for bf16 work, C·Bᵀ once per head, the L x L products over the whole
// square, N walked in slices of 8, and 2 x 201 MB of per-head partials.
// This one took 0.99 ms on an H100 (700 W; chip_smoke.py), 20x the bound:
// by tools/ssd_bwd_phase_profile.py the loads at each head's start and
// the decays' elementwise work take most of it, the products under a
// fifth; an asynchronous pipeline across heads is later work.
//
// Design:
// * Every product on wgmma (m64nNk16, bf16 operands, f32 accumulators):
//   C·Bᵀ, dy·xᵀ and x·dyᵀ (SS, exact operands); W2∘dt·B, dt∘W2ᵀ·C and W1ᵀ·dy
//   (RS: the f32 L x L operand from registers); dy·S_inᵀ, x·Gᵀ (SS) and B·G
//   (SS).  x, dy, B, C enter exact.  Each f32 operand (the three L x L
//   matrices, G, S_in) enters as three bf16 terms, hi + mid + lo (exact to
//   ~2^-24, as f32), as the forward's (ssd_scan_wgmma.cu: two terms failed
//   its per-layer row gate); tests/test_torch_ssd_backward_tc.py models one,
//   two and three terms against the smoke's bf16 limits.  Never TF32.
//   Each f32 factor is folded into an operand that is f32 anyway (dt_j into
//   W2's columns and W2ᵀ's rows); the state terms' factors (w_j, exp(a_i))
//   scale their own accumulators.
// * The diagonals C_j·B_j and dy_j·x_j are summed once more on the CUDA
//   cores, a compensated (two-sum) f32 sum of the exact products, as the
//   forward sums C_j·B_j: under strong decay (dt·A near -20 a step) a row
//   of dx is dt_j·(C_j·B_j)·dy_j and rows of dB, dC hang on dy_j·x_j alone,
//   and where those dot products cancel the tensor cores' chained f32 sum
//   was off by up to 1.6% of a row in the forward.
// * C·Bᵀ once per block: no head changes it (one group).  It is kept in
//   shared memory as f32, 128 x 132 (the pad makes the transposed read
//   conflict-free), and read in both orientations: rows i (P's row sums),
//   and transposed as B·Cᵀ (W1ᵀ and P's column sums).  Registers cannot
//   hold it beside a cross-head accumulator (64 + 64 + 64 of 255 a thread
//   at N 128, with the operand terms), and x·dyᵀ is computed as a product of
//   its own (K = P, cheap) so that W2 and W2ᵀ each come out in the
//   orientation their wgmma reads from registers, with no transpose.
// * One block of two warpgroups (rows 0-63 and 64-127) serves several heads
//   of one (batch row, chunk) and sums dB and dC over them in the f32
//   accumulators of wgmma, in head order.  It walks its heads twice: pass i
//   (rows i: dy·xᵀ, dC) writes dC's partial and, into ddt's slots, the rows
//   of da that need rows i (P's row sums and C_iᵀ·S_in·dy_i); pass j (rows
//   j: x·dyᵀ, dB, dx) finishes ddt and da.  So one cross-head accumulator is
//   live at a time.  It writes partials (B, S, splits, N) of dB and dC;
//   ops.plan_splits chooses splits so the grid fills the SMs: 1 at mamba2's
//   layer (128 blocks), 4 at zamba2's (B·nC = 32).  At mamba2's layer the
//   partials are 2 x 8.4 MB against the FFMA kernel's 2 x 201 MB.
// * The tiles above the diagonal are skipped: in pass i the first
//   warpgroup's rows i < 64 take the k-steps j < 64 only, in pass j the
//   second's rows j >= 64 the k-steps i >= 64 only, so the two warpgroups
//   issue the same number over both passes; the diagonal tiles are masked
//   element by element.  The skip is a branch around a whole fence-to-wait
//   group of wgmma, uniform in a warpgroup; every wgmma loop has a fixed
//   trip count and nothing between a fence and its wait branches.  In each
//   pass a warp of the warpgroup with the fewer k-steps takes the serial
//   work (the decay vectors; in pass j ddt and da).
// * While a head computes, the next head's x, dy, dt and states are
//   prefetched into L2 (prefetch.global.L2), so its start reads L2.
// * Kept from the FFMA kernel, each for its reason there: a is summed in
//   f64 (an f32 cumsum of thousands moves every decay by ~1e-4 of itself),
//   here kept as hi + lo f32 pairs, so that each difference a_i - a_j is
//   taken in f32 as exactly as an f64 one rounded to f32; every decay is
//   exp of a difference (exp(a_i)·exp(-a_j) overflows under strong
//   decay); da leaves out M_kk and the j = k = L-1 state term (they cancel
//   exactly, and under strong decay M_kk is ~5e8 times the rest of da); no
//   atomics: every output is written by one thread and every sum
//   taken in a fixed order, so two runs are bit-equal.
// * Loads: each head's x and dy tiles (L x P) and the chunk's C and B tiles
//   (L x N) go to shared memory by cp.async 16-byte copies from the
//   caller's strided rows (zero-filled past S, N and P), straight into the
//   128-byte swizzle the wgmma descriptors read; a layout off 16 bytes is
//   loaded element by element.  S_in and G (f32) are read by the threads,
//   split and stored into the same swizzle.  No tensor map, and no mbarrier
//   that could wait forever.  The next head's tiles are only warmed in L2:
//   shared memory has no room to stage them at N 128.
// Shared memory at N 128: C, B 2 x 32 KB, x, dy 2 x 16 KB, the state's
// three terms 48 KB, C·Bᵀ 66 KB, a and the vectors 4 KB: 214 KB, one
// block an SM.  At N <= 64 the state tile is 64 rows (158 KB).
//
// Plain C interface (built with nvcc into the ssd_scan library, loaded with
// ctypes): the caller owns every allocation and the stream; one call
// launches one kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;     // two warpgroups
constexpr int ML = 128;          // largest chunk L: the tiles' rows
constexpr int MN = 128;          // largest state dim N
constexpr int MP = 64;           // largest head dim P
constexpr int TERMS = 3;         // bf16 terms of an f32 operand
constexpr int BLK = ML * 128;    // bytes of one 64-column block of a 128-row tile
constexpr int CBS = ML + 4;      // row stride (floats) of C·Bᵀ in shared memory
constexpr float LOG2E = 1.4426950408889634f;

// Phase profile, compiled in only with -DSSD_BWD_PHASES (tools/
// ssd_bwd_phase_profile.py): at each PHASE(k) the first thread of each
// warpgroup adds the clock64() cycles since its last mark to a shared
// counter of phase k, and the counters go to g_phases (block, warpgroup,
// phase) at the end.  A wait at a barrier counts to the phase it ends.
#ifdef SSD_BWD_PHASES
constexpr int PHASES = 16;
__device__ long long* g_phases;
#define PHASE_START                                                          \
  __shared__ long long phase_acc[2][PHASES];                                 \
  if (threadIdx.x < 2 * PHASES) (&phase_acc[0][0])[threadIdx.x] = 0;         \
  __syncthreads();                                                           \
  long long phase_last = clock64()
#define PHASE(k)                                                             \
  do {                                                                       \
    if ((threadIdx.x & 127) == 0) {                                          \
      const long long now = clock64();                                       \
      phase_acc[threadIdx.x >> 7][k] += now - phase_last;                    \
      phase_last = now;                                                      \
    }                                                                        \
  } while (0)
#define PHASE_END                                                            \
  if ((threadIdx.x & 127) == 0)                                              \
    for (int k = 0; k < PHASES; ++k)                                         \
      g_phases[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * \
                   2 * PHASES + (threadIdx.x >> 7) * PHASES + k] =           \
          phase_acc[threadIdx.x >> 7][k]
#else
#define PHASE_START
#define PHASE(k)
#define PHASE_END
#endif

// ptrs as ssd_scan_bwd.cu's: inputs, the state buffers, outputs, partials
enum { X, DT, A, B, C, DY, SIN, G, DX, DDT, DBP, DCP, DAP, NPTR };

struct Params {
  const __nv_bfloat16* x;
  const float* dt;
  const float* A;
  const __nv_bfloat16* B;
  const __nv_bfloat16* C;
  const __nv_bfloat16* dy;
  const float* sin;              // (B, nC, H, N, P): the state entering each chunk
  const float* g;                // (B, nC, H, N, P): the cotangent of the state leaving it
  __nv_bfloat16* dx;             // (B, S, H, P)
  float* ddt;                    // (B, S, H)
  float* dbp;                    // (B, S, splits, N): dB of each block
  float* dcp;                    // (B, S, splits, N): dC of each block
  float* dap;                    // (B, nC, H): dA of each (batch, chunk, head)
  long long x_b, x_s, x_h, x_p;  // element strides of the inputs
  long long dt_b, dt_s, dt_h;
  long long a_h;
  long long b_b, b_s, b_n;
  long long c_b, c_s, c_n;
  long long dy_b, dy_s, dy_h, dy_p;
  int batch, seqlen, heads, p, n, chunk, nchunks, splits, hpb;
  int x_vec, dy_vec, b_vec, c_vec;   // rows readable by 16-byte copies
};

// Shared memory at state tile NT (64 or 128 rows), offsets in bytes from a
// 1024-aligned base
template <int NT>
struct Layout {
  static constexpr int NB = NT / 64;                 // 64-column blocks of C and B
  static constexpr int TERM = NT * 128;              // one term of an (NT x 64) state
  static constexpr int C_OFF = 0;
  static constexpr int B_OFF = C_OFF + NB * BLK;
  static constexpr int X_OFF = B_OFF + NB * BLK;
  static constexpr int DY_OFF = X_OFF + BLK;
  static constexpr int OP_OFF = DY_OFF + BLK;        // the state's terms
  static constexpr int CB_OFF = OP_OFF + TERMS * TERM;
  static constexpr int A_OFF = CB_OFF + ML * CBS * 4;    // a (hi, lo f32 pairs)
  static constexpr int V_OFF = A_OFF + ML * 8;       // six f32 vectors, then 8 warp sums
  static constexpr int BYTES = V_OFF + 6 * ML * 4 + 8 * 4 + 1024;   // + slack to align
};
static_assert(Layout<128>::BYTES <= 232448, "one block fits an SM's shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (row r, 16-byte chunk k) in a block of 128-byte rows under
// the 128-byte swizzle: 8-row atoms of 1024 bytes, chunk k of row r at k ^ r%8.
__device__ __forceinline__ int sw(int r, int k) {
  return (r >> 3) * 1024 + (r & 7) * 128 + ((k ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
// Order this thread's generic-proxy writes to shared memory before the
// async proxy (wgmma) reads them.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows 0 .. ML-1 and 64-column blocks 0 .. nblk-1 of a (rows x cols) bf16
// operand, element (r, c) at g[r*rs + c*cs], into the tile of swizzled
// 64-column blocks at dst; rows from `valid` and columns from `cols` on are
// zero.  `vec`: cs == 1, cols and rs multiples of 8, g 16-byte aligned.
__device__ __forceinline__ void load_tile(uint8_t* sm, int dst, const __nv_bfloat16* g,
                                          long long rs, long long cs, int valid, int cols,
                                          int nblk, bool vec) {
  const int t = threadIdx.x;
  if (vec) {
    const int chunks = nblk * 8;
    const uint32_t base = smem_u32(sm + dst);
    for (int i = t; i < ML * chunks; i += THREADS) {
      const int r = i / chunks, k = i % chunks;
      const bool ok = r < valid && 8 * k < cols;
      cp_async16(base + (k >> 3) * BLK + sw(r, k & 7), ok ? g + r * rs + 8 * k : g, ok ? 16 : 0);
    }
  } else {
    const int width = nblk * 64;
    for (int i = t; i < ML * width; i += THREADS) {
      const int r = i / width, c = i % width;
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (r < valid && c < cols) v = g[r * rs + c * cs];
      *reinterpret_cast<__nv_bfloat16*>(sm + dst + (c >> 6) * BLK + sw(r, (c & 63) >> 3) +
                                        (c & 7) * 2) = v;
    }
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (in 16-byte units), layout type 1 (SW128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}
// K-major operand (rows of the M or N dim, K along a row): k-step kk of
// the 16-column slices, in blocks of 64 columns
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
  return sw128_desc(base + (kk >> 2) * BLK + (kk & 3) * 32, 16, 1024);
}
// MN-major operand (rows of the K dim, 64 M or N values along a row, the
// next 64 one block on): rows 16 kk .. 16 kk + 15
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kk) {
  return sw128_desc(base + kk * 16 * 128, BLK, 1024);
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

#define ACC32(o)                                                                       \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),     \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7]), "+f"(d[o + 8]), "+f"(d[o + 9]),  \
      "+f"(d[o + 10]), "+f"(d[o + 11]), "+f"(d[o + 12]), "+f"(d[o + 13]),              \
      "+f"(d[o + 14]), "+f"(d[o + 15]), "+f"(d[o + 16]), "+f"(d[o + 17]),              \
      "+f"(d[o + 18]), "+f"(d[o + 19]), "+f"(d[o + 20]), "+f"(d[o + 21]),              \
      "+f"(d[o + 22]), "+f"(d[o + 23]), "+f"(d[o + 24]), "+f"(d[o + 25]),              \
      "+f"(d[o + 26]), "+f"(d[o + 27]), "+f"(d[o + 28]), "+f"(d[o + 29]),              \
      "+f"(d[o + 30]), "+f"(d[o + 31])
#define REGS32                                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define REGS64                                                                         \
  REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "    \
         "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
         "%61, %62, %63"

// D (64 x 128, f32) {+}= A (64 x 16, K-major smem) * B (16 x 128, K-major smem)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REGS64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC32(0), ACC32(32)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) {+}= A (64 x 16, K-major smem) * B (16 x 64, smem):
// B K-major (TB = 0) or MN-major (TB = 1)
template <int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" REGS32
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : ACC32(0)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, MN-major smem)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REGS64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC32(0), ACC32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, MN-major smem)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" REGS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The products whose N is the state tile: SS with both operands K-major,
// RS with B MN-major
template <int NT>
struct Mma;
template <>
struct Mma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int s) {
    wgmma_ss_n128(d, a, b, s);
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_rs_n128(d, a, b);
  }
};
template <>
struct Mma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int s) {
    wgmma_ss_n64<0>(d, a, b, s);
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_rs_n64(d, a, b);
  }
};

// (a, b) ≈ t[0] + t[1] + t[2], each a bf16 pair (the lower column in the
// low half); exact to ~2^-24 of a and b
__device__ __forceinline__ void split3(float a, float b, uint32_t (&t)[TERMS]) {
#pragma unroll
  for (int i = 0; i < TERMS; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 f = __bfloat1622float2(h);
    a -= f.x;
    b -= f.y;
    t[i] = *reinterpret_cast<uint32_t*>(&h);
  }
}

// sum + err += x, with the rounding error of the add kept in err (Knuth's
// two-sum): a compensated sum of many terms that cancel stays exact to a
// few ulps of the result
__device__ __forceinline__ void two_sum(float& sum, float& err, float x) {
  const float t = sum + x;
  const float bp = t - sum;
  err += (sum - (t - bp)) + (x - bp);
  sum = t;
}

__device__ __forceinline__ float2 bf2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// Σ_k u[r][k]·v[r][k] over the CHUNKS 16-byte chunks of row r of two
// swizzled bf16 tiles, a compensated f32 sum of the exact products: the
// four lanes of a quad split the chunks and all four get the sum
template <int CHUNKS>
__device__ __forceinline__ float diag_dot(const uint8_t* u, const uint8_t* v, int r, int lane) {
  float sum = 0.f, err = 0.f;
#pragma unroll
  for (int t = 0; t < CHUNKS / 4; ++t) {
    const int k = (lane & 3) + 4 * t;
    const int off = (k >> 3) * BLK + sw(r, k & 7);
    const uint4 uv = *reinterpret_cast<const uint4*>(u + off);
    const uint4 vv = *reinterpret_cast<const uint4*>(v + off);
    const uint32_t uw[4] = {uv.x, uv.y, uv.z, uv.w};
    const uint32_t vw[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 a = bf2(uw[w]), b = bf2(vw[w]);
      two_sum(sum, err, a.x * b.x);               // a bf16 product is exact in f32
      two_sum(sum, err, a.y * b.y);
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    const float s2 = __shfl_xor_sync(0xffffffffu, sum, o);
    const float e2 = __shfl_xor_sync(0xffffffffu, err, o);
    two_sum(sum, err, s2);
    err += e2;
  }
  return sum + err;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// exp(x) of an exponent difference taken in f64, rounded once
__device__ __forceinline__ float decay(double x) { return expf(static_cast<float>(x)); }

// exp(a_i - a_j) where `on` (else 1, for a masked place), a_i and a_j the
// f64 cumsum held as hi + lo f32 pairs: the hi parts' difference is exact
// where they lie within a factor 2 of each other (Sterbenz) and else
// rounded once, as an f64 difference rounded to f32 is; the exponent goes
// to exp2 in f32, as the forward's does
__device__ __forceinline__ float decay(bool on, float2 ai, float2 aj) {
  return exp2f(on ? ((ai.x - aj.x) + (ai.y - aj.y)) * LOG2E : 0.f);
}

// One warp: dt (d), a = cumsum(dt·A) (inclusive, summed in f64 and kept
// as hi + lo f32 pairs; rows past `valid` add 0, so a[ML-1] = a_{L-1}),
// exp(a_i) (ea) and exp(a_{L-1} - a_j) (w) of head h; lane l owns rows
// 4l .. 4l+3
__device__ __forceinline__ void chunk_decay(const Params& p, int b, int h, int s0, int valid,
                                            float2* a, float* d, float* ea, float* w) {
  const int lane = threadIdx.x & 31;
  const float Ah = p.A[h * p.a_h];
  const float* dtg = p.dt + b * p.dt_b + h * p.dt_h;
  float dv[4];
  double av[4], run = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = 4 * lane + e;
    dv[e] = r < valid ? dtg[(s0 + r) * p.dt_s] : 0.f;
    run += static_cast<double>(dv[e]) * Ah;
    av[e] = run;
  }
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const double before = incl - run;
  const double last = __shfl_sync(0xffffffffu, before + av[3], 31);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = 4 * lane + e;
    const double ar = before + av[e];
    const float hi = static_cast<float>(ar);
    a[r] = make_float2(hi, static_cast<float>(ar - hi));
    d[r] = dv[e];
    ea[r] = decay(ar);
    w[r] = decay(last - ar);
  }
}

__device__ __forceinline__ void prefetch_l2(const void* ptr) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(ptr));
}

// Warm L2 with what the start of head h's pass reads (its x and dy rows,
// dt, the state `st` and, with `other`, a second state) while the head
// before it computes
__device__ __forceinline__ void prefetch_head(const Params& p, int b, int h, int s0, int valid,
                                              const float* st, const float* other) {
  const int t = threadIdx.x;
  if (t < valid) {
    prefetch_l2(p.x + b * p.x_b + h * p.x_h + (s0 + t) * p.x_s);
    prefetch_l2(p.dy + b * p.dy_b + h * p.dy_h + (s0 + t) * p.dy_s);
    prefetch_l2(p.dt + b * p.dt_b + h * p.dt_h + (s0 + t) * p.dt_s);
  }
  for (int k = t; 32 * k < p.n * p.p; k += THREADS) {     // 128-byte lines
    prefetch_l2(st + 32 * k);
    if (other != nullptr) prefetch_l2(other + 32 * k);
  }
}

// The start of a head's pass: its x and dy tiles (cp.async), its decay
// vectors (warp `decay_warp`: one of the warpgroup with the fewer wgmma
// k-steps in the pass), and the state `st` ((N, P) f32) as three bf16 terms,
// rows n and columns q, in the operand buffer; with `other`, each warp's
// part of <st, other> into red.  Ends with every tile in place.
template <int NT>
__device__ __forceinline__ void head_start(const Params& p, uint8_t* sm, int b, int h, int s0,
                                           int valid, const float* st, const float* other,
                                           int decay_warp, float2* as, float* vec,
                                           float* red) {
  using Lay = Layout<NT>;
  const int tid = threadIdx.x;
  __syncthreads();                         // the last head is done with every tile and vector
  load_tile(sm, Lay::X_OFF, p.x + b * p.x_b + h * p.x_h + s0 * p.x_s, p.x_s, p.x_p, valid, p.p,
            1, p.x_vec);
  load_tile(sm, Lay::DY_OFF, p.dy + b * p.dy_b + h * p.dy_h + s0 * p.dy_s, p.dy_s, p.dy_p,
            valid, p.p, 1, p.dy_vec);
  if ((tid >> 5) == decay_warp)
    chunk_decay(p, b, h, s0, valid, as, vec, vec + ML, vec + 2 * ML);
  float dot = 0.f;
  for (int e = tid; e < NT * 8; e += THREADS) {
    const int n = e >> 3, k = e & 7;
    float v[8], o[8];
    if (p.p == MP && n < p.n) {
      const float4* s4 = reinterpret_cast<const float4*>(st + n * MP + 8 * k);
      const float4 lo = s4[0], hi = s4[1];
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        v[q] = n < p.n && 8 * k + q < p.p ? st[n * p.p + 8 * k + q] : 0.f;
    }
    if (other != nullptr) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        o[q] = n < p.n && 8 * k + q < p.p ? other[n * p.p + 8 * k + q] : 0.f;
        dot = fmaf(v[q], o[q], dot);
      }
    }
    uint32_t t[4][TERMS];
#pragma unroll
    for (int q = 0; q < 4; ++q) split3(v[2 * q], v[2 * q + 1], t[q]);
#pragma unroll
    for (int i = 0; i < TERMS; ++i)
      *reinterpret_cast<uint4*>(sm + Lay::OP_OFF + i * Lay::TERM + sw(n, k)) =
          make_uint4(t[0][i], t[1][i], t[2][i], t[3][i]);
  }
  if (other != nullptr) {
    dot = warp_sum(dot);
    if ((tid & 31) == 0) red[tid >> 5] = dot;
  }
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();
}

// An accumulator's partial of dB or dC, rows r0, r0 + 8 of the chunk:
// part[(b, s0 + row, split, n)]
template <int NA>
__device__ __forceinline__ void store_part(const Params& p, float* part, const float (&acc)[NA],
                                           int b, int s0, int valid, int r0, int cq) {
#pragma unroll
  for (int v = 0; v < NA; v += 2) {
    const int row = r0 + 8 * ((v >> 1) & 1), n = 8 * (v >> 2) + cq;
    if (row >= valid) continue;
    float* out = part + ((static_cast<long long>(b) * p.seqlen + s0 + row) * p.splits +
                         blockIdx.x) * p.n + n;
    if (n < p.n) out[0] = acc[v];
    if (n + 1 < p.n) out[1] = acc[v + 1];
  }
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1) ssd_scan_bwd_chunk_kernel_wgmma(const Params p) {
  using Lay = Layout<NT>;
  constexpr int NA = NT / 2;               // floats a thread holds of a 64 x NT accumulator
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t su = smem_u32(sm);
  float* cbs = reinterpret_cast<float*>(sm + Lay::CB_OFF);     // [ML][CBS]  C_i·B_j
  float2* as = reinterpret_cast<float2*>(sm + Lay::A_OFF);     // a, hi + lo
  float* ds = reinterpret_cast<float*>(sm + Lay::V_OFF);       // dt
  float* eas = ds + ML;                    // exp(a_i)
  float* ws = eas + ML;                    // exp(a_{L-1} - a_j)
  float* css = ws + ML;                    // Σ_{i>j} P_ij
  float* pds = css + ML;                   // P_jj
  float* bgxs = pds + ML;                  // B_jᵀ·G·x_j
  float* red = bgxs + ML;                  // [8]: each warp's part of <S_in, G>

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int c = blockIdx.y, b = blockIdx.z;
  const int s0 = c * p.chunk, valid = min(p.chunk, p.seqlen - s0);
  const int h_lo = blockIdx.x * p.hpb, h_hi = min(p.heads, h_lo + p.hpb);
  // this thread's rows of a 64-row accumulator (r0, r0 + 8) and the column
  // of its first value in each 8-column group
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const uint32_t c_wg = su + Lay::C_OFF + wg * 64 * 128, b_wg = su + Lay::B_OFF + wg * 64 * 128;
  const uint32_t x_wg = su + Lay::X_OFF + wg * 64 * 128;
  const uint32_t dy_wg = su + Lay::DY_OFF + wg * 64 * 128;
  const long long st_row = (static_cast<long long>(b) * p.nchunks + c) * p.heads;
  const long long st_size = static_cast<long long>(p.n) * p.p;

  PHASE_START;
  // C·Bᵀ of this chunk, once for every head: rows i of this warpgroup, all
  // 128 columns j, the diagonal compensated; into shared memory as f32
  load_tile(sm, Lay::C_OFF, p.C + b * p.c_b + s0 * p.c_s, p.c_s, p.c_n, valid, p.n, Lay::NB,
            p.c_vec);
  load_tile(sm, Lay::B_OFF, p.B + b * p.b_b + s0 * p.b_s, p.b_s, p.b_n, valid, p.n, Lay::NB,
            p.b_vec);
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();
  {
    float cb[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) cb[i] = 0.f;
    fence_regs(cb);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NT / 16; ++kk)
      wgmma_ss_n128(cb, kmajor(c_wg, kk), kmajor(su + Lay::B_OFF, kk), kk > 0);
    wgmma_commit();
    float dg[2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      dg[e] = diag_dot<NT / 8>(sm + Lay::C_OFF, sm + Lay::B_OFF, r0 + 8 * e, lane);
    wgmma_wait_all();
    fence_regs(cb);
#pragma unroll
    for (int v = 0; v < 64; v += 2) {
      const int e = (v >> 1) & 1, i = r0 + 8 * e, j = 8 * (v >> 2) + cq;
      *reinterpret_cast<float2*>(cbs + i * CBS + j) =
          make_float2(j == i ? dg[e] : cb[v], j + 1 == i ? dg[e] : cb[v + 1]);
    }
  }
  PHASE(0);                                // C·Bᵀ

  // ---------------------------------------------------------------- pass i
  // rows i: W2 = D∘(dy·xᵀ); dC += (W2∘dt)·B + exp(a_i)·dy·S_inᵀ over the
  // heads; e_i = Σ_{j<i} P_ij·dt_j + exp(a_i)·C_iᵀ·S_in·dy_i into ddt's slot
  {
    float dC[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) dC[i] = 0.f;
    for (int h = h_lo; h < h_hi; ++h) {
      head_start<NT>(p, sm, b, h, s0, valid, p.sin + (st_row + h) * st_size, nullptr, 0, as,
                     ds, red);
      if (h + 1 < h_hi)                    // the next head's, or pass j's first
        prefetch_head(p, b, h + 1, s0, valid, p.sin + (st_row + h + 1) * st_size, nullptr);
      else
        prefetch_head(p, b, h_lo, s0, valid, p.g + (st_row + h_lo) * st_size,
                      p.sin + (st_row + h_lo) * st_size);
      PHASE(1);                            // pass i's head start: tiles, S_in's terms
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < MP / 16; ++kk)
        wgmma_ss_n128(acc, kmajor(dy_wg, kk), kmajor(su + Lay::X_OFF, kk), kk > 0);
      wgmma_commit();
      float dg[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        dg[e] = diag_dot<MP / 8>(sm + Lay::DY_OFF, sm + Lay::X_OFF, r0 + 8 * e, lane);
      wgmma_wait_all();
      fence_regs(acc);

      const float2 ai[2] = {as[r0], as[r0 + 8]};
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int v = 0; v < 64; ++v) {
        const int e = (v >> 1) & 1, i = r0 + 8 * e, j = 8 * (v >> 2) + cq + (v & 1);
        const float dyx = j == i ? dg[e] : acc[v];
        const float w2 = j <= i ? dyx * decay(j <= i, ai[e], as[j]) : 0.f;
        const float pv = cbs[i * CBS + j] * w2;
        rs[e] = fmaf(j < i ? pv : 0.f, ds[j], rs[e]);
        acc[v] = w2 * ds[j];                 // dC's operand: W2 with dt_j in its columns
      }
      rs[0] = quad_sum(rs[0]);
      rs[1] = quad_sum(rs[1]);
      PHASE(2);                            // dy·xᵀ, W2, P's row sums

      // dC += (W2∘dt)·B in three terms, by halves of four k-steps; the
      // first warpgroup's rows i < 64 have no column j >= 64
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (half == 1 && wg == 0) continue;
        uint32_t st[16][TERMS];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int q = 16 * half + i;
          split3(acc[2 * q], acc[2 * q + 1], st[i]);
        }
        PHASE(3);                          // W2∘dt's terms
        fence_regs(dC);
#pragma unroll
        for (int i = 0; i < 16; ++i) fence_regs(st[i]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint64_t db = mnmajor(su + Lay::B_OFF, 4 * half + k);
#pragma unroll
          for (int t = 0; t < TERMS; ++t) {
            const uint32_t at[4] = {st[4 * k][t], st[4 * k + 1][t], st[4 * k + 2][t],
                                    st[4 * k + 3][t]};
            Mma<NT>::rs(dC, at, db);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dC);
        PHASE(4);                          // (W2∘dt)·B
      }

      // v = dy·S_inᵀ (S_in in three terms); C_iᵀ·S_in·dy_i = C_i·v_i;
      // dC += exp(a_i)·v
      float sv[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i) sv[i] = 0.f;
      fence_regs(sv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < MP / 16; ++kk)
#pragma unroll
        for (int t = 0; t < TERMS; ++t)
          Mma<NT>::ss(sv, kmajor(dy_wg, kk), kmajor(su + Lay::OP_OFF + t * Lay::TERM, kk),
                      kk + t > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sv);
      float csd[2] = {0.f, 0.f};
#pragma unroll
      for (int v = 0; v < NA; v += 2) {
        const int e = (v >> 1) & 1, i = r0 + 8 * e, n = 8 * (v >> 2) + cq;
        const float2 cv = bf2(*reinterpret_cast<const uint32_t*>(
            sm + Lay::C_OFF + (n >> 6) * BLK + sw(i, (n & 63) >> 3) + (n & 7) * 2));
        csd[e] = fmaf(cv.x, sv[v], csd[e]);
        csd[e] = fmaf(cv.y, sv[v + 1], csd[e]);
        dC[v] = fmaf(eas[i], sv[v], dC[v]);
        dC[v + 1] = fmaf(eas[i], sv[v + 1], dC[v + 1]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float cs = quad_sum(csd[e]);
        const int i = r0 + 8 * e;
        if ((lane & 3) == 0 && i < valid)
          p.ddt[(static_cast<long long>(b) * p.seqlen + s0 + i) * p.heads + h] =
              rs[e] + eas[i] * cs;
      }
      PHASE(5);                            // dy·S_inᵀ, C_iᵀ·S_in·dy_i, e
    }
    store_part(p, p.dcp, dC, b, s0, valid, r0, cq);
  }

  // ---------------------------------------------------------------- pass j
  // rows j: W2ᵀ from x·dyᵀ; dB += (dt∘W2ᵀ)·C + dt∘w∘(x·Gᵀ) over the heads;
  // dx = dt∘(W1ᵀ·dy + w∘(B·G)); P's column sums and diagonal, B_jᵀ·G·x_j;
  // then ddt and da from them and e
  float dB[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dB[i] = 0.f;
  for (int h = h_lo; h < h_hi; ++h) {
    head_start<NT>(p, sm, b, h, s0, valid, p.g + (st_row + h) * st_size,
                   p.sin + (st_row + h) * st_size, 4, as, ds, red);
    if (h + 1 < h_hi)
      prefetch_head(p, b, h + 1, s0, valid, p.g + (st_row + h + 1) * st_size,
                    p.sin + (st_row + h + 1) * st_size);
    PHASE(6);                              // pass j's head start: tiles, G's terms, <S_in, G>
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MP / 16; ++kk)
      wgmma_ss_n128(acc, kmajor(x_wg, kk), kmajor(su + Lay::DY_OFF, kk), kk > 0);
    wgmma_commit();
    float dg[2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      dg[e] = diag_dot<MP / 8>(sm + Lay::X_OFF, sm + Lay::DY_OFF, r0 + 8 * e, lane);
    wgmma_wait_all();
    fence_regs(acc);

    const float2 aj[2] = {as[r0], as[r0 + 8]};
    const float dj[2] = {ds[r0], ds[r0 + 8]};
    float cs[2] = {0.f, 0.f}, pd[2] = {0.f, 0.f};
#pragma unroll
    for (int v = 0; v < 64; ++v) {
      const int e = (v >> 1) & 1, j = r0 + 8 * e, i = 8 * (v >> 2) + cq + (v & 1);
      const float xdy = i == j ? dg[e] : acc[v];
      const float w2 = i >= j ? xdy * decay(i >= j, as[i], aj[e]) : 0.f;
      const float pv = cbs[i * CBS + j] * w2;
      cs[e] += i > j ? pv : 0.f;
      pd[e] += i == j ? pv : 0.f;
      acc[v] = dj[e] * w2;                   // dB's operand: W2ᵀ with dt_j in its rows
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float c2 = quad_sum(cs[e]), p2 = quad_sum(pd[e]);
      if ((lane & 3) == 0) {
        css[r0 + 8 * e] = c2;
        pds[r0 + 8 * e] = p2;
      }
    }
    PHASE(7);                              // x·dyᵀ, W2ᵀ, P's column sums

    // dB += (dt∘W2ᵀ)·C in three terms; the second warpgroup's rows j >= 64
    // have no column i < 64
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (half == 0 && wg == 1) continue;
      uint32_t st[16][TERMS];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int q = 16 * half + i;
        split3(acc[2 * q], acc[2 * q + 1], st[i]);
      }
      PHASE(8);                            // dt∘W2ᵀ's terms
      fence_regs(dB);
#pragma unroll
      for (int i = 0; i < 16; ++i) fence_regs(st[i]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint64_t db = mnmajor(su + Lay::C_OFF, 4 * half + k);
#pragma unroll
        for (int t = 0; t < TERMS; ++t) {
          const uint32_t at[4] = {st[4 * k][t], st[4 * k + 1][t], st[4 * k + 2][t],
                                  st[4 * k + 3][t]};
          Mma<NT>::rs(dB, at, db);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dB);
      PHASE(9);                            // (dt∘W2ᵀ)·C
    }

    // dx: W1ᵀ·dy, W1ᵀ_ji = (C_i·B_j)·exp(a_i - a_j) for i >= j, generated
    // from the shared C·Bᵀ half by half in three terms; then B·G (G in
    // three terms)
    float dxa[32], dxs[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dxa[i] = dxs[i] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (half == 0 && wg == 1) continue;
      uint32_t st[16][TERMS];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int q = 16 * half + i, e = q & 1;
        const int j = r0 + 8 * e, i0 = 8 * (q >> 1) + cq;
        const float f0 = i0 >= j ? cbs[i0 * CBS + j] * decay(i0 >= j, as[i0], aj[e]) : 0.f;
        const float f1 =
            i0 + 1 >= j ? cbs[(i0 + 1) * CBS + j] * decay(i0 + 1 >= j, as[i0 + 1], aj[e]) : 0.f;
        split3(f0, f1, st[i]);
      }
      PHASE(10);                           // W1ᵀ's terms
      fence_regs(dxa);
#pragma unroll
      for (int i = 0; i < 16; ++i) fence_regs(st[i]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint64_t db = mnmajor(su + Lay::DY_OFF, 4 * half + k);
#pragma unroll
        for (int t = 0; t < TERMS; ++t) {
          const uint32_t at[4] = {st[4 * k][t], st[4 * k + 1][t], st[4 * k + 2][t],
                                  st[4 * k + 3][t]};
          wgmma_rs_n64(dxa, at, db);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dxa);
      PHASE(11);                           // W1ᵀ·dy
    }
    fence_regs(dxs);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NT / 16; ++kk)
#pragma unroll
      for (int t = 0; t < TERMS; ++t)
        wgmma_ss_n64<1>(dxs, kmajor(b_wg, kk), mnmajor(su + Lay::OP_OFF + t * Lay::TERM, kk),
                        kk + t > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dxs);
    {
      __nv_bfloat16* dxg = p.dx + ((static_cast<long long>(b) * p.seqlen + s0) * p.heads + h) * p.p;
      const long long row_stride = static_cast<long long>(p.heads) * p.p;
#pragma unroll
      for (int v = 0; v < 32; v += 2) {
        const int e = (v >> 1) & 1, j = r0 + 8 * e, q = 8 * (v >> 2) + cq;
        if (j >= valid) continue;
        const float wj = ws[j];
        const float o0 = dj[e] * (dxa[v] + wj * dxs[v]);
        const float o1 = dj[e] * (dxa[v + 1] + wj * dxs[v + 1]);
        __nv_bfloat16* out = dxg + j * row_stride + q;
        if ((p.p & 1) == 0 && q + 1 < p.p) {
          *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(o0, o1);
        } else {
          if (q < p.p) out[0] = __float2bfloat16(o0);
          if (q + 1 < p.p) out[1] = __float2bfloat16(o1);
        }
      }
    }

    PHASE(12);                             // B·G, dx out
    // u = x·Gᵀ (G in three terms): B_jᵀ·G·x_j = B_j·u_j; dB += dt_j·w_j·u
    float u[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) u[i] = 0.f;
    fence_regs(u);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MP / 16; ++kk)
#pragma unroll
      for (int t = 0; t < TERMS; ++t)
        Mma<NT>::ss(u, kmajor(x_wg, kk), kmajor(su + Lay::OP_OFF + t * Lay::TERM, kk),
                    kk + t > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(u);
    float bgx[2] = {0.f, 0.f};
#pragma unroll
    for (int v = 0; v < NA; v += 2) {
      const int e = (v >> 1) & 1, j = r0 + 8 * e, n = 8 * (v >> 2) + cq;
      const float2 bv = bf2(*reinterpret_cast<const uint32_t*>(
          sm + Lay::B_OFF + (n >> 6) * BLK + sw(j, (n & 63) >> 3) + (n & 7) * 2));
      bgx[e] = fmaf(bv.x, u[v], bgx[e]);
      bgx[e] = fmaf(bv.y, u[v + 1], bgx[e]);
      const float f = dj[e] * ws[j];
      dB[v] = fmaf(f, u[v], dB[v]);
      dB[v + 1] = fmaf(f, u[v + 1], dB[v + 1]);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float g2 = quad_sum(bgx[e]);
      if ((lane & 3) == 0) bgxs[r0 + 8 * e] = g2;
    }
    PHASE(13);                             // x·Gᵀ, B_jᵀ·G·x_j
    __syncthreads();                         // the vectors of every row are in place

    // da, r = its suffix sums, ddt and this head's part of dA: the second
    // warpgroup's first warp (the first has the more k-steps in this
    // pass), lane l owns rows 4l .. 4l+3; e (pass i) read back from ddt's
    // slots
    if ((tid >> 5) == 4) {
      const int last = valid - 1;
      float sg = 0.f;                        // <S_in, G>
#pragma unroll
      for (int y = 0; y < THREADS / 32; ++y) sg += red[y];
      float* ddt = p.ddt + (static_cast<long long>(b) * p.seqlen + s0) * p.heads + h;
      float wsum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        if (j < last) wsum += ws[j] * ds[j] * bgxs[j];
      }
      wsum = warp_sum(wsum);
      float dav[4], tot = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * lane + e;
        float v = 0.f;
        if (k < valid) {
          v = ddt[static_cast<long long>(k) * p.heads] - ds[k] * css[k];
          v = k < last ? v - ws[k] * ds[k] * bgxs[k] : v + wsum + eas[ML - 1] * sg;
        }
        dav[e] = v;
        tot += v;
      }
      float incl = tot;                      // Σ over lanes >= this lane
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += v;
      }
      float run = incl - tot;
      float dap = 0.f;
      const float Ah = p.A[h * p.a_h];
#pragma unroll
      for (int e = 3; e >= 0; --e) {
        const int j = 4 * lane + e;
        run += dav[e];
        if (j < valid) {
          ddt[static_cast<long long>(j) * p.heads] = css[j] + pds[j] + ws[j] * bgxs[j] + Ah * run;
          dap = fmaf(run, ds[j], dap);
        }
      }
      dap = warp_sum(dap);
      if (lane == 0) p.dap[st_row + h] = dap;
    }
    PHASE(14);                             // the vectors' wait, da and ddt
  }
  store_part(p, p.dbp, dB, b, s0, valid, r0, cq);
  PHASE(15);                               // the partials out
  PHASE_END;
}

// 16-byte rows: last dim contiguous, its length and the other strides
// multiples of 8 elements, the base 16-byte aligned
bool rows_vec(const void* ptr, const long long* strides, int dims, int cols) {
  if (strides[dims - 1] != 1 || cols % 8 != 0 || reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return false;
  for (int i = 0; i < dims - 1; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

template <int NT>
int launch(const Params& p, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_bwd_chunk_kernel_wgmma<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<NT>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_bwd_chunk_kernel_wgmma<NT><<<dim3(p.splits, p.nchunks, p.batch), THREADS,
                                        Layout<NT>::BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Enqueue the bf16 chunk kernel of the SSD backward on `stream`, after the
// two state passes of ssd_scan_bwd.cu and before its reduction, with their
// arguments: `ptrs` holds their 16 device pointers (x, dt, A, B, C, dy; f32
// sin and g (B, nC, H, N, P); dx (B, S, H, P) bf16; f32 ddt (B, S, H); f32
// dbp and dcp, here (B, S, splits, N); f32 dap (B, nC, H); the reduction's
// db, dc, da, unused here), `strides` the 18 element strides of the inputs,
// `dims` batch, seqlen, heads, head_dim, state, chunk, bf16 (must be 1),
// splits.  Each of the splits blocks of a (batch row, chunk) serves
// ceil(heads / splits) heads in order.  Requires 1 <= chunk <= 128,
// 1 <= state <= 128, 1 <= head_dim <= 64, 1 <= splits <= heads,
// batch, splits and nC < 65536.  Returns cudaGetLastError() of the launch as
// an int (0 = launched).
int repro_ssd_bwd_chunk_tc(const void* const* ptrs, const long long* s, const int* dims,
                           void* stream) {
  const int batch = dims[0], seqlen = dims[1], heads = dims[2], head_dim = dims[3],
            state = dims[4], chunk = dims[5], bf16 = dims[6], splits = dims[7];
  if (bf16 != 1 || batch < 1 || batch > 65535 || seqlen < 1 || heads < 1 || head_dim < 1 ||
      head_dim > MP || state < 1 || state > MN || chunk < 1 || chunk > ML || splits < 1 ||
      splits > heads || splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nchunks = (seqlen + chunk - 1) / chunk;
  if (nchunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(ptrs[X]);
  p.dt = static_cast<const float*>(ptrs[DT]);
  p.A = static_cast<const float*>(ptrs[A]);
  p.B = static_cast<const __nv_bfloat16*>(ptrs[B]);
  p.C = static_cast<const __nv_bfloat16*>(ptrs[C]);
  p.dy = static_cast<const __nv_bfloat16*>(ptrs[DY]);
  p.sin = static_cast<const float*>(ptrs[SIN]);
  p.g = static_cast<const float*>(ptrs[G]);
  p.dx = static_cast<__nv_bfloat16*>(const_cast<void*>(ptrs[DX]));
  p.ddt = static_cast<float*>(const_cast<void*>(ptrs[DDT]));
  p.dbp = static_cast<float*>(const_cast<void*>(ptrs[DBP]));
  p.dcp = static_cast<float*>(const_cast<void*>(ptrs[DCP]));
  p.dap = static_cast<float*>(const_cast<void*>(ptrs[DAP]));
  p.x_b = s[0]; p.x_s = s[1]; p.x_h = s[2]; p.x_p = s[3];
  p.dt_b = s[4]; p.dt_s = s[5]; p.dt_h = s[6];
  p.a_h = s[7];
  p.b_b = s[8]; p.b_s = s[9]; p.b_n = s[10];
  p.c_b = s[11]; p.c_s = s[12]; p.c_n = s[13];
  p.dy_b = s[14]; p.dy_s = s[15]; p.dy_h = s[16]; p.dy_p = s[17];
  p.batch = batch; p.seqlen = seqlen; p.heads = heads; p.p = head_dim; p.n = state;
  p.chunk = chunk; p.nchunks = nchunks; p.splits = splits;
  p.hpb = (heads + splits - 1) / splits;
  p.x_vec = rows_vec(ptrs[X], s, 4, head_dim);
  p.dy_vec = rows_vec(ptrs[DY], s + 14, 4, head_dim);
  p.b_vec = rows_vec(ptrs[B], s + 8, 3, state);
  p.c_vec = rows_vec(ptrs[C], s + 11, 3, state);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  return state <= 64 ? launch<64>(p, strm) : launch<128>(p, strm);
}

#ifdef SSD_BWD_PHASES
// Where the phase counters go: a device array of (blocks x 2 x PHASES) int64.
int repro_ssd_bwd_set_phases(long long* out) {
  return static_cast<int>(cudaMemcpyToSymbol(g_phases, &out, sizeof(out)));
}
#endif

}  // extern "C"
