// The two state passes of the SSD backward on Hopper's tensor cores (sm_90a),
// bf16 x, B, C, dy: ssd_scan_bwd_state_kernel_wgmma and
// ssd_scan_bwd_dstate_kernel_wgmma.
//
// Replace, for bf16, the FFMA state passes of ssd_scan_bwd.cu (f32 stays
// there) in the gradient of the TPU kernel src/repro/kernels/ssd_scan/
// kernel.py::ssd_scan_pallas; the JAX package has no backward kernel (it
// differentiates its chunked jnp route, src/repro/kernels/ssd_scan/ops.py:
// 18-62).  Per head, in a chunk of L rows (the last one may be shorter) with
// a_i = Σ_{k<=i} dt_k·A summed from the chunk's start:
//
//   forward (state):  S_in(0) = 0,  S_in(c+1) = exp(a_{L-1})·S_in(c) + Bᵀ·x̃,
//                     x̃_j = exp(a_{L-1} - a_j)·dt_j·x_j
//   reverse (dstate): G(nC-1) = 0,  G(c-1) = exp(a_{L-1})·G(c) + Cᵀ·dỹ,
//                     dỹ_i = exp(a_i)·dy_i
//
// each written as (B, nC, H, N, P) f32, the layout the chunk kernels and
// the reduction read: S_in(c) the state entering chunk c, G(c) the cotangent
// of the state leaving it.  These are the FFMA passes' numbers (the same f64
// cumsum and the same f32 coefficients) summed in another order.
//
// What bounds it: at mamba2-130m's train layer (B 8, S 2048, H 24, P 64,
// N 128, L 128) a pass reads x (or dy), B (or C) and dt, ~55 MB (0.0167 ms
// at the HBM rate), and writes its 101 MB buffer (0.030 ms more, the
// design's own bytes); its products are 6.4 GFLOP, ~19 GFLOP issued with
// the three-term operand (0.02 ms at the bf16 peak).  At zamba2-7b's (B 4,
// S 1024, H 112, P 64, N 64): 0.0182 and 0.018 ms of bytes.  The FFMA passes
// took 0.767 / 0.678 ms there on an H100 (700 W): f32 FFMA from shared
// memory, and each chunk's scalar loads waited for between barriers.
// These took 0.090 (state) and 0.089 (dstate) ms at mamba2's layer and
// 0.074 and 0.074 at zamba2's on an H100 (700 W; chip_smoke.py), 1.9x and
// 2.1x the bytes and buffers together; ptxas gives them 226 and 236
// registers at N 128 and, at N 64, the 128 that two 256-thread CTAs an SM
// leave a thread, with 132 and 188 bytes spilled.
//
// Design:
// * The chunk's product on wgmma, bf16 operands, f32 accumulators, in fresh
//   accumulators u; then S <- exp(a_{L-1})·S + u on the CUDA cores, the state
//   held in f32 registers across the chunks and stored as S_in (or G) before
//   each update.  x̃ (dỹ) enters as three bf16 terms, hi + mid + lo (split3,
//   as the forward's x̃: exact to ~2^-24, as f32; two terms failed the
//   forward's row gate on the card), B (C) exact.  Never TF32.
// * The product is computed transposed, uᵀ = x̃ᵀ·B (M = P, N = the state
//   dim, K = the chunk's rows): A = x̃ᵀ from registers (RS), built by each
//   thread from the x tile and the coefficients and split in registers; B
//   read in place from the 128-byte-swizzled B tile (MN-major).  The
//   orientation Bᵀ·x̃ (A = Bᵀ transposed from shared memory, x̃'s terms as
//   the B operand) would need the terms in shared memory (48 KB, a proxy
//   fence and a barrier a chunk): with double-buffered stages that is
//   144 KB at N 128, one CTA an SM.  Here a CTA takes 98 KB, two an SM
//   (held by the static_asserts on the layout and __launch_bounds__).
//   m64n128k16 at N 128, m64n64k16 at N <= 64, 24 wgmma a chunk (8 k-steps x
//   three terms) in groups of 4 (N 128) or 2 (N 64) k-steps, so one group's
//   terms are live at a time.
// * One CTA per (batch row, head) at N 128 (one warpgroup, 128 threads) and
//   per (batch row, two heads) at N <= 64 (a warpgroup a head; the two read
//   one B tile, B and C being shared by the heads).  mamba2's train layer:
//   192 CTAs, zamba2's: 224; two an SM on 132 SMs, one wave each.  A second
//   head past H repeats the last one and stores nothing.
// * Loads off the serial path: each chunk's B (C) tile (L x N) and x (dy)
//   tiles (L x P) go by cp.async 16-byte copies (zero-filled past S, N and
//   P; a layout off 16 bytes element by element) into the other of two
//   stages, issued right after the barrier that ends the chunk before, so
//   they land while this chunk's product runs; the next chunk's dt is read
//   at the same point and its f64 cumsum and coefficients computed by one
//   warp of the warpgroup while the last product group is in flight.  One
//   barrier a chunk; cp.async writes and the element-wise fills are fenced
//   (fence.proxy.async) before wgmma reads them.
// * Every wgmma loop has a fixed trip count and no branch around it: rows
//   past the chunk and columns past N or P are zeros.
// * Kept from the FFMA passes: a is summed in f64 (an f32 cumsum moved each
//   decay by ~1e-4), every coefficient is exp of an f64 difference rounded
//   once to f32; no atomics, so two runs are bit-equal.
// Shared memory: two stages of the B tile (2 x 16 KB blocks at N 128, one
// at N 64) and the x tiles (16 KB a head): 2 x 48 KB; the coefficients
// (2 x 0.5 KB a head) and 1 KB of slack to align: 98.0 KB at N 128, 99.0 KB
// at N 64.
//
// Plain C interface (built with nvcc into the ssd_scan library, loaded with
// ctypes): the caller owns every allocation and the stream; one call
// launches one kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ML = 128;          // largest chunk L: the tiles' rows
constexpr int MN = 128;          // largest state dim N
constexpr int MP = 64;           // largest head dim P
constexpr int TERMS = 3;         // bf16 terms of x̃ (dỹ)
constexpr int BLK = ML * 128;    // bytes of one 64-column block of a 128-row tile
constexpr int KSTEPS = ML / 16;  // wgmma k-steps over a chunk's rows

// ptrs as ssd_scan_bwd.cu's: x, dt, A, B, C, dy, then the two state buffers
enum { PX, PDT, PA, PB, PC, PDY, PSIN, PG };

struct Params {
  const __nv_bfloat16* u;        // B (forward) or C (reverse), (B, S, N)
  const __nv_bfloat16* v;        // x (forward) or dy (reverse), (B, S, H, P)
  const float* dt;
  const float* A;
  float* out;                    // (B, nC, H, N, P): S_in (forward) or G (reverse)
  long long u_b, u_s, u_n;       // element strides
  long long v_b, v_s, v_h, v_p;
  long long dt_b, dt_s, dt_h;
  long long a_h;
  int batch, seqlen, heads, p, n, chunk, nchunks;
  int u_vec, v_vec;              // rows readable by 16-byte copies
};

// The tiling at state tile NT (64 or 128 columns); offsets in bytes from a
// 1024-aligned base
template <int NT>
struct Tile {
  static constexpr int G = NT == 128 ? 1 : 2;        // heads a CTA, a warpgroup each
  static constexpr int THREADS = 128 * G;
  static constexpr int NB = NT / 64;                 // 64-column blocks of the B (C) tile
  static constexpr int KG = NT == 128 ? 4 : 2;       // k-steps whose terms are live at once
  static constexpr int STAGE = (NB + G) * BLK;       // B (C) tile, then a x (dy) tile a head
  static constexpr int VEC_OFF = 2 * STAGE;          // [2][G][ML] coefficients
  static constexpr int LAST_OFF = VEC_OFF + 2 * G * ML * 4;   // [2][G] exp(a_{L-1})
  static constexpr int BYTES = LAST_OFF + 2 * G * 4 + 1024;   // + slack to align
};
// two CTAs an SM: 228 KB of shared memory, 1 KB of it reserved a CTA
static_assert(2 * (Tile<128>::BYTES + 1024) <= 233472, "two CTAs fit an SM");
static_assert(2 * (Tile<64>::BYTES + 1024) <= 233472, "two CTAs fit an SM");

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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Order this thread's generic-proxy writes to shared memory before the
// async proxy (wgmma) reads them.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows 0 .. ML-1 and 64-column blocks 0 .. nblk-1 of a (rows x cols) bf16
// operand, element (r, c) at g[r*rs + c*cs], into the tile of swizzled
// 64-column blocks at dst, by thread t of nt; rows from `valid` and columns
// from `cols` on are zero.  `vec`: cs == 1, cols and rs multiples of 8, g
// 16-byte aligned.
__device__ __forceinline__ void load_tile(uint8_t* dst, const __nv_bfloat16* g, long long rs,
                                          long long cs, int valid, int cols, int nblk, bool vec,
                                          int t, int nt) {
  if (vec) {
    const int chunks = nblk * 8;
    const uint32_t base = smem_u32(dst);
    for (int i = t; i < ML * chunks; i += nt) {
      const int r = i / chunks, k = i % chunks;
      const bool ok = r < valid && 8 * k < cols;
      cp_async16(base + (k >> 3) * BLK + sw(r, k & 7), ok ? g + r * rs + 8 * k : g, ok ? 16 : 0);
    }
  } else {
    const int width = nblk * 64;
    for (int i = t; i < ML * width; i += nt) {
      const int r = i / width, c = i % width;
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (r < valid && c < cols) v = g[r * rs + c * cs];
      *reinterpret_cast<__nv_bfloat16*>(dst + (c >> 6) * BLK + sw(r, (c & 63) >> 3) +
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
// MN-major operand (rows of the K dim, 64 N values along a row, the next 64
// one block on): rows 16 kk .. 16 kk + 15
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

template <int NT>
struct Mma;
template <>
struct Mma<128> {
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_rs_n128(d, a, b);
  }
};
template <>
struct Mma<64> {
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

// exp(a_i - a_j) (or exp(a_i)) from the f64 cumsum, the exponent rounded once
__device__ __forceinline__ float decay(double x) { return expf(static_cast<float>(x)); }

// dt of one chunk's rows 4·lane .. 4·lane + 3 (0 past `valid`)
__device__ __forceinline__ void load_dt(const float* dtg, long long dt_s, int s0, int valid,
                                        float (&dv)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = 4 * lane + e;
    dv[e] = r < valid ? dtg[(s0 + r) * dt_s] : 0.f;
  }
}

// One warp: a chunk's coefficients from its dt (lane l holds rows 4l ..
// 4l+3) as ssd_scan_bwd.cu's state passes compute them: a = cumsum(dt·A)
// in f64 (rows past `valid` add 0, so the last is a_{L-1}); forward
// exp(a_{L-1} - a_j)·dt_j, reverse exp(a_i), 0 past `valid`; and
// exp(a_{L-1}) into *last.
template <bool REV>
__device__ __forceinline__ void chunk_coef(const float (&dv)[4], float A, int valid, float* coef,
                                           float* last) {
  const int lane = threadIdx.x & 31;
  double av[4], run = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    run += static_cast<double>(dv[e]) * A;
    av[e] = run;
  }
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const double before = incl - run;
  const double total = __shfl_sync(0xffffffffu, before + av[3], 31);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = 4 * lane + e;
    const double ar = before + av[e];
    coef[r] = r < valid ? (REV ? decay(ar) : decay(total - ar) * dv[e]) : 0.f;
  }
  if (lane == 0) *last = decay(total);
}

// Forward (REV false): S_in of every chunk, chunks in order.  Reverse (REV
// true): G of every chunk, from the last chunk down.
template <int NT, bool REV>
__device__ __forceinline__ void state_pass(const Params& p) {
  using T = Tile<NT>;
  constexpr int NA = NT / 2;               // floats a thread holds of a 64 x NT accumulator
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t su = smem_u32(sm);
  float* vecs = reinterpret_cast<float*>(sm + T::VEC_OFF);
  float* lasts = reinterpret_cast<float*>(sm + T::LAST_OFF);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int b = blockIdx.y;
  const int h_of = blockIdx.x * T::G + wg;
  const bool real = h_of < p.heads;        // a head past H repeats the last, stores nothing
  const int h = real ? h_of : p.heads - 1;
  // this thread's rows of a 64-row accumulator (head dim r0, r0 + 8) and
  // the column (state dim) of its first value in each 8-column group
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const float Ah = p.A[h * p.a_h];
  const float* dtg = p.dt + b * p.dt_b + h * p.dt_h;
  const __nv_bfloat16* ug = p.u + b * p.u_b;
  const __nv_bfloat16* vg = p.v + b * p.v_b + h * p.v_h;
  const long long st_size = static_cast<long long>(p.n) * p.p;

  float S[NA];                             // Sᵀ (or Gᵀ): rows p, columns n
#pragma unroll
  for (int i = 0; i < NA; ++i) S[i] = 0.f;

  // chunk t of the walk, its first row and its rows
  auto chunk_of = [&](int t) { return REV ? p.nchunks - 1 - t : t; };
  auto load_chunk = [&](int t) {           // its tiles into stage t % 2
    const int c = chunk_of(t), s0 = c * p.chunk, valid = min(p.chunk, p.seqlen - s0);
    uint8_t* stage = sm + (t & 1) * T::STAGE;
    load_tile(stage, ug + s0 * p.u_s, p.u_s, p.u_n, valid, p.n, T::NB, p.u_vec, tid, T::THREADS);
    load_tile(stage + (T::NB + wg) * BLK, vg + s0 * p.v_s, p.v_s, p.v_p, valid, p.p, 1, p.v_vec,
              tid & 127, 128);
    cp_async_commit();
  };

  // the first chunk's tiles and coefficients; every later chunk's are
  // fetched while the chunk before it computes
  if (p.nchunks > 1) {
    load_chunk(0);
    if (warp == 0) {
      const int s0 = chunk_of(0) * p.chunk, valid = min(p.chunk, p.seqlen - s0);
      float dv[4];
      load_dt(dtg, p.dt_s, s0, valid, dv);
      chunk_coef<REV>(dv, Ah, valid, vecs + wg * ML, lasts + wg);
    }
  }

  for (int t = 0; t < p.nchunks; ++t) {
    const int c = chunk_of(t);
    if (real) {                            // the state before chunk c's update
      float* og = p.out + ((static_cast<long long>(b) * p.nchunks + c) * p.heads + h) * st_size;
#pragma unroll
      for (int v = 0; v < NA; ++v) {
        const int q = r0 + 8 * ((v >> 1) & 1), n = 8 * (v >> 2) + cq + (v & 1);
        if (q < p.p && n < p.n) og[n * p.p + q] = S[v];
      }
    }
    if (t == p.nchunks - 1) break;         // the last chunk's update is not needed
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();                       // this chunk's tiles and coefficients are in
                                           // place; the last chunk is done with the other stage
    const bool more = t + 2 < p.nchunks;   // the next chunk is updated through too
    float dn[4] = {0.f, 0.f, 0.f, 0.f};
    int valid_n = 0;
    if (more) {
      load_chunk(t + 1);
      const int s0 = chunk_of(t + 1) * p.chunk;
      valid_n = min(p.chunk, p.seqlen - s0);
      if (warp == 0) load_dt(dtg, p.dt_s, s0, valid_n, dn);
    }
    const int s = t & 1;
    const uint8_t* vt = sm + s * T::STAGE + (T::NB + wg) * BLK;   // x (dy): rows j, columns q
    const float* cf = vecs + (s * T::G + wg) * ML;
    const uint32_t ut = su + s * T::STAGE;                         // B (C): rows j, columns n

    float u[NA];                           // uᵀ = x̃ᵀ·B of this chunk
#pragma unroll
    for (int i = 0; i < NA; ++i) u[i] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < KSTEPS; k0 += T::KG) {
      // A = x̃ᵀ of k-steps k0 .. k0 + KG - 1 in three terms: pair i holds
      // rows q = r0 + 8·(i&1), columns j, j + 1 with j = 16·k0 + 8·(i>>1) + cq
      uint32_t st[4 * T::KG][TERMS];
#pragma unroll
      for (int i = 0; i < 4 * T::KG; ++i) {
        const int q = r0 + 8 * (i & 1), j = 16 * k0 + 8 * (i >> 1) + cq;
        const float2 w = *reinterpret_cast<const float2*>(cf + j);
        const int col = (q & 7) * 2;
        const float x0 = __bfloat162float(
            *reinterpret_cast<const __nv_bfloat16*>(vt + sw(j, q >> 3) + col));
        const float x1 = __bfloat162float(
            *reinterpret_cast<const __nv_bfloat16*>(vt + sw(j + 1, q >> 3) + col));
        split3(x0 * w.x, x1 * w.y, st[i]);
      }
      fence_regs(u);
#pragma unroll
      for (int i = 0; i < 4 * T::KG; ++i) fence_regs(st[i]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < T::KG; ++k) {
        const uint64_t db = mnmajor(ut, k0 + k);
#pragma unroll
        for (int tm = 0; tm < TERMS; ++tm) {
          const uint32_t at[4] = {st[4 * k][tm], st[4 * k + 1][tm], st[4 * k + 2][tm],
                                  st[4 * k + 3][tm]};
          Mma<NT>::rs(u, at, db);
        }
      }
      wgmma_commit();
      // while the last group runs: the next chunk's coefficients
      if (k0 + T::KG == KSTEPS && more && warp == 0)
        chunk_coef<REV>(dn, Ah, valid_n, vecs + (((t + 1) & 1) * T::G + wg) * ML,
                        lasts + ((t + 1) & 1) * T::G + wg);
      wgmma_wait_all();
      fence_regs(u);
    }
    const float last = lasts[s * T::G + wg];
#pragma unroll
    for (int i = 0; i < NA; ++i) S[i] = fmaf(S[i], last, u[i]);
  }
}

template <int NT>
__global__ void __launch_bounds__(Tile<NT>::THREADS, 2)
    ssd_scan_bwd_state_kernel_wgmma(const Params p) {
  state_pass<NT, false>(p);
}

template <int NT>
__global__ void __launch_bounds__(Tile<NT>::THREADS, 2)
    ssd_scan_bwd_dstate_kernel_wgmma(const Params p) {
  state_pass<NT, true>(p);
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

using Kernel = void (*)(const Params);

// The kernel of a pass at state tile NT, its shared memory and its
// preference for shared memory over L1 set (two CTAs an SM need 198 KB)
template <int NT>
Kernel prepared(bool rev, cudaError_t* err) {
  const Kernel kernel =
      rev ? &ssd_scan_bwd_dstate_kernel_wgmma<NT> : &ssd_scan_bwd_state_kernel_wgmma<NT>;
  *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Tile<NT>::BYTES);
  if (*err == cudaSuccess)
    *err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  return kernel;
}

template <int NT>
int launch(bool rev, const Params& p, cudaStream_t stream) {
  cudaError_t err;
  const Kernel kernel = prepared<NT>(rev, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.heads + Tile<NT>::G - 1) / Tile<NT>::G, p.batch);
  kernel<<<grid, Tile<NT>::THREADS, Tile<NT>::BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int run(bool rev, const void* const* ptrs, const long long* s, const int* dims, void* stream) {
  const int batch = dims[0], seqlen = dims[1], heads = dims[2], head_dim = dims[3],
            state = dims[4], chunk = dims[5], bf16 = dims[6];
  if (bf16 != 1 || batch < 1 || batch > 65535 || seqlen < 1 || heads < 1 || head_dim < 1 ||
      head_dim > MP || state < 1 || state > MN || chunk < 1 || chunk > ML) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nchunks = (seqlen + chunk - 1) / chunk;
  if (nchunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  // forward: B and x; reverse: C and dy
  p.u = static_cast<const __nv_bfloat16*>(ptrs[rev ? PC : PB]);
  p.v = static_cast<const __nv_bfloat16*>(ptrs[rev ? PDY : PX]);
  p.dt = static_cast<const float*>(ptrs[PDT]);
  p.A = static_cast<const float*>(ptrs[PA]);
  p.out = static_cast<float*>(const_cast<void*>(ptrs[rev ? PG : PSIN]));
  const long long* us = s + (rev ? 11 : 8);          // B (8-10) or C (11-13)
  const long long* vs = s + (rev ? 14 : 0);          // x (0-3) or dy (14-17)
  p.u_b = us[0]; p.u_s = us[1]; p.u_n = us[2];
  p.v_b = vs[0]; p.v_s = vs[1]; p.v_h = vs[2]; p.v_p = vs[3];
  p.dt_b = s[4]; p.dt_s = s[5]; p.dt_h = s[6];
  p.a_h = s[7];
  p.batch = batch; p.seqlen = seqlen; p.heads = heads; p.p = head_dim; p.n = state;
  p.chunk = chunk; p.nchunks = nchunks;
  p.u_vec = rows_vec(p.u, us, 3, state);
  p.v_vec = rows_vec(p.v, vs, 4, head_dim);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  return state <= 64 ? launch<64>(rev, p, strm) : launch<128>(rev, p, strm);
}

}  // namespace

extern "C" {

// Enqueue the bf16 state pass (S_in) or reverse state pass (G) of the SSD
// backward on `stream`, in place of ssd_scan_bwd.cu's repro_ssd_bwd_state
// and repro_ssd_bwd_dstate (f32 only), before the chunk kernel, with their
// arguments: `ptrs` holds the backward's 16 device pointers (x, dt, A, B,
// C, dy: x, B, C, dy bf16, dt and A f32; then f32 sin and g, (B, nC, H, N,
// P) each, nC = ceil(S / chunk), contiguous; the rest unused here),
// `strides` the 18 element strides of the inputs (x 4, dt 3, A 1, B 3,
// C 3, dy 4), `dims` batch, seqlen, heads, head_dim, state, chunk, bf16
// (must be 1), parts (unused).  Requires 1 <= chunk <= 128,
// 1 <= state <= 128, 1 <= head_dim <= 64, 1 <= batch < 65536, nC < 65536.
// Returns cudaGetLastError() of the launch as an int (0 = launched).
int repro_ssd_bwd_state_tc(const void* const* ptrs, const long long* strides, const int* dims,
                           void* stream) {
  return run(false, ptrs, strides, dims, stream);
}

int repro_ssd_bwd_dstate_tc(const void* const* ptrs, const long long* strides, const int* dims,
                            void* stream) {
  return run(true, ptrs, strides, dims, stream);
}

}  // extern "C"
