// Chunked SSD (Mamba2 state-space duality) forward for Hopper (sm_90a) on the
// tensor cores, bf16.
//
// Replaces, for bf16 x, B, C, the TPU kernel src/repro/kernels/ssd_scan/
// kernel.py::ssd_scan_pallas (_ssd_kernel); f32 stays on the FFMA kernel of
// ssd_scan.cu.  Same function: x (B,S,H,P), B/C (B,S,N) shared by the heads,
// bf16; dt (B,S,H) and A (H,) f32; all products f32-exact, h carried in f32,
// y in bf16.  For a chunk of L steps with a = cumsum(dt·A) (inclusive):
//
//   y_i = exp(a_i)·C_i·h + Σ_{j<=i} (C_i·B_j)·exp(a_i - a_j)·dt_j·x_j
//   h  <- exp(a_L)·h + Σ_j B_j ⊗ (exp(a_L - a_j)·dt_j·x_j)
//
// and, when asked, the state after the last step (h_S, B x H x N x P, f32).
// Chunks start at position 0; rows past S are masked here (read as 0), so
// the wrapper never pads.  x, B, C, y are taken by strides: the model's B
// and C are slices of one (B,S,2N) tensor, read in place.
//
// What bounds it: at the mamba2-130m layer (B=8, S=8192, H=24, P=64, N=128,
// L=128) one launch moves ~0.44 GB: bytes bound it near 0.13 ms on an H100.
// The products this kernel issues (~2.6e11 FLOP: three-term operands, and
// the scores' masked half) would take 0.27 ms at the tensor cores' bf16
// peak.  The FFMA kernel's f32 arithmetic and its 1.45 waves of one-head
// CTAs kept it ~80x above the bound.
//
// Design:
// * All four products on wgmma (m64nNk16, bf16 operands, f32 accumulators):
//   C·Bᵀ (SS), the decayed scores times x (RS: the scores from registers),
//   C·h (SS) and the state update Bᵀ·x̃ (SS, A read transposed).  C, B and
//   x enter exact.  Each f32 factor is folded into an operand that is f32
//   anyway: dt_j and exp(a_i - a_j) into the score tile's columns;
//   exp(a_L - a_j)·dt_j into x for the state update (x̃ = w·x: the same
//   precision as folding it into B, on half the elements, L x P against
//   L x N); exp(a_i) scales C·h's accumulator rows.  Each f32 operand (the
//   scores, h, x̃) enters as three bf16 terms, hi + mid + lo (exact to
//   ~2^-24, as f32), so every product but C·Bᵀ costs three wgmma.  With
//   two terms (exact to ~2^-17) the outputs lay ~30x further from the
//   plain f32 version's, and on an H100 the smoke's per-layer check on
//   mamba2-130m's real inputs read a row error of 1.5e-2 (limit 1e-2, the
//   f32 FFMA kernel 6.9e-3): rows whose bf16 rounding flipped more often.
//   tests/test_torch_ssd_tensor_cores.py models one, two and three terms.
//   Never TF32.  The diagonal scores C_i·B_i are summed once more on the
//   CUDA cores, a compensated (two-sum) f32 sum of the exact products, while
//   the tensor cores sum C·Bᵀ: where a step's decay erases the rest of its
//   chunk (dt·A near -20 a step), row i of y is C_i·B_i·dt_i·x_i, and where
//   that dot product of N terms cancels, the tensor cores' chained f32 sum
//   over the 8 k-steps was off by up to 1.6% of the row (chip_smoke.py,
//   mamba2-130m's real inputs on an H100, against the plain version in
//   f64); such a row hangs on C_i·B_i alone, the other scores are damped.  It costs ~15% of the launch (1.31 -> 1.50 ms at the
//   mamba2-130m layer shape).
// * One CTA of 256 threads (two warpgroups of 64 rows) per (two heads,
//   batch row): C·Bᵀ, which no head changes (mamba2 has one group), is
//   computed once per chunk for both heads and kept in registers; each
//   head's mask and decay are applied to it there.  96 CTAs at the layer
//   shape, one wave of 132 SMs; each walks its 64 chunks in order (the TPU
//   grid's sequential chunk axis), h of both heads in shared memory as f32.
//   Of the designs "carry inside a CTA" and "chunk states in parallel, then
//   a scan" this is the first: it writes no chunk states (the second moves
//   ~0.4 GB of them), at the cost of a sequential chunk loop per CTA.
// * Loads: each chunk's C and B tiles (L x N) and the two x tiles (L x P)
//   go to shared memory by cp.async 16-byte copies from the caller's
//   strided rows (zero-filled past S, N and P), straight into the 128-byte
//   swizzle that the wgmma descriptors read; a layout off 16 bytes is
//   loaded element by element instead.  No copy, no tensor map, and no
//   mbarrier that could wait forever.  The next chunk's tiles are fetched
//   as soon as this chunk is done with them (a warpgroup's rows of C after
//   its last C·h, an x tile after its x̃, a warpgroup's block of B after
//   its last state update), so the loads run under the products.
// * Operands written by threads (h's terms, x̃'s terms) share one buffer,
//   and a proxy fence orders those writes before wgmma reads them.
// * Every wgmma loop has a fixed trip count and no branch around it: the
//   zero-filled tiles make the k-steps past N or past the chunk's rows add
//   0, a second head past H runs on zeros and stores nothing, and h = 0
//   makes the first chunk's C·h 0.  (A branch around a wgmma, or one that
//   defines its register operands, makes the compiler serialize them.)
// Shared memory: C 32 KB, B 32 KB, x 2 x 16 KB, the operand buffer 48 KB,
// h 2 x 32 KB, a and dt 2 KB: 210 KB, one CTA per SM.
//
// Plain C interface (built with nvcc into the ssd_scan library, loaded with
// ctypes): the caller owns every allocation and the stream; one call
// launches one kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;     // two warpgroups
constexpr int ML = 128;          // largest chunk L: the tile's rows
constexpr int MN = 128;          // largest state dim N
constexpr int MP = 64;           // largest head dim P
constexpr int G = 2;             // heads per CTA
constexpr int TERMS = 3;         // bf16 terms of an f32 operand
constexpr float LOG2E = 1.4426950408889634f;

// Phase profile, compiled in only with -DSSD_PHASES (tools/
// ssd_phase_profile.py): at each PHASE(k) the first thread of each
// warpgroup adds the clock64() cycles since its last mark to a shared
// counter of phase k, and the counters go to g_phases (CTA, warpgroup,
// phase) at the end.  A wait at a barrier counts to the phase it ends.
#ifdef SSD_PHASES
constexpr int PHASES = 9;
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
      g_phases[(blockIdx.y * gridDim.x + blockIdx.x) * 2 * PHASES +          \
               (threadIdx.x >> 7) * PHASES + k] = phase_acc[threadIdx.x >> 7][k]
#else
#define PHASE_START
#define PHASE(k)
#define PHASE_END
#endif

constexpr int BLK = ML * 128;    // bytes of one 64-column block of a 128-row tile
constexpr int C_OFF = 0;                          // C: 2 blocks (n 0-63, 64-127)
constexpr int B_OFF = C_OFF + 2 * BLK;            // B: 2 blocks
constexpr int X_OFF = B_OFF + 2 * BLK;            // x: one block per head
constexpr int OP_OFF = X_OFF + G * BLK;           // h terms, then x̃ terms
constexpr int H_OFF = OP_OFF + TERMS * BLK;       // h (f32), fragment order
constexpr int A_OFF = H_OFF + G * 32 * THREADS * 4;   // a = cumsum(dt·A)
constexpr int D_OFF = A_OFF + G * ML * 4;         // dt
constexpr int SMEM_BYTES = D_OFF + G * ML * 4 + 1024;  // + slack to align to 1024

struct Params {
  const __nv_bfloat16* x;
  const float* dt;
  const float* A;
  const __nv_bfloat16* B;
  const __nv_bfloat16* C;
  __nv_bfloat16* y;
  float* hout;                   // h_S (B,H,N,P) contiguous, or null
  long long x_b, x_s, x_h, x_p;  // element strides
  long long dt_b, dt_s, dt_h;
  long long a_h;
  long long b_b, b_s, b_n;
  long long c_b, c_s, c_n;
  long long y_b, y_s, y_h, y_p;
  int heads, seqlen, p, n, chunk;
  int x_vec, b_vec, c_vec;       // rows readable by 16-byte copies
  int y_pairs;                   // y's last dim contiguous, every stride even
};

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

// Rows r_lo .. r_lo + nrows - 1 and 64-column blocks blk .. blk + nblk - 1
// of a (rows x cols) bf16 operand, element (r, c) at g[r*rs + c*cs], into
// the tile of swizzled 64-column blocks at dst, by thread t of nt; rows
// from `valid` and columns from `cols` on are zero.  `vec`: cs == 1, cols
// and rs multiples of 8, g 16-byte aligned.
__device__ __forceinline__ void load_tile(uint8_t* sm, int dst, const __nv_bfloat16* g,
                                          long long rs, long long cs, int valid, int cols,
                                          int r_lo, int nrows, int blk, int nblk, bool vec,
                                          int t, int nt) {
  if (vec) {
    const int chunks = nblk * 8;
    const uint32_t base = smem_u32(sm + dst);
    for (int i = t; i < nrows * chunks; i += nt) {
      const int r = r_lo + i / chunks, k = 8 * blk + i % chunks;
      const bool ok = r < valid && 8 * k < cols;
      cp_async16(base + (k >> 3) * BLK + sw(r, k & 7), ok ? g + r * rs + 8 * k : g, ok ? 16 : 0);
    }
  } else {
    const int width = nblk * 64;
    for (int i = t; i < nrows * width; i += nt) {
      const int r = r_lo + i / width, c = 64 * blk + i % width;
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
// MN-major operand (rows of the K dim, 64 M or N values along a row): rows
// 16 kk .. 16 kk + 15
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

// D (64 x 128, f32) {+}= A (64 x 16, K-major smem) * B (16 x 128, K-major smem)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
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
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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

// D (64 x 64, f32) {+}= A (64 x 16, smem) * B (16 x 64, MN-major smem); A
// K-major (TA = 0) or MN-major (TA = 1)
template <int TA>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, MN-major smem)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
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

__global__ void __launch_bounds__(THREADS, 1) ssd_scan_kernel_wgmma(const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t su = smem_u32(sm);
  float* hs = reinterpret_cast<float*>(sm + H_OFF);      // [G][32][THREADS]
  float* as = reinterpret_cast<float*>(sm + A_OFF);      // [G][ML]
  float* ds = reinterpret_cast<float*>(sm + D_OFF);      // [G][ML]

  PHASE_START;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int b = blockIdx.y, h0 = G * blockIdx.x;
  const int ng = min(G, p.heads - h0);                  // a second head past H: zeros
  // this thread's rows of a 64-row accumulator (r0, r0 + 8) and the column
  // of its first value in each 8-column group
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const uint32_t c_wg = su + C_OFF + wg * 64 * 128;     // this warpgroup's rows of C

  // the operands of this CTA, from position 0; a second head past H reads
  // the first one's x and dt, as zero rows
  const __nv_bfloat16* cg = p.C + b * p.c_b;
  const __nv_bfloat16* bg = p.B + b * p.b_b;
  const __nv_bfloat16* xg[G];
#pragma unroll
  for (int g = 0; g < G; ++g) xg[g] = p.x + b * p.x_b + (h0 + min(g, ng - 1)) * p.x_h;

  for (int i = tid; i < G * 32 * THREADS; i += THREADS) hs[i] = 0.f;
  // the first chunk's tiles; every later chunk's are prefetched as soon as
  // the chunk before is done with them
  {
    const int valid = min(p.chunk, p.seqlen);
    load_tile(sm, C_OFF, cg, p.c_s, p.c_n, valid, p.n, 0, ML, 0, 2, p.c_vec, tid, THREADS);
    load_tile(sm, B_OFF, bg, p.b_s, p.b_n, valid, p.n, 0, ML, 0, 2, p.b_vec, tid, THREADS);
#pragma unroll
    for (int g = 0; g < G; ++g)
      load_tile(sm, X_OFF + g * BLK, xg[g], p.x_s, p.x_p, g < ng ? valid : 0, p.p, 0, ML, 0, 1,
                p.x_vec, tid, THREADS);
  }

  for (int s0 = 0; s0 < p.seqlen; s0 += p.chunk) {
    const int valid = min(p.chunk, p.seqlen - s0);
    const int s1 = s0 + p.chunk;                        // the next chunk, if any
    const int valid1 = s1 < p.seqlen ? min(p.chunk, p.seqlen - s1) : 0;
    __syncthreads();                                    // the last chunk is done with a and dt
    // dt and a = cumsum(dt·A) of head g in warp g: lane l owns rows 4l .. 4l+3;
    // rows past `valid` add 0, so a[ML-1] = a_L
    if (warp < G && wg == 0) {
      const int g = warp;
      const float A = g < ng ? p.A[(h0 + g) * p.a_h] : 0.f;
      const float* dtg = p.dt + b * p.dt_b + (h0 + min(g, ng - 1)) * p.dt_h;
      float d[4], a[4], run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * lane + e;
        d[e] = r < valid && g < ng ? dtg[(s0 + r) * p.dt_s] : 0.f;
        run += d[e] * A;
        a[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const float before = incl - run;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        as[g * ML + 4 * lane + e] = before + a[e];
        ds[g * ML + 4 * lane + e] = d[e];
      }
    }
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();
    PHASE(0);                                           // chunk start: a, dt, the tiles' wait

    // C·Bᵀ for this warpgroup's 64 rows and all 128 columns, once for the heads
    float cb[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) cb[i] = 0.f;
    fence_regs(cb);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < ML / 16; ++kk)
      wgmma_ss_n128(cb, kmajor(c_wg, kk), kmajor(su + B_OFF, kk), kk > 0);
    wgmma_commit();
    // while the tensor cores sum C·Bᵀ: the diagonal scores C_i·B_i of this
    // thread's rows r0, r0 + 8 on the CUDA cores, as a compensated f32 sum
    // of the exact products (see the header): thread q of a quad takes
    // columns 8q .. 8q + 7 of each 32, and the quad adds its four sums
    float dg[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float sum = 0.f, err = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k = (lane & 3) + 4 * t;             // 16-byte chunk of the row
        const int off = (k >> 3) * BLK + sw(r0 + 8 * e, k & 7);
        const uint4 cv = *reinterpret_cast<const uint4*>(sm + C_OFF + off);
        const uint4 bv = *reinterpret_cast<const uint4*>(sm + B_OFF + off);
        const uint32_t cw[4] = {cv.x, cv.y, cv.z, cv.w};
        const uint32_t bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 c2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&cw[w]));
          const float2 b2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bw[w]));
          two_sum(sum, err, c2.x * b2.x);               // a bf16 product is exact in f32
          two_sum(sum, err, c2.y * b2.y);
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float s2 = __shfl_xor_sync(0xffffffffu, sum, o);
        const float e2 = __shfl_xor_sync(0xffffffffu, err, o);
        two_sum(sum, err, s2);
        err += e2;
      }
      dg[e] = sum + err;
    }
    wgmma_wait_all();
    fence_regs(cb);
    // the diagonal score of each of this thread's rows, C_i·B_i
#pragma unroll
    for (int v = 0; v < 64; ++v)
      if (8 * (v >> 2) + cq + (v & 1) == r0 + 8 * ((v >> 1) & 1)) cb[v] = dg[(v >> 1) & 1];
    PHASE(1);                                           // C·Bᵀ

#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float* a = as + g * ML;
      const float* dtv = ds + g * ML;
      float* hg = hs + g * 32 * THREADS;
      const float ai0 = a[r0], ai1 = a[r0 + 8];
      const float a_last = a[ML - 1];

      // y = exp(a_i)·(C·h), h in three bf16 terms from its f32 copy
      __syncthreads();                                  // the operand buffer is free
#pragma unroll
      for (int v = 0; v < 32; v += 2) {
        const int n = r0 + 8 * ((v >> 1) & 1), c = 8 * (v >> 2) + cq;
        uint32_t t[TERMS];
        split3(hg[v * THREADS + tid], hg[(v + 1) * THREADS + tid], t);
        const int off = OP_OFF + sw(n, c >> 3) + (c & 7) * 2;
#pragma unroll
        for (int i = 0; i < TERMS; ++i) *reinterpret_cast<uint32_t*>(sm + off + i * BLK) = t[i];
      }
      fence_async_smem();
      __syncthreads();
      PHASE(2);                                         // h's terms
      float y[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) y[i] = 0.f;
      fence_regs(y);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < MN / 16; ++kk)
#pragma unroll
        for (int t = 0; t < TERMS; ++t)
          wgmma_ss_n64<0>(y, kmajor(c_wg, kk), mnmajor(su + OP_OFF + t * BLK, kk), kk + t > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(y);
      const float e0 = exp2f(ai0 * LOG2E), e1 = exp2f(ai1 * LOG2E);
#pragma unroll
      for (int v = 0; v < 32; ++v) y[v] *= (v & 2) ? e1 : e0;
      PHASE(3);                                         // C·h
      // this warpgroup is done with its rows of C: the next chunk's
      if (g == G - 1 && valid1 > 0)
        load_tile(sm, C_OFF, cg + s1 * p.c_s, p.c_s, p.c_n, valid1, p.n, 64 * wg, 64, 0, 2,
                  p.c_vec, tid & 127, 128);

      // y += S·x with S_ij = (C·Bᵀ)_ij·exp(a_i - a_j)·dt_j below the diagonal
      // (0 above it; the exponent is clamped there, so it cannot overflow): S
      // from registers in three bf16 terms, in two halves of four k-steps so
      // that one half's terms are live at a time.  Pair q holds cb[2q],
      // cb[2q+1]: row r0 + 8·(q&1), columns 8·(q>>1) + cq, +1.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t st[16][TERMS];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int q = 16 * half + i;
          const int j = 8 * (q >> 1) + cq;
          const int row = r0 + 8 * (q & 1);
          const float ai = (q & 1) ? ai1 : ai0;
          const float f0 = exp2f(fminf(ai - a[j], 0.f) * LOG2E) * dtv[j];
          const float f1 = exp2f(fminf(ai - a[j + 1], 0.f) * LOG2E) * dtv[j + 1];
          split3(j <= row ? cb[2 * q] * f0 : 0.f, j + 1 <= row ? cb[2 * q + 1] * f1 : 0.f, st[i]);
        }
        PHASE(4);                                       // the scores' terms
        fence_regs(y);
#pragma unroll
        for (int i = 0; i < 16; ++i) fence_regs(st[i]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint64_t db = mnmajor(su + X_OFF + g * BLK, 4 * half + k);
#pragma unroll
          for (int t = 0; t < TERMS; ++t) {
            const uint32_t at[4] = {st[4 * k][t], st[4 * k + 1][t], st[4 * k + 2][t],
                                    st[4 * k + 3][t]};
            wgmma_rs_n64(y, at, db);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(y);
        PHASE(5);                                       // S·x
      }

      // y out: rows r0, r0 + 8 of the chunk, columns 8·(v>>2) + cq + (v&1)
      if (g < ng) {
        __nv_bfloat16* yg = p.y + b * p.y_b + (h0 + g) * p.y_h + s0 * p.y_s;
#pragma unroll
        for (int v = 0; v < 32; v += 2) {
          const int row = r0 + 8 * ((v >> 1) & 1), col = 8 * (v >> 2) + cq;
          if (row >= valid) continue;
          __nv_bfloat16* out = yg + row * p.y_s + col * p.y_p;
          if (p.y_pairs && col + 1 < p.p) {
            *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(y[v], y[v + 1]);
          } else {
            if (col < p.p) out[0] = __float2bfloat16(y[v]);
            if (col + 1 < p.p) out[p.y_p] = __float2bfloat16(y[v + 1]);
          }
        }
      }

      PHASE(6);                                         // y out
      // x̃_j = exp(a_L - a_j)·dt_j·x_j in three bf16 terms into the operand
      // buffer (the same swizzled offsets as the x tile)
      __syncthreads();                                  // every C·h has read h's terms
      for (int i = tid; i < ML * 8; i += THREADS) {
        const int r = i >> 3, off = sw(r, i & 7);
        const float w = exp2f((a_last - a[r]) * LOG2E) * dtv[r];
        const uint4 xv = *reinterpret_cast<const uint4*>(sm + X_OFF + g * BLK + off);
        const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
        uint32_t t[4][TERMS];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xw[e]));
          split3(f.x * w, f.y * w, t[e]);
        }
#pragma unroll
        for (int k = 0; k < TERMS; ++k)
          *reinterpret_cast<uint4*>(sm + OP_OFF + k * BLK + off) =
              make_uint4(t[0][k], t[1][k], t[2][k], t[3][k]);
      }
      fence_async_smem();
      __syncthreads();
      PHASE(7);                                         // x̃'s terms
      // every thread is done with this head's x tile: the next chunk's
      if (valid1 > 0)
        load_tile(sm, X_OFF + g * BLK, xg[g] + s1 * p.x_s, p.x_s, p.x_p, g < ng ? valid1 : 0, p.p,
                  0, ML, 0, 1, p.x_vec, tid, THREADS);

      // h <- exp(a_L)·h + Bᵀ·x̃: this warpgroup's 64 state rows; A = Bᵀ read
      // transposed from the B tile's block wg, B = x̃'s terms
      float u[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) u[i] = 0.f;
      fence_regs(u);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < ML / 16; ++kk)
#pragma unroll
        for (int t = 0; t < TERMS; ++t)
          wgmma_ss_n64<1>(u, mnmajor(su + B_OFF + wg * BLK, kk),
                          mnmajor(su + OP_OFF + t * BLK, kk), kk + t > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(u);
      const float decay = exp2f(a_last * LOG2E);
#pragma unroll
      for (int v = 0; v < 32; ++v) hg[v * THREADS + tid] = hg[v * THREADS + tid] * decay + u[v];
      PHASE(8);                                         // the state update
      // this warpgroup is done with its block of B (the other's C·Bᵀ is
      // long done): the next chunk's
      if (g == G - 1 && valid1 > 0)
        load_tile(sm, B_OFF, bg + s1 * p.b_s, p.b_s, p.b_n, valid1, p.n, 0, ML, wg, 1, p.b_vec,
                  tid & 127, 128);
    }
  }

  PHASE_END;
  if (p.hout != nullptr) {
    for (int g = 0; g < ng; ++g) {
      float* out = p.hout + (static_cast<long long>(b) * p.heads + h0 + g) * p.n * p.p;
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        const int n = r0 + 8 * ((v >> 1) & 1), c = 8 * (v >> 2) + cq + (v & 1);
        if (n < p.n && c < p.p) out[n * p.p + c] = hs[(g * 32 + v) * THREADS + tid];
      }
    }
  }
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

}  // namespace

extern "C" {

// Enqueue the bf16 SSD scan on the tensor cores on `stream`.  x (B,S,H,P),
// B and C (B,S,N) and y (B,S,H,P) are bf16 device arrays, dt (B,S,H) and A
// (H,) f32, all addressed by element strides as in repro_ssd_scan; hout,
// when not null, a contiguous (B,H,N,P) f32 array that receives the state
// after the last step.  Requires 1 <= chunk <= 128, 1 <= n <= 128,
// 1 <= p <= 64, seqlen >= 1, 1 <= batch < 65536, heads >= 1.  Returns
// cudaGetLastError() of the launch as an int (0 = launched).
int repro_ssd_scan_tc(const void* x, const void* dt, const void* A, const void* Bm,
                      const void* Cm, void* y, void* hout, const long long* xs,
                      const long long* dts, long long a_stride, const long long* bs,
                      const long long* cs, const long long* ys, int batch, int seqlen, int heads,
                      int head_dim, int state, int chunk, void* stream) {
  if (batch < 1 || batch > 65535 || seqlen < 1 || heads < 1 || head_dim < 1 ||
      head_dim > MP || state < 1 || state > MN || chunk < 1 || chunk > ML) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.B = static_cast<const __nv_bfloat16*>(Bm);
  p.C = static_cast<const __nv_bfloat16*>(Cm);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.hout = static_cast<float*>(hout);
  p.x_b = xs[0]; p.x_s = xs[1]; p.x_h = xs[2]; p.x_p = xs[3];
  p.dt_b = dts[0]; p.dt_s = dts[1]; p.dt_h = dts[2];
  p.a_h = a_stride;
  p.b_b = bs[0]; p.b_s = bs[1]; p.b_n = bs[2];
  p.c_b = cs[0]; p.c_s = cs[1]; p.c_n = cs[2];
  p.y_b = ys[0]; p.y_s = ys[1]; p.y_h = ys[2]; p.y_p = ys[3];
  p.heads = heads; p.seqlen = seqlen; p.p = head_dim; p.n = state; p.chunk = chunk;
  p.x_vec = rows_vec(x, xs, 4, head_dim);
  p.b_vec = rows_vec(Bm, bs, 3, state);
  p.c_vec = rows_vec(Cm, cs, 3, state);
  p.y_pairs = ys[3] == 1 && ys[0] % 2 == 0 && ys[1] % 2 == 0 && ys[2] % 2 == 0 &&
              reinterpret_cast<uintptr_t>(y) % 4 == 0;
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel_wgmma,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((heads + G - 1) / G, batch);
  ssd_scan_kernel_wgmma<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

#ifdef SSD_PHASES
// Where the phase counters go: a device array of (CTAs x 2 x PHASES) int64.
int repro_ssd_set_phases(long long* out) {
  return static_cast<int>(cudaMemcpyToSymbol(g_phases, &out, sizeof(out)));
}
#endif

}  // extern "C"
