// Flash attention backward's dQ on Hopper's tensor cores (sm_90a), bf16 with
// padded head dims DP = 64 or 128: dQ of O = softmax(mask(cap(s·QKᵀ)))·V,
// and the row statistics LSE and D that the dK/dV kernel reads.
//
// The gradient of the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas for bf16 calls whose max(d, dv) rounds up to at most
// 128 (zamba2-7b's shared attention, D 112).  The JAX package differentiates
// its forward's route and has no backward kernel of its own.  f32, and bf16
// at DP 192 or 256 (gemma2-2b's D 256), keep the FFMA dQ kernel of
// flash_attention_bwd.cu; every call's dK and dV come from that file's dK/dV
// kernel, launched after this one on the same stream.  The function is that
// file's dQ kernel's (see its header for the formulas): GQA by ratio, scale,
// the tanh soft-cap, causal with the ends aligned, the sliding window, ragged
// Sq/Skv, dv != d, and dQ = 0 for a row with no unmasked key.  LSE and D are
// written as that kernel writes them: f32 (B, Hq, Sq), LSE = +inf and D = 0
// for a row with no unmasked key, D summed from P and dP (never from the
// forward's bf16 output, which would move it: see that header).
//
// What bounds it: at zamba2-7b's train layer (B 4, Hq = Hkv = 32, S 1024,
// D 112, causal) the three products the function needs (S = QKᵀ, dP = dO·Vᵀ,
// dQ = dS·K) are 45 GFLOP, 0.0456 ms at the tensor cores' bf16 989 TFLOP/s,
// against ~148 MB of I/O (q, k, v, dO read, dQ and the statistics written),
// 0.044 ms at 3.35 TB/s: the tensor cores bound it, barely.  The two passes
// compute S and dP twice, five products, 0.076 ms; dS in two terms makes six.
//
// Design, after flash_attention_wgmma.cu's forward:
// * One CTA of 256 threads per (128 query rows, head, batch): two consumer
//   warpgroups of 64 rows share each K/V tile of 64 keys.  Query blocks run
//   last-first.  Key tiles wholly above the diagonal or outside the window
//   are never loaded.
// * TMA loads Q and dO once and keeps a 2-stage ring of K/V tiles, which
//   both passes walk in turn (2 × n tiles in all); one elected thread starts
//   the copies, one mbarrier a stage, a __syncthreads() after the last read
//   of a stage frees it.  Four 4-D tensor maps read the model's transposed
//   views in place; D and Dv are padded to DP by TMA's zero fill.  Shared
//   memory at DP 128: Q 32 KB + dO 32 KB + 2 × (K 16 KB + V 16 KB) = 128 KB.
// * Pass 1: S = Q·Kᵀ and dP = dO·Vᵀ, wgmma m64n64k16 with both operands in
//   shared memory (V read K-major, as K is).  Each row keeps its online max
//   m, l = Σ exp(s − m) and w = Σ exp(s − m)·dP in f32; a row lies in the 4
//   threads of a quad: the max takes two shuffles a tile, l and w are summed
//   over the quad once at the end.  LSE = m + log l, D = w / l.
// * Pass 2: S and dP again, P = exp(s − LSE), dS = P ⊙ (dP − D) ⊙ (1 − t²) ·
//   scale on the f32 fragment, and dQ += dS·K with A = dS from registers
//   (the S fragment maps onto the A fragment as P does in the forward) and
//   B = the K tile read MN-major, as the forward reads V; dQ's accumulator
//   is 64 × DP f32 a warpgroup, DP / 2 registers a thread.  dS enters as
//   DS_TERMS = 2 bf16 terms, hi + lo (exact to ~2^-17 of dS).  One term
//   rounds dS to 2^-9, and a dQ row's terms cancel (Σ dS = 0 over a row):
//   in a plain-torch model of this arithmetic (tests/test_torch_flash_
//   backward_tc.py) one term leaves the worst row 0.45–0.57 of the bf16 row
//   limit (1e-2 of its norm) at the card tests' shapes, above the half
//   that the kernel may take, and two terms leave at most 0.25.
// * The products chain onto dQ's accumulator over the whole row: unlike the
//   forward's O, dQ is never rescaled, and its limits (3e-2 elementwise, 1e-2
//   of a row) are far above what wgmma's truncating f32 accumulation moves
//   over 2 × 4 × 16 steps (~1e-5 of a row), so the forward's tile
//   accumulator would cost 64 registers a thread for nothing.
// * Epilogue: dQ rounded to bf16 and stored by strides (rows past Sq and
//   columns past D dropped); LSE and D by one thread of each quad.
// Every dQ element is written by one CTA and summed in one fixed order: no
// atomics, two runs are bit-equal.  No warp specialisation, persistent CTAs
// or clusters: one __syncthreads() a tile keeps the two warpgroups in step.
// __launch_bounds__(256, 1): ptxas gives 157 registers a thread at DP 128
// and 125 at DP 64, no spills, no serialized wgmma (nvcc on the H100 host).
//
// Plain C interface (built with nvcc into the flash_attention library,
// loaded with ctypes): the caller owns every allocation and the stream; one
// call launches one kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

constexpr int BQ = 128;         // query rows per CTA (two warpgroups of 64)
constexpr int THREADS = 256;
constexpr int MAX_DP = 128;     // the largest padded head dim this kernel takes
constexpr int DS_TERMS = 2;     // bf16 terms of dS in dQ += dS·K

struct Params {
  void* dq;
  long long dq_b, dq_h, dq_s, dq_d;  // element strides of dq
  float* lse;                        // (B, Hq, Sq), contiguous
  float* delta;                      // (B, Hq, Sq), contiguous
  int hq, sq, skv, d, group;         // group = Hq / Hkv
  int causal, window;
  float scale, softcap, inv_cap;
  int q_perm, k_perm, v_perm, do_perm;
};

constexpr int Q_BLOCK = BQ * 128;     // bytes of one 64-column block of the Q or dO tile

// Shared memory of the kernel at padded head dim DP, in bytes from the
// first 1024-byte boundary: Q, dO, two ring stages (K's blocks, then V's),
// three mbarriers (Q and dO, stage 0, stage 1).
template <int DP>
struct Layout {
  static constexpr int NB = DP / 64;                  // 64-column blocks of each tile
  static constexpr int TILE_BYTES = NB * Q_BLOCK;     // Q, and dO
  static constexpr int STAGE = 2 * NB * KV_BLOCK;     // K blocks, then V blocks
  static constexpr int Q = 0;
  static constexpr int DO = TILE_BYTES;
  static constexpr int KV = 2 * TILE_BYTES;
  static constexpr int BARS = KV + 2 * STAGE;
  static constexpr int BYTES = BARS + 3 * 8 + 1024;   // + slack to align the base to 1024
};
static_assert(Layout<128>::BARS == 128 * 1024, "DP 128: Q 32 KB + dO 32 KB + 2 x (K + V) 64 KB");
static_assert(Layout<64>::BARS == 64 * 1024, "DP 64: Q 16 KB + dO 16 KB + 2 x (K + V) 32 KB");
static_assert(Layout<MAX_DP>::BYTES <= 232448, "shared memory of one CTA");
static_assert(Layout<128>::DO % 1024 == 0 && Layout<128>::KV % 1024 == 0 &&
                  Layout<128>::STAGE % 1024 == 0 && Layout<64>::STAGE % 1024 == 0,
              "swizzle atoms on 1024-byte boundaries");

// dS pairs as DS_TERMS bf16 pairs, hi first (the A fragment's packing: the
// lower column in the low half); each term rounds what the ones before left.
__device__ __forceinline__ void split_terms(float a, float b, uint32_t (&t)[DS_TERMS]) {
#pragma unroll
  for (int i = 0; i < DS_TERMS; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    t[i] = *reinterpret_cast<uint32_t*>(&h);
    const float2 f = __bfloat1622float2(h);
    a -= f.x;
    b -= f.y;
  }
}

// S = Q·Kᵀ and dP = dO·Vᵀ of this warpgroup's 64 rows and a tile's 64 keys.
template <int DP>
__device__ __forceinline__ void tile_products(float (&s)[32], float (&dp)[32], uint32_t q_wg,
                                              uint32_t do_wg, uint32_t k_st, uint32_t v_st) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t a_off = (kk >> 2) * Q_BLOCK + (kk & 3) * 32;
    const uint32_t b_off = (kk >> 2) * KV_BLOCK + (kk & 3) * 32;
    wgmma_ss_n64(s, sw128_desc(q_wg + a_off, 16, 1024), sw128_desc(k_st + b_off, 16, 1024),
                 kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t a_off = (kk >> 2) * Q_BLOCK + (kk & 3) * 32;
    const uint32_t b_off = (kk >> 2) * KV_BLOCK + (kk & 3) * 32;
    wgmma_ss_n64(dp, sw128_desc(do_wg + a_off, 16, 1024), sw128_desc(v_st + b_off, 16, 1024),
                 kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
  fence_regs(dp);
}

// Scale, soft-cap and mask the S fragment in place (masked: -inf).  s[v] is
// row pos0 + 8·((v>>1)&1) (as key positions), key kv0 + 8·(v>>2) + cq + (v&1).
__device__ __forceinline__ void scores(float (&s)[32], const Params& p, int kv0, int pos0,
                                       int cq, bool interior) {
#pragma unroll
  for (int v = 0; v < 32; ++v) {
    float x = s[v] * p.scale;
    if (p.softcap > 0.f) x = p.softcap * tanhf(x * p.inv_cap);
    if (!interior) {
      const int col = kv0 + 8 * (v >> 2) + cq + (v & 1);
      const int pos = pos0 + ((v & 2) ? 8 : 0);
      bool ok = col < p.skv;
      if (p.causal) ok = ok && pos >= col;
      if (p.window > 0) ok = ok && pos - col < p.window;
      if (!ok) x = -CUDART_INF_F;
    }
    s[v] = x;
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_bwd_dq_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                                        const __grid_constant__ CUtensorMap tk,
                                        const __grid_constant__ CUtensorMap tv,
                                        const __grid_constant__ CUtensorMap tdo, const Params p) {
  using L = Layout<DP>;
  constexpr int NB = L::NB;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base + L::Q, do_s = base + L::DO, kv_s = base + L::KV;
  const uint32_t bar_q = base + L::BARS;            // then bar_kv[st] at bar_q + 8 + 8 st

  const int tid = threadIdx.x;
  const int wg = tid >> 7;                          // consumer warpgroup: rows 64 wg ..
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
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
  // the ring holds tiles 0 .. 2n - 1: pass 1's n tiles, then pass 2's
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * L::TILE_BYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      tma_load(q_s + c * Q_BLOCK, &tq, bar_q, c * BOX_COLS, q0, h, b, p.q_perm);
      tma_load(do_s + c * Q_BLOCK, &tdo, bar_q, c * BOX_COLS, q0, h, b, p.do_perm);
    }
    for (int t = 0; t < 2 && t < 2 * n_tiles; ++t)
      load_kv<NB>(&tk, &tv, bar_q + 8 + 8 * t, kv_s + t * L::STAGE,
                  kv_lo + (t % n_tiles) * BKV, hk, b, p.k_perm, p.v_perm);
  }

  // This thread's accumulator rows r0 and r0 + 8, and the column of its first
  // value in each 8-column group of a fragment.
  const int r0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
  const int pos0 = r0 + off;
  const int cq = 2 * (lane & 3);
  const uint32_t q_wg = q_s + wg * 64 * 128;        // this warpgroup's rows of each block
  const uint32_t do_wg = do_s + wg * 64 * 128;
  // the rows of this warpgroup, for skipping the mask on interior tiles
  const int wg_pos_lo = q0 + wg * 64 + off, wg_pos_hi = wg_pos_lo + 63;

  mbar_wait(bar_q, 0);
  __syncwarp();

  // pass 1: m, l = Σ exp(s − m) and w = Σ exp(s − m)·dP of rows r0 (0) and
  // r0 + 8 (1); l and w summed over this thread's columns only
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f, w0 = 0.f, w1 = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1, kv0 = kv_lo + t * BKV;
    const uint32_t k_st = kv_s + st * L::STAGE, v_st = k_st + NB * KV_BLOCK;
    mbar_wait(bar_q + 8 + 8 * st, (t >> 1) & 1);
    __syncwarp();
    float s[32], dp[32];
    tile_products<DP>(s, dp, q_wg, do_wg, k_st, v_st);
    const bool interior = kv0 + BKV <= p.skv && (!p.causal || kv0 + BKV - 1 <= wg_pos_lo) &&
                          (p.window <= 0 || wg_pos_hi - kv0 < p.window);
    scores(s, p, kv0, pos0, cq, interior);
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      if (v & 2) mx1 = fmaxf(mx1, s[v]);
      else mx0 = fmaxf(mx0, s[v]);
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    // while a row has nothing unmasked its m stays -inf and its sums 0
    const float alpha0 = mn0 == -CUDART_INF_F ? 1.f : exp2f((m0 - mn0) * LOG2E);
    const float alpha1 = mn1 == -CUDART_INF_F ? 1.f : exp2f((m1 - mn1) * LOG2E);
    float rs0 = 0.f, rs1 = 0.f, ws0 = 0.f, ws1 = 0.f;
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      const float mr = (v & 2) ? mn1 : mn0;
      const float e = mr == -CUDART_INF_F ? 0.f : exp2f((s[v] - mr) * LOG2E);
      if (v & 2) {
        rs1 += e;
        ws1 = fmaf(e, dp[v], ws1);
      } else {
        rs0 += e;
        ws0 = fmaf(e, dp[v], ws0);
      }
    }
    l0 = fmaf(l0, alpha0, rs0);
    w0 = fmaf(w0, alpha0, ws0);
    l1 = fmaf(l1, alpha1, rs1);
    w1 = fmaf(w1, alpha1, ws1);
    m0 = mn0;
    m1 = mn1;
    __syncthreads();                                // both warpgroups are done with stage st
    if (tid == 0 && t + 2 < 2 * n_tiles)
      load_kv<NB>(&tk, &tv, bar_q + 8 + 8 * st, kv_s + st * L::STAGE,
                  kv_lo + ((t + 2) % n_tiles) * BKV, hk, b, p.k_perm, p.v_perm);
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  w0 = quad_sum(w0);
  w1 = quad_sum(w1);
  const float lse0 = l0 > 0.f ? m0 + logf(l0) : CUDART_INF_F;
  const float lse1 = l1 > 0.f ? m1 + logf(l1) : CUDART_INF_F;
  const float dl0 = l0 > 0.f ? w0 / l0 : 0.f, dl1 = l1 > 0.f ? w1 / l1 : 0.f;

  // pass 2: dQ += dS·K
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  for (int t = n_tiles; t < 2 * n_tiles; ++t) {
    const int st = t & 1, kv0 = kv_lo + (t - n_tiles) * BKV;
    const uint32_t k_st = kv_s + st * L::STAGE, v_st = k_st + NB * KV_BLOCK;
    mbar_wait(bar_q + 8 + 8 * st, (t >> 1) & 1);
    __syncwarp();
    float s[32], dp[32];
    tile_products<DP>(s, dp, q_wg, do_wg, k_st, v_st);
    const bool interior = kv0 + BKV <= p.skv && (!p.causal || kv0 + BKV - 1 <= wg_pos_lo) &&
                          (p.window <= 0 || wg_pos_hi - kv0 < p.window);
    scores(s, p, kv0, pos0, cq, interior);
    // dS in DS_TERMS bf16 terms; pair i is s[2i], s[2i+1], row r0 + 8·(i&1)
    uint32_t ds[DS_TERMS][16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float lse = (i & 1) ? lse1 : lse0, dl = (i & 1) ? dl1 : dl0;
      float g[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = s[2 * i + e];
        const float pr = exp2f((x - lse) * LOG2E);  // masked (x = -inf): 0
        float cap = 1.f;
        if (p.softcap > 0.f) {
          const float th = x * p.inv_cap;
          cap = fmaf(-th, th, 1.f);
        }
        g[e] = pr > 0.f ? pr * (dp[2 * i + e] - dl) * cap * p.scale : 0.f;
      }
      uint32_t terms[DS_TERMS];
      split_terms(g[0], g[1], terms);
#pragma unroll
      for (int j = 0; j < DS_TERMS; ++j) ds[j][i] = terms[j];
    }
    // keys 16 kk .. 16 kk + 15 of the K tile, read MN-major (rows of 128
    // bytes, 8-row groups 1024 bytes apart, 64-column blocks KV_BLOCK apart);
    // the smallest terms first
#pragma unroll
    for (int j = 0; j < DS_TERMS; ++j) fence_regs(ds[j]);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int j = DS_TERMS - 1; j >= 0; --j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {ds[j][4 * kk], ds[j][4 * kk + 1], ds[j][4 * kk + 2],
                               ds[j][4 * kk + 3]};
        wgmma_pv<DP>(acc, a, sw128_desc(k_st + kk * 16 * 128, KV_BLOCK, 1024));
      }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();                                // both warpgroups are done with stage st
    if (tid == 0 && t + 2 < 2 * n_tiles)
      load_kv<NB>(&tk, &tv, bar_q + 8 + 8 * st, kv_s + st * L::STAGE,
                  kv_lo + ((t + 2) % n_tiles) * BKV, hk, b, p.k_perm, p.v_perm);
  }

  // epilogue: dQ in bf16 by strides; LSE and D by the quad's first thread
  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_b + h * p.dq_h;
  const long long stats = (static_cast<long long>(b) * p.hq + h) * p.sq;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= p.sq) continue;
    __nv_bfloat16* row = dqg + r * p.dq_s;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + cq + e;
        if (col < p.d) row[col * p.dq_d] = __float2bfloat16(acc[4 * j + 2 * half + e]);
      }
    if ((lane & 3) == 0) {
      p.lse[stats + r] = half ? lse1 : lse0;
      p.delta[stats + r] = half ? dl1 : dl0;
    }
  }
}

template <int DP>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const CUtensorMap& tdo, const Params& p, int batch, cudaStream_t stream) {
  constexpr int smem = Layout<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel_wgmma<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + BQ - 1) / BQ, p.hq, batch);
  flash_attention_bwd_dq_kernel_wgmma<DP><<<grid, THREADS, smem, stream>>>(tq, tk, tv, tdo, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Enqueue flash_attention_bwd_dq_kernel_wgmma on `stream`: dq (bf16, by the
// element strides dqs: dq[b][h][s][d] at b*dqs[0] + h*dqs[1] + s*dqs[2] +
// d*dqs[3]) and the f32 row statistics lse and delta ((B, Hq, Sq),
// contiguous) that repro_flash_attention_bwd_dkdv reads.  q, k, v and dout
// (dL/do, bf16) are described by their tensor maps (qm, km, vm, dom: see
// MapSpec; ops.py builds them, q's and dout's tiled 128 rows, k's and v's
// 64).  dp is the padded head dim (64 or 128, at least max(d, dv)).
// Requires hq % hkv == 0, sq, skv >= 1, batch and hq < 65536.  `window` <= 0
// means no window, `softcap` <= 0 no soft-cap.  Returns 0 when the kernel
// was launched, else a cudaError_t, or kEncodeError + the CUresult of a
// refused tensor map (repro_flash_tc_error_string names both).
int repro_flash_attention_bwd_dq_tc(const void* q, const void* k, const void* v,
                                    const void* dout, const MapSpec* qm, const MapSpec* km,
                                    const MapSpec* vm, const MapSpec* dom, void* dq,
                                    const long long* dqs, float* lse, float* delta, int batch,
                                    int hq, int hkv, int sq, int skv, int d, int dv, int dp,
                                    int causal, int window, float softcap, float scale,
                                    void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 || d < 1 || dv < 1 ||
      batch > 65535 || hq > 65535 || (dp != 64 && dp != MAX_DP) || dp < d || dp < dv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tq, tk, tv, tdo;
  int rc = make_map(&tq, q, *qm);
  if (rc == 0) rc = make_map(&tk, k, *km);
  if (rc == 0) rc = make_map(&tv, v, *vm);
  if (rc == 0) rc = make_map(&tdo, dout, *dom);
  if (rc != 0) return rc;
  Params p;
  p.dq = dq;
  p.dq_b = dqs[0]; p.dq_h = dqs[1]; p.dq_s = dqs[2]; p.dq_d = dqs[3];
  p.lse = lse; p.delta = delta;
  p.hq = hq; p.sq = sq; p.skv = skv; p.d = d; p.group = hq / hkv;
  p.causal = causal; p.window = window;
  p.scale = scale; p.softcap = softcap; p.inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  p.q_perm = qm->perm; p.k_perm = km->perm; p.v_perm = vm->perm; p.do_perm = dom->perm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dp == 64) return launch<64>(tq, tk, tv, tdo, p, batch, s);
  return launch<128>(tq, tk, tv, tdo, p, batch, s);
}

// DS_TERMS of this build: the bf16 terms of dS in dQ += dS·K.
int repro_flash_bwd_dq_tc_ds_terms(void) { return DS_TERMS; }

}  // extern "C"
