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

#include "flash_tc.cuh"

namespace {

constexpr int BQ = 128;         // query rows per CTA (two warpgroups of 64)
constexpr int THREADS = 256;
constexpr int MAX_DIM = 256;

struct Params {
  void* o;
  long long o_b, o_h, o_s, o_d;  // element strides of the output
  int sq, skv, dv, group;        // group = Hq / Hkv
  int causal, window;
  float scale, softcap, inv_cap;
  int q_perm, k_perm, v_perm;
};

constexpr int Q_BLOCK = BQ * 128;     // bytes of one 64-column block of the Q tile

template <int DP>
__host__ __device__ constexpr int smem_bytes() {
  // Q, two stages of K and V, three mbarriers, and slack to align to 1024
  return DP / 64 * Q_BLOCK + 2 * 2 * (DP / 64) * KV_BLOCK + 64 + 1024;
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
// _mapped builds them); o is a bf16 device array addressed by element
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
