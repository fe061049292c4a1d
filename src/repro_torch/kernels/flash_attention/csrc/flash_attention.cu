// Flash attention forward for Hopper (sm_90a) in f32: O = softmax(mask(cap(s·QKᵀ)))·V.
//
// Replaces, for f32 q, k, v, the TPU kernel src/repro/kernels/flash_attention/
// kernel.py::flash_attention_pallas (_flash_kernel); bf16 runs the tensor-core
// kernel of flash_attention_wgmma.cu.  Same function: q (B,Hq,Sq,D),
// k (B,Hkv,Skv,D), v (B,Hkv,Skv,Dv) in f32, computed with an
// online softmax; query head h reads KV head h / (Hq/Hkv) (GQA by index, no
// copy); per score: scale, then the tanh soft-cap, then the mask — causal
// with the ends aligned (row i stands at key position i + Skv - Sq, as
// ref.py's attention_ref) and the sliding window rows - cols < window.  A row
// with no unmasked key gives 0: p stays exactly 0 and l == 0 divides by 1.
//
// Beyond the Pallas kernel: KV tiles wholly above the diagonal or wholly
// outside the window are never loaded (the Pallas kernel skips only the
// causal ones); ragged Sq/Skv are masked here, so no length need divide a
// block (the Pallas wrapper raises unless it does); V and O are sized by
// Dv, which may differ from D; q/k/v/o are taken by strides, so the model's
// transposed views are read in place.
//
// What bounds it: at the gemma2-2b prefill (B=2, Hq=8, Hkv=4, S=8192,
// D=Dv=256) the work is ~5.5e11 FLOP per global layer against ~67 MB of
// I/O, so arithmetic bounds it: 8.2 ms at the f32 FFMA peak.  It runs that
// arithmetic as true f32 FFMA on CUDA cores, which the f32 limits of 2e-4
// need (bf16 and TF32 tensor cores round coarser).
//
// Design: one CTA of 256 threads per (64-row query block, head, batch).  The
// Q tile, one 64-row K tile and one 64-row V tile sit in shared memory as
// f32 (216 KB at D = Dv = 256, hence the opt-in to large dynamic shared
// memory), with the 64 x 64 probability tile beside them.  Thread (ty, tx)
// (ty, tx < 16) owns query rows 4ty..4ty+3: for QKᵀ the key columns
// tx + 16j (j < 4), for PV the output columns 4tx + 64jj + e.  The 16 threads
// that share a row are one half-warp, so row max and row sum are shuffles.
// The f32 accumulator (4 rows x Dv/16 columns) stays in registers: 64
// floats a thread at Dv = 256.  Query blocks are scheduled last-first, so
// the causal blocks with the most tiles start first.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): the caller owns every allocation and the stream; one call
// launches one kernel.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BKV = 64;         // keys per tile
constexpr int THREADS = 256;    // 16 x 16 thread grid
constexpr int PSTR = BKV + 4;   // row stride of the probability tile
constexpr int MAX_DIM = 256;    // largest D and Dv

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_b, q_h, q_s, q_d;  // element strides
  long long k_b, k_h, k_s, k_d;
  long long v_b, v_h, v_s, v_d;
  long long o_b, o_h, o_s, o_d;
  int sq, skv, d, dv, group;     // group = Hq / Hkv
  int causal, window;
  float softcap, scale;
  int dr;                        // D rounded up to a multiple of 4
  int qk_stride;                 // shared row stride of the Q and K tiles
};

// Shared row stride (floats) of the Q and K tiles: a multiple of 4 (float4
// rows) that is 4 mod 8, so the eight threads of a quarter-warp reading
// K rows tx, tx+1, ... hit eight different 16-byte bank groups.
__host__ __device__ inline int qk_stride_for(int dr) { return dr % 8 == 0 ? dr + 4 : dr; }

template <int DVT>
__host__ __device__ inline int smem_floats(int qk_stride) {
  return BQ * qk_stride + BKV * qk_stride + BKV * DVT + BQ * PSTR;
}

// Row r of a (rows x cols) tile from global memory into shared memory, zero
// past `valid_cols` and for rows past `valid_rows`; one warp a row.
__device__ __forceinline__ void load_rows(float* dst, int dst_stride, int cols,
                                          const float* src, long long s_row,
                                          long long s_col, int rows, int valid_rows,
                                          int valid_cols, int warp, int lane) {
  for (int r = warp; r < rows; r += THREADS / 32) {
    float* out = dst + r * dst_stride;
    if (r < valid_rows) {
      const float* in = src + r * s_row;
#pragma unroll 4
      for (int c = lane; c < cols; c += 32)
        out[c] = c < valid_cols ? in[c * s_col] : 0.f;
    } else {
      for (int c = lane; c < cols; c += 32) out[c] = 0.f;
    }
  }
}

template <int DVT>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_kernel(const Params p) {
  constexpr int NC = DVT / 16;               // output columns per thread
  extern __shared__ __align__(16) float smem[];
  const int str = p.qk_stride;
  float* Qs = smem;                          // [BQ][str]
  float* Ks = Qs + BQ * str;                 // [BKV][str]
  float* Vs = Ks + BKV * str;                // [BKV][DVT]
  float* Ps = Vs + BKV * DVT;                // [BQ][PSTR]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int qblk = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int q0 = qblk * BQ;
  const int nrows = min(BQ, p.sq - q0);
  const int off = p.skv - p.sq;              // row i stands at key position i + off

  const float* qg = static_cast<const float*>(p.q) + b * p.q_b + h * p.q_h;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_b + hk * p.k_h;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_b + hk * p.v_h;
  float* og = static_cast<float*>(p.o) + b * p.o_b + h * p.o_h;

  // keys this block can see: [kv_lo, kv_hi), kv_lo on a tile boundary
  int kv_hi = p.skv;
  if (p.causal) kv_hi = min(kv_hi, q0 + nrows + off);
  int kv_lo = 0;
  if (p.window > 0) kv_lo = max(0, q0 + off - p.window + 1);
  kv_lo = (kv_lo / BKV) * BKV;

  load_rows(Qs, str, p.dr, qg + q0 * p.q_s, p.q_s, p.q_d, BQ, nrows, p.d, warp,
               lane);

  float m_i[4], l_i[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -CUDART_INF_F;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += BKV) {
    const int kvalid = min(BKV, p.skv - kv0);
    load_rows(Ks, str, p.dr, kg + kv0 * p.k_s, p.k_s, p.k_d, BKV, kvalid, p.d,
                 warp, lane);
    load_rows(Vs, DVT, DVT, vg + kv0 * p.v_s, p.v_s, p.v_d, BKV, kvalid, p.dv,
                 warp, lane);
    __syncthreads();

    // s = Q Kᵀ for rows 4ty+i, keys tx+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < p.dr; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * str + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * str + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // scale, soft-cap, mask; online softmax over the tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i + off;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = col < p.skv;
        if (p.causal) ok = ok && row >= col;
        if (p.window > 0) ok = ok && row - col < p.window;
        s[i][j] = ok ? x : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_i[i], mx);
      float alpha = 1.f, rs = 0.f;
      if (m_new != -CUDART_INF_F) {
        alpha = expf(m_i[i] - m_new);        // 0 while m_i is still -inf
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m_new);   // masked: exp(-inf) = 0
          rs += s[i][j];
        }
      } else {                               // nothing unmasked yet: p = 0
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * PSTR + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // acc += P V for rows 4ty+i, columns 4tx + 64jj + e
    for (int c = 0; c < BKV; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * PSTR + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = Vs + (c + cc) * DVT + tx * 4;
#pragma unroll
        for (int jj = 0; jj < DVT / 64; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 64 * jj);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pp = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
            acc[i][jj * 4 + 0] = fmaf(pp, vv.x, acc[i][jj * 4 + 0]);
            acc[i][jj * 4 + 1] = fmaf(pp, vv.y, acc[i][jj * 4 + 1]);
            acc[i][jj * 4 + 2] = fmaf(pp, vv.z, acc[i][jj * 4 + 2]);
            acc[i][jj * 4 + 3] = fmaf(pp, vv.w, acc[i][jj * 4 + 3]);
          }
        }
      }
    }
    __syncthreads();                         // before the next tile overwrites K, V, P
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nrows) continue;
    const float l = l_i[i] == 0.f ? 1.f : l_i[i];
    float* orow = og + (q0 + r) * p.o_s;
#pragma unroll
    for (int jj = 0; jj < DVT / 64; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = tx * 4 + 64 * jj + e;
        if (col < p.dv) orow[col * p.o_d] = acc[i][jj * 4 + e] / l;
      }
  }
}

template <int DVT>
int launch(const Params& p, int batch, int hq, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(smem_floats<DVT>(p.qk_stride)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<DVT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + BQ - 1) / BQ, hq, batch);
  flash_attention_kernel<DVT><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_dv(const Params& p, int batch, int hq, cudaStream_t stream) {
  if (p.dv <= 64) return launch<64>(p, batch, hq, stream);
  if (p.dv <= 128) return launch<128>(p, batch, hq, stream);
  return launch<256>(p, batch, hq, stream);
}

}  // namespace

extern "C" {

// Enqueue f32 attention on `stream`.  q, k, v, o are f32 device arrays
// addressed by element strides: q[b][h][s][d] at
// b*qs[0] + h*qs[1] + s*qs[2] + d*qs[3], likewise k, v (KV heads) and o
// (Hq heads, Dv columns).  Requires 1 <= d, dv <= 256, hq % hkv == 0,
// sq, skv >= 1, batch and hq < 65536.  `window` <= 0 means no window,
// `softcap` <= 0 no soft-cap.  Returns cudaGetLastError() of the launch as an
// int (0 = launched); faults during the run surface at the next synchronize.
int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                          const long long* qs, const long long* ks,
                          const long long* vs, const long long* os, int batch,
                          int hq, int hkv, int sq, int skv, int d, int dv,
                          int causal, int window, float softcap, float scale,
                          void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 || d < 1 ||
      dv < 1 || d > MAX_DIM || dv > MAX_DIM || batch > 65535 || hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_b = qs[0]; p.q_h = qs[1]; p.q_s = qs[2]; p.q_d = qs[3];
  p.k_b = ks[0]; p.k_h = ks[1]; p.k_s = ks[2]; p.k_d = ks[3];
  p.v_b = vs[0]; p.v_h = vs[1]; p.v_s = vs[2]; p.v_d = vs[3];
  p.o_b = os[0]; p.o_h = os[1]; p.o_s = os[2]; p.o_d = os[3];
  p.sq = sq; p.skv = skv; p.d = d; p.dv = dv; p.group = hq / hkv;
  p.causal = causal; p.window = window; p.softcap = softcap; p.scale = scale;
  p.dr = (d + 3) / 4 * 4;
  p.qk_stride = qk_stride_for(p.dr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_dv(p, batch, hq, s);
}

const char* repro_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
