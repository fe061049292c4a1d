// Flash attention backward for Hopper (sm_90a): dQ, dK, dV of
// O = softmax(mask(cap(s·QKᵀ)))·V, in f32 or bf16 with f32 accumulation.
//
// Replaces no TPU kernel: the JAX package differentiates the forward's route
// (src/repro/kernels/flash_attention/ops.py, reached from
// src/repro/models/layers.py:132,148) and has no backward kernel of its own.
// The port's forward kernels (flash_attention.cu, flash_attention_wgmma.cu)
// write their output through ctypes, outside autograd, so the train path
// needs a gradient of its own: these two kernels compute exactly the
// gradient of the function the forward computes — GQA by ratio (query head h
// reads KV head h / (Hq/Hkv)), scale, then the tanh soft-cap, then the
// mask, causal with the ends aligned (row i stands at key position
// i + Skv - Sq) and the sliding window rows - cols < window; ragged Sq/Skv
// are masked here.  A row with no unmasked key has P = 0 and gets dQ = 0.
//
// With u = scale·q·kᵀ, s = c·tanh(u/c) (s = u without a soft-cap),
// P = softmax(s) over the unmasked keys, dP = dO·Vᵀ and D = rowsum(P ⊙ dP)
// (= rowsum(dO ⊙ O) for the unrounded output O):
//   dV = Pᵀ·dO,  dS = P ⊙ (dP − D) ⊙ (1 − tanh²(u/c)) · scale,
//   dQ = dS·K,   dK = dSᵀ·Q.
//
// * flash_attention_bwd_dq_kernel: one block per (32 query rows, head,
//   batch).  Pass 1 runs over the visible key tiles and keeps each row's
//   max, its sum of exp(s − max) and its sum of exp(s − max)·dP (an online
//   softmax): LSE = max + log(sum), D = the second sum over the first.  D
//   is not taken from the forward's output: a bf16 O is off the f32 one by
//   up to 2^-9 of each value, and that moves D enough to move a dQ row
//   whose terms cancel (a query that sees few keys) by up to half its
//   norm, past the forward's 1e-2 row limit (read on an H100; f32 O moved
//   such rows past 1e-4).  Pass 2 runs over the
//   same tiles, recomputes P = exp(s − LSE), dP and dS, and accumulates
//   dQ = dS·K in registers.  It writes dQ, and LSE and D for the second
//   kernel.
// * flash_attention_bwd_dkdv_kernel: one block per (32 keys, KV head,
//   batch).  It loops over the group's query heads and the query tiles that
//   can see its keys, recomputes P from LSE, and accumulates dV = Pᵀ·dO and
//   dK = dSᵀ·Q in registers.
// Every output element is written by one block and summed in one fixed
// order: no atomics, so two runs on the same inputs are bit-equal.  The
// forward kernels are not changed: the backward recomputes LSE.
//
// What bounds it: at gemma2-2b's train shapes (B 8, S 128, Hq 8, Hkv 4,
// D 256) a layer's backward moves ~21 MB and needs ~1.9 GFLOP (five
// S×S×D products: S, dP, dQ, dK, dV; the two kernels do nine, S and dP
// three times each, ~2.4 GFLOP), so arithmetic bounds it.  This
// is the simple form: f32 FFMA on CUDA cores from shared-memory tiles (32 x
// 32 score tiles, D and Dv padded to 64, 128 or 256 columns), a thread
// owning 2 rows × 4 of the output columns every 64.  wgmma and TMA are later
// work.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): the caller owns every allocation and the stream; one call
// launches one kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BR = 32;           // rows a block owns: queries (dq) or keys (dkdv)
constexpr int BC = 32;           // rows of the other side in one tile
constexpr int THREADS = 256;     // 16 x 16 thread grid
constexpr int TSTR = BC + 1;     // row stride of the score tiles
constexpr int MAX_DIM = 256;     // largest D and Dv

enum { Q, K, V, DO, DQ, DK, DV, NT };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;                    // (B, Hq, Sq): written by dq, read by dkdv
  float* delta;                  // (B, Hq, Sq): D = rowsum(P ⊙ dP)
  long long st[NT][4];           // element strides (b, h, s, d) of each tensor
  int hq, sq, skv, d, dvd, group; // dvd: V's head dim; group = Hq / Hkv
  int causal, window;
  float softcap, scale;
  int dr, dvr;                   // D and Dv rounded up to a multiple of 4
};

template <typename T>
__device__ __forceinline__ float ld(const T* p);
template <>
__device__ __forceinline__ float ld<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T cvt(float x);
template <>
__device__ __forceinline__ float cvt<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DT>
__host__ __device__ constexpr int stride_of() { return DT + 4; }   // float4 rows, 4 mod 8

template <typename T>
__device__ __forceinline__ const T* at(const void* base, const long long* st, int b, int h) {
  return static_cast<const T*>(base) + b * st[0] + h * st[1];
}

// Rows [0, BR or BC) of a tile into shared memory as f32, zero past
// `valid_cols` and for rows past `valid_rows`; one warp a row.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int dst_stride, int cols, const T* src,
                                          long long s_row, long long s_col, int rows,
                                          int valid_rows, int valid_cols, int warp, int lane) {
  for (int r = warp; r < rows; r += THREADS / 32) {
    float* out = dst + r * dst_stride;
    if (r < valid_rows) {
      const T* in = src + r * s_row;
      for (int c = lane; c < cols; c += 32) out[c] = c < valid_cols ? ld(in + c * s_col) : 0.f;
    } else {
      for (int c = lane; c < cols; c += 32) out[c] = 0.f;
    }
  }
}

// acc[i][j] = dot(A row 2ty + i, B row tx + 16j) over the first `n` columns
// (a multiple of 4), both tiles in shared memory with row stride `str`.
__device__ __forceinline__ void tile_dots(const float* A, const float* B, int str, int n, int ty,
                                          int tx, float acc[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < n; c += 4) {
    float4 a[2], b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) a[i] = *reinterpret_cast<const float4*>(A + (2 * ty + i) * str + c);
#pragma unroll
    for (int j = 0; j < 2; ++j) b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * str + c);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][4jj + e] += Σ_c W[2ty + i][c] · X[c][4tx + 64jj + e] over the BC
// columns of the score tile W (row stride TSTR) and the rows of X (stride str).
template <int DT>
__device__ __forceinline__ void accumulate(const float* W, const float* X, int str, int ty, int tx,
                                           float acc[2][DT / 16]) {
  for (int c = 0; c < BC; ++c) {
    const float w0 = W[(2 * ty) * TSTR + c], w1 = W[(2 * ty + 1) * TSTR + c];
#pragma unroll
    for (int jj = 0; jj < DT / 64; ++jj) {
      const float4 x = *reinterpret_cast<const float4*>(X + c * str + tx * 4 + 64 * jj);
      acc[0][jj * 4 + 0] = fmaf(w0, x.x, acc[0][jj * 4 + 0]);
      acc[0][jj * 4 + 1] = fmaf(w0, x.y, acc[0][jj * 4 + 1]);
      acc[0][jj * 4 + 2] = fmaf(w0, x.z, acc[0][jj * 4 + 2]);
      acc[0][jj * 4 + 3] = fmaf(w0, x.w, acc[0][jj * 4 + 3]);
      acc[1][jj * 4 + 0] = fmaf(w1, x.x, acc[1][jj * 4 + 0]);
      acc[1][jj * 4 + 1] = fmaf(w1, x.y, acc[1][jj * 4 + 1]);
      acc[1][jj * 4 + 2] = fmaf(w1, x.z, acc[1][jj * 4 + 2]);
      acc[1][jj * 4 + 3] = fmaf(w1, x.w, acc[1][jj * 4 + 3]);
    }
  }
}

// The score of one (query position `row`, key `col`) pair from its dot
// product: scale, soft-cap (t = tanh(u/c) kept for the derivative), mask.
struct Score {
  float s, t;
  bool ok;
};

__device__ __forceinline__ Score score(const Params& p, float dot, int row, int col) {
  Score r;
  const float u = dot * p.scale;
  r.t = 0.f;
  r.s = u;
  if (p.softcap > 0.f) {
    r.t = tanhf(u / p.softcap);
    r.s = p.softcap * r.t;
  }
  r.ok = col < p.skv;
  if (p.causal) r.ok = r.ok && row >= col;
  if (p.window > 0) r.ok = r.ok && row - col < p.window;
  return r;
}

// dS of one pair from P, dP and D: through the soft-cap, then the scale.
__device__ __forceinline__ float dscore(const Params& p, float pr, float dp, float dl, float t) {
  float ds = pr * (dp - dl);
  if (p.softcap > 0.f) ds *= 1.f - t * t;
  return ds * p.scale;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T, int DT>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_bwd_dq_kernel(const Params p) {
  constexpr int STR = stride_of<DT>();
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [BR][STR]
  float* Gs = Qs + BR * STR;         // dO [BR][STR]
  float* Ks = Gs + BR * STR;         // [BC][STR]
  float* Vs = Ks + BC * STR;         // [BC][STR]
  float* Ss = Vs + BC * STR;         // dS [BR][TSTR]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const int nrows = min(BR, p.sq - q0);
  const int off = p.skv - p.sq;      // row i stands at key position i + off

  const T* qg = at<T>(p.q, p.st[Q], b, h);
  const T* kg = at<T>(p.k, p.st[K], b, hk);
  const T* vg = at<T>(p.v, p.st[V], b, hk);
  const T* gg = at<T>(p.dout, p.st[DO], b, h);
  T* dqg = static_cast<T*>(p.dq) + b * p.st[DQ][0] + h * p.st[DQ][1];

  // keys this block can see: [kv_lo, kv_hi), kv_lo on a tile boundary
  int kv_hi = p.skv;
  if (p.causal) kv_hi = min(kv_hi, q0 + nrows + off);
  int kv_lo = 0;
  if (p.window > 0) kv_lo = max(0, q0 + off - p.window + 1);
  kv_lo = (kv_lo / BC) * BC;

  load_rows(Qs, STR, DT, qg + q0 * p.st[Q][2], p.st[Q][2], p.st[Q][3], BR, nrows, p.d, warp,
            lane);
  load_rows(Gs, STR, DT, gg + q0 * p.st[DO][2], p.st[DO][2], p.st[DO][3], BR, nrows, p.dvd, warp,
            lane);

  // pass 1: each row's max m, l = Σ exp(s − m) and w = Σ exp(s − m)·dP over
  // its visible keys (rows 2ty + i: the 16 threads of a half-warp)
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, w[2] = {0.f, 0.f};
  for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += BC) {
    const int kvalid = min(BC, p.skv - kv0);
    load_rows(Ks, STR, DT, kg + kv0 * p.st[K][2], p.st[K][2], p.st[K][3], BC, kvalid, p.d, warp,
              lane);
    load_rows(Vs, STR, DT, vg + kv0 * p.st[V][2], p.st[V][2], p.st[V][3], BC, kvalid, p.dvd, warp,
              lane);
    __syncthreads();
    float s[2][2], dp[2][2];
    tile_dots(Qs, Ks, STR, p.dr, ty, tx, s);
    tile_dots(Gs, Vs, STR, p.dvr, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + 2 * ty + i + off;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const Score sc = score(p, s[i][j], row, kv0 + tx + 16 * j);
        s[i][j] = sc.ok ? sc.s : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float rs = 0.f, ws = 0.f;
      if (m_new != -CUDART_INF_F) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float e = expf(s[i][j] - m_new);   // masked: 0
          rs += e;
          ws = fmaf(e, dp[i][j], ws);
        }
        const float alpha = expf(m[i] - m_new);    // 0 while m is -inf
        l[i] *= alpha;
        w[i] *= alpha;
        m[i] = m_new;
      }
      l[i] += half_warp_sum(rs);
      w[i] += half_warp_sum(ws);
    }
    __syncthreads();                   // before the next tile overwrites K, V
  }
  float lse[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse[i] = l[i] > 0.f ? m[i] + logf(l[i]) : CUDART_INF_F;
    dl[i] = l[i] > 0.f ? w[i] / l[i] : 0.f;
  }

  // pass 2: dQ = dS·K
  constexpr int NC = DT / 16;
  float acc[2][NC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += BC) {
    const int kvalid = min(BC, p.skv - kv0);
    load_rows(Ks, STR, DT, kg + kv0 * p.st[K][2], p.st[K][2], p.st[K][3], BC, kvalid, p.d, warp,
              lane);
    load_rows(Vs, STR, DT, vg + kv0 * p.st[V][2], p.st[V][2], p.st[V][3], BC, kvalid, p.dvd, warp,
              lane);
    __syncthreads();
    float s[2][2], dp[2][2];
    tile_dots(Qs, Ks, STR, p.dr, ty, tx, s);
    tile_dots(Gs, Vs, STR, p.dvr, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + 2 * ty + i + off;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const Score sc = score(p, s[i][j], row, kv0 + tx + 16 * j);
        const float pr = sc.ok ? expf(sc.s - lse[i]) : 0.f;
        Ss[(2 * ty + i) * TSTR + tx + 16 * j] = dscore(p, pr, dp[i][j], dl[i], sc.t);
      }
    }
    __syncthreads();
    accumulate<DT>(Ss, Ks, STR, ty, tx, acc);
    __syncthreads();                   // before the next tile overwrites K, V, dS
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * ty + i;
    if (r >= nrows) continue;
    T* out = dqg + (q0 + r) * p.st[DQ][2];
#pragma unroll
    for (int jj = 0; jj < DT / 64; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = tx * 4 + 64 * jj + e;
        if (col < p.d) out[col * p.st[DQ][3]] = cvt<T>(acc[i][jj * 4 + e]);
      }
    if (tx == 0) {
      const long long at_row = (static_cast<long long>(b) * p.hq + h) * p.sq + q0 + r;
      p.lse[at_row] = lse[i];
      p.delta[at_row] = dl[i];
    }
  }
}

template <typename T, int DT>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_bwd_dkdv_kernel(const Params p) {
  constexpr int STR = stride_of<DT>();
  constexpr int NC = DT / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                  // [BR][STR]
  float* Vs = Ks + BR * STR;         // [BR][STR]
  float* Qs = Vs + BR * STR;         // [BC][STR]
  float* Gs = Qs + BC * STR;         // dO [BC][STR]
  float* Ps = Gs + BC * STR;         // Pᵀ [BR][TSTR]
  float* Ss = Ps + BR * TSTR;        // dSᵀ [BR][TSTR]
  float* Ls = Ss + BR * TSTR;        // LSE of the tile's queries [BC]
  float* Ds = Ls + BC;               // D of the tile's queries [BC]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int kv0 = blockIdx.x * BR;
  const int nkeys = min(BR, p.skv - kv0);
  const int off = p.skv - p.sq;

  load_rows(Ks, STR, DT, at<T>(p.k, p.st[K], b, hk) + kv0 * p.st[K][2], p.st[K][2], p.st[K][3],
            BR, nkeys, p.d, warp, lane);
  load_rows(Vs, STR, DT, at<T>(p.v, p.st[V], b, hk) + kv0 * p.st[V][2], p.st[V][2], p.st[V][3],
            BR, nkeys, p.dvd, warp, lane);

  // query rows i that see a key of [kv0, kv0 + nkeys): causal i + off >= kv0,
  // window i + off - (kv0 + nkeys - 1) < window
  int q_lo = p.causal ? max(0, kv0 - off) : 0;
  q_lo = (q_lo / BC) * BC;
  int q_hi = p.sq;
  if (p.window > 0) q_hi = min(q_hi, kv0 + nkeys - 1 + p.window - off);

  float dk[2][NC], dv[2][NC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int hh = 0; hh < p.group; ++hh) {
    const int h = hk * p.group + hh;
    const T* qg = at<T>(p.q, p.st[Q], b, h);
    const T* gg = at<T>(p.dout, p.st[DO], b, h);
    const long long stats = (static_cast<long long>(b) * p.hq + h) * p.sq;
    for (int q0 = q_lo; q0 < q_hi; q0 += BC) {
      const int nq = min(BC, p.sq - q0);
      load_rows(Qs, STR, DT, qg + q0 * p.st[Q][2], p.st[Q][2], p.st[Q][3], BC, nq, p.d, warp,
                lane);
      load_rows(Gs, STR, DT, gg + q0 * p.st[DO][2], p.st[DO][2], p.st[DO][3], BC, nq, p.dvd, warp,
                lane);
      if (tid < BC) {
        Ls[tid] = tid < nq ? p.lse[stats + q0 + tid] : CUDART_INF_F;
        Ds[tid] = tid < nq ? p.delta[stats + q0 + tid] : 0.f;
      }
      __syncthreads();
      // Sᵀ and dPᵀ: rows = keys 2ty + i, columns = queries tx + 16j
      float s[2][2], dp[2][2];
      tile_dots(Ks, Qs, STR, p.dr, ty, tx, s);
      tile_dots(Vs, Gs, STR, p.dvr, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = kv0 + 2 * ty + i;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qi = tx + 16 * j;
          const Score sc = score(p, s[i][j], q0 + qi + off, col);
          const bool ok = sc.ok && qi < nq;
          const float pr = ok ? expf(sc.s - Ls[qi]) : 0.f;
          Ps[(2 * ty + i) * TSTR + qi] = pr;
          Ss[(2 * ty + i) * TSTR + qi] = dscore(p, pr, dp[i][j], Ds[qi], sc.t);
        }
      }
      __syncthreads();
      accumulate<DT>(Ps, Gs, STR, ty, tx, dv);   // dV += Pᵀ·dO
      accumulate<DT>(Ss, Qs, STR, ty, tx, dk);   // dK += dSᵀ·Q
      __syncthreads();                 // before the next tile overwrites Q, dO, P, dS
    }
  }

  T* dkg = static_cast<T*>(p.dk) + b * p.st[DK][0] + hk * p.st[DK][1];
  T* dvg = static_cast<T*>(p.dv) + b * p.st[DV][0] + hk * p.st[DV][1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * ty + i;
    if (r >= nkeys) continue;
#pragma unroll
    for (int jj = 0; jj < DT / 64; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = tx * 4 + 64 * jj + e;
        if (col < p.d) dkg[(kv0 + r) * p.st[DK][2] + col * p.st[DK][3]] = cvt<T>(dk[i][jj * 4 + e]);
        if (col < p.dvd)
          dvg[(kv0 + r) * p.st[DV][2] + col * p.st[DV][3]] = cvt<T>(dv[i][jj * 4 + e]);
      }
  }
}

template <int DT>
constexpr size_t dq_smem() {
  return (4 * BR * stride_of<DT>() + BR * TSTR) * sizeof(float);
}

template <int DT>
constexpr size_t dkdv_smem() {
  return (4 * BR * stride_of<DT>() + 2 * BR * TSTR + 2 * BC) * sizeof(float);
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, dim3 grid, const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DT>
int dispatch(bool dkdv, const Params& p, int batch, int hkv, cudaStream_t stream) {
  if (dkdv) {
    const dim3 grid((p.skv + BR - 1) / BR, hkv, batch);
    return launch(flash_attention_bwd_dkdv_kernel<T, DT>, dkdv_smem<DT>(), grid, p, stream);
  }
  const dim3 grid((p.sq + BR - 1) / BR, p.hq, batch);
  return launch(flash_attention_bwd_dq_kernel<T, DT>, dq_smem<DT>(), grid, p, stream);
}

template <typename T>
int dispatch_dim(bool dkdv, const Params& p, int batch, int hkv, cudaStream_t stream) {
  const int dm = p.d > p.dvd ? p.d : p.dvd;
  if (dm <= 64) return dispatch<T, 64>(dkdv, p, batch, hkv, stream);
  if (dm <= 128) return dispatch<T, 128>(dkdv, p, batch, hkv, stream);
  return dispatch<T, 256>(dkdv, p, batch, hkv, stream);
}

int run(bool dkdv, const void* q, const void* k, const void* v, const void* dout,
        void* dq, void* dk, void* dv, float* lse, float* delta, const long long* strides,
        int batch, int hq, int hkv, int sq, int skv, int d, int dvd, int bf16, int causal,
        int window, float softcap, float scale, void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 || d < 1 ||
      dvd < 1 || d > MAX_DIM || dvd > MAX_DIM || batch > 65535 || hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.dq = dq; p.dk = dk; p.dv = dv; p.lse = lse; p.delta = delta;
  for (int t = 0; t < NT; ++t)
    for (int i = 0; i < 4; ++i) p.st[t][i] = strides[4 * t + i];
  p.hq = hq; p.sq = sq; p.skv = skv; p.d = d; p.dvd = dvd; p.group = hq / hkv;
  p.causal = causal; p.window = window; p.softcap = softcap; p.scale = scale;
  p.dr = (d + 3) / 4 * 4;
  p.dvr = (dvd + 3) / 4 * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_dim<__nv_bfloat16>(dkdv, p, batch, hkv, s)
              : dispatch_dim<float>(dkdv, p, batch, hkv, s);
}

}  // namespace

extern "C" {

// Enqueue flash_attention_bwd_dq_kernel on `stream`: dq, and the f32 row
// statistics lse and delta ((B, Hq, Sq), contiguous) that
// repro_flash_attention_bwd_dkdv reads.  q, k, v, dout (dL/do), dq, dk, dv
// are f32 (bf16 = 0) or bf16 (bf16 = 1) device arrays addressed by element
// strides: `strides` holds 4 (b, h, s, d) strides of each, in that order
// (q, k, v, dout, dq, dk, dv).  Requires
// 1 <= d, dv <= 256, hq % hkv == 0, sq, skv >= 1, batch and hq < 65536.
// `window` <= 0 means no window, `softcap` <= 0 no soft-cap.  Returns
// cudaGetLastError() of the launch as an int (0 = launched).
int repro_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk, void* dv, float* lse,
                                 float* delta, const long long* strides, int batch, int hq,
                                 int hkv, int sq, int skv, int d, int dvd, int bf16, int causal,
                                 int window, float softcap, float scale, void* stream) {
  return run(false, q, k, v, dout, dq, dk, dv, lse, delta, strides, batch, hq, hkv, sq, skv,
             d, dvd, bf16, causal, window, softcap, scale, stream);
}

// Enqueue flash_attention_bwd_dkdv_kernel on `stream`: dk and dv, from the
// lse and delta that repro_flash_attention_bwd_dq wrote for the same inputs
// (launched before it on the same stream).  Arguments as above.
int repro_flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                                   const void* dout, void* dq, void* dk, void* dv, float* lse,
                                   float* delta, const long long* strides, int batch, int hq,
                                   int hkv, int sq, int skv, int d, int dvd, int bf16, int causal,
                                   int window, float softcap, float scale, void* stream) {
  return run(true, q, k, v, dout, dq, dk, dv, lse, delta, strides, batch, hq, hkv, sq, skv,
             d, dvd, bf16, causal, window, softcap, scale, stream);
}

const char* repro_flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
