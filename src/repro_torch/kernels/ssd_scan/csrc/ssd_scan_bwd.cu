// Chunked SSD (Mamba2 state-space duality) backward for Hopper (sm_90a):
// dx, ddt, dA, dB, dC of the forward of ssd_scan.cu / ssd_scan_wgmma.cu, in
// f32 or bf16 x, B, C, dy (dt and A f32), with f32 accumulation.  The
// reduction here takes both types; the state passes and the chunk kernel
// here are f32 only (bf16 goes to the tensor cores: the state passes to
// ssd_scan_bwd_state_wgmma.cu, the chunk kernel to ssd_scan_bwd_wgmma.cu).
//
// It differentiates the TPU kernel src/repro/kernels/ssd_scan/kernel.py::
// ssd_scan_pallas.  The JAX package has no backward kernel: it
// differentiates its chunked jnp route (src/repro/kernels/ssd_scan/ops.py:
// 18-62).  The port's forward kernels write y through ctypes, outside
// autograd, so the train path needs a gradient of its own.  Per head, in a
// chunk of L rows (the last one may be shorter) with a_i = Σ_{k<=i} dt_k·A,
// S_in the state entering the chunk and G the cotangent of the state
// leaving it (zero for the last chunk), w_j = exp(a_{L-1} - a_j):
//
//   dS_in = exp(a_{L-1})·G + Σ_i exp(a_i)·C_i ⊗ dy_i          (reverse scan)
//   dx_j  = dt_j·[Σ_{i>=j} (C_i·B_j)·exp(a_i - a_j)·dy_i + w_j·Gᵀ·B_j]
//   dB_j  = Σ_h dt_j·[Σ_{i>=j} exp(a_i - a_j)·(dy_i·x_j)·C_i + w_j·G·x_j]
//   dC_i  = Σ_h [Σ_{j<=i} exp(a_i - a_j)·dt_j·(dy_i·x_j)·B_j + exp(a_i)·S_in·dy_i]
//   ddt_j = Σ_{i>=j} (C_i·B_j)·exp(a_i - a_j)·(dy_i·x_j) + w_j·B_jᵀ·G·x_j + A·r_j
//   da_k  = Σ_{j<k} M_kj - Σ_{i>k} M_ik + exp(a_k)·dy_k·(S_inᵀ·C_k)
//           - [k < L-1]·w_k·dt_k·B_kᵀ·G·x_k
//           + [k = L-1]·(Σ_{j<L-1} w_j·dt_j·B_jᵀ·G·x_j + exp(a_{L-1})·<S_in, G>)
//   M_ij = (C_i·B_j)·exp(a_i - a_j)·dt_j·(dy_i·x_j),  r_j = Σ_{k>=j} da_k,
//   dA = Σ_{b,j} r_j·dt_j.
//
// da leaves out the terms that cancel exactly (M_kk from both sums, and the
// j = k = L-1 state term): where dt·A is near -20 a step, M_kk is ~5e8 times
// the rest of da, and an f32 sum that kept both would leave its rounding as
// the whole of dA.  Decays are always exp of a difference (exp(a_i - a_j)),
// never exp(a_i)·exp(-a_j), which overflows under such decay, and a is
// summed in f64 (an f32 cumsum of thousands moves each decay by ~1e-4 of
// itself; the smoke's f32 strong-decay dA read 0.99 of its limit so, on an
// H100).  In f32 the
// products C·B and dy·x are summed in f64 and rounded once, as the f32
// forward sums C·B (where the decay erases the rest of a chunk, a row of dx
// is dt_j·(C_j·B_j)·dy_j, and an f32 sum of a dot product that cancels
// moves it).
//
// Four kernels, launched in this order on one stream:
// * ssd_scan_bwd_state_kernel (f32; bf16 goes to
//   ssd_scan_bwd_state_kernel_wgmma of ssd_scan_bwd_state_wgmma.cu): one
//   block per (head, batch).  The forward's state pass at chunk
//   granularity: it writes each chunk's S_in, (B, nC, H, N, P) f32, the
//   state kept in registers across the chunks.
// * ssd_scan_bwd_dstate_kernel (f32; bf16 goes to
//   ssd_scan_bwd_dstate_kernel_wgmma of the same file): one block per (head,
//   batch).  The reverse pass: it writes each chunk's G, (B, nC, H, N, P)
//   f32.  On bf16 at mamba2-130m's train layer the two took 0.767 and 0.766
//   ms on an H100 (700 W), ~46x the bytes they need, and gave way to the
//   tensor-core passes.
// * ssd_scan_bwd_chunk_kernel (f32; bf16 goes to ssd_scan_bwd_chunk_kernel_wgmma
//   of ssd_scan_bwd_wgmma.cu): one block per (head, chunk, batch).  It holds
//   x (transposed), dy and the two L x L matrices W1 = (C·Bᵀ)∘decay and
//   W2 = decay∘(dy·xᵀ) in shared memory (0 above the diagonal), and walks
//   the state dim N in slices of 8 columns for B, C, G and S_in, which do
//   not fit beside them.  It writes dx and ddt, and per-head partials of
//   dB, dC ((B, S, H, N) f32) and dA ((B, nC, H) f32).
// * ssd_scan_bwd_reduce_kernel: sums the partials of dB and dC over their
//   parts (the heads after this chunk kernel, the blocks' head splits
//   after the tensor-core one) and of dA over batch and chunks, in a fixed
//   order.
// No atomics: every output is written by one thread and summed in one fixed
// order, so two runs on the same inputs are bit-equal.
//
// What bounds it: at mamba2-130m's train layer (B 8, S 2048, H 24, P 64,
// N 128, L 128) the gradient's own inputs and outputs are ~0.17 GB (~0.05
// ms at the HBM rate) and its products ~52 GFLOP (~0.78 ms at the f32 FFMA
// rate), so in f32 arithmetic bounds it.  The chunk kernel computes C·Bᵀ
// once per head where the function needs it once per batch row, and all of
// each L x L product, zeros above the diagonal included; the partials of dB
// and dC are 2 x 201 MB written and read again, beside the state buffers
// (2 x 101 MB).  This is the simple form: FFMA on CUDA cores from shared
// memory, one 256-thread block per SM (220 KB of shared memory in the chunk
// kernel).  On bf16 it took 7.7 ms at that layer on an H100 and gave way
// to the tensor-core chunk kernel.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): the caller owns every allocation and the stream; one call
// launches one kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int ML = 128;          // largest chunk L
constexpr int MN = 128;          // largest state dim N
constexpr int MP = 64;           // largest head dim P
constexpr int NS = 8;            // state columns a slice in the chunk kernel

// pointers: inputs, the state buffers, the outputs and the partials
enum { X, DT, A, B, C, DY, SIN, G, DX, DDT, DBP, DCP, DAP, DB, DC, DA, NPTR };

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const void* dy;
  float* sin;                    // (B, nC, H, N, P): the state entering each chunk
  float* g;                      // (B, nC, H, N, P): the cotangent of the state leaving it
  void* dx;                      // (B, S, H, P), x's type
  float* ddt;                    // (B, S, H)
  float* dbp;                    // (B, S, parts, N): dB of each head or block
  float* dcp;                    // (B, S, parts, N): dC of each head or block
  float* dap;                    // (B, nC, H): dA of each (batch, chunk, head)
  void* db;                      // (B, S, N), x's type
  void* dc;                      // (B, S, N), x's type
  float* da;                     // (H,)
  long long x_b, x_s, x_h, x_p;  // element strides of the inputs
  long long dt_b, dt_s, dt_h;
  long long a_h;
  long long b_b, b_s, b_n;
  long long c_b, c_s, c_n;
  long long dy_b, dy_s, dy_h, dy_p;
  int batch, seqlen, heads, p, n, chunk, nchunks, parts;
};

template <typename T>
__device__ __forceinline__ float ld(const void* base, long long off);
template <>
__device__ __forceinline__ float ld<float>(const void* base, long long off) {
  return static_cast<const float*>(base)[off];
}

template <typename T>
__device__ __forceinline__ void st(void* base, long long off, float v);
template <>
__device__ __forceinline__ void st<float>(void* base, long long off, float v) {
  static_cast<float*>(base)[off] = v;
}
template <>
__device__ __forceinline__ void st<__nv_bfloat16>(void* base, long long off, float v) {
  static_cast<__nv_bfloat16*>(base)[off] = __float2bfloat16(v);
}

// dt (d) and a = cumsum(dt·A) (inclusive) over one chunk, summed in f64:
// rows past `valid` add 0, so a[ML-1] = a_{L-1}.  Under strong decay a
// reaches thousands within a chunk (dt·A near -20 a step), where an f32
// cumsum's rounding, ~1e-4 absolute, would move every decay exp(a_i - a_j)
// by ~1e-4 of itself (the f32 forward kernels' a is f32).  Warp 0, lane l
// owns rows 4l .. 4l+3.
__device__ __forceinline__ void chunk_decay(const Params& p, const float* dtg, float A, int s0,
                                            int valid, double* a, float* d) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float dv[4];
  double av[4], run = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = 4 * lane + e;
    dv[e] = r < valid ? dtg[(s0 + r) * p.dt_s] : 0.f;
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
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    a[4 * lane + e] = before + av[e];
    d[4 * lane + e] = dv[e];
  }
}

// exp(a_i - a_j) (or exp(a_i)) from the f64 cumsum, the exponent rounded once
__device__ __forceinline__ float decay(double x) { return expf(static_cast<float>(x)); }

__device__ __forceinline__ double mad(double a, double b, double c) { return fma(a, b, c); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------ state passes
// Forward (REV false): S <- exp(a_{L-1})·S + Σ_j (w_j·dt_j·B_j) ⊗ x_j, S_in of
// chunk c written before its update.  Reverse (REV true), from the last
// chunk down: G <- exp(a_{L-1})·G + Σ_i (exp(a_i)·C_i) ⊗ dy_i, the G of chunk
// c written before its update.  Thread (ng, pg), ng < 16, pg < 16, owns
// S[ng + 16r][4pg + q] (r < 8, q < 4) in registers.
constexpr int STATE_SMEM_FLOATS = ML * MN + ML * MP + 4 * ML;

template <bool REV>
__device__ __forceinline__ void state_pass(const Params& p) {
  using T = float;
  extern __shared__ __align__(16) float sm[];
  float* U = sm;                 // [ML][MN]  coefficient · B_j (or C_i)
  float* V = U + ML * MN;        // [ML][MP]  x_j (or dy_i)
  double* a = reinterpret_cast<double*>(V + ML * MP);
  float* d = reinterpret_cast<float*>(a + ML);
  float* coef = d + ML;

  const int tid = threadIdx.x;
  const int ng = tid >> 4, pg = tid & 15;
  const int h = blockIdx.x, b = blockIdx.y;
  const float Ah = p.A[h * p.a_h];
  const float* dtg = p.dt + b * p.dt_b + h * p.dt_h;
  const void* ug = REV ? p.C : p.B;
  const long long u_b = REV ? p.c_b : p.b_b, u_s = REV ? p.c_s : p.b_s,
                  u_n = REV ? p.c_n : p.b_n;
  const void* vg = REV ? p.dy : p.x;
  const long long v_off = REV ? b * p.dy_b + h * p.dy_h : b * p.x_b + h * p.x_h;
  const long long v_s = REV ? p.dy_s : p.x_s, v_p = REV ? p.dy_p : p.x_p;
  float* out = REV ? p.g : p.sin;

  float S[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) S[r][q] = 0.f;

  for (int t = 0; t < p.nchunks; ++t) {
    const int c = REV ? p.nchunks - 1 - t : t;
    const int s0 = c * p.chunk, valid = min(p.chunk, p.seqlen - s0);
    float* og = out + ((static_cast<long long>(b) * p.nchunks + c) * p.heads + h) * p.n * p.p;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int nn = ng + 16 * r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int pp = 4 * pg + q;
        if (nn < p.n && pp < p.p) og[nn * p.p + pp] = S[r][q];
      }
    }
    if (t == p.nchunks - 1) break;
    __syncthreads();                         // the last chunk is done with every tile
    chunk_decay(p, dtg, Ah, s0, valid, a, d);
    __syncthreads();
    if (tid < ML) coef[tid] = REV ? decay(a[tid]) : decay(a[ML - 1] - a[tid]) * d[tid];
    __syncthreads();
    for (int i = tid; i < ML * MN; i += THREADS) {
      const int r = i / MN, k = i % MN;
      U[i] = r < valid && k < p.n ? coef[r] * ld<T>(ug, b * u_b + (s0 + r) * u_s + k * u_n)
                                  : 0.f;
    }
    for (int i = tid; i < ML * MP; i += THREADS) {
      const int r = i / MP, k = i % MP;
      V[i] = r < valid && k < p.p ? ld<T>(vg, v_off + (s0 + r) * v_s + k * v_p) : 0.f;
    }
    __syncthreads();
    const float last = decay(a[ML - 1]);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) S[r][q] *= last;
    for (int j = 0; j < valid; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(V + j * MP + 4 * pg);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float u = U[j * MN + ng + 16 * r];
        S[r][0] = fmaf(u, v.x, S[r][0]);
        S[r][1] = fmaf(u, v.y, S[r][1]);
        S[r][2] = fmaf(u, v.z, S[r][2]);
        S[r][3] = fmaf(u, v.w, S[r][3]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) ssd_scan_bwd_state_kernel(const Params p) {
  state_pass<false>(p);
}

__global__ void __launch_bounds__(THREADS, 1) ssd_scan_bwd_dstate_kernel(const Params p) {
  state_pass<true>(p);
}

// ------------------------------------------------------------ chunk kernel
// XT, DY, W1, W2; the slice tiles (Bs, BT, Cs, Gs, GT, ST; also the column
// sums' scratch); a (f64) and nine vectors; the block sums' scratch
constexpr int SLICE_FLOATS = 3 * ML * NS + 3 * NS * MP;
constexpr int CHUNK_SMEM_FLOATS = 2 * MP * ML + 2 * ML * ML + SLICE_FLOATS + 11 * ML + 32;
static_assert(16 * ML <= SLICE_FLOATS, "the column sums' scratch fits in the slice tiles");

__global__ void __launch_bounds__(THREADS, 1) ssd_scan_bwd_chunk_kernel(const Params p) {
  using T = float;
  using Acc = double;            // the products C·Bᵀ and dy·xᵀ summed in f64
  extern __shared__ __align__(16) float sm[];
  float* XT = sm;                // [MP][ML]  x_j[q] at XT[q*ML + j]
  float* DYs = XT + MP * ML;     // [ML][MP]  dy_i[q]
  float* W1 = DYs + ML * MP;     // [ML][ML]  (C_i·B_j)·exp(a_i - a_j), j <= i
  float* W2 = W1 + ML * ML;      // [ML][ML]  exp(a_i - a_j)·(dy_i·x_j), j <= i
  float* SL = W2 + ML * ML;
  float* Bs = SL;                // [ML][NS]  B_j[n0 + k]
  float* BT = Bs + ML * NS;      // [NS][ML]
  float* Cs = BT + NS * ML;      // [ML][NS]
  float* Gs = Cs + ML * NS;      // [NS][MP]  G[n0 + k][q]
  float* GT = Gs + NS * MP;      // [MP][NS]
  float* ST = GT + MP * NS;      // [MP][NS]  S_in[n0 + k][q]
  double* a = reinterpret_cast<double*>(SL + SLICE_FLOATS);   // cumsum of dt·A, f64
  float* d = reinterpret_cast<float*>(a + ML);                  // dt
  float* ea = d + ML;            // exp(a_i)
  float* w = ea + ML;            // exp(a_{L-1} - a_j)
  float* bgx = w + ML;           // B_jᵀ·G·x_j
  float* csd = bgx + ML;         // C_iᵀ·S_in·dy_i
  float* rs = csd + ML;          // Σ_{j<i} P_ij·dt_j   (P = (C·Bᵀ)∘W2)
  float* cs = rs + ML;           // Σ_{i>j} P_ij
  float* pd = cs + ML;           // P_jj
  float* red = pd + 2 * ML;      // [32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int s0 = c * p.chunk, valid = min(p.chunk, p.seqlen - s0);
  const float Ah = p.A[h * p.a_h];
  const long long x_off = b * p.x_b + h * p.x_h, dy_off = b * p.dy_b + h * p.dy_h;
  const long long st_off =
      ((static_cast<long long>(b) * p.nchunks + c) * p.heads + h) * p.n * p.p;

  chunk_decay(p, p.dt + b * p.dt_b + h * p.dt_h, Ah, s0, valid, a, d);
  for (int i = tid; i < ML * MP; i += THREADS) {
    const int r = i / MP, q = i % MP;
    float xv = 0.f, gv = 0.f;
    if (r < valid && q < p.p) {
      xv = ld<T>(p.x, x_off + (s0 + r) * p.x_s + q * p.x_p);
      gv = ld<T>(p.dy, dy_off + (s0 + r) * p.dy_s + q * p.dy_p);
    }
    XT[q * ML + r] = xv;
    DYs[r * MP + q] = gv;
  }
  __syncthreads();
  if (tid < ML) {
    ea[tid] = decay(a[tid]);
    w[tid] = decay(a[ML - 1] - a[tid]);
    bgx[tid] = 0.f;
    csd[tid] = 0.f;
  }

  // W2 = decay ∘ (dy·xᵀ): thread (ty, tx) owns rows ty + 16r, columns tx + 16k
  {
    Acc acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[r][k] = 0;
    for (int q = 0; q < p.p; ++q) {
      Acc yv[8], xv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) yv[r] = DYs[(ty + 16 * r) * MP + q];
#pragma unroll
      for (int k = 0; k < 8; ++k) xv[k] = XT[q * ML + tx + 16 * k];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[r][k] = mad(yv[r], xv[k], acc[r][k]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = tx + 16 * k;
        W2[i * ML + j] = j <= i ? static_cast<float>(acc[r][k]) * decay(a[i] - a[j]) : 0.f;
      }
    }
  }

  // C·Bᵀ over the state dim in slices; then P = (C·Bᵀ)∘W2 — its row sums
  // (times dt_j) and column sums below the diagonal and its diagonal — and
  // W1 = (C·Bᵀ)∘decay
  {
    Acc cb[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int k = 0; k < 8; ++k) cb[r][k] = 0;
    for (int n0 = 0; n0 < p.n; n0 += NS) {
      __syncthreads();                       // the last slice's readers are done
      for (int e = tid; e < ML * NS; e += THREADS) {
        const int r = e / NS, k = e % NS, nn = n0 + k;
        float cv = 0.f, bv = 0.f;
        if (r < valid && nn < p.n) {
          cv = ld<T>(p.C, b * p.c_b + (s0 + r) * p.c_s + nn * p.c_n);
          bv = ld<T>(p.B, b * p.b_b + (s0 + r) * p.b_s + nn * p.b_n);
        }
        Cs[r * NS + k] = cv;
        BT[k * ML + r] = bv;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        Acc cv[8], bv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) cv[r] = Cs[(ty + 16 * r) * NS + k];
#pragma unroll
        for (int m = 0; m < 8; ++m) bv[m] = BT[k * ML + tx + 16 * m];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int m = 0; m < 8; ++m) cb[r][m] = mad(cv[r], bv[m], cb[r][m]);
      }
    }
    __syncthreads();                         // the slice tiles become the column sums' scratch
    float rsp[8], csp[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) rsp[r] = csp[r] = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = tx + 16 * k;
        const float cbv = static_cast<float>(cb[r][k]);
        const float pv = cbv * W2[i * ML + j];
        if (j < i) {
          rsp[r] = fmaf(pv, d[j], rsp[r]);
          csp[k] += pv;
        } else if (j == i) {
          pd[i] = pv;
        }
        W1[i * ML + j] = j <= i ? cbv * decay(a[i] - a[j]) : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float v = rsp[r];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (tx == 0) rs[ty + 16 * r] = v;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) SL[ty * ML + tx + 16 * k] = csp[k];
    __syncthreads();
    if (tid < ML) {
      float v = 0.f;
      for (int y = 0; y < 16; ++y) v += SL[y * ML + tid];
      cs[tid] = v;
    }
  }

  // the state terms and the outputs over the state dim, slice by slice
  float dxs[8][4];                           // Σ_n B_j[n]·G[n][q]: rows ty + 16r, columns tx + 16k
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) dxs[r][k] = 0.f;
  float sg = 0.f;                            // <S_in, G>, in thread 0
  const int kk = tid & 7, j0 = tid >> 3;     // slice column; rows j0 + 32r
  for (int n0 = 0; n0 < p.n; n0 += NS) {
    __syncthreads();                         // the last slice's readers are done
    for (int e = tid; e < ML * NS; e += THREADS) {
      const int r = e / NS, k = e % NS, nn = n0 + k;
      float cv = 0.f, bv = 0.f;
      if (r < valid && nn < p.n) {
        cv = ld<T>(p.C, b * p.c_b + (s0 + r) * p.c_s + nn * p.c_n);
        bv = ld<T>(p.B, b * p.b_b + (s0 + r) * p.b_s + nn * p.b_n);
      }
      Cs[r * NS + k] = cv;
      Bs[r * NS + k] = bv;
    }
    for (int e = tid; e < NS * MP; e += THREADS) {
      const int k = e / MP, q = e % MP, nn = n0 + k;
      float gv = 0.f, sv = 0.f;
      if (nn < p.n && q < p.p) {
        gv = p.g[st_off + nn * p.p + q];
        sv = p.sin[st_off + nn * p.p + q];
      }
      Gs[k * MP + q] = gv;
      GT[q * NS + k] = gv;
      ST[q * NS + k] = sv;
    }
    __syncthreads();

    // dx's state term
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      float bv[8], gv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) bv[r] = Bs[(ty + 16 * r) * NS + k];
#pragma unroll
      for (int m = 0; m < 4; ++m) gv[m] = Gs[k * MP + tx + 16 * m];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int m = 0; m < 4; ++m) dxs[r][m] = fmaf(bv[r], gv[m], dxs[r][m]);
    }

    // column n0 + kk of dB and dC at rows j0 + 32r
    float xg[4], dys[4], dbi[4], dci[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) xg[r] = dys[r] = dbi[r] = dci[r] = 0.f;
    for (int q = 0; q < p.p; ++q) {
      const float gt = GT[q * NS + kk], sv = ST[q * NS + kk];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        xg[r] = fmaf(XT[q * ML + j0 + 32 * r], gt, xg[r]);          // (G·x_j)[n]
        dys[r] = fmaf(DYs[(j0 + 32 * r) * MP + q], sv, dys[r]);     // (S_in·dy_i)[n]
      }
    }
    for (int i = 0; i < valid; ++i) {
      const float cv = Cs[i * NS + kk], bv = Bs[i * NS + kk] * d[i];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        dbi[r] = fmaf(W2[i * ML + j0 + 32 * r], cv, dbi[r]);        // Σ_i W2_ij·C_i[n]
        dci[r] = fmaf(W2[(j0 + 32 * r) * ML + i], bv, dci[r]);      // Σ_j W2_ij·dt_j·B_j[n]
      }
    }
    const int nn = n0 + kk;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + 32 * r;
      float tb = Bs[j * NS + kk] * xg[r], tc = Cs[j * NS + kk] * dys[r];
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) {
        tb += __shfl_xor_sync(0xffffffffu, tb, o);
        tc += __shfl_xor_sync(0xffffffffu, tc, o);
      }
      if (j < valid) {
        if (kk == 0) {
          bgx[j] += tb;
          csd[j] += tc;
        }
        if (nn < p.n) {
          const long long o = ((static_cast<long long>(b) * p.seqlen + s0 + j) * p.heads + h) *
                                  p.n + nn;
          p.dbp[o] = d[j] * (dbi[r] + w[j] * xg[r]);
          p.dcp[o] = dci[r] + ea[j] * dys[r];
        }
      }
    }

    // <S_in, G> over this slice
    float sgp = 0.f;
    for (int e = tid; e < NS * MP; e += THREADS) sgp += Gs[e] * ST[(e % MP) * NS + e / MP];
    sgp = warp_sum(sgp);
    if (lane == 0) red[warp] = sgp;
    __syncthreads();
    if (tid == 0)
      for (int y = 0; y < THREADS / 32; ++y) sg += red[y];
  }
  __syncthreads();

  // dx_j = dt_j·(Σ_i W1_ij·dy_i + w_j·Gᵀ·B_j)
  {
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
    for (int i = 0; i < valid; ++i) {
      float wv[8], yv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) wv[r] = W1[i * ML + ty + 16 * r];
#pragma unroll
      for (int k = 0; k < 4; ++k) yv[k] = DYs[i * MP + tx + 16 * k];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(wv[r], yv[k], acc[r][k]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = ty + 16 * r;
      if (j >= valid) continue;
      const long long o = ((static_cast<long long>(b) * p.seqlen + s0 + j) * p.heads + h) * p.p;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int q = tx + 16 * k;
        if (q < p.p) st<T>(p.dx, o + q, d[j] * (acc[r][k] + w[j] * dxs[r][k]));
      }
    }
  }

  // da, r = its suffix sums, ddt and this block's part of dA: warp 0, lane l
  // owns rows 4l .. 4l+3
  if (warp == 0) {
    const int last = valid - 1;
    const float sgv = __shfl_sync(0xffffffffu, sg, 0);
    float wsum = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * lane + e;
      if (j < last) wsum += w[j] * d[j] * bgx[j];
    }
    wsum = warp_sum(wsum);
    float dav[4], tot = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * lane + e;
      float v = 0.f;
      if (k < valid) {
        v = rs[k] - d[k] * cs[k] + ea[k] * csd[k];
        v = k < last ? v - w[k] * d[k] * bgx[k] : v + wsum + decay(a[ML - 1]) * sgv;
      }
      dav[e] = v;
      tot += v;
    }
    float incl = tot;                        // Σ over lanes >= this lane
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += v;
    }
    float run = incl - tot;
    float dap = 0.f;
#pragma unroll
    for (int e = 3; e >= 0; --e) {
      const int j = 4 * lane + e;
      run += dav[e];
      if (j < valid) {
        p.ddt[(static_cast<long long>(b) * p.seqlen + s0 + j) * p.heads + h] =
            cs[j] + pd[j] + w[j] * bgx[j] + Ah * run;
        dap = fmaf(run, d[j], dap);
      }
    }
    dap = warp_sum(dap);
    if (lane == 0) p.dap[(static_cast<long long>(b) * p.nchunks + c) * p.heads + h] = dap;
  }
}

// ----------------------------------------------------------- reduce kernel
// dB, dC (B, S, N) = the partials summed over their parts in order; dA[h]
// = the (batch, chunk) partials summed in order.  One thread an output.
template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_scan_bwd_reduce_kernel(const Params p) {
  const long long total = static_cast<long long>(p.batch) * p.seqlen * p.n;
  const long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (e < total) {
    const long long row = e / p.n;
    const int nn = static_cast<int>(e % p.n);
    const float* pb = p.dbp + row * p.parts * p.n + nn;
    const float* pc = p.dcp + row * p.parts * p.n + nn;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < p.parts; ++k) {
      sb += pb[k * p.n];
      sc += pc[k * p.n];
    }
    st<T>(p.db, e, sb);
    st<T>(p.dc, e, sc);
  } else if (e < total + p.heads) {
    const int h = static_cast<int>(e - total);
    float s = 0.f;
    for (long long bc = 0; bc < static_cast<long long>(p.batch) * p.nchunks; ++bc)
      s += p.dap[bc * p.heads + h];
    p.da[h] = s;
  }
}

enum Which { STATE, DSTATE, CHUNK, REDUCE };

template <typename Kernel>
int launch(Kernel kernel, size_t smem, dim3 grid, const Params& p, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(Which which, const Params& p, cudaStream_t stream) {
  const size_t state_smem = static_cast<size_t>(STATE_SMEM_FLOATS) * sizeof(float);
  constexpr bool f32 = std::is_same<T, float>::value;
  switch (which) {               // f32 only but the reduction: bf16 has the tensor-core
    case STATE:                  // kernels of ssd_scan_bwd_state_wgmma.cu and
      if constexpr (f32)         // ssd_scan_bwd_wgmma.cu
        return launch(ssd_scan_bwd_state_kernel, state_smem, dim3(p.heads, p.batch), p, stream);
      else
        return static_cast<int>(cudaErrorInvalidValue);
    case DSTATE:
      if constexpr (f32)
        return launch(ssd_scan_bwd_dstate_kernel, state_smem, dim3(p.heads, p.batch), p, stream);
      else
        return static_cast<int>(cudaErrorInvalidValue);
    case CHUNK:
      if constexpr (f32)
        return launch(ssd_scan_bwd_chunk_kernel,
                      static_cast<size_t>(CHUNK_SMEM_FLOATS) * sizeof(float),
                      dim3(p.heads, p.nchunks, p.batch), p, stream);
      else
        return static_cast<int>(cudaErrorInvalidValue);
    default: {
      const long long outputs = static_cast<long long>(p.batch) * p.seqlen * p.n + p.heads;
      return launch(ssd_scan_bwd_reduce_kernel<T>, 0,
                    dim3(static_cast<unsigned>((outputs + THREADS - 1) / THREADS)), p, stream);
    }
  }
}

int run(Which which, const void* const* ptrs, const long long* s, const int* dims,
        void* stream) {
  const int batch = dims[0], seqlen = dims[1], heads = dims[2], head_dim = dims[3],
            state = dims[4], chunk = dims[5], bf16 = dims[6], parts = dims[7];
  if (batch < 1 || batch > 65535 || seqlen < 1 || heads < 1 || heads > 65535 ||
      head_dim < 1 || head_dim > MP || state < 1 || state > MN || chunk < 1 || chunk > ML ||
      (which == REDUCE && (parts < 1 || parts > heads)) ||
      (which == CHUNK && parts != heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nchunks = (seqlen + chunk - 1) / chunk;
  if (nchunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = ptrs[X]; p.dt = static_cast<const float*>(ptrs[DT]);
  p.A = static_cast<const float*>(ptrs[A]); p.B = ptrs[B]; p.C = ptrs[C]; p.dy = ptrs[DY];
  p.sin = static_cast<float*>(const_cast<void*>(ptrs[SIN]));
  p.g = static_cast<float*>(const_cast<void*>(ptrs[G]));
  p.dx = const_cast<void*>(ptrs[DX]);
  p.ddt = static_cast<float*>(const_cast<void*>(ptrs[DDT]));
  p.dbp = static_cast<float*>(const_cast<void*>(ptrs[DBP]));
  p.dcp = static_cast<float*>(const_cast<void*>(ptrs[DCP]));
  p.dap = static_cast<float*>(const_cast<void*>(ptrs[DAP]));
  p.db = const_cast<void*>(ptrs[DB]); p.dc = const_cast<void*>(ptrs[DC]);
  p.da = static_cast<float*>(const_cast<void*>(ptrs[DA]));
  p.x_b = s[0]; p.x_s = s[1]; p.x_h = s[2]; p.x_p = s[3];
  p.dt_b = s[4]; p.dt_s = s[5]; p.dt_h = s[6];
  p.a_h = s[7];
  p.b_b = s[8]; p.b_s = s[9]; p.b_n = s[10];
  p.c_b = s[11]; p.c_s = s[12]; p.c_n = s[13];
  p.dy_b = s[14]; p.dy_s = s[15]; p.dy_h = s[16]; p.dy_p = s[17];
  p.batch = batch; p.seqlen = seqlen; p.heads = heads; p.p = head_dim; p.n = state;
  p.chunk = chunk; p.nchunks = nchunks; p.parts = parts;
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(which, p, strm) : dispatch<float>(which, p, strm);
}

}  // namespace

extern "C" {

// Enqueue one of the four backward kernels on `stream`; launch them in the
// order state, dstate, chunk, reduce on one stream (the first three f32
// here; bf16 repro_ssd_bwd_state_tc and repro_ssd_bwd_dstate_tc of
// ssd_scan_bwd_state_wgmma.cu and repro_ssd_bwd_chunk_tc of
// ssd_scan_bwd_wgmma.cu).  `ptrs` holds 16 device
// pointers: x, dt, A, B, C, dy (the inputs: x, B, C, dy f32 or bf16 by
// dims[6], dt and A f32), then f32 sin and g ((B, nC, H, N, P) each, nC =
// ceil(S / chunk)), dx (B, S, H, P) in x's type, f32 ddt (B, S, H), f32 dbp
// and dcp (B, S, parts, N), f32 dap (B, nC, H), db and dc (B, S, N) in x's
// type and f32 da (H,) — the outputs and buffers contiguous.  `strides`
// holds the 18 element strides of the inputs: x (4), dt (3), A (1), B (3),
// C (3), dy (4).  `dims`: batch, seqlen, heads, head_dim, state, chunk,
// bf16, parts (the partials' parts: heads for this chunk kernel, the
// splits for the tensor-core one).  Requires 1 <= chunk <= 128,
// 1 <= state <= 128, 1 <= head_dim <= 64, 1 <= batch, heads < 65536,
// nC < 65536, 1 <= parts <= heads (the state passes ignore it).  Returns cudaGetLastError() of the
// launch as an int (0 = launched); faults during the run surface at the
// next synchronize.
int repro_ssd_bwd_state(const void* const* ptrs, const long long* strides, const int* dims,
                        void* stream) {
  return run(STATE, ptrs, strides, dims, stream);
}

int repro_ssd_bwd_dstate(const void* const* ptrs, const long long* strides, const int* dims,
                         void* stream) {
  return run(DSTATE, ptrs, strides, dims, stream);
}

int repro_ssd_bwd_chunk(const void* const* ptrs, const long long* strides, const int* dims,
                        void* stream) {
  return run(CHUNK, ptrs, strides, dims, stream);
}

int repro_ssd_bwd_reduce(const void* const* ptrs, const long long* strides, const int* dims,
                         void* stream) {
  return run(REDUCE, ptrs, strides, dims, stream);
}

}  // extern "C"
