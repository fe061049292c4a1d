// Chunked SSD (Mamba2 state-space duality) forward for Hopper (sm_90a), f32
// FFMA on the CUDA cores.
//
// Replaces, for f32 x, B, C, the TPU kernel src/repro/kernels/ssd_scan/
// kernel.py::ssd_scan_pallas (_ssd_kernel); bf16 runs the tensor-core kernel
// of ssd_scan_wgmma.cu.  Same function: x (B,S,H,P), dt (B,S,H), A (H,),
// B/C (B,S,N) shared across heads, all f32, all math in f32 but the scores,
// y f32.  For a chunk of L steps with a = cumsum(dt·A) (inclusive):
//
//   y_i = Σ_{j<=i} exp(a_i - a_j)·(C_i·B_j)·dt_j·x_j  +  exp(a_i)·C_i·h
//   h  <- h·exp(a_L) + Σ_j exp(a_L - a_j)·dt_j·B_j ⊗ x_j        (h: N x P, f32)
//
// The scores C_i·B_j are summed in f64 and rounded once to f32: where a
// step's decay erases the rest of its chunk, a row of y is C_i·B_i·dt_i·x_i,
// and where that dot product cancels, an f32 sum of its N products is off
// by a few % of the row (JAX's sum, and the plain version's in f32, against
// the plain version in f64 on zamba2-7b's and mamba2-130m's real inputs:
// chip_smoke.py's per-layer checks on an H100), and this kernel's f32 sum
// lay 1.9e-3 of a row from the f64 one at mamba2-130m's layer shape on
// random inputs, past the f32 row limit of 1e-3 (chip_smoke.py, an H100).
//
// The upper triangle is masked before the exp, so it cannot overflow;
// exp(a_i) may underflow to 0, as on the TPU.  Chunks start at position 0;
// the last partial chunk is masked here (rows past S read as 0, which is
// what JAX's zero padding gives), so the wrapper never pads.  x, dt, B, C
// and y are taken by strides: the model's B and C are slices of one
// (B,S,2N) tensor, read in place.  When asked, the launch also writes the
// state after the last step (h_S, B x H x N x P, f32).
//
// What bounds it: at the mamba2-130m layer (B=8, S=8192, H=24, P=64, N=128,
// L=128, f32) one launch moves ~0.88 GB (x in, y out, B, C, dt) and needs
// ~0.9e11 FLOP of unmasked work: at the H100's f32 peak, ~1 ms.
// It does its arithmetic as f32 FFMA on CUDA cores, which the f32 limits
// need, so it runs well above that bound.
//
// Design: one CTA of 256 threads per (head, batch) walks the chunks in
// order — the TPU grid's sequential chunk axis becomes this loop, and h
// stays in shared memory across it (192 CTAs at the layer shape: 1.45
// waves of 132 SMs).  Per chunk, in shared memory as f32: the C and B tiles
// (L x N), x·dt (L x P), h (N x P), cumsum a and the two exp vectors.  The
// L x L score tile would not fit beside them (256 KB in all), so scores go
// in 32-row blocks (16 KB): block r computes C_i·B_j only for the 32-column
// groups at or below the diagonal, scales by the decay, and at once turns
// its 32 rows into y (the carried-state term, then the intra-chunk sum over
// j < 32(r+1)).  Then each thread updates its 8 x 4 piece of h.  219 KB of
// dynamic shared memory a CTA (hence the opt-in); the tiles are sized for
// L, N <= 128 and P <= 64 and zero-filled past the actual L, N and P.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): the caller owns every allocation and the stream; one call
// launches one kernel.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ML = 128;          // largest chunk L
constexpr int MN = 128;          // largest state dim N
constexpr int MP = 64;           // largest head dim P
constexpr int RB = 32;           // score rows per block
constexpr int BC_STR = MN + 4;   // row stride (floats) of the C and B tiles

// C, B tiles; x·dt; h; one block of scores; a, exp(a), exp(a_L - a), dt
constexpr int SMEM_FLOATS = 2 * ML * BC_STR + ML * MP + MN * MP + RB * ML + 4 * ML;

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  float* y;
  float* hout;                   // h_S (B,H,N,P) contiguous, or null
  long long x_b, x_s, x_h, x_p;  // element strides
  long long dt_b, dt_s, dt_h;
  long long a_h;
  long long b_b, b_s, b_n;
  long long c_b, c_s, c_n;
  long long y_b, y_s, y_h, y_p;
  int seqlen, p, n, chunk;
  int nr;                        // N rounded up to a multiple of 4
};

struct Tiles {
  float* C;   // [ML][BC_STR]
  float* B;   // [ML][BC_STR]
  float* X;   // [ML][MP]  x·dt
  float* H;   // [MN][MP]  carried state
  float* P;   // [RB][ML]  decayed, masked scores of one row block
  float* a;   // [ML]      cumsum of dt·A within the chunk
  float* ea;  // [ML]      exp(a_i)
  float* w;   // [ML]      exp(a_L - a_j)
  float* d;   // [ML]      dt
};

// Rows r0 .. r0+31 of the chunk: scores at or below the diagonal, then y.
// Thread (ty, tx), ty < 8, tx < 32: rows r0 + 4ty + i (i < 4); score columns
// tx + 32k (k <= RBI); output columns 2tx, 2tx + 1.
template <int RBI>
__device__ __forceinline__ void row_block(const Params& p, const Tiles& t, float* yg, int s0,
                                          int valid, int tid) {
  constexpr int K = RBI + 1;
  constexpr int r0 = RBI * RB;
  const int ty = tid >> 5, tx = tid & 31;

  double s[4][K];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < K; ++k) s[i][k] = 0.0;
#pragma unroll 2
  for (int n = 0; n < p.nr; n += 4) {
    float4 cv[4], bv[K];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cv[i] = *reinterpret_cast<const float4*>(t.C + (r0 + 4 * ty + i) * BC_STR + n);
#pragma unroll
    for (int k = 0; k < K; ++k)
      bv[k] = *reinterpret_cast<const float4*>(t.B + (tx + 32 * k) * BC_STR + n);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        s[i][k] = fma(static_cast<double>(cv[i].x), static_cast<double>(bv[k].x), s[i][k]);
        s[i][k] = fma(static_cast<double>(cv[i].y), static_cast<double>(bv[k].y), s[i][k]);
        s[i][k] = fma(static_cast<double>(cv[i].z), static_cast<double>(bv[k].z), s[i][k]);
        s[i][k] = fma(static_cast<double>(cv[i].w), static_cast<double>(bv[k].w), s[i][k]);
      }
  }
  // decay exp(a_i - a_j) below the diagonal; the mask comes before the exp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    const float ai = t.a[row];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int col = tx + 32 * k;
      t.P[(4 * ty + i) * ML + col] =
          col <= row ? static_cast<float>(s[i][k]) * expf(ai - t.a[col]) : 0.f;
    }
  }
  __syncthreads();

  // carried state: exp(a_i)·(C_i · h)
  float yi[4][2], yc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) yi[i][0] = yi[i][1] = yc[i][0] = yc[i][1] = 0.f;
#pragma unroll 2
  for (int n = 0; n < p.nr; n += 4) {
    float4 cv[4];
    float2 hv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cv[i] = *reinterpret_cast<const float4*>(t.C + (r0 + 4 * ty + i) * BC_STR + n);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      hv[e] = *reinterpret_cast<const float2*>(t.H + (n + e) * MP + 2 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      yc[i][0] = fmaf(cv[i].x, hv[0].x, yc[i][0]);
      yc[i][1] = fmaf(cv[i].x, hv[0].y, yc[i][1]);
      yc[i][0] = fmaf(cv[i].y, hv[1].x, yc[i][0]);
      yc[i][1] = fmaf(cv[i].y, hv[1].y, yc[i][1]);
      yc[i][0] = fmaf(cv[i].z, hv[2].x, yc[i][0]);
      yc[i][1] = fmaf(cv[i].z, hv[2].y, yc[i][1]);
      yc[i][0] = fmaf(cv[i].w, hv[3].x, yc[i][0]);
      yc[i][1] = fmaf(cv[i].w, hv[3].y, yc[i][1]);
    }
  }
  // within the chunk: Σ_{j < 32K} P[i][j]·(x·dt)[j]  (P is 0 above the diagonal)
#pragma unroll 2
  for (int j = 0; j < 32 * K; j += 4) {
    float4 pv[4];
    float2 xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(t.P + (4 * ty + i) * ML + j);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      xv[e] = *reinterpret_cast<const float2*>(t.X + (j + e) * MP + 2 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      yi[i][0] = fmaf(pv[i].x, xv[0].x, yi[i][0]);
      yi[i][1] = fmaf(pv[i].x, xv[0].y, yi[i][1]);
      yi[i][0] = fmaf(pv[i].y, xv[1].x, yi[i][0]);
      yi[i][1] = fmaf(pv[i].y, xv[1].y, yi[i][1]);
      yi[i][0] = fmaf(pv[i].z, xv[2].x, yi[i][0]);
      yi[i][1] = fmaf(pv[i].z, xv[2].y, yi[i][1]);
      yi[i][0] = fmaf(pv[i].w, xv[3].x, yi[i][0]);
      yi[i][1] = fmaf(pv[i].w, xv[3].y, yi[i][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= valid) continue;
    const float ea = t.ea[row];
    float* yrow = yg + (s0 + row) * p.y_s;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 2 * tx + e;
      if (col < p.p) yrow[col * p.y_p] = yi[i][e] + ea * yc[i][e];
    }
  }
  __syncthreads();                           // before the next block overwrites P
}

__global__ void __launch_bounds__(THREADS, 1) ssd_scan_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  Tiles t;
  t.C = smem;
  t.B = t.C + ML * BC_STR;
  t.X = t.B + ML * BC_STR;
  t.H = t.X + ML * MP;
  t.P = t.H + MN * MP;
  t.a = t.P + RB * ML;
  t.ea = t.a + ML;
  t.w = t.ea + ML;
  t.d = t.w + ML;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const float* xg = p.x + b * p.x_b + h * p.x_h;
  const float* dtg = p.dt + b * p.dt_b + h * p.dt_h;
  const float* bg = p.B + b * p.b_b;
  const float* cg = p.C + b * p.c_b;
  float* yg = p.y + b * p.y_b + h * p.y_h;
  const float A = p.A[h * p.a_h];

  for (int i = tid; i < MN * MP; i += THREADS) t.H[i] = 0.f;

  for (int s0 = 0; s0 < p.seqlen; s0 += p.chunk) {
    const int valid = min(p.chunk, p.seqlen - s0);
    __syncthreads();                         // the last chunk is done with every tile

    // dt and a = cumsum(dt·A) over the chunk; rows past `valid` add 0, so
    // a[ML-1] = a_L.  Warp 0, lane l owns rows 4l .. 4l+3.
    if (warp == 0) {
      float d[4], a[4], run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * lane + e;
        d[e] = r < valid ? dtg[(s0 + r) * p.dt_s] : 0.f;
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
        t.a[4 * lane + e] = before + a[e];
        t.d[4 * lane + e] = d[e];
      }
      __syncwarp();
      const float a_last = t.a[ML - 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ar = t.a[4 * lane + e];
        t.ea[4 * lane + e] = expf(ar);
        t.w[4 * lane + e] = expf(a_last - ar);
      }
    }
    __syncthreads();

    // C, B (L x N) and x·dt (L x P) as f32, zero past the valid rows, N, P
#pragma unroll 4
    for (int i = tid; i < ML * MN; i += THREADS) {
      const int r = i / MN, c = i % MN;
      float cv = 0.f, bv = 0.f;
      if (r < valid && c < p.n) {
        cv = cg[(s0 + r) * p.c_s + c * p.c_n];
        bv = bg[(s0 + r) * p.b_s + c * p.b_n];
      }
      t.C[r * BC_STR + c] = cv;
      t.B[r * BC_STR + c] = bv;
    }
#pragma unroll 4
    for (int i = tid; i < ML * MP; i += THREADS) {
      const int r = i / MP, c = i % MP;
      float v = 0.f;
      if (r < valid && c < p.p) v = xg[(s0 + r) * p.x_s + c * p.x_p] * t.d[r];
      t.X[i] = v;
    }
    __syncthreads();

    // outputs, 32 rows at a time (row blocks past the chunk are skipped)
    row_block<0>(p, t, yg, s0, valid, tid);
    if (RB < valid) row_block<1>(p, t, yg, s0, valid, tid);
    if (2 * RB < valid) row_block<2>(p, t, yg, s0, valid, tid);
    if (3 * RB < valid) row_block<3>(p, t, yg, s0, valid, tid);

    // h <- h·exp(a_L) + Σ_j (B_j·exp(a_L - a_j)) ⊗ (x·dt)_j; thread (ty, tx),
    // ty, tx < 16, owns h rows 8ty .. 8ty+7, columns 4tx .. 4tx+3
    {
      const int ty = tid >> 4, tx = tid & 15;
      float u[8][4];
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int f = 0; f < 4; ++f) u[e][f] = 0.f;
#pragma unroll 2
      for (int j = 0; j < valid; ++j) {
        const float wj = t.w[j];
        const float4 b0 = *reinterpret_cast<const float4*>(t.B + j * BC_STR + 8 * ty);
        const float4 b1 = *reinterpret_cast<const float4*>(t.B + j * BC_STR + 8 * ty + 4);
        const float4 xv = *reinterpret_cast<const float4*>(t.X + j * MP + 4 * tx);
        const float bw[8] = {b0.x * wj, b0.y * wj, b0.z * wj, b0.w * wj,
                             b1.x * wj, b1.y * wj, b1.z * wj, b1.w * wj};
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
          for (int f = 0; f < 4; ++f) u[e][f] = fmaf(bw[e], xs[f], u[e][f]);
      }
      const float decay = expf(t.a[ML - 1]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float4* hp = reinterpret_cast<float4*>(t.H + (8 * ty + e) * MP + 4 * tx);
        float4 hv = *hp;
        hv.x = hv.x * decay + u[e][0];
        hv.y = hv.y * decay + u[e][1];
        hv.z = hv.z * decay + u[e][2];
        hv.w = hv.w * decay + u[e][3];
        *hp = hv;
      }
    }
  }
  if (p.hout != nullptr) {
    __syncthreads();
    float* hg = p.hout + (static_cast<long long>(b) * gridDim.x + h) * p.n * p.p;
    for (int i = tid; i < p.n * p.p; i += THREADS) hg[i] = t.H[(i / p.p) * MP + i % p.p];
  }
}

int launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(SMEM_FLOATS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(heads, batch);
  ssd_scan_kernel<<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Enqueue the f32 SSD scan on `stream`.  x (B,S,H,P), B and C (B,S,N), y
// (B,S,H,P), dt (B,S,H) and A (H,) are f32 device arrays; hout, when not
// null, a contiguous (B,H,N,P) f32 array that receives the state after the
// last step.  All are addressed by element strides: x[b][s][h][p] at
// b*xs[0] + s*xs[1] + h*xs[2] + p*xs[3], likewise dt, B, C, y; A[h] at
// h*a_stride.  Requires 1 <= chunk <= 128, 1 <= n <= 128, 1 <= p <= 64,
// seqlen >= 1, 1 <= batch < 65536, heads >= 1.  Returns cudaGetLastError()
// of the launch as an int (0 = launched); faults during the run surface at
// the next synchronize.
int repro_ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, void* y, void* hout, const long long* xs, const long long* dts,
                   long long a_stride, const long long* bs, const long long* cs,
                   const long long* ys, int batch, int seqlen, int heads, int head_dim,
                   int state, int chunk, void* stream) {
  if (batch < 1 || batch > 65535 || seqlen < 1 || heads < 1 || head_dim < 1 ||
      head_dim > MP || state < 1 || state > MN || chunk < 1 || chunk > ML) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const float*>(x); p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A); p.B = static_cast<const float*>(Bm);
  p.C = static_cast<const float*>(Cm); p.y = static_cast<float*>(y);
  p.hout = static_cast<float*>(hout);
  p.x_b = xs[0]; p.x_s = xs[1]; p.x_h = xs[2]; p.x_p = xs[3];
  p.dt_b = dts[0]; p.dt_s = dts[1]; p.dt_h = dts[2];
  p.a_h = a_stride;
  p.b_b = bs[0]; p.b_s = bs[1]; p.b_n = bs[2];
  p.c_b = cs[0]; p.c_s = cs[1]; p.c_n = cs[2];
  p.y_b = ys[0]; p.y_s = ys[1]; p.y_h = ys[2]; p.y_p = ys[3];
  p.seqlen = seqlen; p.p = head_dim; p.n = state; p.chunk = chunk;
  p.nr = (state + 3) / 4 * 4;
  return launch(p, batch, heads, static_cast<cudaStream_t>(stream));
}

const char* repro_ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
