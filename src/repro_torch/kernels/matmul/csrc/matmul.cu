// Blocked matmul for Hopper (sm_90a): C = A @ B with f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/matmul/kernel.py::matmul_pallas
// (_matmul_kernel): the Sigma∘Join contraction that tra._fused_matmul_2d
// collapses an unmasked (matMul, matAdd) pair into.  Same function:
// A (M,K) and B (K,N) in f32 or bf16, summed in f32, written in f32 or bf16.
//
// What bounds it at the FFNN scorer's shapes (speech-100k, bucket b <= 8):
//   * (b x 1600) @ (1600 x 100000): reading B (640 MB of f32) is the whole
//     cost; the arithmetic is 2*b*1600*100000 <= 2.6 GFLOP.  The design keeps
//     many blocks in flight (one 8 x 128 output tile each, ~800 blocks), each
//     streaming its B column strip once through shared memory, so the card's
//     memory rate, not its FMA rate, is the limit.
//   * (b x 100000) @ (100000 x 10): 4 MB of B and one output tile.  One block
//     per tile would run a 100000-long serial loop on one SM, so the K range
//     is split across blocks (split-K).  The partial sums go to a workspace
//     and a second kernel, splitk_reduce_kernel, adds them in a fixed order:
//     deterministic, no float atomics, so served results are bit-identical
//     from run to run.  At this size the two launches themselves are most of
//     the time.
//
// Design: one output tile per block, BK-deep tiles of A and B staged in
// shared memory as f32, each thread owning a TM x TN register tile and
// accumulating with FFMA (true f32, never TF32).  The next tile is fetched
// into registers (B as float4 where the layout allows) while the current one
// is multiplied, so loads overlap the arithmetic.  Ragged edges are masked
// in the kernel, so the caller never pads or copies an operand.  TMA, wgmma
// and a deeper shared-memory pipeline are left for later work.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes): the caller owns every allocation and the stream.  Each entry point
// launches one kernel, so the caller counts every launch: repro_matmul the
// tile kernel, repro_splitk_reduce the reduction pass.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
