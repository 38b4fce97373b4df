// Blocked matmul for Hopper (sm_90a), plain C interface for ctypes: the
// paper's running example (MMulBlockBench, Table 1/3), with the block
// sizes baked in as compile-time constants.
//
// Replaces: src/repro/kernels/matmul/kernel.py::matmul_pallas (body
// _matmul_kernel), the reference's Pallas TPU kernel.  Same function:
// out (m, n) = x (m, k) @ y (k, n) with an fp32 accumulator, cast once to
// the output's type.
//
// What bounds it: operations.  2mnk flops against (mk + kn) reads and mn
// writes; at the square 4096 case that is 137 GFLOP against 201 MB, about
// 680 flops a byte, far above the card's ~20 (fp32 FMA) or ~295 (bf16
// tensor cores) flops a byte.  This kernel computes in fp32 on the FMA
// units (67 TFLOP/s), so its bound is 2mnk / 67e12 for both input types;
// a bf16 path on the tensor cores (wgmma) is later work.
//
// What the design does about it.  One thread block per (BM, BN) output
// tile; a loop over k stages the (BM, BK) tile of x (transposed) and the
// (BK, BN) tile of y in shared memory as fp32 (bf16 is widened while it
// is staged), and each thread keeps a TM x TN register micro-tile of fp32
// accumulators: per k it reads TM + TN values from shared memory for
// TM * TN fused multiply-adds.  A thread's rows and columns are strided by
// the thread grid (row ty + i * TY, column tx + j * TX), so a warp reads
// x's tile as a broadcast and y's tile as consecutive words: no bank
// conflicts on the reads.  BM, BN and BK are template arguments (the
// paper's B as a constant: the loops over the tile unroll), and so is
// DIVISIBLE, the CUDA form of the reference's assume_divisible: when set
// the bounds checks on the loads and stores are compiled out; without it
// the ragged edge tiles are masked (zeros staged past the edge, stores
// skipped), so a shape is never padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// Thread grid and register micro-tile of one (BM, BN) tile: at most 256
// threads, at least 4 outputs a thread.
template <int BM, int BN> struct Tile {
  static constexpr int kThreads = (BM * BN / 4 < 256) ? BM * BN / 4 : 256;
  static constexpr int kPer = BM * BN / kThreads;
  static constexpr int TN = kPer >= 64 ? 8 : (kPer >= 8 ? 4 : 2);
  static constexpr int TM = kPer / TN;
  static constexpr int TX = BN / TN;
  static constexpr int TY = BM / TM;
  static_assert(TX * TY == kThreads, "thread grid does not cover the tile");
  static_assert(TM * TY == BM && TN * TX == BN, "micro-tile mismatch");
};

template <typename TIn, typename TOut, int BM, int BN, int BK, bool DIVISIBLE>
__global__ void __launch_bounds__(Tile<BM, BN>::kThreads)
    matmul_kernel(const TIn* __restrict__ x, const TIn* __restrict__ y,
                  TOut* __restrict__ out, int m, int n, int k) {
  using G = Tile<BM, BN>;
  constexpr int kThreads = G::kThreads, TM = G::TM, TN = G::TN;
  constexpr int TX = G::TX, TY = G::TY;
  // x's tile transposed (k-major) with one word of padding per row, so the
  // transposing stores spread over the banks; y's tile as it lies.
  __shared__ float xs[BK][BM + 1];
  __shared__ float ys[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // Stage x[row0 : row0 + BM, k0 : k0 + BK]: consecutive threads read
    // consecutive k of one row.
#pragma unroll
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const int64_t gr = row0 + r, gc = k0 + c;
      float v;
      if (DIVISIBLE || (gr < m && gc < k))
        v = to_f(x[gr * k + gc]);
      else
        v = 0.0f;
      xs[c][r] = v;
    }
    // Stage y[k0 : k0 + BK, col0 : col0 + BN]: consecutive threads read
    // consecutive columns of one row.
#pragma unroll
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int64_t gr = k0 + r, gc = col0 + c;
      float v;
      if (DIVISIBLE || (gr < k && gc < n))
        v = to_f(y[gr * n + gc]);
      else
        v = 0.0f;
      ys[r][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ys[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gr = row0 + ty + i * TY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gc = col0 + tx + j * TX;
      if (DIVISIBLE || (gr < m && gc < n))
        out[gr * n + gc] = from_f<TOut>(acc[i][j]);
    }
  }
}

template <typename TIn, typename TOut, int BM, int BN, int BK>
cudaError_t launch(const void* x, const void* y, void* out, int m, int n,
                   int k, bool divisible, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const dim3 block(Tile<BM, BN>::kThreads);
  const TIn* xp = static_cast<const TIn*>(x);
  const TIn* yp = static_cast<const TIn*>(y);
  TOut* op = static_cast<TOut*>(out);
  if (divisible) {
    if (m % BM || n % BN || k % BK) return cudaErrorInvalidValue;
    matmul_kernel<TIn, TOut, BM, BN, BK, true>
        <<<grid, block, 0, stream>>>(xp, yp, op, m, n, k);
  } else {
    matmul_kernel<TIn, TOut, BM, BN, BK, false>
        <<<grid, block, 0, stream>>>(xp, yp, op, m, n, k);
  }
  return cudaGetLastError();
}

// The tile triples the library instantiates; keep in step with TILES in
// kernel.py.
template <typename TIn, typename TOut>
cudaError_t dispatch_tiles(const void* x, const void* y, void* out, int m,
                           int n, int k, int bm, int bn, int bk,
                           bool divisible, cudaStream_t s) {
#define REPRO_MATMUL_TILE(BM, BN, BK)                                        \
  if (bm == BM && bn == BN && bk == BK)                                      \
    return launch<TIn, TOut, BM, BN, BK>(x, y, out, m, n, k, divisible, s);
  REPRO_MATMUL_TILE(16, 16, 16)
  REPRO_MATMUL_TILE(32, 16, 8)
  REPRO_MATMUL_TILE(32, 64, 32)
  REPRO_MATMUL_TILE(64, 32, 8)
  REPRO_MATMUL_TILE(64, 64, 16)
  REPRO_MATMUL_TILE(128, 64, 16)
  REPRO_MATMUL_TILE(128, 128, 8)
  REPRO_MATMUL_TILE(128, 128, 16)
#undef REPRO_MATMUL_TILE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  Pairs (in, out): (0, 0),
// (1, 1), (1, 0).  x is (m, k), y (k, n), out (m, n), all row-major and
// contiguous.  divisible != 0 asserts m % bm == n % bn == k % bk == 0 and
// runs the instantiation without bounds checks (refused otherwise).
// Returns the cudaError_t of the launch (0 = success).
int matmul_fwd(const void* x, const void* y, void* out, int m, int n, int k,
               int bm, int bn, int bk, int in_dtype, int out_dtype,
               int divisible, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool div = divisible != 0;
  cudaError_t err;
  if (in_dtype == 0 && out_dtype == 0)
    err = dispatch_tiles<float, float>(x, y, out, m, n, k, bm, bn, bk, div,
                                       s);
  else if (in_dtype == 1 && out_dtype == 1)
    err = dispatch_tiles<__nv_bfloat16, __nv_bfloat16>(x, y, out, m, n, k,
                                                       bm, bn, bk, div, s);
  else if (in_dtype == 1 && out_dtype == 0)
    err = dispatch_tiles<__nv_bfloat16, float>(x, y, out, m, n, k, bm, bn,
                                               bk, div, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
