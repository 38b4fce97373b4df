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
// tensor cores) flops a byte.  fp32 products run on the FMA units (67
// TFLOP/s; TF32 is never used, so the result is what the plain version and
// cuBLAS with TF32 off compute), bf16 and fp16 products on the tensor
// cores (989 TFLOP/s, reachable only through wgmma).
//
// What the design does about it: three bodies under one entry point, the
// launcher picking one from the dtypes, the tile triple and the operands'
// alignment.  BM, BN and BK are template arguments (the paper's B as a
// constant: every loop over the tile unrolls), and so is DIVISIBLE, the
// CUDA form of the reference's assume_divisible: when set the edge masks
// are compiled out; without it ragged edges are masked (zeros staged past
// the edge, stores skipped), so a shape is never padded.
//
// * fp32, card tiles (fp32_kernel): the FMA units are fed from shared
//   memory, so the body keeps the loads off their path.  A ring of STAGES
//   tiles (2-4, derived from the tile: as many as let two blocks share an
//   SM) in dynamic shared memory is filled by cp.async while the FMAs run
//   on the oldest stage, one __syncthreads per k-tile.  x's tile is stored as it lies
//   (row-major, rows padded by 4 words) and y's as it lies; a thread owns
//   an 8 x 8 register tile (rows r, r + 4, ..., r + 28 of its warp's 32;
//   columns c..c+3 and c+32..c+35 of its warp's 64) and reads both
//   fragments as 128-bit loads: 4 k of one x row a load, 4 columns of one
//   y row a load, 16 loads for 256 FMAs, no bank conflicts (the 4 x rows a
//   warp reads at once land in 4 different bank quads).  Blocks are
//   numbered in groups of 8 tile rows so neighbouring blocks share x and y
//   panels in L2.  16-byte copies need 16-byte-aligned rows; other
//   operands (a view into its storage, n = 3001) take the same body with
//   4-byte copies (VEC false).
// * bf16 or fp16, card tiles (wgmma_kernel, the input type a template
//   argument): one producer warp issues TMA loads of
//   x's (BM, BK) tile (K-major, swizzled to BK * 2 bytes) and y's (BK, BN)
//   tile (as 64-column boxes, N-major, 128-byte swizzle) into a ring of
//   STAGES buffers behind full/empty mbarriers; one consumer warpgroup per
//   64 rows issues wgmma.m64nBNk16 on them (fp32 accumulators in
//   registers), keeps one group in flight and frees a stage when the group
//   that read it retires.  TMA fills zeros past the edges, so the mainloop
//   has no masks and a short or ragged k drains like any other.  TMA needs
//   16-byte-aligned pointers and rows (k and n multiples of 8).
// * everything else (simt_kernel): the reference's test tiles, and half
//   operands TMA cannot take: one stage staged through registers (bf16 and
//   fp16 widened to fp32), a TM x TN register tile a thread.
//
// Every body writes any of fp32, bf16 and fp16 (the accumulator rounded
// once): the output type is a runtime code, read by one branch after the
// main loop that picks an epilogue instantiated for each type, so the
// instantiation count does not grow with the outputs.  Operands of two
// dtypes are widened to fp32 by the wrapper (as jnp.dot promotes them) and
// take the fp32 bodies: every product of narrow operands is exact in fp32.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// Output dtype codes (kernel.py's _DTYPE_CODES).  A body's epilogue is
// instantiated for each output type and picked by one branch on the code,
// after the main loop.
enum OutCode { kOutF32 = 0, kOutBF16 = 1, kOutF16 = 2 };

// Block b of a 1-D grid over mt x nt tiles, numbered in groups of kGroup
// tile rows: consecutive blocks walk down a group's rows before moving one
// tile column right, so blocks in flight together share x rows and y
// columns in L2.
constexpr int kGroup = 8;
__device__ __forceinline__ void tile_of_block(int mt, int nt, int& tm,
                                              int& tn) {
  const int b = blockIdx.x;
  const int per_group = kGroup * nt;
  const int first = (b / per_group) * kGroup;
  const int rows = min(mt - first, kGroup);
  const int r = b % per_group;
  tm = first + r % rows;
  tn = r / rows;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// simt_kernel: one stage through registers (the general body)
// ---------------------------------------------------------------------------

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

// The simt body's epilogue: rows r0 + i TY, columns c0 + j TX of out.
template <typename TOut, int TM, int TN, int TX, int TY, bool DIVISIBLE>
__device__ __forceinline__ void simt_store(const float (&acc)[TM][TN],
                                           void* out, int64_t r0, int64_t c0,
                                           int m, int n) {
  TOut* o = static_cast<TOut*>(out);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gr = r0 + i * TY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gc = c0 + j * TX;
      if (DIVISIBLE || (gr < m && gc < n))
        o[gr * n + gc] = from_f<TOut>(acc[i][j]);
    }
  }
}

template <typename TIn, int BM, int BN, int BK, bool DIVISIBLE>
__global__ void __launch_bounds__(Tile<BM, BN>::kThreads)
    simt_kernel(const TIn* __restrict__ x, const TIn* __restrict__ y,
                void* __restrict__ out, int m, int n, int k, int out_code) {
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
#pragma unroll
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const int64_t gr = row0 + r, gc = k0 + c;
      xs[c][r] = (DIVISIBLE || (gr < m && gc < k)) ? to_f(x[gr * k + gc])
                                                   : 0.0f;
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int64_t gr = k0 + r, gc = col0 + c;
      ys[r][c] = (DIVISIBLE || (gr < k && gc < n)) ? to_f(y[gr * n + gc])
                                                   : 0.0f;
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

  if (out_code == kOutF32)
    simt_store<float, TM, TN, TX, TY, DIVISIBLE>(acc, out, row0 + ty,
                                                  col0 + tx, m, n);
  else if (out_code == kOutBF16)
    simt_store<__nv_bfloat16, TM, TN, TX, TY, DIVISIBLE>(acc, out, row0 + ty,
                                                          col0 + tx, m, n);
  else
    simt_store<__half, TM, TN, TX, TY, DIVISIBLE>(acc, out, row0 + ty,
                                                   col0 + tx, m, n);
}

template <typename TIn, int BM, int BN, int BK>
cudaError_t launch_simt(const void* x, const void* y, void* out, int m,
                        int n, int k, bool divisible, int out_code,
                        cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const dim3 block(Tile<BM, BN>::kThreads);
  const TIn* xp = static_cast<const TIn*>(x);
  const TIn* yp = static_cast<const TIn*>(y);
  if (divisible)
    simt_kernel<TIn, BM, BN, BK, true>
        <<<grid, block, 0, stream>>>(xp, yp, out, m, n, k, out_code);
  else
    simt_kernel<TIn, BM, BN, BK, false>
        <<<grid, block, 0, stream>>>(xp, yp, out, m, n, k, out_code);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32_kernel: cp.async ring, 128-bit fragment reads (fp32 card tiles)
// ---------------------------------------------------------------------------

template <int BM, int BN, int BK> struct Fp32Tile {
  static_assert(BM % 32 == 0 && BN % 64 == 0 && BK % 4 == 0,
                "fp32 body: BM % 32, BN % 64, BK % 4");
  static constexpr int kWarpsN = BN / 64;
  static constexpr int kThreads = 32 * (BM / 32) * kWarpsN;
  static_assert((BM * BK / 4) % kThreads == 0 && (BK * BN / 4) % kThreads == 0,
                "fp32 body: the 16-byte copies of a tile split evenly");
  static constexpr int kXStride = BK + 4;            // words per x row
  static constexpr int kXWords = BM * kXStride;
  static constexpr int kYWords = BK * BN;
  static constexpr int kStageBytes = 4 * (kXWords + kYWords);
  // As many stages (2 to 4) as fit two blocks in an SM's 227 KB, or one
  // block where a stage is that large.
  static constexpr int kFit2 = (113 * 1024) / kStageBytes;
  static constexpr int kFit1 = (226 * 1024) / kStageBytes;
  static constexpr int kStages =
      kFit2 >= 4 ? 4 : (kFit2 >= 3 ? 3 : (kFit1 >= 3 ? 3 : 2));
  static constexpr int kSmem = kStages * kStageBytes;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four outputs at p (16-byte aligned for fp32, 8-byte for half) as one
// store.
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y),
                               __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}
__device__ __forceinline__ void store4(__half* p, float4 v) {
  const __half2 h[2] = {__floats2half2_rn(v.x, v.y),
                        __floats2half2_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// The fp32 body's epilogue: a thread's 8 x 8 tile, rows r0 + 4i, columns
// c0..c0+3 and c0+32..c0+35.
template <typename TOut, bool DIVISIBLE, bool VEC>
__device__ __forceinline__ void fp32_store(const float (&acc)[8][8],
                                           void* out, int64_t r0, int64_t c0,
                                           int m, int n) {
  TOut* base = static_cast<TOut*>(out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t gr = r0 + 4 * i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gc = c0 + 32 * h;
      const float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                   acc[i][4 * h + 2], acc[i][4 * h + 3]);
      if (DIVISIBLE) {
        store4(base + gr * n + gc, v);
      } else if (gr < m) {
        TOut* o = base + gr * n + gc;
        if (VEC && gc + 3 < n) {
          store4(o, v);
        } else {
          if (gc < n) o[0] = from_f<TOut>(v.x);
          if (gc + 1 < n) o[1] = from_f<TOut>(v.y);
          if (gc + 2 < n) o[2] = from_f<TOut>(v.z);
          if (gc + 3 < n) o[3] = from_f<TOut>(v.w);
        }
      }
    }
  }
}

template <int BM, int BN, int BK, bool DIVISIBLE, bool VEC>
__global__ void __launch_bounds__(Fp32Tile<BM, BN, BK>::kThreads, 1)
    fp32_kernel(const float* __restrict__ x, const float* __restrict__ y,
                void* __restrict__ out, int m, int n, int k, int out_code) {
  using P = Fp32Tile<BM, BN, BK>;
  constexpr int kThreads = P::kThreads, XS = P::kXStride;
  constexpr int kStages = P::kStages;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                               // [stages][BM][XS]
  float* ys = smem + kStages * P::kXWords;        // [stages][BK][BN]

  int tm, tn;
  tile_of_block((m + BM - 1) / BM, (n + BN - 1) / BN, tm, tn);
  const int64_t row0 = static_cast<int64_t>(tm) * BM;
  const int64_t col0 = static_cast<int64_t>(tn) * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / P::kWarpsN) * 32, wn = (warp % P::kWarpsN) * 64;
  const int lr = lane / 8, lc = lane % 8;
  const int num_kt = (k + BK - 1) / BK;

  // Issue the copies of k-tile kt into stage s (zeros past the edges).
  auto load_tile = [&](int kt, int s) {
    float* xd = xs + s * P::kXWords;
    float* yd = ys + s * P::kYWords;
    const int k0 = kt * BK;
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < BM * BK / 4 / kThreads; ++i) {
        const int c = tid + i * kThreads;
        const int r = c / (BK / 4), cc = (c % (BK / 4)) * 4;
        const int64_t gr = row0 + r;
        const int gc = k0 + cc;
        const bool ok = DIVISIBLE || (gr < m && gc < k);
        cp_async16(xd + r * XS + cc, ok ? x + gr * k + gc : x, ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < BK * BN / 4 / kThreads; ++i) {
        const int c = tid + i * kThreads;
        const int r = c / (BN / 4), cc = (c % (BN / 4)) * 4;
        const int gr = k0 + r;
        const int64_t gc = col0 + cc;
        const bool ok = DIVISIBLE || (gr < k && gc < n);
        cp_async16(yd + r * BN + cc,
                   ok ? y + static_cast<int64_t>(gr) * n + gc : y,
                   ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < BM * BK / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int r = e / BK, cc = e % BK;
        const int64_t gr = row0 + r;
        const int gc = k0 + cc;
        const bool ok = DIVISIBLE || (gr < m && gc < k);
        cp_async4(xd + r * XS + cc, ok ? x + gr * k + gc : x, ok ? 4 : 0);
      }
#pragma unroll 4
      for (int i = 0; i < BK * BN / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int r = e / BN, cc = e % BN;
        const int gr = k0 + r;
        const int64_t gc = col0 + cc;
        const bool ok = DIVISIBLE || (gr < k && gc < n);
        cp_async4(yd + r * BN + cc,
                  ok ? y + static_cast<int64_t>(gr) * n + gc : y,
                  ok ? 4 : 0);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // Fill all but one stage; every step commits one group (empty past the
  // end), so "wait until at most kStages - 2 groups are pending" always
  // means "k-tile kt has landed".
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < num_kt) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < num_kt; ++kt) {
    cp_async_wait<kStages - 2>();
    // k-tile kt is visible to every thread, and every thread is done with
    // k-tile kt - 1, whose stage the next copies overwrite.
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < num_kt) load_tile(next, next % kStages);
    cp_async_commit();

    const float* xt = xs + (kt % kStages) * P::kXWords + (wm + lr) * XS;
    const float* yt = ys + (kt % kStages) * P::kYWords + wn + lc * 4;
#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      float a[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(xt + 4 * i * XS + kk);
        a[i][0] = v.x, a[i][1] = v.y, a[i][2] = v.z, a[i][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(yt + (kk + q) * BN);
        const float4 b1 =
            *reinterpret_cast<const float4*>(yt + (kk + q) * BN + 32);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(a[i][q], b[j], acc[i][j]);
      }
    }
  }

  const int64_t r0 = row0 + wm + lr, c0 = col0 + wn + lc * 4;
  if (out_code == kOutF32)
    fp32_store<float, DIVISIBLE, VEC>(acc, out, r0, c0, m, n);
  else if (out_code == kOutBF16)
    fp32_store<__nv_bfloat16, DIVISIBLE, VEC>(acc, out, r0, c0, m, n);
  else
    fp32_store<__half, DIVISIBLE, VEC>(acc, out, r0, c0, m, n);
}

template <int BM, int BN, int BK, bool DIVISIBLE, bool VEC>
cudaError_t launch_fp32_body(const float* x, const float* y, void* out,
                             int m, int n, int k, int out_code,
                             cudaStream_t stream) {
  using P = Fp32Tile<BM, BN, BK>;
  auto fn = fp32_kernel<BM, BN, BK, DIVISIBLE, VEC>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (attr != cudaSuccess) return attr;
  const int64_t tiles = static_cast<int64_t>((m + BM - 1) / BM) *
                        ((n + BN - 1) / BN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  fn<<<static_cast<unsigned>(tiles), P::kThreads, P::kSmem, stream>>>(
      x, y, out, m, n, k, out_code);
  return cudaGetLastError();
}

template <int BM, int BN, int BK>
cudaError_t launch_fp32(const void* x, const void* y, void* out, int m,
                        int n, int k, bool divisible, bool vec, int out_code,
                        cudaStream_t stream) {
  const float* xp = static_cast<const float*>(x);
  const float* yp = static_cast<const float*>(y);
  if (!vec)
    return launch_fp32_body<BM, BN, BK, false, false>(xp, yp, out, m, n, k,
                                                      out_code, stream);
  if (divisible)
    return launch_fp32_body<BM, BN, BK, true, true>(xp, yp, out, m, n, k,
                                                    out_code, stream);
  return launch_fp32_body<BM, BN, BK, false, true>(xp, yp, out, m, n, k,
                                                   out_code, stream);
}

// ---------------------------------------------------------------------------
// wgmma_kernel: TMA + mbarrier ring feeding wgmma (bf16, fp16 card tiles)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Spin until the phase of parity `parity` of the barrier has completed.  A
// pipeline fault that would leave it waiting forever traps instead (no
// wait on a running pipeline lasts 2^26 polls).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of wgmma: start address, leading and
// stride byte offsets (16-byte units) and the swizzle (1 = 128-byte, 2 =
// 64-byte, 3 = 32-byte).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo,
                                              uint32_t layout) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// wgmma.mma_async m64nNk16, fp32 accumulators, bf16 or fp16 inputs (the
// type string T): A (x) K-major, B (y) N-major (the trailing 0, 1: x not
// transposed, y transposed).  REPRO_D<n> lists the n accumulator
// operands.
#define REPRO_D8(i)                                                  \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]),           \
      "+f"(d[(i) + 7])
#define REPRO_D32 REPRO_D8(0), REPRO_D8(8), REPRO_D8(16), REPRO_D8(24)
#define REPRO_D64 REPRO_D32, REPRO_D8(32), REPRO_D8(40), REPRO_D8(48), \
                  REPRO_D8(56)
#define REPRO_D128 REPRO_D64, REPRO_D8(64), REPRO_D8(72), REPRO_D8(80), \
                   REPRO_D8(88), REPRO_D8(96), REPRO_D8(104),           \
                   REPRO_D8(112), REPRO_D8(120)
#define REPRO_WGMMA_64(T)                                        \
  asm volatile(                                                  \
      "{\n"                                                      \
      ".reg .pred p;\n"                                          \
      "setp.ne.b32 p, %34, 0;\n"                                 \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." T "." T " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7,\n"                        \
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"                  \
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"                \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                \
      "%32, %33, p, 1, 1, 0, 1;\n"                               \
      "}\n"                                                      \
      : REPRO_D32                                                \
      : "l"(da), "l"(db), "r"(scale_d))
#define REPRO_WGMMA_128(T)                                        \
  asm volatile(                                                   \
      "{\n"                                                       \
      ".reg .pred p;\n"                                           \
      "setp.ne.b32 p, %66, 0;\n"                                  \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." T "." T " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7,\n"                         \
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"                   \
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"                 \
      "%24, %25, %26, %27, %28, %29, %30, %31,\n"                 \
      "%32, %33, %34, %35, %36, %37, %38, %39,\n"                 \
      "%40, %41, %42, %43, %44, %45, %46, %47,\n"                 \
      "%48, %49, %50, %51, %52, %53, %54, %55,\n"                 \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                 \
      "%64, %65, p, 1, 1, 0, 1;\n"                                \
      "}\n"                                                       \
      : REPRO_D64                                                 \
      : "l"(da), "l"(db), "r"(scale_d))
#define REPRO_WGMMA_256(T)                                        \
  asm volatile(                                                   \
      "{\n"                                                       \
      ".reg .pred p;\n"                                           \
      "setp.ne.b32 p, %130, 0;\n"                                 \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." T "." T " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7,\n"                         \
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"                   \
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"                 \
      "%24, %25, %26, %27, %28, %29, %30, %31,\n"                 \
      "%32, %33, %34, %35, %36, %37, %38, %39,\n"                 \
      "%40, %41, %42, %43, %44, %45, %46, %47,\n"                 \
      "%48, %49, %50, %51, %52, %53, %54, %55,\n"                 \
      "%56, %57, %58, %59, %60, %61, %62, %63,\n"                 \
      "%64, %65, %66, %67, %68, %69, %70, %71,\n"                 \
      "%72, %73, %74, %75, %76, %77, %78, %79,\n"                 \
      "%80, %81, %82, %83, %84, %85, %86, %87,\n"                 \
      "%88, %89, %90, %91, %92, %93, %94, %95,\n"                 \
      "%96, %97, %98, %99, %100, %101, %102, %103,\n"             \
      "%104, %105, %106, %107, %108, %109, %110, %111,\n"         \
      "%112, %113, %114, %115, %116, %117, %118, %119,\n"         \
      "%120, %121, %122, %123, %124, %125, %126, %127}, "         \
      "%128, %129, p, 1, 1, 0, 1;\n"                              \
      "}\n"                                                       \
      : REPRO_D128                                                \
      : "l"(da), "l"(db), "r"(scale_d))

template <int N> struct Wgmma;
#define REPRO_WGMMA_STRUCT(N, NREG)                                        \
  template <> struct Wgmma<N> {                                            \
    template <bool F16>                                                    \
    static __device__ __forceinline__ void mma(float (&d)[NREG],           \
                                               uint64_t da, uint64_t db,   \
                                               int scale_d) {              \
      if constexpr (F16)                                                   \
        REPRO_WGMMA_##N("f16");                                            \
      else                                                                 \
        REPRO_WGMMA_##N("bf16");                                           \
    }                                                                      \
  };
REPRO_WGMMA_STRUCT(64, 32)
REPRO_WGMMA_STRUCT(128, 64)
REPRO_WGMMA_STRUCT(256, 128)
#undef REPRO_WGMMA_STRUCT

template <int BM, int BN, int BK> struct WgTile {
  static_assert(BM % 64 == 0 && BN % 64 == 0 && BN <= 256 && BK % 16 == 0 &&
                    BK <= 64,
                "wgmma body: BM % 64, BN % 64 (<= 256), BK % 16 (<= 64)");
  static constexpr int kConsumers = BM / 64;     // warpgroups
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kXRow = BK * 2;            // bytes: 32, 64 or 128
  static constexpr int kXBytes = BM * kXRow;
  static constexpr int kYBox = BK * 128;          // one 64-column box of y
  static constexpr int kStageBytes = kXBytes + (BN / 64) * kYBox;
  static constexpr int kFit = (200 * 1024) / kStageBytes;
  static constexpr int kStages = kFit > 8 ? 8 : (kFit < 3 ? 3 : kFit);
  // ring + slack to align it to 1024 bytes + full and empty barriers
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 16 * kStages;
  // x's swizzle as a descriptor layout and as a tensor map mode
  static constexpr uint32_t kXLayout = kXRow == 128 ? 1 : (kXRow == 64 ? 2
                                                                       : 3);
};

template <typename T> __device__ __forceinline__ void store2(T* p, float a,
                                                             float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a,
                                                          float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(
    __nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <> __device__ __forceinline__ void store2<__half>(__half* p,
                                                           float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// The wgmma body's epilogue.  Accumulator layout of m64nN: warp w of the
// warpgroup holds rows 16w .. 16w + 15; acc[4p + 2h + e] is row 16w + lane
// / 4 + 8h, column 8p + 2 (lane % 4) + e.  r0 and c0: this thread's first
// row and column.
template <typename TOut, int BN, bool DIVISIBLE>
__device__ __forceinline__ void wgmma_store(const float (&acc)[BN / 2],
                                            void* out, int64_t r0,
                                            int64_t c0, int m, int n) {
  TOut* base = static_cast<TOut*>(out);
#pragma unroll
  for (int p = 0; p < BN / 8; ++p) {
    const int64_t col = c0 + p * 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = r0 + 8 * h;
      const float a = acc[4 * p + 2 * h], b = acc[4 * p + 2 * h + 1];
      TOut* o = base + row * n + col;
      if (DIVISIBLE) {
        store2<TOut>(o, a, b);
      } else if (row < m) {
        if (col < n) o[0] = from_f<TOut>(a);
        if (col + 1 < n) o[1] = from_f<TOut>(b);
      }
    }
  }
}

template <typename TIn, int BM, int BN, int BK, bool DIVISIBLE>
__global__ void __launch_bounds__(WgTile<BM, BN, BK>::kThreads, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                 const __grid_constant__ CUtensorMap tmy,
                 void* __restrict__ out, int m, int n, int k, int out_code) {
  using P = WgTile<BM, BN, BK>;
  constexpr int kStages = P::kStages;
  constexpr bool kF16 = std::is_same<TIn, __half>::value;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages *
                                               P::kStageBytes);
  uint64_t* empty = full + kStages;

  int tm, tn;
  tile_of_block((m + BM - 1) / BM, (n + BN - 1) / BN, tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;
  const int num_kt = (k + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * P::kConsumers);   // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == P::kConsumers) {
    // Producer: one thread keeps the ring full.
    if (threadIdx.x == 128 * P::kConsumers) {
      for (int kt = 0; kt < num_kt; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        uint8_t* st = ring + s * P::kStageBytes;
        mbar_expect_tx(&full[s], P::kStageBytes);
        tma_load_2d(st, &tmx, &full[s], kt * BK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(st + P::kXBytes + j * P::kYBox, &tmy, &full[s],
                      n0 + 64 * j, kt * BK);
      }
    }
    return;
  }

  // Consumers: warpgroup wg computes rows wg * 64 .. wg * 64 + 63.
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  const int lane = threadIdx.x % 32;
  for (int kt = 0; kt < num_kt; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint8_t* xt = ring + s * P::kStageBytes + wg * 64 * P::kXRow;
    const uint8_t* yt = ring + s * P::kStageBytes + P::kXBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // x: 16 k (32 bytes) further along each swizzled row; 8-row groups
      // 8 rows apart.  y: 16 k rows (2048 bytes) further; 8-row groups
      // 1024 bytes apart, 64-column boxes kYBox apart.
      const uint64_t da = smem_desc(xt + kk * 32, 16, 8 * P::kXRow,
                                    P::kXLayout);
      const uint64_t db = smem_desc(yt + kk * 2048, P::kYBox, 1024, 1);
      Wgmma<BN>::template mma<kF16>(acc, da, db, 1);
    }
    wgmma_commit();
    // The group of k-tile kt - 1 has retired: its stage may be refilled.
    wgmma_wait<1>();
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  wgmma_wait<0>();

  const int w = (threadIdx.x % 128) / 32;
  const int64_t r0 = m0 + wg * 64 + w * 16 + lane / 4;
  const int64_t c0 = n0 + (lane % 4) * 2;
  if (out_code == kOutF32)
    wgmma_store<float, BN, DIVISIBLE>(acc, out, r0, c0, m, n);
  else if (out_code == kOutBF16)
    wgmma_store<__nv_bfloat16, BN, DIVISIBLE>(acc, out, r0, c0, m, n);
  else
    wgmma_store<__half, BN, DIVISIBLE>(acc, out, r0, c0, m, n);
}

// cuTensorMapEncodeTiled, fetched at run time with cudaGetDriverEntryPoint
// (so the library links no libcuda of its own).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A 2-D tensor map of a row-major (rows, cols) matrix of 2-byte elements
// (bf16 or fp16: `type`), box (box_cols, box_rows); zeros are read past its
// edges.
bool half_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
              int rows, int cols, int box_cols, int box_rows,
              CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TIn, int BM, int BN, int BK, bool DIVISIBLE>
cudaError_t launch_wgmma_body(const void* x, const void* y, void* out,
                              int m, int n, int k, int out_code,
                              cudaStream_t stream) {
  using P = WgTile<BM, BN, BK>;
  auto fn = wgmma_kernel<TIn, BM, BN, BK, DIVISIBLE>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (attr != cudaSuccess) return attr;
  const CUtensorMapSwizzle xswz =
      P::kXRow == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : (P::kXRow == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                        : CU_TENSOR_MAP_SWIZZLE_32B);
  const CUtensorMapDataType type = std::is_same<TIn, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tmx, tmy;
  if (!half_map(&tmx, type, x, m, k, BK, BM, xswz) ||
      !half_map(&tmy, type, y, k, n, 64, BK, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorNotSupported;
  const int64_t tiles = static_cast<int64_t>((m + BM - 1) / BM) *
                        ((n + BN - 1) / BN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  fn<<<static_cast<unsigned>(tiles), P::kThreads, P::kSmem, stream>>>(
      tmx, tmy, out, m, n, k, out_code);
  return cudaGetLastError();
}

template <typename TIn, int BM, int BN, int BK>
cudaError_t launch_wgmma(const void* x, const void* y, void* out, int m,
                         int n, int k, bool divisible, int out_code,
                         cudaStream_t stream) {
  if (divisible)
    return launch_wgmma_body<TIn, BM, BN, BK, true>(x, y, out, m, n, k,
                                                    out_code, stream);
  return launch_wgmma_body<TIn, BM, BN, BK, false>(x, y, out, m, n, k,
                                                   out_code, stream);
}

// ---------------------------------------------------------------------------
// Body selection and dispatch
// ---------------------------------------------------------------------------

// The tile triples the library instantiates; keep in step with
// TEST_TILES and CARD_TILES in kernel.py.
#define REPRO_MATMUL_TEST_TILES(X) \
  X(16, 16, 16) X(32, 16, 8) X(32, 64, 32) X(64, 32, 8)
#define REPRO_MATMUL_CARD_TILES(X)                                   \
  X(64, 64, 16) X(128, 64, 16) X(128, 128, 16) X(128, 128, 32)       \
  X(128, 128, 64) X(128, 256, 64)
// The simt body's tile for card-tile calls the other bodies cannot take.
constexpr int kSimtBM = 128, kSimtBN = 128, kSimtBK = 16;

enum Body { kSimt = 0, kFp32Vec = 1, kFp32Scalar = 2, kWgmma = 3 };

bool is_test_tile(int bm, int bn, int bk) {
#define REPRO_MATMUL_IS(BM, BN, BK) \
  if (bm == BM && bn == BN && bk == BK) return true;
  REPRO_MATMUL_TEST_TILES(REPRO_MATMUL_IS)
  return false;
}
bool is_card_tile(int bm, int bn, int bk) {
  REPRO_MATMUL_CARD_TILES(REPRO_MATMUL_IS)
  return false;
#undef REPRO_MATMUL_IS
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// -1: no instantiation for this tile triple or these dtypes.
int select_body(const void* x, const void* y, const void* out, int m, int n,
                int k, int bm, int bn, int bk, int in_dtype, int out_dtype) {
  if (in_dtype < 0 || in_dtype > 2 || out_dtype < 0 || out_dtype > 2)
    return -1;
  if (is_test_tile(bm, bn, bk)) return kSimt;
  if (!is_card_tile(bm, bn, bk)) return -1;
  if (in_dtype == 0)
    return aligned16(x) && aligned16(y) && aligned16(out) && k % 4 == 0 &&
                   n % 4 == 0
               ? kFp32Vec
               : kFp32Scalar;
  (void)m;
  return aligned16(x) && aligned16(y) && k % 8 == 0 && n % 8 == 0 ? kWgmma
                                                                   : kSimt;
}

template <typename TIn>
cudaError_t dispatch_simt(const void* x, const void* y, void* out, int m,
                          int n, int k, int bm, int bn, int bk,
                          bool divisible, int out_code, cudaStream_t s) {
#define REPRO_MATMUL_SIMT(BM, BN, BK)                                      \
  if (bm == BM && bn == BN && bk == BK)                                    \
    return launch_simt<TIn, BM, BN, BK>(x, y, out, m, n, k, divisible,     \
                                        out_code, s);
  REPRO_MATMUL_TEST_TILES(REPRO_MATMUL_SIMT)
#undef REPRO_MATMUL_SIMT
  // A card tile whose operands TMA cannot take: the simt body at its own
  // tile, edge-masked (the caller's tiles need not divide it).
  return launch_simt<TIn, kSimtBM, kSimtBN, kSimtBK>(x, y, out, m, n, k,
                                                     false, out_code, s);
}

cudaError_t dispatch_fp32(const void* x, const void* y, void* out, int m,
                          int n, int k, int bm, int bn, int bk,
                          bool divisible, bool vec, int out_code,
                          cudaStream_t s) {
#define REPRO_MATMUL_FP32(BM, BN, BK)                                  \
  if (bm == BM && bn == BN && bk == BK)                                \
    return launch_fp32<BM, BN, BK>(x, y, out, m, n, k, divisible, vec, \
                                   out_code, s);
  REPRO_MATMUL_CARD_TILES(REPRO_MATMUL_FP32)
#undef REPRO_MATMUL_FP32
  return cudaErrorInvalidValue;
}

template <typename TIn>
cudaError_t dispatch_wgmma(const void* x, const void* y, void* out, int m,
                           int n, int k, int bm, int bn, int bk,
                           bool divisible, int out_code, cudaStream_t s) {
#define REPRO_MATMUL_WGMMA(BM, BN, BK)                                   \
  if (bm == BM && bn == BN && bk == BK)                                  \
    return launch_wgmma<TIn, BM, BN, BK>(x, y, out, m, n, k, divisible, \
                                         out_code, s);
  REPRO_MATMUL_CARD_TILES(REPRO_MATMUL_WGMMA)
#undef REPRO_MATMUL_WGMMA
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Which body matmul_fwd runs for these arguments: 0 the simt body, 1 the
// fp32 body with 16-byte copies, 2 the fp32 body with 4-byte copies, 3
// the wgmma body; -1 if the library has no instantiation for them.
int matmul_body(const void* x, const void* y, const void* out, int m, int n,
                int k, int bm, int bn, int bk, int in_dtype, int out_dtype) {
  return select_body(x, y, out, m, n, k, bm, bn, bk, in_dtype, out_dtype);
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16; x and y share
// in_dtype, out may have any of the three.  x is (m, k), y (k, n), out (m,
// n), all row-major and contiguous (any alignment).  divisible != 0
// asserts m % bm == n % bn == k % bk == 0 and runs the instantiation
// without edge masks (refused otherwise).  Returns the cudaError_t of the
// launch (0 = success).
int matmul_fwd(const void* x, const void* y, void* out, int m, int n, int k,
               int bm, int bn, int bk, int in_dtype, int out_dtype,
               int divisible, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bn <= 0 || bk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool div = divisible != 0;
  if (div && (m % bm || n % bn || k % bk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int body =
      select_body(x, y, out, m, n, k, bm, bn, bk, in_dtype, out_dtype);
  cudaError_t err;
  switch (body) {
    case kFp32Vec:
    case kFp32Scalar:
      err = dispatch_fp32(x, y, out, m, n, k, bm, bn, bk, div,
                          body == kFp32Vec, out_dtype, s);
      break;
    case kWgmma:
      err = in_dtype == 1
                ? dispatch_wgmma<__nv_bfloat16>(x, y, out, m, n, k, bm, bn,
                                                bk, div, out_dtype, s)
                : dispatch_wgmma<__half>(x, y, out, m, n, k, bm, bn, bk,
                                         div, out_dtype, s);
      break;
    case kSimt:
      if (in_dtype == 0)
        err = dispatch_simt<float>(x, y, out, m, n, k, bm, bn, bk, div,
                                   out_dtype, s);
      else if (in_dtype == 1)
        err = dispatch_simt<__nv_bfloat16>(x, y, out, m, n, k, bm, bn, bk,
                                           div, out_dtype, s);
      else
        err = dispatch_simt<__half>(x, y, out, m, n, k, bm, bn, bk, div,
                                    out_dtype, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
