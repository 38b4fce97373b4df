// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/attention/kernel.py::flash_attention_pallas
// (body _flash_kernel), the reference's Pallas TPU kernel.  Same function:
// per (batch*head, query row), softmax(scale * q k^T) v over the kv columns
// that the causal and sliding-window masks (relative to q_offset) leave,
// with an online softmax in fp32; GQA reads kv head h / group.  A row with
// no valid column gets 0, as the Pallas kernel writes (its l == 0 guard).
//
// What bounds it: operations.  A causal prefill at S = 4096, 16 heads,
// d = 128 does 2 * 16 * S^2 * 128 * 2 / 2 ~ 69 GFLOP per layer against
// ~34 MB of q/k/v/out, ~2000 flops per byte.  The inputs are fp32 and the
// reference computes in fp32, so the peak that applies is the 67 TFLOP/s of
// the fp32 FMA units (TF32 tensor cores would change the numerics).
//
// What the design does about it (a simple kernel, right first; wgmma, TMA
// and pipelining are later work):
// * one thread block per (bh, q tile of BQ rows), 2*BQ threads; the q tile
//   and one (K, V) tile of BKV rows at a time are staged in shared memory
//   as fp32, so each K/V value read from device memory serves BQ rows;
// * kv tiles that the masks leave empty for the whole q tile are never
//   loaded (the pl.when(relevant) skip of the Pallas kernel): causal
//   prefill does half the work of a full one;
// * both products are register-tiled on the fp32 FMA units: a thread
//   computes a 4 x BKV/8 block of scores and accumulates a 4 x 16 block of
//   the output, reading 16-byte vectors from shared memory (rows padded to
//   an odd number of vectors, so the eight lanes that read different rows
//   hit different banks);
// * the running max and sum of each row live in registers of the eight
//   lanes that share the row and are combined with warp shuffles; scores
//   are kept in the log2 domain so the exponentials are exp2f;
// * the q tiles are visited heaviest first (the last tiles of a causal
//   sequence have the most kv tiles), which shortens the tail of the grid.
//
// BQ and BKV (the block_q / block_kv spec points) are template arguments:
// each tile pair is its own compiled kernel.  The head dims are runtime
// values up to kMaxHead; the shared-memory rows are sized to them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHead = 128;       // largest d and dv the kernel takes
constexpr int kRows = 4;            // query rows per thread
constexpr int kLanesPerRow = 8;     // threads sharing a row group
constexpr int kColsPerThread = kMaxHead / kLanesPerRow;   // 16
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Row stride (floats) of a staged tile of width w: w rounded up to whole
// 16-byte vectors, then to an odd number of them (bank spread).
__host__ __device__ __forceinline__ int tile_stride(int w) {
  return 4 * (((w + 3) / 4) | 1);
}

// Four consecutive values of T as fp32, from one 16-byte (fp32) or
// 8-byte (bf16) load.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Stage rows [0, rows) of a (n_valid, width) row-major slab into shared
// memory as fp32, zero-filling rows past n_valid and columns width..width4.
// With vec (width % 4 == 0 and the slab aligned to 4 values), each thread
// moves 4 values per load.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int stride,
                                      const T* __restrict__ src, int n_valid,
                                      int rows, int width, int width4,
                                      bool vec) {
  if (vec) {
    const int vpr = width / 4;           // vectors per row (width4 == width)
    const int n = rows * vpr;
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
      const int r = idx / vpr;
      const int c = 4 * (idx - r * vpr);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < n_valid) v = load4(src + static_cast<int64_t>(r) * width + c);
      *reinterpret_cast<float4*>(dst + r * stride + c) = v;
    }
    return;
  }
  const int n = rows * width4;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int r = idx / width4;
    const int c = idx - r * width4;
    float v = 0.0f;
    if (r < n_valid && c < width)
      v = to_f(src[static_cast<int64_t>(r) * width + c]);
    dst[r * stride + c] = v;
  }
}

template <typename T, int BQ, int BKV>
__global__ void __launch_bounds__(2 * BQ)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int sq,
                     int skv, int d, int dv, int group, float scale2,
                     int causal, int window, int q_offset, bool vec) {
  constexpr int kThreads = 2 * BQ;
  constexpr int kTn = BKV / kLanesPerRow;  // score columns per thread
  static_assert(BQ / kRows * kLanesPerRow == kThreads, "thread layout");
  static_assert(BKV % kLanesPerRow == 0, "BKV must be a multiple of 8");

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d4 = (d + 3) / 4 * 4;
  const int dv4 = (dv + 3) / 4 * 4;
  const int qk_stride = tile_stride(d);
  const int v_stride = tile_stride(dv);
  constexpr int p_stride = BKV + 4;
  float* qs = smem;
  float* ks = qs + BQ * qk_stride;
  float* vs = ks + BKV * qk_stride;
  float* ps = vs + BKV * v_stride;

  const int bh = blockIdx.y;
  const int n_q = gridDim.x;
  const int tile = n_q - 1 - blockIdx.x;   // heaviest (last) tiles first
  const int q0 = tile * BQ;
  const int tid = threadIdx.x;
  const int cg = tid % kLanesPerRow;       // column group
  const int r0 = (tid / kLanesPerRow) * kRows;   // first of my rows

  const T* qb = q + (static_cast<int64_t>(bh) * sq + q0) * d;
  const T* kb = k + static_cast<int64_t>(bh / group) * skv * d;
  const T* vb = v + static_cast<int64_t>(bh / group) * skv * dv;

  // kv tiles any row of this q tile can see (the tile-level skip).
  const int rows_here = min(BQ, sq - q0);
  const int row_first = q_offset + q0;
  const int row_last = q_offset + q0 + rows_here - 1;
  const int n_kv = (skv + BKV - 1) / BKV;
  int kv_lo = 0, kv_hi = n_kv;
  if (causal) kv_hi = row_last < 0 ? 0 : min(n_kv, row_last / BKV + 1);
  if (window > 0) {
    const int col_min = row_first - window + 1;
    kv_lo = col_min <= 0 ? 0 : col_min / BKV;
  }

  stage(qs, qk_stride, qb, rows_here, BQ, d, d4, vec);

  float m[kRows], l[kRows], acc[kRows][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.0f;
  }

  for (int t = kv_lo; t < kv_hi; ++t) {
    const int c0 = t * BKV;
    const int cols_here = min(BKV, skv - c0);
    __syncthreads();   // the previous tile's readers are done
    stage(ks, qk_stride, kb + static_cast<int64_t>(c0) * d, cols_here, BKV,
          d, d4, vec);
    stage(vs, v_stride, vb + static_cast<int64_t>(c0) * dv, cols_here, BKV,
          dv, dv4, vec);
    __syncthreads();

    // Scores s[i][j] of rows r0+i and columns cg + 8j, log2 domain.
    float s[kRows][kTn];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kTn; ++j) s[i][j] = 0.0f;
    for (int e = 0; e < d4; e += 4) {
      float4 qv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (r0 + i) * qk_stride +
                                                 e);
#pragma unroll
      for (int j = 0; j < kTn; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(
            ks + (cg + kLanesPerRow * j) * qk_stride + e);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

    // Mask, then the online softmax update of each row.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = row_first + r0 + i;
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kTn; ++j) {
        const int cl = cg + kLanesPerRow * j;
        const int col = c0 + cl;
        bool ok = cl < cols_here;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        s[i][j] = ok ? s[i][j] * scale2 : kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < kLanesPerRow; off <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = exp2f(m[i] - m_new);
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < kTn; ++j) {
        // A masked score contributes 0, never exp(0) (a row whose every
        // column so far is masked has m_new == kNegInf).
        const float p = s[i][j] == kNegInf ? 0.0f : exp2f(s[i][j] - m_new);
        rsum += p;
        ps[(r0 + i) * p_stride + cg + kLanesPerRow * j] = p;
      }
#pragma unroll
      for (int off = 1; off < kLanesPerRow; off <<= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = alpha * l[i] + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc[i][4g + x] += sum_c p[r0+i][c] * v[c][4 cg + 32 g + x].
    for (int c = 0; c < BKV; c += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (r0 + i) * p_stride +
                                                 c);
#pragma unroll
      for (int g = 0; g < kColsPerThread / 4; ++g) {
        const int col = 4 * cg + 4 * kLanesPerRow * g;
        if (col < dv4) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float4 vv = *reinterpret_cast<const float4*>(
                vs + (c + cc) * v_stride + col);
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              const float p = comp(pv[i], cc);
              acc[i][4 * g + 0] = fmaf(p, vv.x, acc[i][4 * g + 0]);
              acc[i][4 * g + 1] = fmaf(p, vv.y, acc[i][4 * g + 1]);
              acc[i][4 * g + 2] = fmaf(p, vv.z, acc[i][4 * g + 2]);
              acc[i][4 * g + 3] = fmaf(p, vv.w, acc[i][4 * g + 3]);
            }
          }
        }
      }
    }
  }

  T* ob = out + (static_cast<int64_t>(bh) * sq + q0) * dv;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + i;
    if (r >= rows_here) continue;
    const float inv = l[i] == 0.0f ? 0.0f : 1.0f / l[i];
#pragma unroll
    for (int g = 0; g < kColsPerThread / 4; ++g) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int col = 4 * cg + 4 * kLanesPerRow * g + x;
        if (col < dv)
          ob[static_cast<int64_t>(r) * dv + col] =
              from_f<T>(acc[i][4 * g + x] * inv);
      }
    }
  }
}

template <int BQ, int BKV>
size_t smem_bytes(int d, int dv) {
  return sizeof(float) *
         (static_cast<size_t>(BQ + BKV) * tile_stride(d) +
          static_cast<size_t>(BKV) * tile_stride(dv) +
          static_cast<size_t>(BQ) * (BKV + 4));
}

template <typename T, int BQ, int BKV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int bh, int sq, int skv, int d, int dv, int group,
                   float scale, int causal, int window, int q_offset,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<BQ, BKV>(d, dv);
  auto kernel = flash_fwd_kernel<T, BQ, BKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // Every row of every slab starts 4 values past an aligned one when the
  // widths are multiples of 4 and the base pointers are aligned.
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = d % 4 == 0 && dv % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % align == 0 &&
                   reinterpret_cast<uintptr_t>(k) % align == 0 &&
                   reinterpret_cast<uintptr_t>(v) % align == 0;
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  kernel<<<grid, 2 * BQ, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, d, dv, group,
      scale * kLog2e, causal, window, q_offset, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_tiles(const void* q, const void* k, const void* v,
                           void* out, int bh, int sq, int skv, int d, int dv,
                           int group, float scale, int causal, int window,
                           int q_offset, int block_q, int block_kv,
                           cudaStream_t s) {
#define FA_CASE(BQ_, BKV_)                                                  \
  if (block_q == BQ_ && block_kv == BKV_)                                   \
    return launch<T, BQ_, BKV_>(q, k, v, out, bh, sq, skv, d, dv, group,    \
                                scale, causal, window, q_offset, s);
  FA_CASE(64, 32)
  FA_CASE(64, 64)
  FA_CASE(128, 32)
  FA_CASE(128, 64)
#undef FA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (bh, sq, d), k (bh / group, skv, d), v (bh / group, skv, dv), out
// (bh, sq, dv), all row-major and of one dtype (0 = float32, 1 = bfloat16).
// window <= 0 means no sliding window.  Returns the cudaError_t of the
// launch (0 = success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int bh, int sq, int skv, int d, int dv,
                        int group, float scale, int causal, int window,
                        int q_offset, int dtype, int block_q, int block_kv,
                        void* stream) {
  if (bh <= 0 || sq <= 0 || skv <= 0 || d <= 0 || dv <= 0 || group <= 0 ||
      d > kMaxHead || dv > kMaxHead || bh % group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_tiles<float>(q, k, v, out, bh, sq, skv, d, dv, group,
                                scale, causal, window, q_offset, block_q,
                                block_kv, s);
  else if (dtype == 1)
    err = dispatch_tiles<__nv_bfloat16>(q, k, v, out, bh, sq, skv, d, dv,
                                        group, scale, causal, window,
                                        q_offset, block_q, block_kv, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
