// Chunked gated linear attention forward for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces: src/repro/kernels/linear_attention/kernel.py::
// linear_attention_pallas (body _gla_kernel), the reference's Pallas TPU
// kernel.  Same function: per (batch*head) bh, over the chunks of C steps
// in order, with an fp32 state S (dk, dv) that starts at 0,
//   la   = cumsum(log_w) over the chunk, la_q = la (inclusive) or la - lw
//   out  = (q e^{la_q}) S + mask((q e^{la_q}) (k e^{-la})^T [+ diag]) v
//   S   <- e^{la_tot} S + (k e^{la_tot - la})^T v
// with a strict (exclusive) or non-strict (inclusive) lower-triangular
// mask; the RWKV bonus diagonal sum_e q u k is added in exclusive mode
// only, as the reference's oracle does (chunk_math.py:106; the Pallas
// kernel adds it whenever a bonus is given, and the wrapper refuses an
// inclusive call with a bonus).  The order of operations is the
// reference's, so both round alike: the factors e^{-la} reach e^{64} at
// C = 64 under the models' clamp (log_w >= -1), finite in fp32.
//
// What bounds it: at the rwkv6-1.6b prefill shape (bh 32, T 4096, dk = dv
// = 64, C = 64) the scores, intra, inter and state products are 4.3
// GFLOP of fp32 FMA (64 us at 67 TFLOP/s) against 168 MB of q, k, v, log_w
// and out (50 us at 3.35 TB/s): operations, narrowly.  But the recurrence
// is sequential over the chunks, and at batch 1 there are only 32 of them
// for 132 SMs, so the first limit is parallelism.
//
// What the design does about it (a simple kernel, right first; wgmma, TMA
// and pipelining are later work):
// * the Pallas kernel's sequential grid axis becomes a loop inside one
//   thread block, which keeps its part of S in shared memory;
// * each output column j depends only on S[:, j] and v[:, j], so the dv
//   columns are split across blocks of kSlice = 16 columns each, exactly:
//   a block owns S[:, slice] and recomputes the chunk's scores (c x c x dk
//   FMAs, the share that grows with the split).  The prefill shape launches
//   bh x dv / 16 = 32 x 4 = 128 blocks, one per SM; the chunk-parallel form
//   (summaries in parallel, a composing pass, outputs in parallel) would
//   fill the card too but needs three launches and the summaries in HBM;
// * per chunk the block stages q, k, log_w (fp32, 16-byte loads where
//   aligned) and its v columns in shared memory, scans log_w per column
//   (one thread a column, the chunk unrolled), forms the transformed
//   tiles, then the c x c scores as 16 x 16 threads with (C/16)^2 register
//   tiles, the outputs and the state update with fp32 FMA;
// * a ragged tail (T not a multiple of C) is masked, not refused: past T,
//   q, k and v stage as 0 and log_w as 0, which leaves every valid output
//   and the state exact.
//
// C (the chunk_len spec point: 16, 32, 64) is a template argument; dk and
// dv are runtime values up to kMaxHead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHead = 128;   // largest dk and dv the kernel takes
constexpr int kSlice = 16;      // dv columns per thread block
constexpr int kGrid = 16;       // the 16 x 16 thread grid of the scores
constexpr int kThreads = kGrid * kGrid;

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

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    gla_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ log_w,
                   const float* __restrict__ bonus, T* __restrict__ out,
                   int t_len, int dk, int dv, int n_slices, int inclusive,
                   bool vec, bool vec_w) {
  constexpr int R = C / kGrid;          // score rows and columns a thread
  constexpr int sc_stride = C + 1;
  static_assert(C % kGrid == 0, "C must be a multiple of 16");

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dk4 = (dk + 3) / 4 * 4;
  const int ks = tile_stride(dk);
  float* q_s = smem;                    // q, then q e^{la_q}
  float* k_s = q_s + C * ks;            // k, then k e^{-la}
  float* w_s = k_s + C * ks;            // log_w
  float* a_s = w_s + C * ks;            // la, then k e^{la_tot - la}
  float* sc_s = a_s + C * ks;           // (C, C) masked scores
  float* v_s = sc_s + C * sc_stride;    // (C, kSlice) this slice of v
  float* st_s = v_s + C * kSlice;       // (dk4, kSlice) this slice of S
  float* tot_s = st_s + dk4 * kSlice;   // (dk4) la_tot
  float* dg_s = tot_s + dk4;            // (C) bonus diagonal

  const int bh = blockIdx.x / n_slices;
  const int j0 = (blockIdx.x - bh * n_slices) * kSlice;
  const int nj = min(kSlice, dv - j0);
  const int tid = threadIdx.x;
  const int ti = tid / kGrid;
  const int tj = tid - ti * kGrid;
  const bool use_diag = bonus != nullptr && !inclusive;

  const T* qb = q + static_cast<int64_t>(bh) * t_len * dk;
  const T* kb = k + static_cast<int64_t>(bh) * t_len * dk;
  const float* wb = log_w + static_cast<int64_t>(bh) * t_len * dk;
  const T* vb = v + static_cast<int64_t>(bh) * t_len * dv;
  T* ob = out + static_cast<int64_t>(bh) * t_len * dv;
  const float* ub = use_diag ? bonus + static_cast<int64_t>(bh) * dk
                             : nullptr;

  for (int idx = tid; idx < dk4 * kSlice; idx += kThreads) st_s[idx] = 0.0f;

  const int n_chunks = (t_len + C - 1) / C;
  for (int n = 0; n < n_chunks; ++n) {
    const int t0 = n * C;
    const int rows = min(C, t_len - t0);
    __syncthreads();   // the previous chunk's readers are done
    const int64_t row0 = static_cast<int64_t>(t0) * dk;
    stage(q_s, ks, qb + row0, rows, C, dk, dk4, vec);
    stage(k_s, ks, kb + row0, rows, C, dk, dk4, vec);
    stage(w_s, ks, wb + row0, rows, C, dk, dk4, vec_w);
    for (int idx = tid; idx < C * kSlice; idx += kThreads) {
      const int r = idx / kSlice;
      const int j = idx - r * kSlice;
      float x = 0.0f;
      if (r < rows && j < nj)
        x = to_f(vb[static_cast<int64_t>(t0 + r) * dv + j0 + j]);
      v_s[idx] = x;
    }
    __syncthreads();

    // la = cumsum(log_w) per column; the bonus diagonal from raw q, k.
    if (tid < dk4) {
      float run = 0.0f;
#pragma unroll
      for (int r = 0; r < C; ++r) {
        run += w_s[r * ks + tid];
        a_s[r * ks + tid] = run;
      }
      tot_s[tid] = run;
    }
    if (use_diag && tid >= kThreads - C) {
      const int r = tid - (kThreads - C);
      float acc = 0.0f;
      for (int e = 0; e < dk; ++e)
        acc += q_s[r * ks + e] * ub[e] * k_s[r * ks + e];
      dg_s[r] = acc;
    }
    __syncthreads();

    // q e^{la_q}, k e^{-la}, k e^{la_tot - la}, in place.
    for (int idx = tid; idx < C * dk4; idx += kThreads) {
      const int r = idx / dk4;
      const int e = idx - r * dk4;
      const int o = r * ks + e;
      const float la = a_s[o];
      const float la_q = inclusive ? la : la - w_s[o];
      const float kk = k_s[o];
      q_s[o] = q_s[o] * expf(la_q);
      k_s[o] = kk * expf(-la);
      a_s[o] = kk * expf(tot_s[e] - la);
    }
    __syncthreads();

    // Scores of rows ti*R + a and columns tj + 16 b, masked, + diagonal.
    {
      float s[R][R];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b) s[a][b] = 0.0f;
      for (int e = 0; e < dk4; e += 4) {
        float4 qv[R], kv[R];
#pragma unroll
        for (int a = 0; a < R; ++a)
          qv[a] = *reinterpret_cast<const float4*>(q_s + (ti * R + a) * ks +
                                                   e);
#pragma unroll
        for (int b = 0; b < R; ++b)
          kv[b] = *reinterpret_cast<const float4*>(
              k_s + (tj + kGrid * b) * ks + e);
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int b = 0; b < R; ++b) {
            s[a][b] = fmaf(qv[a].x, kv[b].x, s[a][b]);
            s[a][b] = fmaf(qv[a].y, kv[b].y, s[a][b]);
            s[a][b] = fmaf(qv[a].z, kv[b].z, s[a][b]);
            s[a][b] = fmaf(qv[a].w, kv[b].w, s[a][b]);
          }
      }
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b) {
          const int i = ti * R + a;
          const int j = tj + kGrid * b;
          float x = (inclusive ? j <= i : j < i) ? s[a][b] : 0.0f;
          if (use_diag && i == j) x += dg_s[i];
          sc_s[i * sc_stride + j] = x;
        }
    }
    __syncthreads();

    // out[i][j] = (q e^{la_q})[i] . S[:, j] + scores[i] . v[:, j].
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int i = ti + kGrid * a;
      float inter = 0.0f, intra = 0.0f;
      for (int e = 0; e < dk4; ++e)
        inter = fmaf(q_s[i * ks + e], st_s[e * kSlice + tj], inter);
#pragma unroll 8
      for (int c = 0; c < C; ++c)
        intra = fmaf(sc_s[i * sc_stride + c], v_s[c * kSlice + tj], intra);
      if (i < rows && tj < nj)
        ob[static_cast<int64_t>(t0 + i) * dv + j0 + tj] =
            from_f<T>(inter + intra);
    }
    __syncthreads();

    // S[e][j] <- e^{la_tot[e]} S[e][j] + sum_r (k e^{la_tot - la})[r][e] v[r][j].
    for (int e = ti; e < dk4; e += kGrid) {
      float add = 0.0f;
#pragma unroll 8
      for (int r = 0; r < C; ++r)
        add = fmaf(a_s[r * ks + e], v_s[r * kSlice + tj], add);
      st_s[e * kSlice + tj] = expf(tot_s[e]) * st_s[e * kSlice + tj] + add;
    }
  }
}

template <int C>
size_t smem_bytes(int dk) {
  const size_t dk4 = (dk + 3) / 4 * 4;
  return sizeof(float) *
         (4 * static_cast<size_t>(C) * tile_stride(dk) +
          static_cast<size_t>(C) * (C + 1) + static_cast<size_t>(C) * kSlice +
          dk4 * kSlice + dk4 + C);
}

template <typename T, int C>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* log_w, const float* bonus, void* out, int bh,
                   int t_len, int dk, int dv, int inclusive,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<C>(dk);
  auto kernel = gla_fwd_kernel<T, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // Every row of every slab starts 4 values past an aligned one when dk is
  // a multiple of 4 and the base pointers are aligned.
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = dk % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % align == 0 &&
                   reinterpret_cast<uintptr_t>(k) % align == 0;
  const bool vec_w =
      dk % 4 == 0 && reinterpret_cast<uintptr_t>(log_w) % 16 == 0;
  const int n_slices = (dv + kSlice - 1) / kSlice;
  kernel<<<bh * n_slices, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), log_w, bonus, static_cast<T*>(out), t_len,
      dk, dv, n_slices, inclusive, vec, vec_w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_chunk(const void* q, const void* k, const void* v,
                           const float* log_w, const float* bonus, void* out,
                           int bh, int t_len, int dk, int dv, int chunk,
                           int inclusive, cudaStream_t s) {
  switch (chunk) {
    case 16:
      return launch<T, 16>(q, k, v, log_w, bonus, out, bh, t_len, dk, dv,
                           inclusive, s);
    case 32:
      return launch<T, 32>(q, k, v, log_w, bonus, out, bh, t_len, dk, dv,
                           inclusive, s);
    case 64:
      return launch<T, 64>(q, k, v, log_w, bonus, out, bh, t_len, dk, dv,
                           inclusive, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k (bh, t, dk) and v, out (bh, t, dv) row-major, of one dtype (0 =
// float32, 1 = bfloat16); log_w (bh, t, dk) and bonus (bh, dk) float32,
// bonus may be null.  Returns the cudaError_t of the launch (0 = success).
int linear_attention_fwd(const void* q, const void* k, const void* v,
                         const void* log_w, const void* bonus, void* out,
                         int bh, int t_len, int dk, int dv, int chunk,
                         int inclusive, int dtype, void* stream) {
  const int64_t n_slices = (dv + kSlice - 1) / kSlice;
  if (bh <= 0 || t_len <= 0 || dk <= 0 || dv <= 0 || dk > kMaxHead ||
      dv > kMaxHead || bh * n_slices > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(log_w);
  const float* u = static_cast<const float*>(bonus);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_chunk<float>(q, k, v, w, u, out, bh, t_len, dk, dv, chunk,
                                inclusive, s);
  else if (dtype == 1)
    err = dispatch_chunk<__nv_bfloat16>(q, k, v, w, u, out, bh, t_len, dk,
                                        dv, chunk, inclusive, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* linear_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
