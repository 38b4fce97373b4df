// Fused row RMSNorm for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas (body
// _rmsnorm_kernel), the reference's Pallas TPU kernel.  Same function:
// per row, fp32 mean(x^2), then x * rsqrt(var + eps) * w, cast back to
// x's type.
//
// What bounds it: bytes.  It must read rows*d*sizeof(x), write the same,
// and read d*4 bytes of weight; it does ~4 flops per element.  On the
// serve path's decode step (8 rows, d=1024, fp32) that is ~68 KB, about
// 0.02 us at 3.35 TB/s: far below the few microseconds a launch costs, so
// in practice the kernel is launch-bound, 113 launches per decode step.
//
// What the design does about it: one pass over device memory and nothing
// else.  One warp owns a row (no shared memory, no block-wide barrier:
// the sum of squares is combined with warp shuffles), each lane moves
// 16 bytes per load, and a block holds ROWS warps (the norm_block_rows
// spec point; 4 rows per block is the one instantiation the serve path
// uses), so small row counts spread over several SMs and large ones
// fill the card through a grid-stride loop.  The row is read twice (the
// second read hits L1/L2); the launch, not the bytes, is the cost to
// remove later, by fusing the norm into its neighbours or capturing the
// step in a CUDA graph.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxBlocks = 4096;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

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

// One 16-byte vector of T (4 floats or 8 bf16 values), loaded and stored
// with a single 128-bit access.
template <typename T> struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T, int ROWS>
__global__ void __launch_bounds__(ROWS * kWarp)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   T* __restrict__ out, int rows, int d, float eps,
                   bool vec_ok) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const float inv_d = 1.0f / static_cast<float>(d);
  const int nvec = vec_ok ? d / N : 0;       // vectors per row
  for (int row = blockIdx.x * ROWS + warp; row < rows;
       row += gridDim.x * ROWS) {
    const T* xr = x + static_cast<int64_t>(row) * d;
    T* orow = out + static_cast<int64_t>(row) * d;
    float ss = 0.0f;
    for (int i = lane; i < nvec; i += kWarp) {
      const Vec<T> a = reinterpret_cast<const Vec<T>*>(xr)[i];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float f = to_f(a.v[j]);
        ss += f * f;
      }
    }
    for (int i = nvec * N + lane; i < d; i += kWarp) {   // scalar tail
      float f = to_f(xr[i]);
      ss += f * f;
    }
    const float r = rsqrtf(warp_sum(ss) * inv_d + eps);
    for (int i = lane; i < nvec; i += kWarp) {
      const Vec<T> a = reinterpret_cast<const Vec<T>*>(xr)[i];
      Vec<T> o;
      const float4* wv = reinterpret_cast<const float4*>(w + i * N);
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 ww = wv[q];
        o.v[4 * q + 0] = from_f<T>(to_f(a.v[4 * q + 0]) * r * ww.x);
        o.v[4 * q + 1] = from_f<T>(to_f(a.v[4 * q + 1]) * r * ww.y);
        o.v[4 * q + 2] = from_f<T>(to_f(a.v[4 * q + 2]) * r * ww.z);
        o.v[4 * q + 3] = from_f<T>(to_f(a.v[4 * q + 3]) * r * ww.w);
      }
      reinterpret_cast<Vec<T>*>(orow)[i] = o;
    }
    for (int i = nvec * N + lane; i < d; i += kWarp)
      orow[i] = from_f<T>(to_f(xr[i]) * r * w[i]);
  }
}

template <typename T, int ROWS>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int d,
                   float eps, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(w) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const bool vec_ok = aligned && (d % N == 0);
  int blocks = (rows + ROWS - 1) / ROWS;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  rmsnorm_kernel<T, ROWS><<<blocks, ROWS * kWarp, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(out), rows, d, eps, vec_ok);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(const void* x, const void* w, void* out, int rows,
                          int d, float eps, int block_rows,
                          cudaStream_t stream) {
  switch (block_rows) {
    case 4: return launch<T, 4>(x, w, out, rows, d, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x and out are (rows, d) row-major,
// w is (d,) float32.  Returns the cudaError_t of the launch (0 = success).
int rmsnorm_fwd(const void* x, const void* w, void* out, int rows, int d,
                float eps, int dtype, int block_rows, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_rows<float>(x, w, out, rows, d, eps, block_rows, s);
  else if (dtype == 1)
    err = dispatch_rows<__nv_bfloat16>(x, w, out, rows, d, eps, block_rows,
                                       s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
