// Fused row RMSNorm for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas (body
// _rmsnorm_kernel), the reference's Pallas TPU kernel.  Same function:
// per row, fp32 mean(x^2), then x * rsqrt(var + eps) * w, cast back to
// x's type (fp32, bf16 or fp16 rows: the fp32 weight, fp32 math inside).
//
// What bounds it: bytes.  It must read rows*d*sizeof(x), write the same,
// and read d*4 bytes of weight; it does ~4 flops per element.  At the
// prefill widths ((4096, 1024) and (4096, 2048) fp32) that is 32 and 64 MB,
// 10 and 20 us at 3.35 TB/s.  On the serve path's decode step (8 rows,
// d=1024, fp32) it is ~68 KB, 0.02 us: there a launch costs far more than
// the bytes, and the host's part of a launch most of all.
//
// What the design does about it:
// * One read of each row from device memory.  Where the row width is one
//   the library instantiates (d = 64, 128, 1024, 2048: G threads a row,
//   NV 16-byte vectors a thread, both template arguments) and every
//   pointer is 16-byte aligned, a thread loads all its vectors of the row
//   at once into registers, the G threads combine their sums of squares
//   (shuffles, and shared memory where a row spans several warps), and
//   the scale pass reads the registers, not memory.  A thread holds at
//   most 4 vectors, so it needs few registers and an SM keeps its 64 warps
//   resident, each with up to 64 bytes a lane in flight; narrow rows share
//   a warp (d = 64 fp32: 2 a warp), wide ones span warps (d = 2048 fp32:
//   4).  The grid covers every row group at once (no block cap).
// * Any other width or alignment takes the general body: one warp a row,
//   the row read twice (sum, then scale; the second read mostly from
//   L1/L2), 16-byte accesses where aligned and a scalar tail.
// * Two segments in one launch: the blocks of the grid are split between
//   two (x, w, out) triples of one width and dtype, so a layer's q-norm
//   and k-norm are one launch, not two.
// * Rows are taken in storage order: the caller passes any tensor whose
//   last dimension is contiguous and whose elements are dense, and gets
//   the output in the same layout, so a permuted view needs no copy.
// Block size is ROWS warps (the norm_block_rows spec point, 4 on every
// path of the port).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarp = 32;

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

// One 16-byte vector of T (4 floats or 8 bf16 or fp16 values), loaded and
// stored with a single 128-bit access.
template <typename T> struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

// One (x, w, out) triple of `rows` rows.
template <typename T> struct Seg {
  const T* x;
  const float* w;
  T* out;
  int rows;
};

// Sum over groups of G consecutive lanes (G a power of two <= 32).
template <int G> __device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Scale one vector of x by r and the matching 16 bytes' worth of w.
template <typename T>
__device__ __forceinline__ Vec<T> scale(const Vec<T>& a, const float* w,
                                        float r) {
  constexpr int N = Vec<T>::N;
  Vec<T> o;
  const float4* wv = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 ww = wv[q];
    o.v[4 * q + 0] = from_f<T>(to_f(a.v[4 * q + 0]) * r * ww.x);
    o.v[4 * q + 1] = from_f<T>(to_f(a.v[4 * q + 1]) * r * ww.y);
    o.v[4 * q + 2] = from_f<T>(to_f(a.v[4 * q + 2]) * r * ww.z);
    o.v[4 * q + 3] = from_f<T>(to_f(a.v[4 * q + 3]) * r * ww.w);
  }
  return o;
}

// The register body: G threads a row, NV vectors a thread (d = G * NV * N).
// Blocks [0, blocks_a) take segment a, the rest segment b.
template <typename T, int G, int NV, int ROWS>
__global__ void __launch_bounds__(ROWS * kWarp)
    rmsnorm_regs(Seg<T> a, Seg<T> b, int blocks_a, float inv_d, float eps) {
  constexpr int N = Vec<T>::N;
  constexpr int D = G * NV * N;
  constexpr int kRowsPerBlock = ROWS * kWarp / G;
  const bool second = blockIdx.x >= blocks_a;
  const Seg<T> s = second ? b : a;
  const int blk = second ? blockIdx.x - blocks_a : blockIdx.x;
  const int row = blk * kRowsPerBlock + threadIdx.x / G;
  const int g = threadIdx.x % G;
  // Groups past the last row stay (the shuffles need the whole warp) but
  // load and store nothing.
  const bool live = row < s.rows;
  const int64_t base = static_cast<int64_t>(live ? row : 0) * D;
  const Vec<T>* xr = reinterpret_cast<const Vec<T>*>(s.x + base);
  Vec<T> v[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (live) {
      v[i] = xr[g + i * G];
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) v[i].v[j] = from_f<T>(0.0f);
    }
  }
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float f = to_f(v[i].v[j]);
      ss += f * f;
    }
  ss = group_sum<(G < kWarp ? G : kWarp)>(ss);
  if constexpr (G > kWarp) {
    // A row spans G / 32 warps: combine their sums through shared memory.
    __shared__ float part[ROWS];
    const int warp = threadIdx.x / kWarp;
    if (threadIdx.x % kWarp == 0) part[warp] = ss;
    __syncthreads();
    const int first = warp - warp % (G / kWarp);
    ss = 0.0f;
#pragma unroll
    for (int i = 0; i < G / kWarp; ++i) ss += part[first + i];
  }
  const float r = rsqrtf(ss * inv_d + eps);
  if (!live) return;
  Vec<T>* orow = reinterpret_cast<Vec<T>*>(s.out + base);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = g + i * G;
    orow[c] = scale<T>(v[i], s.w + c * N, r);
  }
}

// The general body: one warp a row, two passes over the row.
template <typename T, int ROWS>
__global__ void __launch_bounds__(ROWS * kWarp)
    rmsnorm_general(Seg<T> a, Seg<T> b, int blocks_a, int d, float eps,
                    bool vec_ok) {
  constexpr int N = Vec<T>::N;
  const bool second = blockIdx.x >= blocks_a;
  const Seg<T> s = second ? b : a;
  const int blk = second ? blockIdx.x - blocks_a : blockIdx.x;
  const int row = blk * ROWS + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= s.rows) return;                  // whole warps leave together
  const float inv_d = 1.0f / static_cast<float>(d);
  const int nvec = vec_ok ? d / N : 0;       // vectors per row
  const T* xr = s.x + static_cast<int64_t>(row) * d;
  T* orow = s.out + static_cast<int64_t>(row) * d;
  float ss = 0.0f;
  for (int i = lane; i < nvec; i += kWarp) {
    const Vec<T> v = reinterpret_cast<const Vec<T>*>(xr)[i];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float f = to_f(v.v[j]);
      ss += f * f;
    }
  }
  for (int i = nvec * N + lane; i < d; i += kWarp) {   // scalar tail
    const float f = to_f(xr[i]);
    ss += f * f;
  }
  const float r = rsqrtf(group_sum<kWarp>(ss) * inv_d + eps);
  for (int i = lane; i < nvec; i += kWarp)
    reinterpret_cast<Vec<T>*>(orow)[i] =
        scale<T>(reinterpret_cast<const Vec<T>*>(xr)[i], s.w + i * N, r);
  for (int i = nvec * N + lane; i < d; i += kWarp)
    orow[i] = from_f<T>(to_f(xr[i]) * r * s.w[i]);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T> bool seg_aligned(const Seg<T>& s) {
  return s.rows == 0 ||
         (aligned16(s.x) && aligned16(s.w) && aligned16(s.out));
}

// Threads a row of the register body for width d, or 0 where the library
// has no register instantiation for it: a thread holds at most 4 vectors
// (few registers, so an SM keeps its 64 warps resident), and NV = d / (G *
// N) follows.  Wide rows span several warps (fp32 d = 1024: 2, d = 2048:
// 4), narrow ones share a warp (d = 64: 2 rows a warp in fp32, 4 in bf16
// and fp16).
template <typename T> constexpr int regs_group(int d) {
  if (d != 64 && d != 128 && d != 1024 && d != 2048) return 0;
  const int vecs = d / Vec<T>::N;
  return vecs <= kWarp ? vecs : (vecs / 4 > kWarp ? vecs / 4 : kWarp);
}

template <typename T, int D, int ROWS>
cudaError_t launch_width(const Seg<T>& a, const Seg<T>& b, float eps,
                         cudaStream_t stream) {
  constexpr int G = regs_group<T>(D);
  constexpr int NV = D / (G * Vec<T>::N);
  static_assert(G * NV * Vec<T>::N == D && G <= ROWS * kWarp,
                "register body does not cover the row");
  constexpr int kRowsPerBlock = ROWS * kWarp / G;
  const int blocks_a = (a.rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const int blocks_b = (b.rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_regs<T, G, NV, ROWS><<<blocks_a + blocks_b, ROWS * kWarp, 0,
                                 stream>>>(
      a, b, blocks_a, 1.0f / static_cast<float>(D), eps);
  return cudaGetLastError();
}

template <typename T, int ROWS>
cudaError_t launch(const Seg<T>& a, const Seg<T>& b, int d, float eps,
                   cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const bool aligned = seg_aligned(a) && seg_aligned(b) && d % N == 0;
  if (aligned) {
    switch (d) {
      case 64: return launch_width<T, 64, ROWS>(a, b, eps, stream);
      case 128: return launch_width<T, 128, ROWS>(a, b, eps, stream);
      case 1024: return launch_width<T, 1024, ROWS>(a, b, eps, stream);
      case 2048: return launch_width<T, 2048, ROWS>(a, b, eps, stream);
    }
  }
  const int blocks_a = (a.rows + ROWS - 1) / ROWS;
  const int blocks_b = (b.rows + ROWS - 1) / ROWS;
  rmsnorm_general<T, ROWS><<<blocks_a + blocks_b, ROWS * kWarp, 0,
                             stream>>>(a, b, blocks_a, d, eps, aligned);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(const void* x0, const void* w0, void* out0,
                          int rows0, const void* x1, const void* w1,
                          void* out1, int rows1, int d, float eps,
                          int block_rows, cudaStream_t stream) {
  const Seg<T> a{static_cast<const T*>(x0), static_cast<const float*>(w0),
                 static_cast<T*>(out0), rows0};
  const Seg<T> b{static_cast<const T*>(x1), static_cast<const float*>(w1),
                 static_cast<T*>(out1), rows1};
  switch (block_rows) {
    case 4: return launch<T, 4>(a, b, d, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The launch's arguments as the wrapper packs them (Python's struct
// "<QQQqQQQqqdqqQ": every field 8 bytes, so the layout has no padding).
// One packed buffer crosses the ctypes boundary far faster than thirteen
// converted arguments, and on the decode step that conversion costs more
// than the kernel.
struct PairArgs {
  uint64_t x0, w0, out0;
  int64_t rows0;
  uint64_t x1, w1, out1;
  int64_t rows1;
  int64_t d;
  double eps;
  int64_t dtype, block_rows;
  uint64_t stream;
};
static_assert(sizeof(PairArgs) == 13 * 8, "PairArgs must be unpadded");

cudaError_t pair_fwd(const PairArgs& a) {
  if (a.rows0 <= 0 || a.rows1 < 0 || a.d <= 0 || a.rows0 > INT32_MAX ||
      a.rows1 > INT32_MAX || a.d > INT32_MAX)
    return cudaErrorInvalidValue;
  const void* x0 = reinterpret_cast<const void*>(a.x0);
  const void* w0 = reinterpret_cast<const void*>(a.w0);
  void* out0 = reinterpret_cast<void*>(a.out0);
  const void* x1 = reinterpret_cast<const void*>(a.x1);
  const void* w1 = reinterpret_cast<const void*>(a.w1);
  void* out1 = reinterpret_cast<void*>(a.out1);
  const int rows0 = static_cast<int>(a.rows0);
  const int rows1 = static_cast<int>(a.rows1);
  const int d = static_cast<int>(a.d);
  const float eps = static_cast<float>(a.eps);
  const int block_rows = static_cast<int>(a.block_rows);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(a.stream);
  if (a.dtype == 0)
    return dispatch_rows<float>(x0, w0, out0, rows0, x1, w1, out1, rows1, d,
                                eps, block_rows, s);
  if (a.dtype == 1)
    return dispatch_rows<__nv_bfloat16>(x0, w0, out0, rows0, x1, w1, out1,
                                        rows1, d, eps, block_rows, s);
  if (a.dtype == 2)
    return dispatch_rows<__half>(x0, w0, out0, rows0, x1, w1, out1, rows1, d,
                                 eps, block_rows, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Normalise up to two segments in one launch.  `packed` points to a
// PairArgs: each x and out holds rows of d elements back to back, each w
// is (d,) float32, dtype 0 = float32, 1 = bfloat16 and 2 = float16; rows1
// may be 0 (one segment).  Returns the cudaError_t of the launch (0 =
// success).
int rmsnorm_fwd_packed(const void* packed) {
  PairArgs a;
  memcpy(&a, packed, sizeof a);
  return static_cast<int>(pair_fwd(a));
}

// 1 if a launch with these pointers and width takes the register body, 0
// if the general one.
int rmsnorm_uses_registers(const void* x, const void* w, const void* out,
                           int d, int dtype) {
  const bool aligned = aligned16(x) && aligned16(w) && aligned16(out);
  if (dtype == 0) return aligned && d % 4 == 0 && regs_group<float>(d) != 0;
  if (dtype == 1)
    return aligned && d % 8 == 0 && regs_group<__nv_bfloat16>(d) != 0;
  if (dtype == 2) return aligned && d % 8 == 0 && regs_group<__half>(d) != 0;
  return 0;
}

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
