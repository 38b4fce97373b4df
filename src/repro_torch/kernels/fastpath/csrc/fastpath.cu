// Fast-path hot-key matcher for Hopper (sm_90a), plain C interface for
// ctypes: the matcher of the paper's §5 fast path (Morpheus hot keys).
//
// Replaces: src/repro/kernels/fastpath/kernel.py::fastpath_lookup_pallas
// (body _fastpath_kernel), the reference's Pallas TPU kernel.  Same
// function: for each query row x[b] (K integers), hit[b] = any key row
// equals it, and out[b] = the sum of the value rows of the matching keys
// (0 where none match; duplicate keys sum, as the oracle's onehot @ values
// does).  The TPU kernel gathers with an MXU product of the one-hot match
// matrix; here each thread adds the matching rows itself, so integer
// values are summed exactly in their own type (int32 and int64 wrap as
// the oracle's integer product does), and float values in an fp32
// accumulator rounded once to the value type, as the oracle's product.
//
// What bounds it: bytes, or the B * N * K compares on the integer units
// when the table is large.  Reading x (B * K) and writing out (B * V)
// and hit (B) is the floor; the table (N * (K + V)) is read once from
// device memory and then from shared memory by every block.
//
// What the design does about it.  One thread per query row, BLOCK_B rows
// a block (a template argument: 32, 128 or 256); a row's first 8 key
// integers sit in registers.  The block stages the key table in slabs of
// kSlab rows in shared memory, with the values of kCols columns at a time
// beside it (a 4096 x 16 fp32 values table is 256 KB and does not fit at
// once); every thread of the block reads the same key word at once (a
// broadcast), compares, and on a match adds the value row to its register
// accumulators.  A ragged tail of B is masked, never padded; an empty table
// (N = 0) gives all misses; more than kCols value columns take one more
// pass over the table per kCols columns.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlab = 128;   // key rows staged per slab
constexpr int kCols = 16;    // value columns accumulated per pass
constexpr int kRegKeys = 8;  // key integers of a query held in registers
constexpr int kMaxKeyWidth = 32;

// Accumulator of a value type: fp32 for float types; for integers the
// unsigned type of the same width, so a sum wraps (as the oracle's integer
// product does) without signed overflow.
template <typename V> struct Acc { using T = V; };
template <> struct Acc<__nv_bfloat16> { using T = float; };
template <> struct Acc<int32_t> { using T = uint32_t; };
template <> struct Acc<int64_t> { using T = uint64_t; };

template <typename V> __device__ __forceinline__ typename Acc<V>::T widen(
    V v) {
  return static_cast<typename Acc<V>::T>(v);
}
template <> __device__ __forceinline__ float widen<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename V> __device__ __forceinline__ V narrow(
    typename Acc<V>::T a) {
  return static_cast<V>(a);
}
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(
    float a) {
  return __float2bfloat16(a);
}

template <typename KT, typename VT, int BLOCK_B>
__global__ void __launch_bounds__(BLOCK_B)
    fastpath_kernel(const KT* __restrict__ x, const KT* __restrict__ keys,
                    const VT* __restrict__ vals, VT* __restrict__ out,
                    bool* __restrict__ hit, int b, int n, int kw, int v) {
  using A = typename Acc<VT>::T;
  // Dynamic shared memory: kSlab * kw keys, then kSlab * kCols values
  // (the key slab's size is a multiple of 8 bytes, so the values are
  // aligned for every value type).
  extern __shared__ __align__(16) unsigned char smem[];
  KT* skeys = reinterpret_cast<KT*>(smem);
  VT* svals = reinterpret_cast<VT*>(smem + sizeof(KT) * kSlab * kw);

  const int64_t row = static_cast<int64_t>(blockIdx.x) * BLOCK_B +
                      threadIdx.x;
  const bool valid = row < b;
  KT q[kRegKeys];
#pragma unroll
  for (int c = 0; c < kRegKeys; ++c)
    q[c] = (valid && c < kw) ? x[row * kw + c] : KT(0);

  bool any = false;
  // At least one pass, so that hit is computed when v == 0.
  for (int c0 = 0; c0 == 0 || c0 < v; c0 += kCols) {
    const int cols = (v - c0 < kCols) ? v - c0 : kCols;
    A acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = A(0);
    for (int n0 = 0; n0 < n; n0 += kSlab) {
      const int rows = (n - n0 < kSlab) ? n - n0 : kSlab;
      __syncthreads();  // the previous slab is no longer read
      for (int e = threadIdx.x; e < rows * kw; e += BLOCK_B)
        skeys[e] = keys[static_cast<int64_t>(n0) * kw + e];
      for (int e = threadIdx.x; e < rows * cols; e += BLOCK_B) {
        const int r = e / cols, c = e % cols;
        svals[r * kCols + c] = vals[static_cast<int64_t>(n0 + r) * v + c0 + c];
      }
      __syncthreads();
      if (!valid) continue;
      for (int r = 0; r < rows; ++r) {
        const KT* kr = skeys + r * kw;
        bool match = true;
#pragma unroll
        for (int c = 0; c < kRegKeys; ++c)
          if (c < kw) match = match && (q[c] == kr[c]);
        for (int c = kRegKeys; c < kw; ++c)
          match = match && (x[row * kw + c] == kr[c]);
        if (match) {
          any = true;
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            if (c < cols) acc[c] += widen<VT>(svals[r * kCols + c]);
        }
      }
    }
    if (valid) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (c < cols) out[row * v + c0 + c] = narrow<VT>(acc[c]);
    }
  }
  if (valid) hit[row] = any;
}

template <typename KT, typename VT, int BLOCK_B>
cudaError_t launch(const void* x, const void* keys, const void* vals,
                   void* out, void* hit, int b, int n, int kw, int v,
                   cudaStream_t stream) {
  const size_t key_bytes = sizeof(KT) * kSlab * kw;
  const size_t smem = key_bytes + sizeof(VT) * kSlab * kCols;
  const int blocks = (b + BLOCK_B - 1) / BLOCK_B;
  fastpath_kernel<KT, VT, BLOCK_B><<<blocks, BLOCK_B, smem, stream>>>(
      static_cast<const KT*>(x), static_cast<const KT*>(keys),
      static_cast<const VT*>(vals), static_cast<VT*>(out),
      static_cast<bool*>(hit), b, n, kw, v);
  return cudaGetLastError();
}

template <typename KT, typename VT>
cudaError_t dispatch_block(const void* x, const void* keys, const void* vals,
                           void* out, void* hit, int b, int n, int kw, int v,
                           int block_b, cudaStream_t s) {
  switch (block_b) {
    case 32:
      return launch<KT, VT, 32>(x, keys, vals, out, hit, b, n, kw, v, s);
    case 128:
      return launch<KT, VT, 128>(x, keys, vals, out, hit, b, n, kw, v, s);
    case 256:
      return launch<KT, VT, 256>(x, keys, vals, out, hit, b, n, kw, v, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename KT>
cudaError_t dispatch_values(const void* x, const void* keys,
                            const void* vals, void* out, void* hit, int b,
                            int n, int kw, int v, int value_dtype,
                            int block_b, cudaStream_t s) {
  switch (value_dtype) {
    case 0:
      return dispatch_block<KT, float>(x, keys, vals, out, hit, b, n, kw, v,
                                       block_b, s);
    case 1:
      return dispatch_block<KT, __nv_bfloat16>(x, keys, vals, out, hit, b, n,
                                               kw, v, block_b, s);
    case 2:
      return dispatch_block<KT, int32_t>(x, keys, vals, out, hit, b, n, kw,
                                         v, block_b, s);
    case 3:
      return dispatch_block<KT, int64_t>(x, keys, vals, out, hit, b, n, kw,
                                         v, block_b, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// key_dtype (queries and keys, one type): 0 = int32, 1 = int64.
// value_dtype: 0 = float32, 1 = bfloat16, 2 = int32, 3 = int64.
// x is (b, kw), keys (n, kw), vals (n, v), out (b, v) of the value type,
// hit (b,) bool; all row-major and contiguous.  1 <= kw <= 32; n and v
// may be 0.  Returns the cudaError_t of the launch (0 = success).
int fastpath_fwd(const void* x, const void* keys, const void* vals,
                 void* out, void* hit, int b, int n, int kw, int v,
                 int key_dtype, int value_dtype, int block_b, void* stream) {
  if (b <= 0 || n < 0 || v < 0 || kw < 1 || kw > kMaxKeyWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (key_dtype == 0)
    err = dispatch_values<int32_t>(x, keys, vals, out, hit, b, n, kw, v,
                                   value_dtype, block_b, s);
  else if (key_dtype == 1)
    err = dispatch_values<int64_t>(x, keys, vals, out, hit, b, n, kw, v,
                                   value_dtype, block_b, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* fastpath_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
