// Fast-path hot-key matcher for Hopper (sm_90a), plain C interface for
// ctypes: the matcher of the paper's §5 fast path (Morpheus hot keys).
//
// Replaces: src/repro/kernels/fastpath/kernel.py::fastpath_lookup_pallas
// (body _fastpath_kernel), the reference's Pallas TPU kernel.  Same
// function: for each query row x[b] (K integers), hit[b] = any key row
// equals it, and out[b] = the sum of the value rows of the matching keys
// (0 where none match; duplicate keys sum, as the oracle's onehot @ values
// does).  The TPU kernel gathers with an MXU product of the one-hot match
// matrix; here the matching rows are added by the thread of the query, so
// integer values are summed exactly in their own type (int32 and int64 wrap
// as the oracle's integer sum does), and float values in an fp32
// accumulator rounded once to the value type.  Every launch also writes
// the batch's miss count.
//
// What bounds it: bytes.  The function reads x (B * K) and the table
// (N * (K + V)) once and writes out (B * V), hit (B) and the count; at the
// router's size (8192 queries, 16 keys, one int32 next hop) that is ~100
// KB, 0.03 us at the card's memory rate, so a launch is bound by its
// latency and by the host's part of it, not by the card.
//
// What the design does about it.  One entry, two bodies (select_body):
//
// * Dense (any table; the router's hot tables of a few keys): one thread
//   per query row, its key in registers; the block stages the whole table
//   in shared memory once (when it fits in kStageBytes, else it reads the
//   table through the caches, every thread of a warp the same word) and
//   compares each query with every key.  Blocks are sized so that a batch
//   fills the SMs: at most block_b rows, fewer when the batch would give
//   fewer blocks than SMs (8192 rows take 128 blocks of 64).
// * Hashed (a table prepared once, on the host, when the handler is
//   specialized: the reference bakes the table into the specialized
//   handler as a constant): an open-addressing table of power-of-two slots
//   (at least twice the keys), each slot a distinct key's index or -1, the
//   distinct keys, and their values pre-summed over duplicates (integers in
//   their own type, wrapping; floats in fp32, rounded once here).  A query
//   hashes its K integers (Query::hash, written again as kernel.py's
//   hash_keys), probes linearly until it finds its key or an empty slot, and
//   copies that key's row: a few loads a query instead of N compares.
//   The wrapper picks it for a prepared table of at least kHashMinKeys
//   keys, the size above which it measured faster on the card.
//
// The miss count: the warps of a block count their misses with a ballot,
// and the block adds them with one 64-bit atomic to a per-stream scratch
// word (low half: misses, high half: blocks done).  The block that finds
// itself last sets the word back to 0 for the next launch on the stream
// (no memset launch) and writes the total to the 4-byte mapped host word
// the caller supplies, if any; the entry then waits on the stream, so a
// specialized call learns whether its batch all hit with no copy and no
// reduction launch.
//
// A launch takes one packed argument struct (Args) from the wrapper: one
// bytes object through ctypes instead of a dozen converted arguments.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kCols = 16;          // value columns accumulated per pass
constexpr int kMaxKeyWidth = 32;   // integers per key
constexpr int kMaxThreads = 256;   // rows per block at most (block_b)
// dense: the table is staged up to this (under the 48 KB a block gets
// without opting in, beside the block's static shared word)
constexpr int kStageBytes = 47 * 1024;
// Prepared tables of at least this many keys take the hashed body.  On an
// H100 (chip_smoke.py phase 4d, device times in a CUDA graph), at the
// router's batch (8192 rows, one int32 value), the dense body is the
// faster at one key and the hashed one from two keys on.
constexpr int64_t kHashMinKeys = 2;

// The key hash, shared with kernel.py's table construction (hash_keys): each
// key integer, sign-extended to 64 bits, is xored into the state and mixed
// with splitmix64's finalizer; the slot is the low bits.
constexpr uint64_t kHashSeed = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kMix1 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kMix2 = 0x94D049BB133111EBull;

__host__ __device__ __forceinline__ uint64_t mix64(uint64_t z) {
  z ^= z >> 30;
  z *= kMix1;
  z ^= z >> 27;
  z *= kMix2;
  z ^= z >> 31;
  return z;
}

template <typename KT>
__host__ __device__ __forceinline__ uint64_t hash_step(uint64_t h, KT c) {
  return mix64(h ^ static_cast<uint64_t>(static_cast<int64_t>(c)));
}

// Accumulator of a value type: fp32 for float types; for integers the
// unsigned type of the same width, so a sum wraps (as the oracle's integer
// sum does) without signed overflow.  The hashed body's table stores its
// pre-summed values in Stored<V>: fp32 for float types, V for integers.
template <typename V> struct Acc { using T = V; };
template <> struct Acc<__nv_bfloat16> { using T = float; };
template <> struct Acc<int32_t> { using T = uint32_t; };
template <> struct Acc<int64_t> { using T = uint64_t; };
template <typename V> struct Stored { using T = V; };
template <> struct Stored<__nv_bfloat16> { using T = float; };

template <typename V> __device__ __forceinline__ typename Acc<V>::T widen(
    V v) {
  return static_cast<typename Acc<V>::T>(v);
}
template <> __device__ __forceinline__ float widen<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename V, typename A> __device__ __forceinline__ V narrow(A a) {
  return static_cast<V>(a);
}
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(
    float a) {
  return __float2bfloat16(a);
}

// What one launch needs.  keys/vals: the raw table (dense body); hkeys,
// hvals, slots: the prepared table (hashed body).
struct Params {
  const void* x;
  const void* keys;
  const void* vals;
  const void* hkeys;
  const void* hvals;
  const int32_t* slots;
  void* out;
  bool* hit;
  unsigned long long* ticket;
  int32_t* host_miss;
  int b, n, kw, v;
  uint32_t mask;
  bool staged, vec16;
};

// A query's key, held in registers (ONE: the key is one integer).
template <typename KT, bool ONE> struct Query {
  KT q[ONE ? 1 : kMaxKeyWidth];

  __device__ __forceinline__ void load(const KT* x, int64_t row, int kw,
                                       bool valid) {
#pragma unroll
    for (int c = 0; c < (ONE ? 1 : kMaxKeyWidth); ++c)
      q[c] = (valid && c < kw) ? x[row * kw + c] : KT(0);
  }
  __device__ __forceinline__ bool equals(const KT* k, int kw) const {
    if constexpr (ONE) {
      return q[0] == k[0];
    } else {
#pragma unroll
      for (int c = 0; c < kMaxKeyWidth; ++c) {
        if (c >= kw) break;
        if (q[c] != k[c]) return false;
      }
      return true;
    }
  }
  __device__ __forceinline__ uint64_t hash(int kw) const {
    uint64_t h = kHashSeed;
#pragma unroll
    for (int c = 0; c < (ONE ? 1 : kMaxKeyWidth); ++c) {
      if (c >= kw) break;
      h = hash_step(h, q[c]);
    }
    return h;
  }
};

// Adds the block's misses to the stream's scratch word with one atomic;
// the last block to arrive clears the word and writes the batch's total to
// the host word, if the call has one.  Every thread of the block calls it.
__device__ __forceinline__ void count_misses(const Params& p, bool missed) {
  __shared__ int block_misses;
  if (threadIdx.x == 0) block_misses = 0;
  __syncthreads();
  const unsigned ballot = __ballot_sync(0xffffffffu, missed);
  if ((threadIdx.x & 31) == 0 && ballot)
    atomicAdd(&block_misses, __popc(ballot));
  __syncthreads();
  if (threadIdx.x != 0) return;
  const unsigned long long mine =
      (1ull << 32) | static_cast<unsigned>(block_misses);
  const unsigned long long old = atomicAdd(p.ticket, mine);
  if ((old >> 32) != gridDim.x - 1) return;
  const int32_t total =
      static_cast<int32_t>((old & 0xffffffffull) + block_misses);
  *p.ticket = 0ull;
  if (p.host_miss != nullptr) {
    *reinterpret_cast<volatile int32_t*>(p.host_miss) = total;
    __threadfence_system();
  }
}

template <typename KT, typename VT, bool ONE>
__global__ void __launch_bounds__(kMaxThreads) dense_kernel(Params p) {
  using A = typename Acc<VT>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const KT* keys = static_cast<const KT*>(p.keys);
  const VT* vals = static_cast<const VT*>(p.vals);
  if (p.staged) {
    // The whole table, once: keys, then values from a 16-byte boundary.
    const int nk = p.n * p.kw, nv = p.n * p.v;
    KT* sk = reinterpret_cast<KT*>(smem);
    VT* sv = reinterpret_cast<VT*>(
        smem + ((sizeof(KT) * nk + 15) & ~static_cast<size_t>(15)));
    for (int e = threadIdx.x; e < nk; e += blockDim.x) sk[e] = keys[e];
    for (int e = threadIdx.x; e < nv; e += blockDim.x) sv[e] = vals[e];
    __syncthreads();
    keys = sk;
    vals = sv;
  }
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const bool valid = row < p.b;
  Query<KT, ONE> query;
  query.load(static_cast<const KT*>(p.x), row, p.kw, valid);
  VT* out = static_cast<VT*>(p.out);

  bool any = false;
  // At least one pass, so that hit is computed when v == 0.
  for (int c0 = 0; c0 == 0 || c0 < p.v; c0 += kCols) {
    const int cols = (p.v - c0 < kCols) ? p.v - c0 : kCols;
    A acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = A(0);
    if (valid) {
      for (int r = 0; r < p.n; ++r) {
        if (!query.equals(keys + static_cast<int64_t>(r) * p.kw, p.kw))
          continue;
        any = true;
        const VT* vr = vals + static_cast<int64_t>(r) * p.v + c0;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (c < cols) acc[c] += widen<VT>(vr[c]);
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (c < cols) out[row * p.v + c0 + c] = narrow<VT>(acc[c]);
    }
  }
  if (valid) p.hit[row] = any;
  count_misses(p, valid && !any);
}

template <typename KT, typename VT, bool ONE>
__global__ void __launch_bounds__(kMaxThreads) hashed_kernel(Params p) {
  using ST = typename Stored<VT>::T;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const bool valid = row < p.b;
  Query<KT, ONE> query;
  query.load(static_cast<const KT*>(p.x), row, p.kw, valid);
  int idx = -1;
  if (valid) {
    const KT* keys = static_cast<const KT*>(p.hkeys);
    uint32_t s = static_cast<uint32_t>(query.hash(p.kw)) & p.mask;
    // The table has an empty slot (at least twice the keys), so the probe
    // ends.
    for (;;) {
      const int k = __ldg(p.slots + s);
      if (k < 0) break;
      if (query.equals(keys + static_cast<int64_t>(k) * p.kw, p.kw)) {
        idx = k;
        break;
      }
      s = (s + 1) & p.mask;
    }
    VT* out = static_cast<VT*>(p.out) + row * p.v;
    const ST* src = static_cast<const ST*>(p.hvals) +
                    static_cast<int64_t>(idx) * p.v;
    bool wide = false;
    if constexpr (std::is_same<ST, VT>::value) wide = p.vec16;
    if (wide) {
      // rows of a multiple of 16 bytes, 16-byte aligned: copy as uint4
      const int n16 = p.v * static_cast<int>(sizeof(VT)) / 16;
      uint4* o4 = reinterpret_cast<uint4*>(out);
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      for (int c = 0; c < n16; ++c)
        o4[c] = idx >= 0 ? __ldg(s4 + c) : make_uint4(0, 0, 0, 0);
    } else {
      for (int c = 0; c < p.v; ++c)
        out[c] = idx >= 0 ? narrow<VT>(src[c]) : narrow<VT>(ST(0));
    }
    p.hit[row] = idx >= 0;
  }
  count_misses(p, valid && idx < 0);
}

// The body a call runs: 1 (hashed) for a prepared table of at least
// kHashMinKeys keys, else 0 (dense).
int select_body(bool prepared, int64_t n) {
  return prepared && n >= kHashMinKeys ? 1 : 0;
}

template <typename KT, typename VT, bool ONE>
cudaError_t launch(int body, const Params& p, int threads, int blocks,
                   size_t smem, cudaStream_t s) {
  if (body == 1)
    hashed_kernel<KT, VT, ONE><<<blocks, threads, 0, s>>>(p);
  else
    dense_kernel<KT, VT, ONE><<<blocks, threads, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename KT, typename VT>
cudaError_t dispatch_width(int body, const Params& p, int threads,
                           int blocks, size_t smem, cudaStream_t s) {
  if (p.kw == 1)
    return launch<KT, VT, true>(body, p, threads, blocks, smem, s);
  return launch<KT, VT, false>(body, p, threads, blocks, smem, s);
}

template <typename KT>
cudaError_t dispatch_values(int value_dtype, int body, const Params& p,
                            int threads, int blocks, size_t smem,
                            cudaStream_t s) {
  switch (value_dtype) {
    case 0:
      return dispatch_width<KT, float>(body, p, threads, blocks, smem, s);
    case 1:
      return dispatch_width<KT, __nv_bfloat16>(body, p, threads, blocks,
                                               smem, s);
    case 2:
      return dispatch_width<KT, int32_t>(body, p, threads, blocks, smem, s);
    case 3:
      return dispatch_width<KT, int64_t>(body, p, threads, blocks, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}

size_t key_size(int64_t key_dtype) { return key_dtype == 1 ? 8 : 4; }
size_t value_size(int64_t value_dtype) {
  return value_dtype == 1 ? 2 : (value_dtype == 3 ? 8 : 4);
}
size_t stored_size(int64_t value_dtype) {
  return value_dtype == 3 ? 8 : 4;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The wrapper's packed arguments (kernel.py's _pack_call + _pack_table).
struct Args {
  // per call
  uint64_t x, out, hit, ticket, host_miss, stream;
  int64_t b, block_b, sms, body, wait;
  // per table
  uint64_t keys, vals, hkeys, hvals, slots;
  int64_t n, kw, v, mask, key_dtype, value_dtype;
};
static_assert(sizeof(Args) == 22 * 8, "Args must be unpadded");

cudaError_t fwd(const Args& a) {
  const bool prepared = a.slots != 0;
  if (a.b <= 0 || a.n < 0 || a.v < 0 || a.kw < 1 || a.kw > kMaxKeyWidth ||
      a.b > INT32_MAX || a.n > INT32_MAX || a.b * a.kw > INT32_MAX ||
      a.b * a.v > INT32_MAX || a.n * a.kw > INT32_MAX ||
      a.n * a.v > INT32_MAX || a.block_b < 32 || a.block_b > kMaxThreads ||
      a.block_b % 32 != 0 || a.sms < 1 || a.body < -1 || a.body > 1 ||
      a.ticket == 0 || a.key_dtype < 0 || a.key_dtype > 1 ||
      (a.wait && a.host_miss == 0) ||
      (a.body == 1 && !prepared) || (prepared && a.mask < 1) ||
      a.mask > INT32_MAX)
    return cudaErrorInvalidValue;
  const int body = a.body >= 0 ? static_cast<int>(a.body)
                               : select_body(prepared, a.n);
  Params p;
  p.x = reinterpret_cast<const void*>(a.x);
  p.keys = reinterpret_cast<const void*>(a.keys);
  p.vals = reinterpret_cast<const void*>(a.vals);
  p.hkeys = reinterpret_cast<const void*>(a.hkeys);
  p.hvals = reinterpret_cast<const void*>(a.hvals);
  p.slots = reinterpret_cast<const int32_t*>(a.slots);
  p.out = reinterpret_cast<void*>(a.out);
  p.hit = reinterpret_cast<bool*>(a.hit);
  p.ticket = reinterpret_cast<unsigned long long*>(a.ticket);
  p.host_miss = reinterpret_cast<int32_t*>(a.host_miss);
  p.b = static_cast<int>(a.b);
  p.n = static_cast<int>(a.n);
  p.kw = static_cast<int>(a.kw);
  p.v = static_cast<int>(a.v);
  p.mask = static_cast<uint32_t>(a.mask);
  const size_t stage = ((key_size(a.key_dtype) * a.n * a.kw + 15) & ~15ull) +
                       value_size(a.value_dtype) * a.n * a.v;
  p.staged = body == 0 && stage <= static_cast<size_t>(kStageBytes);
  p.vec16 = (stored_size(a.value_dtype) * a.v) % 16 == 0 &&
            aligned16(p.out) && aligned16(p.hvals);
  // At most block_b rows a block, fewer (a multiple of 32) when the batch
  // would otherwise give fewer blocks than the card has SMs.
  int64_t threads = (a.b + a.sms - 1) / a.sms;
  threads = (threads + 31) / 32 * 32;
  if (threads > a.block_b) threads = a.block_b;
  const int blocks = static_cast<int>((a.b + threads - 1) / threads);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(a.stream);
  const size_t smem = p.staged ? stage : 0;
  cudaError_t err =
      a.key_dtype == 0
          ? dispatch_values<int32_t>(static_cast<int>(a.value_dtype), body, p,
                                     static_cast<int>(threads), blocks, smem,
                                     s)
          : dispatch_values<int64_t>(static_cast<int>(a.value_dtype), body, p,
                                     static_cast<int>(threads), blocks, smem,
                                     s);
  if (err == cudaSuccess && a.wait) err = cudaStreamSynchronize(s);
  return err;
}

}  // namespace

extern "C" {

// One launch (Args, packed little-endian by the wrapper).  key_dtype
// (queries and keys, one type): 0 = int32, 1 = int64.  value_dtype: 0 =
// float32, 1 = bfloat16, 2 = int32, 3 = int64.  x is (b, kw); keys (n, kw)
// and vals (n, v) the raw table; a prepared table adds hkeys (d, kw),
// hvals (d, v) of fp32 for float values (else the value type) and slots
// (mask + 1,) int32, and slots == 0 means none.  out (b, v) of the value
// type and hit (b,) bool are the call's; ticket is the stream's scratch
// word (0 between launches), host_miss a mapped host word's device address
// (it receives the batch's miss count) or 0; body -1 lets select_body
// choose; wait (with a host word) makes the call wait on the stream after
// the launch.  All row-major and
// contiguous, 1 <= kw <= 32, n and v may be 0.  Returns the cudaError_t of
// the launch (0 = success).
int fastpath_fwd_packed(const void* packed) {
  Args a;
  memcpy(&a, packed, sizeof a);
  return static_cast<int>(fwd(a));
}

// The body a launch on a prepared table of n keys takes when the caller
// does not name one: 0 = dense, 1 = hashed.
int fastpath_body(long long n) { return select_body(true, n); }

// The least table size the hashed body takes (kHashMinKeys).
long long fastpath_hash_min_keys() { return kHashMinKeys; }

// The hash of n keys of kw integers each (as int64), as the kernel
// computes it: the card check that kernel.py's hash_keys agrees.
void fastpath_hash(const int64_t* keys, long long n, int kw, uint64_t* out) {
  for (long long i = 0; i < n; ++i) {
    uint64_t h = kHashSeed;
    for (int c = 0; c < kw; ++c) h = hash_step(h, keys[i * kw + c]);
    out[i] = h;
  }
}

// A mapped, pinned host word for a launch's miss count: its host address
// in *host and its device address in *device.  Returns the cudaError_t.
int fastpath_host_word(void** host, void** device) {
  cudaError_t err = cudaHostAlloc(host, sizeof(int32_t), cudaHostAllocMapped);
  if (err != cudaSuccess) return static_cast<int>(err);
  *static_cast<int32_t*>(*host) = 0;
  err = cudaHostGetDevicePointer(device, *host, 0);
  if (err != cudaSuccess) cudaFreeHost(*host);
  return static_cast<int>(err);
}

int fastpath_free_host_word(void* host) {
  return static_cast<int>(cudaFreeHost(host));
}

const char* fastpath_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
