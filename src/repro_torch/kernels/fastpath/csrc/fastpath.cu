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
//   fills the SMs: at most block_b rows rounded up to whole warps and at
//   most kMaxThreads (256), fewer (a multiple of 32) when the batch would
//   give fewer blocks than SMs (8192 rows take 128 blocks of 64).  So any
//   positive block_b runs: 1 and 7 run warps of 32 rows, 100 blocks of
//   128, 512 and 1024 blocks of 256; the reference's block_b only tiles
//   the batch, and no answer depends on it.
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
// Keys and queries of any dtype (the design that compares canonical
// integers).  `==` compares a query and a key in their promoted dtype, as
// the oracle's does.  Two integers compare as values; an integer query
// and a float key (fp32, bf16, fp16) compare after the query is rounded to
// the key's type (through fp32, as PyTorch and JAX convert it).  Every key
// is mapped to a canonical integer, once: an integer key to its value (as
// int32, or int64 for int64 keys), a float key to the bit pattern of its
// fp32 value with -0.0 as +0.0.  A query is canonicalised in the kernel
// as it is loaded (canon_query, canon_query_slow): its value, or the same
// bit pattern of its rounded value; a query value that the canonical type cannot hold
// (an int64 query beyond an int32 table's range) matches nothing.  Then
// equal canonical integers are exactly the pairs `==` finds equal: a NaN
// key matches nothing (no rounded integer is NaN), -0.0 matches 0, a key
// that is not integral matches nothing, 16777217 matches an fp32 key of
// 16777216.0 and 70000 an fp16 key of inf.  The hashed body hashes the
// canonical integers, so a prepared table of float keys takes it too; the
// dense body canonicalises the keys as it stages them (or as it reads
// them, when the table is not staged).  A query or key of the canonical
// type itself is read as it is (the router's int32 queries and keys).
//
// Keys wider than kRegKey (32) integers: the query's first 32 integers
// stay in registers; a key whose first 32 match is compared on against
// the query's other integers, read again through the caches (Query, W =
// kWide), and the hash reads them the same way.  So any width runs up to
// the 32-bit index limits; keys of up to 32 keep their instantiations
// (kOne, kNarrow).
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
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kCols = 16;          // value columns accumulated per pass
constexpr int kRegKey = 32;        // key integers a query keeps in registers
constexpr int kMaxThreads = 256;   // rows per block at most
// dense: the table is staged up to this (under the 48 KB a block gets
// without opting in, beside the block's static shared word)
constexpr int kStageBytes = 47 * 1024;
// Prepared tables of at least this many keys take the hashed body.  On an
// H100 (chip_smoke.py phase 4d, device times in a CUDA graph), at the
// router's batch (8192 rows, one int32 value), the dense body is the
// faster at one key and the hashed one from two keys on.
constexpr int64_t kHashMinKeys = 2;

// Key dtype codes (kernel.py's _KEY_CODES); queries take the integer ones
// (0 to 4).  Codes from kKeyF32 on are float keys.
enum KeyCode {
  kI32 = 0, kI64 = 1, kI8 = 2, kI16 = 3, kU8 = 4,
  kKeyF32 = 5, kKeyBF16 = 6, kKeyF16 = 7
};
// Key width classes: one integer, up to kRegKey, wider.
enum Width { kOne = 0, kNarrow = 1, kWide = 2 };

// The key hash, shared with kernel.py's table construction (hash_keys): each
// canonical key integer, sign-extended to 64 bits, is xored into the state
// and mixed with splitmix64's finalizer; the slot is the low bits.
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
template <> struct Acc<__half> { using T = float; };
template <> struct Acc<int32_t> { using T = uint32_t; };
template <> struct Acc<int64_t> { using T = uint64_t; };
template <typename V> struct Stored { using T = V; };
template <> struct Stored<__nv_bfloat16> { using T = float; };
template <> struct Stored<__half> { using T = float; };

template <typename V> __device__ __forceinline__ typename Acc<V>::T widen(
    V v) {
  return static_cast<typename Acc<V>::T>(v);
}
template <> __device__ __forceinline__ float widen<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float widen<__half>(__half v) {
  return __half2float(v);
}
template <typename V, typename A> __device__ __forceinline__ V narrow(A a) {
  return static_cast<V>(a);
}
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(
    float a) {
  return __float2bfloat16(a);
}
template <> __device__ __forceinline__ __half narrow<__half>(float a) {
  return __float2half_rn(a);
}

// The canonical integer of a float value: its fp32 bit pattern, with -0.0
// as +0.0's.
__device__ __forceinline__ int32_t float_bits(float f) {
  const int32_t b = __float_as_int(f);
  return b == INT32_MIN ? 0 : b;
}

// The value of element i of an integer array of dtype code `code`.
__device__ __forceinline__ int64_t load_int(const void* p, int64_t i,
                                            int code) {
  switch (code) {
    case kI32: return static_cast<const int32_t*>(p)[i];
    case kI64: return static_cast<const int64_t*>(p)[i];
    case kI8: return static_cast<const int8_t*>(p)[i];
    case kI16: return static_cast<const int16_t*>(p)[i];
    default: return static_cast<const uint8_t*>(p)[i];
  }
}

// The conversions of keys and queries of other dtypes than the canonical
// one, out of line: they are called from every unrolled integer of every
// instantiation, where inlined they doubled the build.
//
// The canonical form of element i of a key array of dtype code `code`.
__device__ __noinline__ int64_t canon_key(const void* p, int64_t i,
                                          int code) {
  switch (code) {
    case kKeyF32: return float_bits(static_cast<const float*>(p)[i]);
    case kKeyBF16:
      return float_bits(
          __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]));
    case kKeyF16:
      return float_bits(__half2float(static_cast<const __half*>(p)[i]));
    default: return load_int(p, i, code);
  }
}

// The canonical form of element i of an integer query array of dtype code
// `qcode` against keys of dtype code `kcode`: the value, or against float
// keys the canonical form of the value rounded to their type (through
// fp32, as PyTorch and JAX convert it).
__device__ __noinline__ int64_t canon_query_slow(const void* x, int64_t i,
                                                 int qcode, int kcode) {
  const int64_t v = load_int(x, i, qcode);
  if (kcode < kKeyF32) return v;
  const float f = __ll2float_rn(v);
  if (kcode == kKeyF32) return float_bits(f);
  if (kcode == kKeyBF16)
    return float_bits(__bfloat162float(__float2bfloat16_rn(f)));
  return float_bits(__half2float(__float2half_rn(f)));
}

// What one launch needs.  keys/vals: the raw table (dense body); hkeys,
// hvals, slots: the prepared table (hashed body), its keys canonical.
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
  int qcode, kcode;      // dtype codes of the queries and the raw keys
  uint32_t mask;
  bool staged, vec16;
  bool qnative;          // queries of the canonical type, read as they are
  bool knative;          // raw keys of the canonical type, read as they are
};

// The canonical form (CT) of query element i: `bad` is set where CT cannot
// hold its value.
template <typename CT>
__device__ __forceinline__ CT canon_query(const Params& p, int64_t i,
                                          bool& bad) {
  if (p.qnative) return static_cast<const CT*>(p.x)[i];
  const int64_t v = canon_query_slow(p.x, i, p.qcode, p.kcode);
  if (sizeof(CT) == 4 && (v < INT32_MIN || v > INT32_MAX)) bad = true;
  return static_cast<CT>(v);
}

// Canonical keys as they lie (the staged table, the prepared table's
// distinct keys, or a raw table of the canonical type).
template <typename CT> struct NativeKeys {
  const CT* k;
  __device__ __forceinline__ CT operator()(int64_t i) const { return k[i]; }
};
// A raw table of another dtype, canonicalised as it is read.
template <typename CT> struct RawKeys {
  const void* k;
  int code;
  __device__ __forceinline__ CT operator()(int64_t i) const {
    return static_cast<CT>(canon_key(k, i, code));
  }
};

// A query's key: its first integers in registers (W: kOne, kNarrow or
// kWide); a wide key's others read again from x when needed.  `bad`: a
// register integer the canonical type cannot hold, so the query matches
// nothing.
template <typename CT, int W> struct Query {
  static constexpr int R = W == kOne ? 1 : kRegKey;
  CT q[R];
  bool bad;
  int64_t base;          // the row's first element in x

  __device__ __forceinline__ void load(const Params& p, int64_t row,
                                       bool valid) {
    bad = false;
    base = row * p.kw;
#pragma unroll
    for (int c = 0; c < R; ++c)
      q[c] = (valid && c < p.kw) ? canon_query<CT>(p, base + c, bad) : CT(0);
  }
  template <typename Keys>
  __device__ __forceinline__ bool equals(const Params& p, const Keys& key,
                                         int64_t kbase) const {
    if constexpr (W == kOne) {
      return q[0] == key(kbase);
    } else {
#pragma unroll
      for (int c = 0; c < R; ++c) {
        if (c >= p.kw) break;
        if (q[c] != key(kbase + c)) return false;
      }
      if constexpr (W == kWide) {
        for (int c = R; c < p.kw; ++c) {
          bool out_of_range = false;
          if (canon_query<CT>(p, base + c, out_of_range) != key(kbase + c) ||
              out_of_range)
            return false;
        }
      }
      return true;
    }
  }
  __device__ __forceinline__ uint64_t hash(const Params& p) const {
    uint64_t h = kHashSeed;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      if (c >= p.kw) break;
      h = hash_step(h, q[c]);
    }
    if constexpr (W == kWide) {
      bool out_of_range = false;    // such a query misses in equals
      for (int c = R; c < p.kw; ++c)
        h = hash_step(h, canon_query<CT>(p, base + c, out_of_range));
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

// The dense body's rows: each value pass sums the rows of the keys that
// match (live: a query that can match); the row's output is written when
// valid.  Returns whether any key matched.
template <typename CT, typename VT, int W, typename Keys>
__device__ __forceinline__ bool dense_rows(const Params& p,
                                           const Query<CT, W>& query,
                                           const Keys& keys, const VT* vals,
                                           int64_t row, bool valid,
                                           bool live) {
  using A = typename Acc<VT>::T;
  VT* out = static_cast<VT*>(p.out);
  bool any = false;
  // At least one pass, so that hit is computed when v == 0.
  for (int c0 = 0; c0 == 0 || c0 < p.v; c0 += kCols) {
    const int cols = (p.v - c0 < kCols) ? p.v - c0 : kCols;
    A acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = A(0);
    if (live) {
      for (int r = 0; r < p.n; ++r) {
        if (!query.equals(p, keys, static_cast<int64_t>(r) * p.kw))
          continue;
        any = true;
        const VT* vr = vals + static_cast<int64_t>(r) * p.v + c0;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (c < cols) acc[c] += widen<VT>(vr[c]);
      }
    }
    if (valid) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (c < cols) out[row * p.v + c0 + c] = narrow<VT>(acc[c]);
    }
  }
  return any;
}

template <typename CT, typename VT, int W>
__global__ void __launch_bounds__(kMaxThreads) dense_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const CT* keys = static_cast<const CT*>(p.keys);
  const VT* vals = static_cast<const VT*>(p.vals);
  if (p.staged) {
    // The whole table, once: canonical keys, then values from a 16-byte
    // boundary.
    const int nk = p.n * p.kw, nv = p.n * p.v;
    CT* sk = reinterpret_cast<CT*>(smem);
    VT* sv = reinterpret_cast<VT*>(
        smem + ((sizeof(CT) * nk + 15) & ~static_cast<size_t>(15)));
    if (p.knative) {
      for (int e = threadIdx.x; e < nk; e += blockDim.x) sk[e] = keys[e];
    } else {
      for (int e = threadIdx.x; e < nk; e += blockDim.x)
        sk[e] = static_cast<CT>(canon_key(p.keys, e, p.kcode));
    }
    for (int e = threadIdx.x; e < nv; e += blockDim.x) sv[e] = vals[e];
    __syncthreads();
    keys = sk;
    vals = sv;
  }
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const bool valid = row < p.b;
  Query<CT, W> query;
  query.load(p, row, valid);
  const bool live = valid && !query.bad;
  const bool any =
      p.staged || p.knative
          ? dense_rows(p, query, NativeKeys<CT>{keys}, vals, row, valid, live)
          : dense_rows(p, query, RawKeys<CT>{p.keys, p.kcode}, vals, row,
                       valid, live);
  if (valid) p.hit[row] = any;
  count_misses(p, valid && !any);
}

template <typename CT, typename VT, int W>
__global__ void __launch_bounds__(kMaxThreads) hashed_kernel(Params p) {
  using ST = typename Stored<VT>::T;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const bool valid = row < p.b;
  Query<CT, W> query;
  query.load(p, row, valid);
  int idx = -1;
  if (valid) {
    if (!query.bad) {
      const NativeKeys<CT> keys{static_cast<const CT*>(p.hkeys)};
      uint32_t s = static_cast<uint32_t>(query.hash(p)) & p.mask;
      // The table has an empty slot (at least twice the keys), so the
      // probe ends.
      for (;;) {
        const int k = __ldg(p.slots + s);
        if (k < 0) break;
        if (query.equals(p, keys, static_cast<int64_t>(k) * p.kw)) {
          idx = k;
          break;
        }
        s = (s + 1) & p.mask;
      }
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

template <typename CT, typename VT, int W>
cudaError_t launch(int body, const Params& p, int threads, int blocks,
                   size_t smem, cudaStream_t s) {
  if (body == 1)
    hashed_kernel<CT, VT, W><<<blocks, threads, 0, s>>>(p);
  else
    dense_kernel<CT, VT, W><<<blocks, threads, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename CT, typename VT>
cudaError_t dispatch_width(int body, const Params& p, int threads,
                           int blocks, size_t smem, cudaStream_t s) {
  if (p.kw == 1)
    return launch<CT, VT, kOne>(body, p, threads, blocks, smem, s);
  if (p.kw <= kRegKey)
    return launch<CT, VT, kNarrow>(body, p, threads, blocks, smem, s);
  return launch<CT, VT, kWide>(body, p, threads, blocks, smem, s);
}

template <typename CT>
cudaError_t dispatch_values(int value_dtype, int body, const Params& p,
                            int threads, int blocks, size_t smem,
                            cudaStream_t s) {
  switch (value_dtype) {
    case 0:
      return dispatch_width<CT, float>(body, p, threads, blocks, smem, s);
    case 1:
      return dispatch_width<CT, __nv_bfloat16>(body, p, threads, blocks,
                                               smem, s);
    case 2:
      return dispatch_width<CT, int32_t>(body, p, threads, blocks, smem, s);
    case 3:
      return dispatch_width<CT, int64_t>(body, p, threads, blocks, smem, s);
    case 4:
      return dispatch_width<CT, __half>(body, p, threads, blocks, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}

size_t value_size(int64_t value_dtype) {
  return value_dtype == 1 || value_dtype == 4 ? 2
                                              : (value_dtype == 3 ? 8 : 4);
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
  int64_t b, block_b, sms, body, wait, query_dtype;
  // per table
  uint64_t keys, vals, hkeys, hvals, slots;
  int64_t n, kw, v, mask, key_dtype, value_dtype;
};
static_assert(sizeof(Args) == 23 * 8, "Args must be unpadded");

cudaError_t fwd(const Args& a) {
  const bool prepared = a.slots != 0;
  if (a.b <= 0 || a.n < 0 || a.v < 0 || a.kw < 1 || a.b > INT32_MAX ||
      a.n > INT32_MAX || a.kw > INT32_MAX || a.b * a.kw > INT32_MAX ||
      a.b * a.v > INT32_MAX || a.n * a.kw > INT32_MAX ||
      a.n * a.v > INT32_MAX || a.block_b < 1 || a.sms < 1 || a.body < -1 ||
      a.body > 1 || a.ticket == 0 || a.query_dtype < kI32 ||
      a.query_dtype > kU8 || a.key_dtype < kI32 || a.key_dtype > kKeyF16 ||
      (a.wait && a.host_miss == 0) || (a.body == 1 && !prepared) ||
      (prepared && a.mask < 1) || a.mask > INT32_MAX)
    return cudaErrorInvalidValue;
  const int body = a.body >= 0 ? static_cast<int>(a.body)
                               : select_body(prepared, a.n);
  // The canonical type: int64 for int64 keys, else int32.
  const bool wide_ct = a.key_dtype == kI64;
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
  p.qcode = static_cast<int>(a.query_dtype);
  p.kcode = static_cast<int>(a.key_dtype);
  p.mask = static_cast<uint32_t>(a.mask);
  p.knative = a.key_dtype == (wide_ct ? kI64 : kI32);
  p.qnative = a.key_dtype < kKeyF32 && a.query_dtype == (wide_ct ? kI64
                                                                  : kI32);
  const size_t stage =
      (((wide_ct ? 8 : 4) * a.n * a.kw + 15) & ~15ull) +
      value_size(a.value_dtype) * a.n * a.v;
  p.staged = body == 0 && stage <= static_cast<size_t>(kStageBytes);
  p.vec16 = (stored_size(a.value_dtype) * a.v) % 16 == 0 &&
            aligned16(p.out) && aligned16(p.hvals);
  // At most block_b rows a block, rounded up to whole warps and capped at
  // kMaxThreads; fewer (a multiple of 32) when the batch would otherwise
  // give fewer blocks than the card has SMs.
  int64_t cap = (a.block_b + 31) / 32 * 32;
  if (cap > kMaxThreads) cap = kMaxThreads;
  int64_t threads = (a.b + a.sms - 1) / a.sms;
  threads = (threads + 31) / 32 * 32;
  if (threads > cap) threads = cap;
  const int blocks = static_cast<int>((a.b + threads - 1) / threads);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(a.stream);
  const size_t smem = p.staged ? stage : 0;
  cudaError_t err =
      wide_ct
          ? dispatch_values<int64_t>(static_cast<int>(a.value_dtype), body, p,
                                     static_cast<int>(threads), blocks, smem,
                                     s)
          : dispatch_values<int32_t>(static_cast<int>(a.value_dtype), body, p,
                                     static_cast<int>(threads), blocks, smem,
                                     s);
  if (err == cudaSuccess && a.wait) err = cudaStreamSynchronize(s);
  return err;
}

}  // namespace

extern "C" {

// One launch (Args, packed little-endian by the wrapper).  query_dtype: 0
// = int32, 1 = int64, 2 = int8, 3 = int16, 4 = uint8; key_dtype: those, 5 =
// float32, 6 = bfloat16, 7 = float16.  value_dtype: 0 = float32, 1 =
// bfloat16, 2 = int32, 3 = int64, 4 = float16.  x is (b, kw); keys (n, kw)
// and vals (n, v) the raw table; a prepared table adds hkeys (d, kw), its
// distinct canonical keys (int64 for int64 keys, else int32), hvals (d, v)
// of fp32 for float values (else the value type) and slots (mask + 1,)
// int32, and slots == 0 means none.  out (b, v) of the value type and hit
// (b,) bool are the call's; ticket is the stream's scratch word (0 between
// launches), host_miss a mapped host word's device address (it receives
// the batch's miss count) or 0; body -1 lets select_body choose; wait (with
// a host word) makes the call wait on the stream after the launch; block_b
// >= 1.  All row-major and contiguous, kw >= 1, n and v may be 0.  Returns
// the cudaError_t of the launch (0 = success).
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

// The hash of n canonical keys of kw integers each (as int64), as the
// kernel computes it: the card check that kernel.py's hash_keys agrees.
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
