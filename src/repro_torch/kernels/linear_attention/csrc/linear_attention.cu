// Chunked gated linear attention forward for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces: src/repro/kernels/linear_attention/kernel.py::
// linear_attention_pallas (body _gla_kernel), the reference's Pallas TPU
// kernel.  Same function: per (batch*head) bh, over the chunks of C steps,
// with an fp32 state S (dk, dv) that starts at 0,
//   la   = cumsum(log_w) over the chunk, la_q = la (inclusive) or la - lw
//   out  = (q e^{la_q}) S + mask((q e^{la_q}) (k e^{-la})^T [+ diag]) v
//   S   <- e^{la_tot} S + (k e^{la_tot - la})^T v
// with a strict (exclusive) or non-strict (inclusive) lower-triangular
// mask; the RWKV bonus diagonal sum_e q u k is added in exclusive mode
// only, as the reference's oracle does (chunk_math.py:106; the Pallas
// kernel adds it whenever a bonus is given, and the wrapper refuses an
// inclusive call with a bonus).  The factors e^{-la} reach e^{64} at
// C = 64 under the models' clamp (log_w >= -1), finite in fp32.
//
// What bounds it: at the rwkv6-1.6b prefill shape (bh 32, T 4096, dk = dv
// = 64, C = 64) the scores, intra, inter and state products are ~3.2
// GFLOP of fp32 FMA under the mask (48 us at 67 TFLOP/s) against 168 MB of
// q, k, v, log_w and out (50 us at 3.35 TB/s; bf16 and fp16 q, k, v and
// out halve their bytes, log_w stays fp32, and every product and the
// workspace stay fp32).  The recurrence over the
// chunks is the one sequential part, and it is cheap once each chunk's
// summary is known, so the work is split the way the port's plain version
// (chunk_math.py) orders it, into three launches behind one call:
//
// 1. summary_kernel, one block per (bh, chunk, slice of 128 dv columns),
//    all in parallel: la = cumsum(log_w) over the chunk, la_tot, and the
//    chunk's state increment dS = (k e^{la_tot - la})^T v (dk x dv),
//    written to a workspace.
// 2. fold_kernel, one thread per (bh, e, j): S_n = e^{la_tot,n} S_{n-1} +
//    dS_n from S_0 = 0, in chunk order, a multiply and an add as the plain
//    version's loop (chunk_math.py:84-91) rounds them; it overwrites each
//    dS_n with the state entering chunk n.  Reads are issued 8 chunks
//    ahead, so the loop is bound by bytes, not by latency.
// 3. output_kernel, one block per (bh, chunk, slice of 128 dv columns), all
//    in parallel: out = (q e^{la_q}) S_enter + mask((q e^{la_q})(k
//    e^{-la})^T [+ diag]) v.  The c x c scores are computed once per chunk
//    for each slice (once for dv <= 128).  q, k and log_w are staged 128
//    key columns at a time (la's columns are independent), with the rows
//    of S_enter those columns meet: the scores and the inter product
//    accumulate across the key chunks in registers, in the same order of
//    fp32 operations as one pass would, so dk up to 256 fits at C = 64
//    (168 KB a block; one pass would take 299 KB).
//
// Each chunk kernel stages its inputs by cp.async in two groups (what the
// cumsum needs, then v and the state, which land while it runs).  The
// cumsum keeps every thread busy: dk columns x (256 / dk) row segments,
// each thread running its column's fp32 chain from row 0 through its own
// segment, so la rounds exactly as the plain version's torch.cumsum does.
// The products are register-tiled on a 16 x 16 thread grid: a thread holds
// C/16 x C/16 scores, C/16 rows x 4 columns of out (its rows contiguous,
// so the intra product stops at its last row's diagonal), 4 x 4 of dS,
// reading 128-bit vectors from shared memory (rows padded to an odd number
// of vectors).  The workspace (bh x n_chunks x (dk x dv + dk) fp32) is
// allocated by the wrapper on the caller's stream; nothing here allocates.
//
// A ragged tail (T not a multiple of C) is masked, not refused: past T,
// q, k and v stage as 0 and log_w as 0, which leaves every valid output and
// the states exact.  C (the chunk_len spec point: 16, 32, 64) is a template
// argument; dk and dv are runtime values up to kMaxKeyHead and
// kMaxValueHead (GLA-1.3B's 256 and 512).  The inputs are of one dtype T;
// q, k and v of mixed dtypes are widened to fp32 by the wrapper (exact),
// and the output is stored in the dtype the entry's out_dtype names (v's).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxKeyHead = 256;     // largest dk the kernel takes
constexpr int kMaxValueHead = 512;   // largest dv the kernel takes
constexpr int kSlice = 128;          // dv columns a block computes
constexpr int kKeyChunk = 128;       // key columns output_kernel stages at once
constexpr int kThreads = 256;   // the 16 x 16 thread grid of the products
constexpr int kFoldThreads = 256;
constexpr int kFoldAhead = 8;   // chunks the fold reads ahead

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

// Row stride (floats) of a staged tile of width w: w rounded up to whole
// 16-byte vectors, then to an odd number of them (bank spread).
__host__ __device__ __forceinline__ int tile_stride(int w) {
  return 4 * (((w + 3) / 4) | 1);
}
// Width (floats) the output-column passes cover: whole passes of 64.
__host__ __device__ __forceinline__ int pass_width(int w) {
  return 64 * ((w + 63) / 64);
}

// Four consecutive values of T as fp32, from one 16-byte (fp32) or
// 8-byte (bf16, fp16) load.
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
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Stage rows [0, rows) of a slab of `width` columns, rows `ld` values
// apart, into shared memory as fp32, columns [0, pad) of each (pad a
// multiple of 4), with zeros past n_valid and past width.  With vec (ld
// and width % 4 == 0 and the slab aligned to 4 values), each thread moves
// 4 values per load.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int stride, int pad,
                                      const T* __restrict__ src, int ld,
                                      int n_valid, int rows, int width,
                                      bool vec) {
  const int vpr = pad / 4;
  for (int idx = threadIdx.x; idx < rows * vpr; idx += blockDim.x) {
    const int r = idx / vpr;
    const int c = 4 * (idx - r * vpr);
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < n_valid && c < width) {
      const T* p = src + static_cast<int64_t>(r) * ld + c;
      if (vec) {
        x = load4(p);
      } else {
        x.x = to_f(p[0]);
        if (c + 1 < width) x.y = to_f(p[1]);
        if (c + 2 < width) x.z = to_f(p[2]);
        if (c + 3 < width) x.w = to_f(p[3]);
      }
    }
    *reinterpret_cast<float4*>(dst + r * stride + c) = x;
  }
}

// cp.async helpers: a copy of 16 or 4 bytes into shared memory that fills
// with zeros past `bytes` (0 copies nothing and writes zeros).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
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

// stage() for fp32 slabs, by cp.async: every copy of the slab is in
// flight at once, none through registers (16-byte copies with vec, else
// 4-byte ones), zeros past n_valid and width.  The caller commits and
// waits.
__device__ __forceinline__ void stage_async(float* dst, int stride, int pad,
                                            const float* __restrict__ src,
                                            int ld, int n_valid, int rows,
                                            int width, bool vec) {
  if (vec) {
    const int vpr = pad / 4;
    if (kThreads % vpr == 0) {
      // A thread keeps one column and steps over rows: no division a copy.
      const int c = 4 * (threadIdx.x % vpr);
      for (int r = threadIdx.x / vpr; r < rows; r += kThreads / vpr) {
        const bool ok = r < n_valid && c < width;
        cp_async16(dst + r * stride + c,
                   ok ? src + static_cast<int64_t>(r) * ld + c : src,
                   ok ? 16 : 0);
      }
      return;
    }
    for (int idx = threadIdx.x; idx < rows * vpr; idx += kThreads) {
      const int r = idx / vpr;
      const int c = 4 * (idx - r * vpr);
      const bool ok = r < n_valid && c < width;
      cp_async16(dst + r * stride + c,
                 ok ? src + static_cast<int64_t>(r) * ld + c : src,
                 ok ? 16 : 0);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < rows * pad; idx += blockDim.x) {
    const int r = idx / pad;
    const int c = idx - r * pad;
    const bool ok = r < n_valid && c < width;
    cp_async4(dst + r * stride + c,
              ok ? src + static_cast<int64_t>(r) * ld + c : src,
              ok ? 4 : 0);
  }
}
// bf16 and fp16 slabs are widened to fp32 on the way, through registers.
__device__ __forceinline__ void stage_async(float* dst, int stride, int pad,
                                            const __nv_bfloat16* src, int ld,
                                            int n_valid, int rows, int width,
                                            bool vec) {
  stage(dst, stride, pad, src, ld, n_valid, rows, width, vec);
}
__device__ __forceinline__ void stage_async(float* dst, int stride, int pad,
                                            const __half* src, int ld,
                                            int n_valid, int rows, int width,
                                            bool vec) {
  stage(dst, stride, pad, src, ld, n_valid, rows, width, vec);
}

// x stored as the dtype of `code` (0 = float32, 1 = bfloat16, 2 = float16)
// at element i of `base`.
__device__ __forceinline__ void store_as(void* base, int64_t i, float x,
                                         int code) {
  if (code == 1)
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16(x);
  else if (code == 2)
    static_cast<__half*>(base)[i] = __float2half_rn(x);
  else
    static_cast<float*>(base)[i] = x;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The cumsum's split of a C x dk4 chunk: dk4 columns x n_seg row segments
// of len rows; thread tid owns column tid % dk4 of segment tid / dk4.  Each
// thread runs its column's chain of fp32 adds from row 0 through its own
// segment, the rows before it redundantly, so la is the plain version's
// sequential cumsum (torch.cumsum along a non-innermost dim on the card)
// to the last bit while every thread has its rows to finish: its error
// enters every e^{+-la} factor, up to e^{64}, the same way in both.
struct Scan {
  int n_seg, len, e, first, last;   // this thread: column, rows [first, last)
  __device__ __forceinline__ Scan(int dk4, int c) {
    n_seg = min(c, kThreads / dk4);
    len = (c + n_seg - 1) / n_seg;
    e = threadIdx.x % dk4;
    const int g = threadIdx.x / dk4;
    first = g < n_seg ? min(c, g * len) : 0;
    last = g < n_seg ? min(c, (g + 1) * len) : 0;
  }
  // The chain's value before row `first`: the sum of rows [0, first).
  __device__ __forceinline__ float prefix(const float* w, int ks) const {
    float run = 0.0f;
#pragma unroll 4
    for (int r = 0; r < first; ++r) run += w[r * ks + e];
    return run;
  }
};

// ---------------------------------------------------------------------------
// 1. summary_kernel: dS and la_tot of every (bh, chunk)
// ---------------------------------------------------------------------------

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    summary_kernel(const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ log_w, float* __restrict__ ds,
                   float* __restrict__ tot, int t_len, int dk, int dv,
                   int n_chunks, bool vec, bool vec_v, bool vec_w,
                   bool vec_s) {
  extern __shared__ __align__(16) float smem[];
  const int dk4 = (dk + 3) / 4 * 4;
  const int ks = tile_stride(dk), vp = pass_width(min(dv, kSlice));
  float* k_s = smem;                 // k, then k e^{la_tot - la}
  float* w_s = k_s + C * ks;         // log_w
  float* v_s = w_s + C * ks;         // (C, vp) this block's columns of v

  const int bh = blockIdx.x / n_chunks, n = blockIdx.x % n_chunks;
  const int j_base = blockIdx.y * kSlice, sw = min(kSlice, dv - j_base);
  const int t0 = n * C, rows = min(C, t_len - t0);
  const int64_t row0 = static_cast<int64_t>(bh) * t_len + t0;
  // Two copy groups: what the cumsum needs, then v (lands during it).
  stage_async(k_s, ks, dk4, k + row0 * dk, dk, rows, C, dk, vec);
  stage_async(w_s, ks, dk4, log_w + row0 * dk, dk, rows, C, dk, vec_w);
  cp_async_commit();
  stage_async(v_s, vp, vp, v + row0 * dv + j_base, dv, rows, C, sw, vec_v);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // la in place over log_w, then k e^{la_tot - la} (la_tot = la's last
  // row), in the plain version's order of fp32 operations.
  const Scan sc(dk4, C);
  float run = sc.prefix(w_s, ks);
  __syncthreads();   // every chain has read the log_w it needs
#pragma unroll 4
  for (int r = sc.first; r < sc.last; ++r) {
    run += w_s[r * ks + sc.e];
    w_s[r * ks + sc.e] = run;
  }
  __syncthreads();
  if (kThreads % dk4 == 0) {
    const int e = threadIdx.x % dk4;
    const float la_tot = w_s[(C - 1) * ks + e];
    for (int r = threadIdx.x / dk4; r < C; r += kThreads / dk4)
      k_s[r * ks + e] *= expf(la_tot - w_s[r * ks + e]);
  } else {
    for (int idx = threadIdx.x; idx < C * dk4; idx += kThreads) {
      const int r = idx / dk4, e = idx - r * dk4;
      k_s[r * ks + e] *= expf(w_s[(C - 1) * ks + e] - w_s[r * ks + e]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // dS[e][j_base + j] = sum_r kd[r][e] v[r][j]: a thread owns e = e0 + 4 ti
  // + y, j = j0 + 4 tj + x.
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  float* dsb = ds + (static_cast<int64_t>(bh) * n_chunks + n) * dk * dv +
               j_base;
  for (int e0 = 0; e0 < dk4; e0 += 64) {
    const int e = e0 + 4 * ti;
    for (int j0 = 0; j0 < sw; j0 += 64) {
      const int j = j0 + 4 * tj;
      if (e >= dk4 || j >= sw) continue;
      float acc[4][4] = {};
#pragma unroll 8
      for (int r = 0; r < C; ++r) {
        const float4 kv = *reinterpret_cast<const float4*>(k_s + r * ks + e);
        const float4 vv = *reinterpret_cast<const float4*>(v_s + r * vp + j);
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const float a = comp(kv, y);
          acc[y][0] = fmaf(a, vv.x, acc[y][0]);
          acc[y][1] = fmaf(a, vv.y, acc[y][1]);
          acc[y][2] = fmaf(a, vv.z, acc[y][2]);
          acc[y][3] = fmaf(a, vv.w, acc[y][3]);
        }
      }
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        if (e + y >= dk) break;
        float* o = dsb + static_cast<int64_t>(e + y) * dv + j;
        if (vec_s && j + 3 < sw) {
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[y][0], acc[y][1], acc[y][2], acc[y][3]);
        } else {
#pragma unroll
          for (int x = 0; x < 4; ++x)
            if (j + x < sw) o[x] = acc[y][x];
        }
      }
    }
  }
  if (blockIdx.y == 0 && threadIdx.x < dk)
    tot[(static_cast<int64_t>(bh) * n_chunks + n) * dk + threadIdx.x] =
        w_s[(C - 1) * ks + threadIdx.x];
}

// ---------------------------------------------------------------------------
// 2. fold_kernel: the state entering every chunk, in place over dS
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kFoldThreads)
    fold_kernel(float* __restrict__ ds, const float* __restrict__ tot,
                int n_chunks, int dk, int dv, int64_t n_cells) {
  const int64_t cell =
      static_cast<int64_t>(blockIdx.x) * kFoldThreads + threadIdx.x;
  if (cell >= n_cells) return;
  const int64_t per_head = static_cast<int64_t>(dk) * dv;
  const int64_t bh = cell / per_head;
  const int64_t ej = cell - bh * per_head;
  const int e = static_cast<int>(ej / dv);
  float* p = ds + bh * n_chunks * per_head + ej;
  const float* tp = tot + bh * n_chunks * dk + e;
  float state = 0.0f;
  for (int n0 = 0; n0 < n_chunks; n0 += kFoldAhead) {
    float add[kFoldAhead], decay[kFoldAhead];
#pragma unroll
    for (int b = 0; b < kFoldAhead; ++b) {
      if (n0 + b < n_chunks) {
        add[b] = p[(n0 + b) * per_head];
        decay[b] = expf(tp[static_cast<int64_t>(n0 + b) * dk]);
      }
    }
#pragma unroll
    for (int b = 0; b < kFoldAhead; ++b) {
      if (n0 + b < n_chunks) {
        p[(n0 + b) * per_head] = state;
        state = __fadd_rn(__fmul_rn(decay[b], state), add[b]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. output_kernel: every chunk's output from the state entering it
// ---------------------------------------------------------------------------

// output_kernel's shared memory, in floats from its base, for one key-chunk
// width and the PASSES x 64 staged state and v columns of the
// instantiation (whatever dv is: a narrow slice zero-fills the rest).  The
// kernel takes its pointers from it and the launch its size, so the two
// cannot disagree.
template <int C, int PASSES>
struct OutLayout {
  static constexpr int vp = 64 * PASSES;  // the slice's staged columns
  static constexpr int ps = C + 4;        // row stride of the scores
  int dk4, kc4, ks;                       // keys, widest key chunk, stride
  int k_off, w_off, st_off, u_off, dg_off, floats;
  __host__ __device__ explicit OutLayout(int dk)
      : dk4((dk + 3) / 4 * 4),
        kc4(dk4 < kKeyChunk ? dk4 : kKeyChunk),
        ks(tile_stride(kc4)) {
    k_off = C * ks;                             // q chunk
    w_off = k_off + C * (ks > vp ? ks : vp);    // k chunk, then v
    st_off = w_off + C * (ks > ps ? ks : ps);   // log_w chunk, then scores
    u_off = st_off + kc4 * vp;                  // state rows
    dg_off = u_off + dk4;                       // bonus
    floats = dg_off + C;                        // bonus diagonal
  }
  size_t bytes() const { return sizeof(float) * static_cast<size_t>(floats); }
};

template <typename T, int C, int PASSES, int KEY_CHUNKS>
__global__ void __launch_bounds__(kThreads)
    output_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ log_w,
                  const float* __restrict__ bonus,
                  const float* __restrict__ states, void* __restrict__ out,
                  int t_len, int dk, int dv, int n_chunks, int inclusive,
                  int out_code, bool vec, bool vec_v, bool vec_w, bool vec_s,
                  bool vec_u, bool vec_o) {
  using Layout = OutLayout<C, PASSES>;
  constexpr int R = C / 16;             // score rows and columns a thread
  constexpr int ps = Layout::ps;
  constexpr int kPasses = PASSES;       // output-column passes of 64
  constexpr int vp = Layout::vp;
  extern __shared__ __align__(16) float smem[];
  const Layout lay(dk);
  const int dk4 = lay.dk4, ks = lay.ks;
  float* q_s = smem;                    // a key chunk of q, then q e^{la_q}
  float* k_s = smem + lay.k_off;        // ... of k, then k e^{-la}
  float* v_s = k_s;                     // (C, vp) v, once the scores are done
  float* w_s = smem + lay.w_off;        // ... of log_w
  float* p_s = w_s;                     // (C, ps) scores, once log_w is spent
  float* st_s = smem + lay.st_off;      // (kc4, vp) the chunk's state rows
  float* u_s = smem + lay.u_off;        // (dk4) bonus
  float* dg_s = smem + lay.dg_off;      // (C) bonus diagonal

  const int bh = blockIdx.x / n_chunks, n = blockIdx.x % n_chunks;
  const int j_base = blockIdx.y * kSlice, sw = min(kSlice, dv - j_base);
  const int t0 = n * C, rows = min(C, t_len - t0);
  const int64_t row0 = static_cast<int64_t>(bh) * t_len + t0;
  const float* st_g =
      states + (static_cast<int64_t>(bh) * n_chunks + n) * dk * dv + j_base;
  const bool use_diag = bonus != nullptr && !inclusive;
  // Copy groups of key chunk c: what the cumsum and the scores need; the
  // entering state's rows of the chunk (land during them).  After the last
  // chunk's scores, v into k's slot (lands during the inter product).
  auto stage_keys = [&](int c) {
    const int e0 = c * kKeyChunk, cw = min(kKeyChunk, dk - e0);
    const int cw4 = (cw + 3) / 4 * 4;
    stage_async(q_s, ks, cw4, q + row0 * dk + e0, dk, rows, C, cw, vec);
    stage_async(k_s, ks, cw4, k + row0 * dk + e0, dk, rows, C, cw, vec);
    stage_async(w_s, ks, cw4, log_w + row0 * dk + e0, dk, rows, C, cw,
                vec_w);
    cp_async_commit();
    stage_async(st_s, vp, vp, st_g + static_cast<int64_t>(e0) * dv, dv, cw,
                cw4, sw, vec_s);
    cp_async_commit();
  };
  if (use_diag)
    stage_async(u_s, dk4, dk4, bonus + static_cast<int64_t>(bh) * dk, dk, 1,
                1, dk, vec_u);
  stage_keys(0);

  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  // Scores of rows R ti + a and columns tj + 16 b; out rows R ti + a,
  // columns 64 pp + 4 tj + x of the slice; the bonus diagonal's share of
  // row threadIdx.x / G.  Each sums over the key chunks in order.
  float s[R][R], acc[kPasses][R][4], dsum = 0.0f;
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int b = 0; b < R; ++b) s[a][b] = 0.0f;
#pragma unroll
    for (int pp = 0; pp < kPasses; ++pp)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[pp][a][x] = 0.0f;
  }
  // KEY_CHUNKS (dk / 128, rounded up) is a template argument, so the loop
  // unrolls and the one-chunk heads (dk <= 128) keep no score registers
  // live through the inter product.
#pragma unroll
  for (int c = 0; c < KEY_CHUNKS; ++c) {
    const bool last = c == KEY_CHUNKS - 1;
    const int e0 = c * kKeyChunk, cw = min(kKeyChunk, dk - e0);
    const int cw4 = (cw + 3) / 4 * 4;
    cp_async_wait<1>();
    __syncthreads();   // the chunk's q, k and log_w (and the bonus) are in

    if (use_diag) {
      // diag[r] = sum_e q u k over raw q, k: kThreads / C lanes a row.
      constexpr int G = kThreads / C;
      const int r = threadIdx.x / G, g = threadIdx.x % G;
      for (int e = g; e < cw; e += G)
        dsum += q_s[r * ks + e] * u_s[e0 + e] * k_s[r * ks + e];
      if (last) {
#pragma unroll
        for (int off = 1; off < G; off <<= 1)
          dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
        if (g == 0) dg_s[r] = dsum;
      }
    }
    __syncthreads();
    {
      // q e^{la_q}, k e^{-la}, la_q = la - lw when exclusive, in the plain
      // version's order of fp32 operations.
      const Scan sc(cw4, C);
      float run = sc.prefix(w_s, ks);
#pragma unroll 4
      for (int r = sc.first; r < sc.last; ++r) {
        const int o = r * ks + sc.e;
        const float lw = w_s[o];
        run += lw;
        q_s[o] *= expf(inclusive ? run : run - lw);
        k_s[o] *= expf(-run);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int e = 0; e < cw4; e += 4) {
      float4 qv[R], kv[R];
#pragma unroll
      for (int a = 0; a < R; ++a)
        qv[a] = *reinterpret_cast<const float4*>(q_s + (R * ti + a) * ks +
                                                 e);
#pragma unroll
      for (int b = 0; b < R; ++b)
        kv[b] = *reinterpret_cast<const float4*>(k_s + (tj + 16 * b) * ks +
                                                 e);
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
    if (last) {
      // The scores, masked, + diagonal, go where log_w was; the last reads
      // of log_w were before the barrier above.
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b) {
          const int i = R * ti + a, j = tj + 16 * b;
          float x = (inclusive ? j <= i : j < i) ? s[a][b] : 0.0f;
          if (use_diag && i == j) x += dg_s[i];
          p_s[i * ps + j] = x;
        }
    }
    cp_async_wait<0>();
    __syncthreads();   // the state rows are in; this chunk's k is spent
    if (last) {
      stage_async(v_s, vp, vp, v + row0 * dv + j_base, dv, rows, C, sw,
                  vec_v);
      cp_async_commit();
    }

    // out[i][j] += (q e^{la_q})[i] . S[:, j] over the chunk's keys: the
    // inter product (while v lands, after the last chunk).
#pragma unroll
    for (int pp = 0; pp < kPasses; ++pp) {
      const int j = 64 * pp + 4 * tj;
      if (j >= sw) continue;
#pragma unroll 2
      for (int e = 0; e < cw4; e += 4) {
        float4 qv[R];
#pragma unroll
        for (int a = 0; a < R; ++a)
          qv[a] = *reinterpret_cast<const float4*>(q_s + (R * ti + a) * ks +
                                                   e);
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const float4 sv =
              *reinterpret_cast<const float4*>(st_s + (e + y) * vp + j);
#pragma unroll
          for (int a = 0; a < R; ++a) {
            const float x = comp(qv[a], y);
            acc[pp][a][0] = fmaf(x, sv.x, acc[pp][a][0]);
            acc[pp][a][1] = fmaf(x, sv.y, acc[pp][a][1]);
            acc[pp][a][2] = fmaf(x, sv.z, acc[pp][a][2]);
            acc[pp][a][3] = fmaf(x, sv.w, acc[pp][a][3]);
          }
        }
      }
    }
    if (!last) {
      __syncthreads();   // every thread is done with q and the state rows
      stage_keys(c + 1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // v is in

  // out[i][j] += scores[i] . v[:, j]: the scores of rows R ti + a are 0
  // past column R ti + R - 1 (the mask), so the intra product stops there.
  const int c_end = (R * ti + R + 3) / 4 * 4;
#pragma unroll
  for (int pp = 0; pp < kPasses; ++pp) {
    const int j = 64 * pp + 4 * tj;
    if (j >= sw) continue;
#pragma unroll 2
    for (int c = 0; c < c_end; c += 4) {
      float4 pv[R];
#pragma unroll
      for (int a = 0; a < R; ++a)
        pv[a] = *reinterpret_cast<const float4*>(p_s + (R * ti + a) * ps +
                                                 c);
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const float4 vv =
            *reinterpret_cast<const float4*>(v_s + (c + y) * vp + j);
#pragma unroll
        for (int a = 0; a < R; ++a) {
          const float x = comp(pv[a], y);
          acc[pp][a][0] = fmaf(x, vv.x, acc[pp][a][0]);
          acc[pp][a][1] = fmaf(x, vv.y, acc[pp][a][1]);
          acc[pp][a][2] = fmaf(x, vv.z, acc[pp][a][2]);
          acc[pp][a][3] = fmaf(x, vv.w, acc[pp][a][3]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int i = R * ti + a;
      if (i >= rows) continue;
      const int64_t o = (row0 + i) * dv + j_base + j;
      if (vec_o && j + 3 < sw) {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
            make_float4(acc[pp][a][0], acc[pp][a][1], acc[pp][a][2],
                        acc[pp][a][3]);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (j + x < sw) store_as(out, o + x, acc[pp][a][x], out_code);
      }
    }
  }
}

template <int C>
size_t summary_smem(int dk, int dv) {
  return sizeof(float) * (2 * static_cast<size_t>(C) * tile_stride(dk) +
                          static_cast<size_t>(C) *
                              pass_width(dv < kSlice ? dv : kSlice));
}

// An output_kernel instantiation with its shared memory for dk.
template <typename T, int C>
struct OutputLaunch {
  decltype(&output_kernel<T, C, 1, 1>) kernel;
  size_t smem;
};

template <typename T, int C, int PASSES, int KEY_CHUNKS>
OutputLaunch<T, C> output_launch(int dk) {
  return {output_kernel<T, C, PASSES, KEY_CHUNKS>,
          OutLayout<C, PASSES>(dk).bytes()};
}

template <typename T, int C>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* log_w, const float* bonus, void* out,
                   float* work, int bh, int t_len, int dk, int dv,
                   int inclusive, int out_code, cudaStream_t stream) {
  const int n_chunks = (t_len + C - 1) / C;
  const int64_t blocks = static_cast<int64_t>(bh) * n_chunks;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  // One block a chunk for each slice of kSlice dv columns.
  const dim3 grid(static_cast<unsigned>(blocks), (dv + kSlice - 1) / kSlice);
  float* ds = work;
  float* tot = work + blocks * dk * dv;
  // Every row of every slab starts 4 values past an aligned one when the
  // width is a multiple of 4 and the base pointer is aligned.
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = dk % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % align == 0 &&
                   reinterpret_cast<uintptr_t>(k) % align == 0;
  const bool vec_v =
      dv % 4 == 0 && reinterpret_cast<uintptr_t>(v) % align == 0;
  const bool vec_s =
      dv % 4 == 0 && reinterpret_cast<uintptr_t>(work) % 16 == 0;
  const bool vec_w =
      dk % 4 == 0 && reinterpret_cast<uintptr_t>(log_w) % 16 == 0;
  const bool vec_u = dk % 4 == 0 && bonus != nullptr &&
                     reinterpret_cast<uintptr_t>(bonus) % 16 == 0;
  const bool vec_o = out_code == 0 && dv % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;

  auto summary = summary_kernel<T, C>;
  const size_t smem1 = summary_smem<C>(dk, dv);
  cudaError_t err = cudaFuncSetAttribute(
      summary, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return err;
  summary<<<grid, kThreads, smem1, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), log_w, ds, tot,
      t_len, dk, dv, n_chunks, vec, vec_v, vec_w, vec_s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t cells = static_cast<int64_t>(bh) * dk * dv;
  const int64_t fold_blocks = (cells + kFoldThreads - 1) / kFoldThreads;
  if (fold_blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto fold = fold_kernel;
  fold<<<static_cast<unsigned>(fold_blocks), kFoldThreads, 0, stream>>>(
      ds, tot, n_chunks, dk, dv, cells);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // One output-column pass for dv <= 64 (half the accumulators), two of a
  // slice of kSlice columns above; keys over 128 in two chunks (then two
  // passes whatever dv: the second skips columns past it).
  const OutputLaunch<T, C> output =
      dk > kKeyChunk ? output_launch<T, C, 2, 2>(dk)
      : dv <= 64     ? output_launch<T, C, 1, 1>(dk)
                     : output_launch<T, C, 2, 1>(dk);
  err = cudaFuncSetAttribute(output.kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(output.smem));
  if (err != cudaSuccess) return err;
  output.kernel<<<grid, kThreads, output.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), log_w, bonus, ds, out, t_len, dk, dv,
      n_chunks, inclusive, out_code, vec, vec_v, vec_w, vec_s, vec_u, vec_o);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_chunk(const void* q, const void* k, const void* v,
                           const float* log_w, const float* bonus, void* out,
                           float* work, int bh, int t_len, int dk, int dv,
                           int chunk, int inclusive, int out_code,
                           cudaStream_t s) {
  switch (chunk) {
    case 16:
      return launch<T, 16>(q, k, v, log_w, bonus, out, work, bh, t_len, dk,
                           dv, inclusive, out_code, s);
    case 32:
      return launch<T, 32>(q, k, v, log_w, bonus, out, work, bh, t_len, dk,
                           dv, inclusive, out_code, s);
    case 64:
      return launch<T, 64>(q, k, v, log_w, bonus, out, work, bh, t_len, dk,
                           dv, inclusive, out_code, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k (bh, t, dk) and v (bh, t, dv) row-major, of one dtype (0 = float32,
// 1 = bfloat16, 2 = float16); out (bh, t, dv) row-major of dtype out_dtype
// (any for float32 inputs, the inputs' otherwise); log_w (bh, t, dk) and
// bonus (bh, dk) float32, bonus may be null; work: bh x n_chunks x (dk x dv
// + dk) floats (the state entering each chunk, then each chunk's la_tot),
// 16-byte aligned.  Makes three launches on `stream`.  Returns the
// cudaError_t of the first that failed (0 = success).
int linear_attention_fwd(const void* q, const void* k, const void* v,
                         const void* log_w, const void* bonus, void* out,
                         void* work, int bh, int t_len, int dk, int dv,
                         int chunk, int inclusive, int dtype, int out_dtype,
                         void* stream) {
  if (bh <= 0 || t_len <= 0 || dk <= 0 || dv <= 0 || dk > kMaxKeyHead ||
      dv > kMaxValueHead || work == nullptr || out_dtype < 0 ||
      out_dtype > 2 || (dtype != 0 && out_dtype != dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(log_w);
  const float* u = static_cast<const float*>(bonus);
  float* ws = static_cast<float*>(work);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_chunk<float>(q, k, v, w, u, out, ws, bh, t_len, dk, dv,
                                chunk, inclusive, out_dtype, s);
  else if (dtype == 1)
    err = dispatch_chunk<__nv_bfloat16>(q, k, v, w, u, out, ws, bh, t_len,
                                        dk, dv, chunk, inclusive, out_dtype,
                                        s);
  else if (dtype == 2)
    err = dispatch_chunk<__half>(q, k, v, w, u, out, ws, bh, t_len, dk, dv,
                                 chunk, inclusive, out_dtype, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* linear_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
