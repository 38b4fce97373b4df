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
// the fp32 FMA units (TF32 tensor cores would change the numerics).  Each
// FMA is an issue slot, so the design keeps every other instruction
// (shared loads, copies, masks, barriers) a small share of the stream.
// For bf16 and fp16 inputs the bound is the tensor cores' 989 TFLOP/s.
//
// Two bodies under one entry point, picked by dtype:
//
// * fp32 (ring_kernel).  One block of 2 * BQ threads per (q tile of BQ
//   rows, head), heaviest q tiles first across all heads (the last tiles of
//   a causal sequence see the most kv tiles), so the grid's tail is short.
//   - Copies: the q tile is copied once; each kv tile is then streamed as
//     64-column chunks (DP / 64 of K, DVP / 64 of V, DP and DVP the padded
//     head dims, compile-time) through a ring of STAGES (2-4) chunk buffers
//     filled by cp.async while the products run on the oldest; one
//     __syncthreads a chunk (2048 FMAs a thread at BKV = 64).  16-byte
//     copies where rows are 16-byte aligned, 4-byte zero-filling copies
//     otherwise; rows and columns past the edges land as zeros.
//   - Operand feed: a warp owns 16 query rows; a lane owns 4 of them
//     (rows lr, lr + 4, lr + 8, lr + 12, lr = lane / 8) and, in the score
//     product, BKV / 8 kv columns (lc + 8 j, lc = lane % 8): per 4 head
//     elements 4 + BKV / 8 128-bit shared loads feed 16 * BKV / 8 FMAs.
//     In the P.V product a lane owns 16 output columns of its 4 rows:
//     4 + 8 loads for 128 FMAs per 4 kv columns.  The q tile, the K chunks
//     and P are stored with a 16-byte-granule XOR swizzle (granule ^ (row
//     & 3) for q and P, ^ (row & 7) for K), so the 4 or 8 rows a warp reads
//     at once fall in distinct bank quads with no padding: shared memory is
//     the scarce resource at d = 192 (q 96 KB, P 32 KB, ring 64 KB for
//     (128, 64)).
//   - Probabilities: the 8 lanes that share a row hold its scores; row max
//     and sum combine with 3 shuffles each.  P goes through shared memory,
//     into the warp's own rows (no block barrier beyond the ring's): for
//     the P.V product every lane needs all BKV probabilities of its rows,
//     which would take 4 * BKV shuffles a lane against 4 * BKV / 8 stores
//     and 4 * BKV / 4 loads through shared memory.
//   - Masks: only tiles that straddle the causal diagonal, the window's
//     edge or the ragged end of the sequence run the masked softmax; a warp
//     whose 16 rows see none of a tile's columns skips its products.  The
//     scale times log2(e) is folded into q once it has landed, so scores
//     are in the log2 domain and the exponentials are exp2f.
// * bf16 and fp16 (simple_kernel): the kernel's first body, for half-
//   precision inputs (fp32 inside): q, one K and one V tile and P staged
//   synchronously through registers as fp32.  It runs on the prefill of
//   every attention model whose compute_dtype is bfloat16 or float16 (each
//   configuration's default is bfloat16).  In fp16, P is rounded to fp16
//   before the P.V product, as the Pallas kernel rounds it to v's dtype
//   (p.astype(v.dtype)); the bf16 instantiation keeps its fp32 P, within
//   one bf16 ulp of the plain version, which rounding P to bf16 (2^-8 of
//   each probability) would exceed.  Its FMAs are fp32, so it is far from
//   the tensor-core bound that half-precision inputs allow.
//
// BQ and BKV (the block_q / block_kv spec points) are template arguments:
// each tile pair is its own compiled kernel; the fp32 body also has one
// per padded head-dim pair (DP, DVP) in {(64, 64), (128, 128), (192, 128)}
// (d = 192 with dv = 128 is MLA's nope + rope over v).  Every instantiation
// fits the 227 KB of shared memory a block may use (static_asserts).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHead = 192;       // largest d the kernel takes
constexpr int kMaxValueHead = 128;  // largest dv the kernel takes
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

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

// ---------------------------------------------------------------------------
// ring_kernel: the fp32 body
// ---------------------------------------------------------------------------

template <int BQ, int BKV, int DP, int DVP> struct Ring {
  static_assert(BQ % 16 == 0 && BKV % 8 == 0 && DP % 64 == 0 &&
                    DVP % 64 == 0,
                "ring body: BQ % 16, BKV % 8, DP and DVP % 64");
  static constexpr int kThreads = 2 * BQ;      // 16 rows a warp
  static constexpr int kNJ = BKV / 8;          // score columns a lane
  static constexpr int kKChunks = DP / 64;
  static constexpr int kVChunks = DVP / 64;
  static constexpr int kChunks = kKChunks + kVChunks;   // a kv tile
  static constexpr int kChunkFloats = BKV * 64;
  static constexpr int kQFloats = BQ * DP;
  static constexpr int kPFloats = BQ * BKV;
  static constexpr int kFit =
      (kSmemLimit / 4 - kQFloats - kPFloats) / kChunkFloats;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "ring body: two chunk stages must fit");
  static constexpr int kSmem = 4 * (kQFloats + kPFloats +
                                    kStages * kChunkFloats);
  static_assert(kSmem <= kSmemLimit, "ring body: shared memory");
  static_assert((BKV * 16) % kThreads == 0 && (BQ * DP / 4) % kThreads == 0,
                "ring body: the 16-byte copies split evenly");
};

// acc[i][8 VC + 4 h + x] += sum_c p[row i][c] v[c][64 VC + 32 h + 4 lc + x]
// over a kv tile's BKV columns c, from this warp's rows of P (prow, row i
// at 4 i BKV, granules swizzled by lr) and V chunk VC (buf, 64 columns).
template <int VC, int BKV, int NVC>
__device__ __forceinline__ void pv_chunk(float (&acc)[4][8 * NVC],
                                         const float* prow, const float* buf,
                                         int lr, int lc) {
#pragma unroll 2
  for (int c4 = 0; c4 < BKV / 4; ++c4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(prow + 4 * i * BKV +
                                               4 * (c4 ^ lr));
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float* vr = buf + (4 * c4 + x) * 64 + 4 * lc;
      const float4 v0 = *reinterpret_cast<const float4*>(vr);
      const float4 v1 = *reinterpret_cast<const float4*>(vr + 32);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = x == 0 ? pv[i].x
                        : x == 1 ? pv[i].y
                        : x == 2 ? pv[i].z
                                 : pv[i].w;
        constexpr int a = 8 * VC;
        acc[i][a + 0] = fmaf(p, v0.x, acc[i][a + 0]);
        acc[i][a + 1] = fmaf(p, v0.y, acc[i][a + 1]);
        acc[i][a + 2] = fmaf(p, v0.z, acc[i][a + 2]);
        acc[i][a + 3] = fmaf(p, v0.w, acc[i][a + 3]);
        acc[i][a + 4] = fmaf(p, v1.x, acc[i][a + 4]);
        acc[i][a + 5] = fmaf(p, v1.y, acc[i][a + 5]);
        acc[i][a + 6] = fmaf(p, v1.z, acc[i][a + 6]);
        acc[i][a + 7] = fmaf(p, v1.w, acc[i][a + 7]);
      }
    }
  }
}

template <int BQ, int BKV, int DP, int DVP>
__global__ void __launch_bounds__(2 * BQ, 1)
    ring_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out, int bh,
                int sq, int skv, int d, int dv, int group, float scale2,
                int causal, int window, int q_offset, bool vec,
                bool vec_out) {
  using R = Ring<BQ, BKV, DP, DVP>;
  constexpr int kThreads = R::kThreads, NJ = R::kNJ, NS = R::kStages;
  constexpr int NKC = R::kKChunks, NVC = R::kVChunks, NC = R::kChunks;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [BQ][DP], swizzled
  float* ps = qs + R::kQFloats;              // [BQ][BKV], swizzled
  float* ring = ps + R::kPFloats;            // [NS][BKV][64]

  const int n_q = (sq + BQ - 1) / BQ;
  const int tile = n_q - 1 - static_cast<int>(blockIdx.x) / bh;
  const int head = static_cast<int>(blockIdx.x) % bh;
  const int q0 = tile * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lr = lane / 8, lc = lane % 8;

  const float* qb = q + (static_cast<int64_t>(head) * sq + q0) * d;
  const float* kb = k + static_cast<int64_t>(head / group) * skv * d;
  const float* vb = v + static_cast<int64_t>(head / group) * skv * dv;

  // kv tiles any row of this q tile can see (the tile-level skip).
  const int rows_here = min(BQ, sq - q0);
  const int row_first = q_offset + q0;
  const int row_last = row_first + rows_here - 1;
  const int n_kv = (skv + BKV - 1) / BKV;
  int kv_lo = 0, kv_hi = n_kv;
  if (causal) kv_hi = row_last < 0 ? 0 : min(n_kv, row_last / BKV + 1);
  if (window > 0) {
    const int col_min = row_first - window + 1;
    kv_lo = col_min <= 0 ? 0 : min(col_min / BKV, kv_hi);
  }
  // This warp's 16 rows (absolute positions; rows past sq only compute).
  const int w_first = row_first + warp * 16;
  const int w_last = w_first + 15;
  const bool warp_rows = warp * 16 < rows_here;

  // q tile: rows past sq and columns past d land as zeros.
  if (vec) {
#pragma unroll
    for (int i = 0; i < BQ * DP / 4 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (DP / 4), g = idx % (DP / 4);
      const bool ok = r < rows_here && 4 * g < d;
      cp_async16(qs + r * DP + 4 * (g ^ (r & 3)),
                 ok ? qb + static_cast<int64_t>(r) * d + 4 * g : qb,
                 ok ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < BQ * DP; idx += kThreads) {
      const int r = idx / DP, e = idx % DP;
      const bool ok = r < rows_here && e < d;
      cp_async4(qs + r * DP + 4 * ((e >> 2) ^ (r & 3)) + (e & 3),
                ok ? qb + static_cast<int64_t>(r) * d + e : qb, ok ? 4 : 0);
    }
  }
  cp_async_commit();

  // Chunk g of this block's stream: kv tile kv_lo + g / NC, part g % NC
  // (K columns 64 p.. for p < NKC, then V columns 64 (p - NKC)..).
  auto load_chunk = [&](int g, int stage) {
    const int part = g % NC;
    const int c0 = (kv_lo + g / NC) * BKV;
    const bool is_k = part < NKC;
    const float* base = is_k ? kb : vb;
    const int width = is_k ? d : dv;
    const int col0 = 64 * (is_k ? part : part - NKC);
    float* dst = ring + stage * R::kChunkFloats;
    if (vec) {
#pragma unroll
      for (int i = 0; i < BKV * 16 / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / 16, g4 = idx % 16;
        const int col = col0 + 4 * g4;
        const bool ok = c0 + r < skv && col < width;
        cp_async16(dst + r * 64 + 4 * (is_k ? g4 ^ (r & 7) : g4),
                   ok ? base + static_cast<int64_t>(c0 + r) * width + col
                      : base,
                   ok ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < BKV * 64; idx += kThreads) {
        const int r = idx / 64, e = idx % 64;
        const int col = col0 + e;
        const bool ok = c0 + r < skv && col < width;
        const int g4 = is_k ? (e >> 2) ^ (r & 7) : e >> 2;
        cp_async4(dst + r * 64 + 4 * g4 + (e & 3),
                  ok ? base + static_cast<int64_t>(c0 + r) * width + col
                     : base,
                  ok ? 4 : 0);
      }
    }
  };

  const int n_chunks = (kv_hi - kv_lo) * NC;
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_chunks) load_chunk(s, s);
    cp_async_commit();
  }
  // The q tile has landed (only the NS - 1 chunk groups may be pending):
  // fold scale * log2(e) into it, in place.
  cp_async_wait<NS - 1>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < BQ * DP / 4 / kThreads; ++i) {
    float4* p = reinterpret_cast<float4*>(qs) + tid + i * kThreads;
    float4 x = *p;
    x.x *= scale2, x.y *= scale2, x.z *= scale2, x.w *= scale2;
    *p = x;
  }

  float m[4], l[4], s[4][NJ], acc[4][8 * NVC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8 * NVC; ++j) acc[i][j] = 0.0f;
  }
  // This lane's first q row and P row (row i at + 4 i DP, + 4 i BKV);
  // both are swizzled by row & 3 == lr.
  const float* qrow = qs + (warp * 16 + lr) * DP;
  float* prow = ps + (warp * 16 + lr) * BKV;

  int part = 0, t = kv_lo, stage = 0;
  bool active = false, masked = false;
  for (int g = 0; g < n_chunks; ++g) {
    // Chunk g has landed, and every thread is done with chunk g - 1, whose
    // stage the next copies overwrite.
    cp_async_wait<NS - 2>();
    __syncthreads();
    {
      const int next = g + NS - 1;
      if (next < n_chunks) load_chunk(next, (stage + NS - 1) % NS);
      cp_async_commit();
    }
    const float* buf = ring + stage * R::kChunkFloats;
    const int c0 = t * BKV;
    if (part == 0) {
      // Does this warp see any column of tile t, and must it mask?
      const int cols_here = min(BKV, skv - c0);
      active = warp_rows && !(causal && c0 > w_last) &&
               !(window > 0 && c0 + cols_here - 1 <= w_first - window);
      masked = cols_here < BKV || (causal && c0 + BKV - 1 > w_first) ||
               (window > 0 && c0 <= w_last - window);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = 0.0f;
    }
    if (active && part < NKC) {
      // s[i][j] += q[row i] . k[col lc + 8 j] over this chunk's 64 columns.
      const float* kr = buf + lc * 64;
      const float* qr = qrow + 64 * part;
#pragma unroll 4
      for (int e4 = 0; e4 < 16; ++e4) {
        float4 qv[4];
        const int qo = 4 * (e4 ^ lr);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qr + 4 * i * DP + qo);
        const int ko = 4 * (e4 ^ lc);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 kv =
              *reinterpret_cast<const float4*>(kr + j * 8 * 64 + ko);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
          }
        }
      }
      if (part == NKC - 1) {
        // The online softmax update of each row; P to this warp's rows.
        if (masked) {
          const int cols_here = min(BKV, skv - c0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = w_first + lr + 4 * i;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              const int cl = lc + 8 * j;
              const int col = c0 + cl;
              bool ok = cl < cols_here;
              if (causal) ok = ok && col <= row;
              if (window > 0) ok = ok && col > row - window;
              if (!ok) s[i][j] = kNegInf;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float tmax = s[i][0];
#pragma unroll
          for (int j = 1; j < NJ; ++j) tmax = fmaxf(tmax, s[i][j]);
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 4));
          const float m_new = fmaxf(m[i], tmax);
          const float alpha = exp2f(m[i] - m_new);
          float rsum = 0.0f;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            // A masked score contributes 0, never exp(0) (a row whose
            // every column so far is masked has m_new == kNegInf).
            const float p = (masked && s[i][j] == kNegInf)
                                ? 0.0f
                                : exp2f(s[i][j] - m_new);
            rsum += p;
            const int cl = lc + 8 * j;
            prow[4 * i * BKV + 4 * ((cl >> 2) ^ lr) + (cl & 3)] = p;
          }
          rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
          rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
          rsum += __shfl_xor_sync(0xffffffffu, rsum, 4);
          l[i] = alpha * l[i] + rsum;
          m[i] = m_new;
#pragma unroll
          for (int j = 0; j < 8 * NVC; ++j) acc[i][j] *= alpha;
        }
      }
    }
    if (active && part >= NKC) {
      // P was written by this warp before the barrier at the top of this
      // chunk.  One instance per V chunk, so acc is indexed at compile time.
      if (part == NKC)
        pv_chunk<0, BKV, NVC>(acc, prow, buf, lr, lc);
      if constexpr (NVC > 1)
        if (part == NKC + 1) pv_chunk<1, BKV, NVC>(acc, prow, buf, lr, lc);
    }
    if (++part == NC) part = 0, ++t;
    if (++stage == NS) stage = 0;
  }
  cp_async_wait<0>();

  if (!warp_rows) return;
  float* ob = out + (static_cast<int64_t>(head) * sq + q0) * dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 16 + lr + 4 * i;
    if (r >= rows_here) continue;
    const float inv = l[i] == 0.0f ? 0.0f : 1.0f / l[i];
    float* o = ob + static_cast<int64_t>(r) * dv;
#pragma unroll
    for (int vc = 0; vc < NVC; ++vc)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 64 * vc + 32 * h + 4 * lc;
        const int a = 8 * vc + 4 * h;
        if (vec_out && col + 3 < dv) {
          *reinterpret_cast<float4*>(o + col) =
              make_float4(acc[i][a] * inv, acc[i][a + 1] * inv,
                          acc[i][a + 2] * inv, acc[i][a + 3] * inv);
        } else {
#pragma unroll
          for (int x = 0; x < 4; ++x)
            if (col + x < dv) o[col + x] = acc[i][a + x] * inv;
        }
      }
  }
}

template <int BQ, int BKV, int DP, int DVP>
cudaError_t launch_ring(const void* q, const void* k, const void* v,
                        void* out, int bh, int sq, int skv, int d, int dv,
                        int group, float scale, int causal, int window,
                        int q_offset, cudaStream_t stream) {
  using R = Ring<BQ, BKV, DP, DVP>;
  auto kernel = ring_kernel<BQ, BKV, DP, DVP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (attr != cudaSuccess) return attr;
  // 16-byte copies need every row of q, k and v to start 16 bytes past an
  // aligned one: widths that are multiples of 4 and aligned bases.
  const bool vec = d % 4 == 0 && dv % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const bool vec_out =
      dv % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t blocks = static_cast<int64_t>((sq + BQ - 1) / BQ) * bh;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), R::kThreads, R::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), bh, sq, skv,
      d, dv, group, scale * kLog2e, causal, window, q_offset, vec, vec_out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// simple_kernel: the bf16 body (staged through registers, fp32 inside)
// ---------------------------------------------------------------------------

constexpr int kRows = 4;            // query rows per thread
constexpr int kLanesPerRow = 8;     // threads sharing a row group
constexpr int kColsPerThread = kMaxValueHead / kLanesPerRow;   // 16

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Row stride (floats) of a staged tile of width w: w rounded up to whole
// 16-byte vectors, then to an odd number of them (bank spread).
__host__ __device__ __forceinline__ int tile_stride(int w) {
  return 4 * (((w + 3) / 4) | 1);
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

// A probability as the P.V product of the simple body takes it: fp16
// rounds it to fp16, as the Pallas kernel rounds P to v's dtype; bf16
// keeps it in fp32 (see the note at the top).
template <typename T> __device__ __forceinline__ float pv_operand(float p) {
  return p;
}
template <> __device__ __forceinline__ float pv_operand<__half>(float p) {
  return __half2float(__float2half_rn(p));
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
    simple_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int sq,
                  int skv, int d, int dv, int group, float scale2,
                  int causal, int window, int q_offset, bool vec) {
  constexpr int kTn = BKV / kLanesPerRow;  // score columns per thread
  static_assert(BQ / kRows * kLanesPerRow == 2 * BQ, "thread layout");
  static_assert(BKV % kLanesPerRow == 0, "BKV must be a multiple of 8");

  extern __shared__ __align__(16) float smem[];
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
        const float p = s[i][j] == kNegInf ? 0.0f : exp2f(s[i][j] - m_new);
        rsum += p;
        ps[(r0 + i) * p_stride + cg + kLanesPerRow * j] = pv_operand<T>(p);
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
size_t simple_smem_bytes(int d, int dv) {
  return sizeof(float) *
         (static_cast<size_t>(BQ + BKV) * tile_stride(d) +
          static_cast<size_t>(BKV) * tile_stride(dv) +
          static_cast<size_t>(BQ) * (BKV + 4));
}

template <typename T, int BQ, int BKV>
cudaError_t launch_simple(const void* q, const void* k, const void* v,
                          void* out, int bh, int sq, int skv, int d, int dv,
                          int group, float scale, int causal, int window,
                          int q_offset, cudaStream_t stream) {
  const size_t smem = simple_smem_bytes<BQ, BKV>(d, dv);
  auto kernel = simple_kernel<T, BQ, BKV>;
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

// The fp32 body's padded head dims for (d, dv): 0 if none takes them.
int ring_dims(int d, int dv, int* dp, int* dvp) {
  if (d <= 64 && dv <= 64) *dp = 64, *dvp = 64;
  else if (d <= 128 && dv <= 128) *dp = 128, *dvp = 128;
  else if (d <= 192 && dv <= 128) *dp = 192, *dvp = 128;
  else return 0;
  return 1;
}

#define FA_TILES(X) X(64, 32) X(64, 64) X(128, 32) X(128, 64)

using LaunchFn = cudaError_t (*)(const void*, const void*, const void*,
                                 void*, int, int, int, int, int, int, float,
                                 int, int, int, cudaStream_t);

// One instantiation: its launch (nullptr if no body takes the arguments),
// which body it is (0 = the fp32 ring body, 1 = the simple body), its shared
// memory a block and its ring stages (0 for the simple body).
struct Body {
  LaunchFn launch = nullptr;
  int kind = -1;
  int smem = 0;
  int stages = 0;
};

template <int BQ, int BKV, int DP, int DVP>
Body ring_body() {
  using R = Ring<BQ, BKV, DP, DVP>;
  return {launch_ring<BQ, BKV, DP, DVP>, 0, R::kSmem, R::kStages};
}

// The one place that picks the instantiation for a call: the launch runs
// what it returns and flash_attention_body reports it.
Body select_body(int dtype, int block_q, int block_kv, int d, int dv) {
  if (d <= 0 || dv <= 0 || d > kMaxHead || dv > kMaxValueHead) return {};
  if (dtype == 0) {
    int dp, dvp;
    if (!ring_dims(d, dv, &dp, &dvp)) return {};
#define FA_RING(BQ_, BKV_)                                                 \
  if (block_q == BQ_ && block_kv == BKV_)                                  \
    return dp == 64    ? ring_body<BQ_, BKV_, 64, 64>()                    \
           : dp == 128 ? ring_body<BQ_, BKV_, 128, 128>()                  \
                       : ring_body<BQ_, BKV_, 192, 128>();
    FA_TILES(FA_RING)
#undef FA_RING
    return {};
  }
#define FA_SIMPLE(T_, BQ_, BKV_)                                           \
  if (block_q == BQ_ && block_kv == BKV_)                                  \
    return {launch_simple<T_, BQ_, BKV_>, 1,                               \
            static_cast<int>(simple_smem_bytes<BQ_, BKV_>(d, dv)), 0};
  if (dtype == 1) {
#define FA_SIMPLE_BF16(BQ_, BKV_) FA_SIMPLE(__nv_bfloat16, BQ_, BKV_)
    FA_TILES(FA_SIMPLE_BF16)
#undef FA_SIMPLE_BF16
  }
  if (dtype == 2) {
#define FA_SIMPLE_F16(BQ_, BKV_) FA_SIMPLE(__half, BQ_, BKV_)
    FA_TILES(FA_SIMPLE_F16)
#undef FA_SIMPLE_F16
  }
#undef FA_SIMPLE
  return {};
}

}  // namespace

extern "C" {

// q (bh, sq, d), k (bh / group, skv, d), v (bh / group, skv, dv), out
// (bh, sq, dv), all row-major and of one dtype (0 = float32, 1 = bfloat16,
// 2 = float16).
// window <= 0 means no sliding window.  Returns the cudaError_t of the
// launch (0 = success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int bh, int sq, int skv, int d, int dv,
                        int group, float scale, int causal, int window,
                        int q_offset, int dtype, int block_q, int block_kv,
                        void* stream) {
  const Body body = select_body(dtype, block_q, block_kv, d, dv);
  if (bh <= 0 || sq <= 0 || skv <= 0 || group <= 0 || bh % group != 0 ||
      body.launch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(body.launch(q, k, v, out, bh, sq, skv, d, dv,
                                      group, scale, causal, window, q_offset,
                                      static_cast<cudaStream_t>(stream)));
}

// The body a call with these arguments runs (0 = the fp32 ring body, 1 =
// the simple body; -1 = none), its shared memory a block and its ring
// stages (0 for the simple body).
int flash_attention_body(int dtype, int block_q, int block_kv, int d, int dv,
                         int* smem_bytes, int* stages) {
  const Body body = select_body(dtype, block_q, block_kv, d, dv);
  if (body.launch == nullptr) return -1;
  *smem_bytes = body.smem;
  *stages = body.stages;
  return body.kind;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
