// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/attention/kernel.py::flash_attention_pallas
// (body _flash_kernel), the reference's Pallas TPU kernel.  Same function:
// per (batch*head, query row), softmax(scale * q k^T) v over the kv columns
// that the causal and sliding-window masks (relative to q_offset) leave,
// with an online softmax in fp32; GQA reads kv head h / group.  The window
// is any integer (has_window says whether there is one): column c of row r
// is kept where c > r - window, as the Pallas kernel masks it, so a window
// <= 0 keeps no past column.  A row with no valid column gets 0, as the
// Pallas kernel writes (its l == 0 guard).
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
// * fp32 (ring_kernel), also for q, k and v of mixed dtypes: the wrapper
//   widens them to fp32 (exact), and the body takes two runtime codes, the
//   dtype P is rounded to before P.V (v's, as the Pallas kernel's
//   p.astype(v.dtype); none for fp32) and the dtype the output is stored
//   in (q's).  One block of 2 * BQ threads per (q tile of BQ rows, head),
//   heaviest q tiles first across all heads (the last tiles of a causal
//   sequence see the most kv tiles), so the grid's tail is short.
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
//     (128, 64)) and at d = 256 (q 128 KB, P 32 KB, four 16 KB stages:
//     224 KB).
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
// * bf16 and fp16 (fa_wgmma_kernel): the tensor cores, the only way to
//   their 989 TFLOP/s, reached through wgmma.  It runs on the prefill of
//   every attention model whose compute_dtype is bfloat16 or float16 (each
//   configuration's default is bfloat16).  One block per (q tile, head),
//   heaviest q tiles first as above: BQ / 64 consumer warpgroups, each
//   owning 64 query rows, and one producer warp.
//   - Copies: the producer warp fills the q tile once, then each kv tile's
//     K and V into a ring of 2-4 stages (as many as let two blocks share
//     an SM), each behind a full and an empty mbarrier, so the consumers
//     never issue a copy and never wait on one another.  Rows TMA can read
//     (16-byte-aligned bases and rows: d and dv multiples of 8) come in by
//     TMA, one lane issuing a box of 64 columns at a time from 3-D tensor
//     maps (head, row, column) that read zeros past each head's rows and
//     past d / dv; other rows are copied by the warp's 32 lanes (16-byte,
//     4-byte or 2-byte copies, zeros past the edges).  Every tile is kept
//     as 64-column blocks of 128-byte rows with the 128-byte swizzle that
//     TMA writes and wgmma's descriptors name, so nothing is transposed or
//     repacked.
//   - S = q K^T: wgmma m64n{BKV}k16 from the q tile and the K tile, both
//     K-major in shared memory, fp32 accumulators in registers.
//   - Softmax: a row lives in a quad of lanes (the accumulator's layout),
//     so its max and sum take two shuffles each; scores are scaled by
//     scale * log2(e) in registers and exponentiated with ex2.approx; l
//     sums the fp32 probabilities.  Only a tile that straddles the
//     diagonal, the window's edge or the ragged end runs the mask (one
//     branch a tile); a masked score is NEG_INF, and a row that has seen
//     no column yet subtracts 0, so a masked score is never exp(0).
//   - P.V: P is rounded to the input dtype in registers, as the Pallas
//     kernel rounds it to v's dtype (p.astype(v.dtype)), and fed as wgmma's
//     A operand from registers (the score accumulator's columns 16j .. 16j
//     + 15 are already the A fragment of step j); V's row-major tile is the
//     B operand, MN-major, read through wgmma's transpose bit.  At DVP =
//     256 the product is two m64n128k16 halves over V's column blocks 0-1
//     and 2-3: O takes 128 fp32 registers a consumer thread, beside 32 of
//     S and 16 of P (the consumers' budget is 224 at two warpgroups, 255
//     at one; the producer is one warp, so setmaxnreg, which moves
//     registers between whole warpgroups, has none to give).
//     Rounding P moves an output by at most 2^-8 (bf16) or 2^-11 (fp16) of
//     the plain attention over |v| from the plain version's fp32 P.
//   - Masks: as the ring body, per warpgroup of 64 rows: a warpgroup that
//     sees none of a tile skips its products (it still waits for the tile
//     and frees its stage).
//   Tried on the card and not kept: copies issued by the consumers
//   themselves behind a block barrier (slower), and a tile's P.V product
//   issued behind the next tile's S product to overlap that softmax
//   (slower while a branch around the products made ptxas serialize every
//   wgmma; written without one, faster on some tile pairs and no faster
//   than this body's best pair at the prefill shapes).
//
// BQ and BKV (the block_q / block_kv spec points) are template arguments:
// each tile pair is its own compiled kernel, at each padded head-dim pair
// (DP, DVP) in {(64, 64), (128, 128), (192, 128), (256, 256)} (d = 192 with
// dv = 128 is MLA's nope + rope over v; 256 is Gemma's head), for each
// dtype.  Every instantiation fits the 227 KB of shared memory a block may
// use (static_asserts).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHead = 256;       // largest d the kernel takes
constexpr int kMaxValueHead = 256;  // largest dv the kernel takes
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// cp.async helpers: a copy of 16 or 4 bytes into shared memory that fills
// with zeros past `bytes` (0 copies nothing and writes zeros).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
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

// The dtype codes of the entry point: 0 = float32, 1 = bfloat16, 2 =
// float16.  x rounded to the dtype of `code` (and back to fp32), and x
// stored as that dtype at element i of `base`.
__device__ __forceinline__ float round_to(float x, int code) {
  return code == 1   ? __bfloat162float(__float2bfloat16(x))
         : code == 2 ? __half2float(__float2half_rn(x))
                     : x;
}
__device__ __forceinline__ void store_as(void* base, int64_t i, float x,
                                         int code) {
  if (code == 1)
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16(x);
  else if (code == 2)
    static_cast<__half*>(base)[i] = __float2half_rn(x);
  else
    static_cast<float*>(base)[i] = x;
}

// ---------------------------------------------------------------------------
// ring_kernel: the fp32 body (and mixed dtypes, widened to fp32)
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
                const float* __restrict__ v, void* __restrict__ out, int bh,
                int sq, int skv, int d, int dv, int group, float scale2,
                int causal, int has_window, int window, int q_offset,
                int p_round, int out_code, bool vec, bool vec_out) {
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
  if (has_window) {
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
               !(has_window && c0 + cols_here - 1 <= w_first - window);
      masked = cols_here < BKV || (causal && c0 + BKV - 1 > w_first) ||
               (has_window && c0 <= w_last - window);
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
              if (has_window) ok = ok && col > row - window;
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
            rsum += p;   // l sums the fp32 probabilities
            const int cl = lc + 8 * j;
            prow[4 * i * BKV + 4 * ((cl >> 2) ^ lr) + (cl & 3)] =
                round_to(p, p_round);
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
      if constexpr (NVC > 2)
        if (part == NKC + 2) pv_chunk<2, BKV, NVC>(acc, prow, buf, lr, lc);
      if constexpr (NVC > 3)
        if (part == NKC + 3) pv_chunk<3, BKV, NVC>(acc, prow, buf, lr, lc);
    }
    if (++part == NC) part = 0, ++t;
    if (++stage == NS) stage = 0;
  }
  cp_async_wait<0>();

  if (!warp_rows) return;
  const int64_t o0 = (static_cast<int64_t>(head) * sq + q0) * dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 16 + lr + 4 * i;
    if (r >= rows_here) continue;
    const float inv = l[i] == 0.0f ? 0.0f : 1.0f / l[i];
    const int64_t orow = o0 + static_cast<int64_t>(r) * dv;
#pragma unroll
    for (int vc = 0; vc < NVC; ++vc)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 64 * vc + 32 * h + 4 * lc;
        const int a = 8 * vc + 4 * h;
        if (vec_out && col + 3 < dv) {
          *reinterpret_cast<float4*>(static_cast<float*>(out) + orow + col) =
              make_float4(acc[i][a] * inv, acc[i][a + 1] * inv,
                          acc[i][a + 2] * inv, acc[i][a + 3] * inv);
        } else {
#pragma unroll
          for (int x = 0; x < 4; ++x)
            if (col + x < dv)
              store_as(out, orow + col + x, acc[i][a + x] * inv, out_code);
        }
      }
  }
}

template <int BQ, int BKV, int DP, int DVP>
cudaError_t launch_ring(const void* q, const void* k, const void* v,
                        void* out, int bh, int sq, int skv, int d, int dv,
                        int group, float scale, int causal, int has_window,
                        int window, int q_offset, int p_round, int out_code,
                        cudaStream_t stream) {
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
  const bool vec_out = out_code == 0 && dv % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t blocks = static_cast<int64_t>((sq + BQ - 1) / BQ) * bh;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), R::kThreads, R::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), out, bh, sq, skv, d, dv, group,
      scale * kLog2e, causal, has_window, window, q_offset, p_round,
      out_code, vec, vec_out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fa_wgmma_kernel: the bf16 and fp16 body (wgmma on the tensor cores)
// ---------------------------------------------------------------------------

// wgmma.mma_async's register lists and accumulator operands, by count.
#define FA_REGS16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15}"
#define FA_OUT16 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
  "+f"(d[15])
#define FA_REGS32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define FA_OUT32 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31])
#define FA_REGS64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63}"
#define FA_OUT64 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// The products of one warpgroup, fp32 accumulators, for 16-bit T (the
// array's length picks N):
// * ss: d (m64 x N) = (scale_d ? d : 0) + A B, A the 64 q rows and B the
//   N kv rows of a tile (m64nNk16, N = BKV), both from shared memory and
//   K-major (the trailing 0, 0: neither transposed);
// * rs: d (m64 x N) += A B, A the probabilities from registers (4 words,
//   8 values of T a thread), B 16 rows of V's tile from shared memory,
//   MN-major (the trailing 1: B transposed; m64nNk16, N = DVP).
template <typename T> struct Mma;
#define FA_MMA(TYPE, TY)                                                     \
  template <> struct Mma<TYPE> {                                             \
    static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,   \
                                              uint64_t db, int scale_d) {    \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"              \
                   "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY   \
                   " " FA_REGS16 ", %16, %17, p, 1, 1, 0, 0;\n}\n"           \
                   : FA_OUT16                                                \
                   : "l"(da), "l"(db), "r"(scale_d));                        \
    }                                                                        \
    static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,   \
                                              uint64_t db, int scale_d) {    \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"              \
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY   \
                   " " FA_REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"           \
                   : FA_OUT32                                                \
                   : "l"(da), "l"(db), "r"(scale_d));                        \
    }                                                                        \
    static __device__ __forceinline__ void rs(float (&d)[32],                \
                                              const uint32_t (&a)[4],        \
                                              uint64_t db) {                 \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"              \
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY   \
                   " " FA_REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1, "    \
                   "1;\n}\n"                                                 \
                   : FA_OUT32                                                \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),    \
                     "r"(1));                                                \
    }                                                                        \
    static __device__ __forceinline__ void rs(float (&d)[64],                \
                                              const uint32_t (&a)[4],        \
                                              uint64_t db) {                 \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"              \
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY  \
                   " " FA_REGS64 ", {%64, %65, %66, %67}, %68, p, 1, 1, "    \
                   "1;\n}\n"                                                 \
                   : FA_OUT64                                                \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),    \
                     "r"(1));                                                \
    }                                                                        \
  };
FA_MMA(__nv_bfloat16, "bf16")
FA_MMA(__half, "f16")
#undef FA_MMA

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin registers that an in-flight wgmma reads or writes: the compiler may
// not move their uses across this point (CUTLASS's
// warpgroup_fence_operand).
template <int N> __device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
// Shared-memory writes of the generic proxy (st.shared, cp.async) made
// visible to wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

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
// One box of a 3-D tensor map (columns c0.., rows c1.., head c2) into
// shared memory, completing on `bar`; TMA reads zeros past the edges.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor of wgmma: start address, leading and
// stride byte offsets (16-byte units), 128-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// 2^x (ex2.approx.ftz: 2^-22 relative, -inf and huge negatives to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values rounded to T in one word, the first in the low half (a
// register of wgmma's A fragment).
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo,
                                                                float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(
    float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo,
                                                              float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <typename T> __device__ __forceinline__ void store_out(T* p, float x);
template <> __device__ __forceinline__ void store_out<__nv_bfloat16>(
    __nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
template <> __device__ __forceinline__ void store_out<__half>(__half* p,
                                                              float x) {
  *p = __float2half_rn(x);
}

// Byte offset of 16-byte granule c (values 8c .. 8c + 7) of row r in a
// tile of ROWS rows kept as 64-column blocks of 128-byte rows, the granule
// swizzled to c ^ (r % 8) within its row: the layout a 128-byte-swizzle
// descriptor reads, K-major (q, K) and MN-major (V) alike.  Each block
// starts 1024-byte aligned.
template <int ROWS> __device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// How a tile's rows are copied: 16-byte cp.async where every row starts
// 16 bytes past an aligned one, 4-byte cp.async where rows are whole
// 4-byte words, else 2-byte loads and stores.
enum CopyMode { kCopy16 = 0, kCopy4 = 1, kCopy2 = 2 };

// Rows [0, ROWS) of a row-major (n_valid, width) slab of 16-bit values
// into the swizzled tile of CP columns; rows past n_valid and columns past
// width land as zeros.
template <int ROWS, int CP, int THREADS>
__device__ __forceinline__ void load_tile(uint8_t* dst,
                                          const uint16_t* __restrict__ src,
                                          int n_valid, int width, int mode,
                                          int tid) {
  if (mode == kCopy16) {
    // Copy idx is granule idx % 8 of block row idx / 8 (block row ROWS b +
    // r is row r of 64-column block b): 8 lanes fill one 128-byte row.
    for (int idx = tid; idx < ROWS * CP / 8; idx += THREADS) {
      const int r = idx / 8 % ROWS, c = 8 * (idx / 8 / ROWS) + idx % 8;
      const bool ok = r < n_valid && 8 * c < width;
      cp_async16(dst + swz<ROWS>(r, c),
                 ok ? src + static_cast<int64_t>(r) * width + 8 * c : src,
                 ok ? 16 : 0);
    }
  } else if (mode == kCopy4) {
    for (int idx = tid; idx < ROWS * CP / 2; idx += THREADS) {
      const int r = idx / (CP / 2), e = 2 * (idx % (CP / 2));
      const bool ok = r < n_valid && e < width;
      cp_async4(dst + swz<ROWS>(r, e >> 3) + 2 * (e & 7),
                ok ? src + static_cast<int64_t>(r) * width + e : src,
                ok ? 4 : 0);
    }
  } else {
    for (int idx = tid; idx < ROWS * CP; idx += THREADS) {
      const int r = idx / CP, e = idx % CP;
      const uint16_t x = r < n_valid && e < width
                             ? src[static_cast<int64_t>(r) * width + e]
                             : 0;
      *reinterpret_cast<uint16_t*>(dst + swz<ROWS>(r, e >> 3) +
                                   2 * (e & 7)) = x;
    }
  }
}

template <int BQ, int BKV, int DP, int DVP> struct Wg {
  static_assert(BQ % 64 == 0 && (BKV == 32 || BKV == 64) && DP % 64 == 0 &&
                    DP <= kMaxHead &&
                    (DVP == 64 || DVP == 128 || DVP == 256),
                "wgmma body: BQ % 64, BKV 32 or 64, DP % 64, DVP 64, 128 "
                "or 256");
  static constexpr int kGroups = BQ / 64;        // warpgroups, 64 rows each
  // the consumer warpgroups, then one producer warp
  static constexpr int kThreads = 128 * kGroups + 32;
  static constexpr int kQBytes = BQ * DP * 2;
  static constexpr int kKBytes = BKV * DP * 2;
  static constexpr int kVBytes = BKV * DVP * 2;
  static constexpr int kStageBytes = kKBytes + kVBytes;
  // As many K/V stages (2-4) as let two blocks share an SM.
  static constexpr int kFit =
      (kSmemLimit / 2 - kQBytes - 2048) / kStageBytes;
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 4 ? 4 : kFit);
  // slack to align the tiles to 1024 bytes + q tile + K/V ring + barriers
  static constexpr int kSmem =
      1024 + kQBytes + kStages * kStageBytes + 8 * (1 + 2 * kStages);
  static_assert(kSmem <= kSmemLimit, "wgmma body: shared memory");
  static_assert(kQBytes % 1024 == 0 && kKBytes % 1024 == 0 &&
                    kStageBytes % 1024 == 0,
                "wgmma body: every tile block 1024-byte aligned");
};

template <typename T, int BQ, int BKV, int DP, int DVP>
__global__ void __launch_bounds__(Wg<BQ, BKV, DP, DVP>::kThreads)
    fa_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                    const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv,
                    const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int bh,
                    int sq, int skv, int d, int dv, int group, float scale2,
                    int causal, int has_window, int window, int q_offset,
                    int qk_mode, int v_mode, bool tma, bool pair_out) {
  using W = Wg<BQ, BKV, DP, DVP>;
  constexpr int NS = W::kStages, NC = W::kGroups;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = qs + W::kQBytes;   // stage s: K, then V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + NS * W::kStageBytes);
  uint64_t* full = q_full + 1;       // a stage has landed
  uint64_t* empty = full + NS;       // every warpgroup is done with it

  const int n_q = (sq + BQ - 1) / BQ;
  const int tile = n_q - 1 - static_cast<int>(blockIdx.x) / bh;
  const int head = static_cast<int>(blockIdx.x) % bh;
  const int q0 = tile * BQ;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int warp = (tid % 128) / 32;

  // kv tiles any row of this q tile can see (the tile-level skip).
  const int rows_here = min(BQ, sq - q0);
  const int row_first = q_offset + q0;
  const int row_last = row_first + rows_here - 1;
  const int n_kv = (skv + BKV - 1) / BKV;
  int kv_lo = 0, kv_hi = n_kv;
  if (causal) kv_hi = row_last < 0 ? 0 : min(n_kv, row_last / BKV + 1);
  if (has_window) {
    const int col_min = row_first - window + 1;
    kv_lo = col_min <= 0 ? 0 : min(col_min / BKV, kv_hi);
  }
  const int n_tiles = kv_hi - kv_lo;

  if (tid == 0) {
    // TMA completes a stage with one arrival and its bytes; the copies of
    // the producer warp's 32 lanes with an arrival each.
    mbar_init(q_full, tma ? 1 : 32);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], tma ? 1 : 32);
      mbar_init(&empty[s], 4 * NC);      // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // Producer warp: the q tile, then each kv tile's K and V into the ring
    // as soon as every warpgroup is done with the stage's previous tile.
    const int kvh = head / group;
    if (tma) {
      if (lane == 0) {
        mbar_expect_tx(q_full, W::kQBytes);
#pragma unroll
        for (int b = 0; b < DP / 64; ++b)
          tma_load_3d(qs + b * (BQ * 128), &tmq, q_full, 64 * b, q0, head);
        for (int i = 0; i < n_tiles; ++i) {
          const int s = i % NS;
          mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
          uint8_t* st = ring + s * W::kStageBytes;
          const int c0 = (kv_lo + i) * BKV;
          mbar_expect_tx(&full[s], W::kStageBytes);
#pragma unroll
          for (int b = 0; b < DP / 64; ++b)
            tma_load_3d(st + b * (BKV * 128), &tmk, &full[s], 64 * b, c0,
                        kvh);
#pragma unroll
          for (int b = 0; b < DVP / 64; ++b)
            tma_load_3d(st + W::kKBytes + b * (BKV * 128), &tmv, &full[s],
                        64 * b, c0, kvh);
        }
      }
    } else {
      const uint16_t* qb = reinterpret_cast<const uint16_t*>(q) +
                           (static_cast<int64_t>(head) * sq + q0) * d;
      const uint16_t* kb = reinterpret_cast<const uint16_t*>(k) +
                           static_cast<int64_t>(kvh) * skv * d;
      const uint16_t* vb = reinterpret_cast<const uint16_t*>(v) +
                           static_cast<int64_t>(kvh) * skv * dv;
      load_tile<BQ, DP, 32>(qs, qb, rows_here, d, qk_mode, lane);
      cp_async_commit();
      cp_async_wait<0>();
      mbar_arrive(q_full);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS;
        mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
        uint8_t* st = ring + s * W::kStageBytes;
        const int c0 = (kv_lo + i) * BKV;
        const int n = min(BKV, skv - c0);
        load_tile<BKV, DP, 32>(st, kb + static_cast<int64_t>(c0) * d, n, d,
                               qk_mode, lane);
        load_tile<BKV, DVP, 32>(st + W::kKBytes,
                                vb + static_cast<int64_t>(c0) * dv, n, dv,
                                v_mode, lane);
        cp_async_commit();
        cp_async_wait<0>();
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // Consumer warpgroup wg: its 64 rows (absolute positions; rows past sq
  // only compute), and this thread's two: r_lo and r_lo + 8.
  const int g_first = row_first + wg * 64;
  const int g_last = g_first + 63;
  const bool group_rows = wg * 64 < rows_here;
  const int r_lo = g_first + warp * 16 + lane / 4;
  const int c_lane = 2 * (lane % 4);

  // Accumulator layout of m64nN: warp w of the warpgroup holds rows
  // 16w .. 16w + 15; x[4p + 2h + e] is row 16w + lane / 4 + 8h, column
  // 8p + 2 (lane % 4) + e.  m and l by h.
  float o[DVP / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < DVP / 2; ++j) o[j] = 0.0f;

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    // Every warpgroup waits for every tile, seen or not, so none runs a
    // phase ahead of the stage's empty barrier.
    const int s = i % NS;
    mbar_wait(&full[s], (i / NS) & 1);
    // The producer's copies (generic proxy) made visible to wgmma.
    if (!tma) fence_async_shared();
    const int c0 = (kv_lo + i) * BKV;
    const int cols_here = min(BKV, skv - c0);
    // Does this warpgroup see any column of the tile, and must it mask?
    const bool active =
        group_rows && !(causal && c0 > g_last) &&
        !(has_window && c0 + cols_here - 1 <= g_first - window);
    if (active) {
      const bool masked = cols_here < BKV ||
                          (causal && c0 + BKV - 1 > g_first) ||
                          (has_window && c0 <= g_last - window);
      const uint8_t* ks = ring + s * W::kStageBytes;
      const uint8_t* vs = ks + W::kKBytes;

      // S = q K^T over DP / 16 steps of 16 (32 bytes along the swizzled
      // rows, the next 64-column block every 4 steps); 8-row groups 1024
      // bytes apart.
      float sc[BKV / 2];
#pragma unroll
      for (int j = 0; j < BKV / 2; ++j) sc[j] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint8_t* qa = qs + (kk / 4) * (BQ * 128) + wg * (64 * 128) +
                            (kk % 4) * 32;
        const uint8_t* kbk = ks + (kk / 4) * (BKV * 128) + (kk % 4) * 32;
        Mma<T>::ss(sc, smem_desc(qa, 16, 1024), smem_desc(kbk, 16, 1024),
                   kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(sc);

      // Scores in the log2 domain; in a masked tile, masked ones to
      // NEG_INF (one branch for the tile, so unmasked tiles run no mask
      // arithmetic).
#pragma unroll
      for (int j = 0; j < BKV / 2; ++j) sc[j] *= scale2;
      if (masked) {
#pragma unroll
        for (int j = 0; j < BKV / 2; ++j) {
          const int row = r_lo + 8 * ((j >> 1) & 1);
          const int cl = 8 * (j >> 2) + c_lane + (j & 1);
          const int col = c0 + cl;
          bool ok = cl < cols_here;
          if (causal) ok = ok && col <= row;
          if (has_window) ok = ok && col > row - window;
          if (!ok) sc[j] = kNegInf;
        }
      }
      // The online softmax update of rows r_lo (h 0) and r_lo + 8 (h 1):
      // the quad of lanes that shares a row combines with two shuffles.
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float tmax = kNegInf;
#pragma unroll
        for (int p = 0; p < BKV / 8; ++p)
          tmax = fmaxf(tmax, fmaxf(sc[4 * p + 2 * h], sc[4 * p + 2 * h + 1]));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float m_new = fmaxf(m[h], tmax);
        alpha[h] = fast_exp2(m[h] - m_new);
        // A masked score (NEG_INF) contributes 2^-1e30 = 0, also in a row
        // whose every column so far is masked (m_new == NEG_INF, taken as
        // 0 here), never exp(0).
        const float m_use = m_new == kNegInf ? 0.0f : m_new;
        float rsum = 0.0f;
#pragma unroll
        for (int p = 0; p < BKV / 8; ++p)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * p + 2 * h + e];
            x = fast_exp2(x - m_use);
            rsum += x;
          }
        rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
        rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
        l[h] = alpha[h] * l[h] + rsum;   // from the fp32 probabilities
        m[h] = m_new;
      }
#pragma unroll
      for (int p = 0; p < DVP / 8; ++p) {
        o[4 * p + 0] *= alpha[0];
        o[4 * p + 1] *= alpha[0];
        o[4 * p + 2] *= alpha[1];
        o[4 * p + 3] *= alpha[1];
      }
      // P rounded to T (the Pallas kernel's p.astype(v.dtype)): the score
      // accumulator's columns 16j .. 16j + 15 are the A fragment of step j.
      uint32_t a[BKV / 16][4];
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) {
        a[j][0] = pack2<T>(sc[8 * j + 0], sc[8 * j + 1]);
        a[j][1] = pack2<T>(sc[8 * j + 2], sc[8 * j + 3]);
        a[j][2] = pack2<T>(sc[8 * j + 4], sc[8 * j + 5]);
        a[j][3] = pack2<T>(sc[8 * j + 6], sc[8 * j + 7]);
      }
      // o += P V over BKV / 16 steps of 16 kv rows (2048 bytes down each
      // 64-column box of V; boxes BKV * 128 bytes apart); at DVP = 256 as
      // two halves of 128 columns, the second from box 2.
      pin(o);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) {
        if constexpr (DVP <= 128) {
          Mma<T>::rs(o, a[j], smem_desc(vs + j * 2048, BKV * 128, 1024));
        } else {
          using Half = float[64];
          Mma<T>::rs(*reinterpret_cast<Half*>(o), a[j],
                     smem_desc(vs + j * 2048, BKV * 128, 1024));
          Mma<T>::rs(*reinterpret_cast<Half*>(o + 64), a[j],
                     smem_desc(vs + 2 * BKV * 128 + j * 2048, BKV * 128,
                               1024));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(o);
      pin(a);
    }
    // This warpgroup is done with the stage.
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  if (!group_rows) return;
  T* ob = out + (static_cast<int64_t>(head) * sq + q0) * dv;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + warp * 16 + lane / 4 + 8 * h;
    if (r >= rows_here) continue;
    const float inv = l[h] == 0.0f ? 0.0f : 1.0f / l[h];
    T* orow = ob + static_cast<int64_t>(r) * dv;
#pragma unroll
    for (int p = 0; p < DVP / 8; ++p) {
      const int col = 8 * p + c_lane;
      const float x0 = o[4 * p + 2 * h] * inv, x1 = o[4 * p + 2 * h + 1] * inv;
      if (pair_out && col + 1 < dv) {
        *reinterpret_cast<uint32_t*>(orow + col) = pack2<T>(x0, x1);
      } else {
        if (col < dv) store_out<T>(orow + col, x0);
        if (col + 1 < dv) store_out<T>(orow + col + 1, x1);
      }
    }
  }
}

// The copy mode (CopyMode) of rows of `width` 16-bit values from a and b.
int copy_mode(int width, const void* a, const void* b) {
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a);
  const uintptr_t pb = reinterpret_cast<uintptr_t>(b);
  if (width % 8 == 0 && pa % 16 == 0 && pb % 16 == 0) return kCopy16;
  if (width % 2 == 0 && pa % 4 == 0 && pb % 4 == 0) return kCopy4;
  return kCopy2;
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

template <typename T> struct TmaType;
template <> struct TmaType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct TmaType<__half> {
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

// A 3-D tensor map of (heads, rows, cols) row-major 16-bit values, boxes
// of 64 columns by box_rows rows of one head, 128-byte swizzle; zeros are
// read past its edges.
template <typename T>
bool map_3d(CUtensorMap* map, const void* base, int heads, int rows,
            int cols, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows) * cols * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, TmaType<T>::kType, 3, const_cast<void*>(base), dims,
                strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int BQ, int BKV, int DP, int DVP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, int bh, int sq, int skv, int d, int dv,
                         int group, float scale, int causal, int has_window,
                         int window, int q_offset, int /*p_round*/,
                         int /*out_code*/, cudaStream_t stream) {
  using W = Wg<BQ, BKV, DP, DVP>;
  auto kernel = fa_wgmma_kernel<T, BQ, BKV, DP, DVP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::kSmem);
  if (attr != cudaSuccess) return attr;
  const int qk_mode = copy_mode(d, q, k), v_mode = copy_mode(dv, v, v);
  // TMA takes 16-byte-aligned bases and rows; other inputs are copied by
  // the producer warp's lanes.
  CUtensorMap tmq = {}, tmk = {}, tmv = {};
  const bool tma = qk_mode == kCopy16 && v_mode == kCopy16 &&
                   map_3d<T>(&tmq, q, bh, sq, d, BQ) &&
                   map_3d<T>(&tmk, k, bh / group, skv, d, BKV) &&
                   map_3d<T>(&tmv, v, bh / group, skv, dv, BKV);
  const bool pair_out =
      dv % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const int64_t blocks = static_cast<int64_t>((sq + BQ - 1) / BQ) * bh;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), W::kThreads, W::kSmem, stream>>>(
      tmq, tmk, tmv, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), bh, sq, skv, d, dv,
      group, scale * kLog2e, causal, has_window, window, q_offset, qk_mode,
      v_mode, tma, pair_out);
  return cudaGetLastError();
}

// The padded head dims for (d, dv): 0 if no instantiation takes them.
int ring_dims(int d, int dv, int* dp, int* dvp) {
  if (d <= 64 && dv <= 64) *dp = 64, *dvp = 64;
  else if (d <= 128 && dv <= 128) *dp = 128, *dvp = 128;
  else if (d <= 192 && dv <= 128) *dp = 192, *dvp = 128;
  else if (d <= 256 && dv <= 256) *dp = 256, *dvp = 256;
  else return 0;
  return 1;
}

#define FA_TILES(X) X(64, 32) X(64, 64) X(128, 32) X(128, 64)

using LaunchFn = cudaError_t (*)(const void*, const void*, const void*,
                                 void*, int, int, int, int, int, int, float,
                                 int, int, int, int, int, int, cudaStream_t);

// One instantiation: its launch (nullptr if no body takes the arguments),
// which body it is (0 = the fp32 ring body, 1 = the wgmma body), its shared
// memory a block and its stages (chunk stages of the ring body, K/V tile
// stages of the wgmma body).
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

template <typename T, int BQ, int BKV, int DP, int DVP>
Body wgmma_body() {
  using W = Wg<BQ, BKV, DP, DVP>;
  return {launch_wgmma<T, BQ, BKV, DP, DVP>, 1, W::kSmem, W::kStages};
}

// The one place that picks the instantiation for a call: the launch runs
// what it returns and flash_attention_body reports it.
Body select_body(int dtype, int block_q, int block_kv, int d, int dv) {
  if (d <= 0 || dv <= 0 || d > kMaxHead || dv > kMaxValueHead) return {};
  int dp, dvp;
  if (!ring_dims(d, dv, &dp, &dvp)) return {};
  if (dtype == 0) {
#define FA_RING(BQ_, BKV_)                                                 \
  if (block_q == BQ_ && block_kv == BKV_)                                  \
    return dp == 64    ? ring_body<BQ_, BKV_, 64, 64>()                    \
           : dp == 128 ? ring_body<BQ_, BKV_, 128, 128>()                  \
           : dp == 192 ? ring_body<BQ_, BKV_, 192, 128>()                  \
                       : ring_body<BQ_, BKV_, 256, 256>();
    FA_TILES(FA_RING)
#undef FA_RING
    return {};
  }
#define FA_WGMMA(T_, BQ_, BKV_)                                            \
  if (block_q == BQ_ && block_kv == BKV_)                                  \
    return dp == 64    ? wgmma_body<T_, BQ_, BKV_, 64, 64>()               \
           : dp == 128 ? wgmma_body<T_, BQ_, BKV_, 128, 128>()             \
           : dp == 192 ? wgmma_body<T_, BQ_, BKV_, 192, 128>()             \
                       : wgmma_body<T_, BQ_, BKV_, 256, 256>();
  if (dtype == 1) {
#define FA_WGMMA_BF16(BQ_, BKV_) FA_WGMMA(__nv_bfloat16, BQ_, BKV_)
    FA_TILES(FA_WGMMA_BF16)
#undef FA_WGMMA_BF16
  }
  if (dtype == 2) {
#define FA_WGMMA_F16(BQ_, BKV_) FA_WGMMA(__half, BQ_, BKV_)
    FA_TILES(FA_WGMMA_F16)
#undef FA_WGMMA_F16
  }
#undef FA_WGMMA
  return {};
}

}  // namespace

extern "C" {

// q (bh, sq, d), k (bh / group, skv, d), v (bh / group, skv, dv) row-major
// of one dtype (0 = float32, 1 = bfloat16, 2 = float16), out (bh, sq, dv)
// row-major of dtype out_dtype.  P is rounded to dtype p_round before P.V.
// A bf16 or fp16 call takes p_round == out_dtype == dtype (the wgmma body);
// a float32 one any codes (the ring body: mixed inputs widened to fp32).
// has_window = 0 means no sliding window; else `window` is any integer.
// Returns the cudaError_t of the launch (0 = success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int bh, int sq, int skv, int d, int dv,
                        int group, float scale, int causal, int has_window,
                        int window, int q_offset, int dtype, int p_round,
                        int out_dtype, int block_q, int block_kv,
                        void* stream) {
  const Body body = select_body(dtype, block_q, block_kv, d, dv);
  const bool codes_ok =
      p_round >= 0 && p_round <= 2 && out_dtype >= 0 && out_dtype <= 2 &&
      (dtype == 0 || (p_round == dtype && out_dtype == dtype));
  if (bh <= 0 || sq <= 0 || skv <= 0 || group <= 0 || bh % group != 0 ||
      body.launch == nullptr || !codes_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(body.launch(
      q, k, v, out, bh, sq, skv, d, dv, group, scale, causal, has_window,
      window, q_offset, p_round, out_dtype,
      static_cast<cudaStream_t>(stream)));
}

// The body a call with these arguments runs (0 = the fp32 ring body, 1 =
// the wgmma body; -1 = none), its shared memory a block and its stages.
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
