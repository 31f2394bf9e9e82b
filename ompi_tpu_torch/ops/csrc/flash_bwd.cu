// Flash-attention backward for Hopper (sm_90a), CUDA C++: two kernels.
//
// Replaces: ompi_tpu/ops/flash_attention.py `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (the Pallas kernels launched by `_flash_bwd_raw`).
// Same functions.  For one batch*head, with s = q k^T * scale and the
// causal mask on GLOBAL positions q_offset + i >= k_offset + j (runtime
// ints, as in the forward):
//   p  = exp(s - lse), from the SAVED f32 lse, not renormalised;
//   dp = g v^T in f32;
//   ds = p * (dp - dm) * scale, rounded to q's dtype;
//   dq = ds k           (one block per q tile, K/V streamed: `dq` kernel);
//   dv = sum pc^T g     with pc = p rounded to g's dtype, and
//   dk = sum ds^T q     (one block per k tile, Q/G streamed: `dkv` kernel).
// dm = rowsum(g * out) - g_lse comes in precomputed (B*H, Tq) f32, beside
// lse; outputs are in the storage dtype.  The TPU's (BH, nq, 8, block_q)
// sublane layout of lse/dm is not carried over.
//
// Kept exactly as in the reference: masked scores are -1e30 and the mask
// is applied twice.  A fully masked row has lse ~ -1e30, so its masked
// s - lse is 0 and p would be 1; the second mask makes it 0.  Here both
// masks are one test: p = live ? exp(s * scale - lse) : 0.
//
// What bounds them on this card.  At the training shape (B*H = 256,
// T = 1024, D = 128, bf16, causal: 524,800 live pairs a head) dq does
// 6 * pairs * D = 103 GFLOP and moves ~337 MB (q, k, v, g read, dq
// written, lse/dm); dk/dv does 8 * pairs * D = 138 GFLOP and moves
// ~405 MB.  At H100 SXM peaks that is 104 us of tensor-core math against
// 101 us of HBM traffic for dq, 139 against 121 us for dk/dv: both sit
// on the line between the two bounds, with FLOPs slightly ahead.
//
// What the design does about it.  The two-kernel split of the reference
// stays: it is deterministic and needs no atomics on dq.  Each streamed
// K/V (or Q/G) element is read from HBM once per tile of the block's own
// rows and scores, weights and ds never leave the SM; tiles that the
// causal mask empties are skipped (K tiles above the diagonal in dq, Q
// tiles wholly before the k tile in dk/dv).
//
//   - dk/dv, bf16, D = 64 and 128 (the training path): Hopper's tensor
//     cores through wgmma, fed by TMA.  A block owns 128 keys, two
//     warpgroups of 64 key rows each.  Warp 0 loads the block's K and V
//     once (64 KB at D = 128) and the first two 64-query Q and G tiles of
//     a ring of 2 stages (32 KB each), 3-D TMA boxes of the (D, T, B*H)
//     tensors, 128-byte swizzled, completing on the stage's "full"
//     mbarrier (expect_tx); the warp's 32 lanes put the tile's lse (times
//     log2 e) and dm beside it and arrive on the same barrier.  A stage is
//     refilled the same way by the last of the 8 warps to finish with it
//     (a shared counter): no producer warpgroup, for the register reason
//     the forward's note gives.  A warpgroup computes S^T = K Q^T and
//     dP^T = V G^T (64 keys x 64 queries each) with wgmma m64n64k16 from
//     shared memory, K/V and Q/G all K-major; p = exp2(s * scale * log2 e
//     - lse * log2 e) and ds = p (dp - dm) scale run on the accumulator
//     registers, with the position test only on tiles that the diagonal
//     or the T edge crosses; then dV += P^T G and dK += dS^T Q with wgmma
//     m64nDk16, P^T and dS^T rounded to bf16 as register A operands and
//     the same staged G and Q tiles read MN-major (transpose bit): one
//     staged tile serves two products through two descriptors.  dK and dV
//     (64 f32 registers each a thread at D = 128), S^T and dP^T (32 each)
//     stay in registers (256 threads: up to 255 a thread).  The epilogue
//     rounds dK and dV into the warpgroup's own K and V tiles and stores
//     them with TMA; keys past T are dropped.  Shared memory: 128 KB at
//     D = 128, one block an SM.  A head's k tiles run side by side (Q and
//     G come from HBM about once, then from L2), the one with the most
//     live q tiles (the smallest k0) first.
//   - dq, bf16, D = 64 and 128: the same design turned round.  A block
//     owns 128 queries, two warpgroups of 64 query rows.  Thread 0 loads
//     the block's Q and G once (64 KB at D = 128) by 3-D TMA, 128-byte
//     swizzled, on one mbarrier, and the first two 128-key K/V tiles of a
//     ring of 2 stages (64 KB each); a stage is refilled by the last of
//     the 8 warps to release it.  Each thread keeps its two rows' lse
//     (times log2 e) and dm in registers.  A warpgroup computes S = Q K^T
//     and dP = G V^T (64 queries x 128 keys, wgmma m64n128k16, all
//     operands K-major), p and ds on the accumulators (the position test
//     only on tiles the diagonal or the T edge crosses), then dQ += dS K
//     with wgmma m64nDk16: dS rounded to bf16 as the register A operand,
//     the staged K tile read MN-major, the same tile S read K-major.  dQ
//     (64 f32 registers a thread at D = 128), S and dP (64 each) stay in
//     registers (220 a thread, no spill).  A block visits K tiles up to
//     its last live key; a warpgroup whose own last tile came earlier
//     skips the wgmmas but still waits for each stage, so its releases
//     never run a ring round ahead.  The epilogue rounds dQ into the
//     warpgroup's own Q tile and stores it with TMA; rows past T are
//     dropped.  Shared memory 192 KB at D = 128, one block an SM; a
//     head's q tiles run side by side (K and V from L2 after the first),
//     the heaviest (largest q0) first.  No atomics: dq stays
//     deterministic.
//   - dq and dk/dv at D = 16 and 32 (test sizes only), bf16: mma.sync
//     m16n8k16 tensor-core tiles (bf16 in, f32 accumulate), 4 warps of 16
//     rows each, streamed tiles copied with 16-byte cp.async into two
//     shared-memory stages.  In dq a warp owns 16 query rows; S = Q K^T
//     and dP = G V^T come out in the accumulator layout, which, rounded to
//     bf16, is the A operand of dS K, so ds never goes to shared memory;
//     K's B fragments come out transposed through ldmatrix.  In the small
//     dk/dv a warp owns 16 key rows and computes the transposed products
//     S^T = K Q^T and dP^T = V G^T, so P^T and dS^T are again A operands
//     in registers for P^T G and dS^T Q.  The streamed tile is worked
//     through 32 (dq) or 16 (dk/dv) columns at a time.
//   - f32: products on the f32 CUDA cores (tensor cores would round f32
//     inputs to TF32 and break float32 parity).  256 threads as 32 row
//     groups x 8 column lanes, as the forward; ds (and p for dv) go
//     through shared memory between the two products.
//
// All kernels allocate nothing, launch on the caller's stream and do not
// synchronise; the Hopper dq and dk/dv launches build their five and six
// tensor maps on the host first (cuTensorMapEncodeTiled through the
// runtime: no -lcuda), and return any error of the encoding or launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

constexpr int TILE = 64;   // rows of a block's own tile and of a streamed tile
// streamed columns a bf16 warp works on at a time: 32 keys in dq, 16
// queries in dk/dv, whose two (16 x D) f32 accumulators already take 128
// registers a thread at D = 128
constexpr int DQ_SUB = 32;
constexpr int DKV_SUB = 16;

// First Q tile a dk/dv block must visit: with a causal mask, tiles whose
// queries all come before the block's first key are skipped.  Returns the
// number of q tiles when none is live.
__device__ __forceinline__ int dkv_first_tile(int k0, int tq, int causal,
                                              int q_offset, int k_offset) {
  if (!causal) return 0;
  const int first_q = k_offset + k0 - q_offset;  // first query to see k0
  if (first_q >= tq) return (tq + TILE - 1) / TILE;
  return first_q <= 0 ? 0 : first_q / TILE;
}

// ---------------------------------------------------------------------------
// float32: CUDA-core kernels
// ---------------------------------------------------------------------------

constexpr int NT32 = 256;   // 32 row groups x 8 lanes; 2 rows a thread

// Stage rows [row0, row0 + TILE) of a (rows_total, D) matrix into shared
// memory with row stride D + 1; rows past the end are zero.
template <int D>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src,
                                               int row0, int rows_total) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < TILE * D; e += NT32) {
    const int r = e / D;
    const int c = e % D;
    const int g = row0 + r;
    dst[r * LD + c] = g < rows_total ? src[(size_t)g * D + c] : 0.0f;
  }
}

template <int D>
constexpr size_t dq_f32_smem() {
  return sizeof(float) * (size_t)(4 * TILE * (D + 1) + TILE * (TILE + 1));
}

template <int D>
__global__ void __launch_bounds__(NT32)
    bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      const float* __restrict__ lse,
                      const float* __restrict__ dm, float* __restrict__ dq,
                      int tq, int tk, float scale, int causal, int q_offset,
                      int k_offset) {
  constexpr int LD = D + 1;
  constexpr int LP = TILE + 1;
  constexpr int DPT = D / 8;
  extern __shared__ float smem[];
  float* qs = smem;              // TILE x LD
  float* gs = qs + TILE * LD;    // TILE x LD
  float* ks = gs + TILE * LD;    // TILE x LD
  float* vs = ks + TILE * LD;    // TILE x LD
  float* dss = vs + TILE * LD;   // TILE x LP: ds of this K tile

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  const int lane = threadIdx.x & 7;
  const int row = (threadIdx.x >> 3) * 2;   // first local row of mine
  const float* kb = k + (size_t)bh * tk * D;
  const float* vb = v + (size_t)bh * tk * D;

  stage_rows_f32<D>(qs, q + (size_t)bh * tq * D, q0, tq);
  stage_rows_f32<D>(gs, g + (size_t)bh * tq * D, q0, tq);

  float lse_r[2], dm_r[2], acc[2][DPT];
  int qpos[2];
  bool qin[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + row + i;
    qin[i] = r < tq;
    lse_r[i] = qin[i] ? lse[(size_t)bh * tq + r] : 0.0f;
    dm_r[i] = qin[i] ? dm[(size_t)bh * tq + r] : 0.0f;
    qpos[i] = q_offset + r;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.0f;
  }

  const int n_tiles = live_tiles(q0, TILE, TILE, tq, tk, causal, q_offset,
                                 k_offset);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TILE;
    __syncthreads();  // previous tile's K/V/ds reads are done
    stage_rows_f32<D>(ks, kb, k0, tk);
    stage_rows_f32<D>(vs, vb, k0, tk);
    __syncthreads();

    float s[2][8], dp[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[2], gv[2], kv[8], vv[8];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        qv[i] = qs[(row + i) * LD + d];
        gv[i] = gs[(row + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kv[j] = ks[(lane + 8 * j) * LD + d];
        vv[j] = vs[(lane + 8 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + lane + 8 * j;
        const bool live = qin[i] && key < tk &&
                          (!causal || qpos[i] >= k_offset + key);
        const float p = live ? expf(s[i][j] * scale - lse_r[i]) : 0.0f;
        dss[(row + i) * LP + lane + 8 * j] = p * (dp[i][j] - dm_r[i]) * scale;
      }
    __syncthreads();  // ds tile complete

    const int kn = min(TILE, tk - k0);
    for (int c = 0; c < kn; ++c) {
      float dsv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) dsv[i] = dss[(row + i) * LP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float kval = ks[c * LD + lane + 8 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i) acc[i][j] = fmaf(dsv[i], kval, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!qin[i]) continue;
    float* orow = dq + ((size_t)bh * tq + q0 + row + i) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[lane + 8 * j] = acc[i][j];
  }
}

template <int D>
constexpr size_t dkv_f32_smem() {
  return sizeof(float) *
         (size_t)(4 * TILE * (D + 1) + 2 * TILE * (TILE + 1) + 2 * TILE);
}

template <int D>
__global__ void __launch_bounds__(NT32)
    bwd_dkv_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ g,
                       const float* __restrict__ lse,
                       const float* __restrict__ dm, float* __restrict__ dk,
                       float* __restrict__ dv, int tq, int tk, float scale,
                       int causal, int q_offset, int k_offset) {
  constexpr int LD = D + 1;
  constexpr int LP = TILE + 1;
  constexpr int DPT = D / 8;
  extern __shared__ float smem[];
  float* ks = smem;              // TILE x LD, this block's keys
  float* vs = ks + TILE * LD;    // TILE x LD
  float* qs = vs + TILE * LD;    // TILE x LD, streamed
  float* gs = qs + TILE * LD;    // TILE x LD, streamed
  float* ps = gs + TILE * LD;    // TILE x LP: p^T (keys x queries)
  float* dss = ps + TILE * LP;   // TILE x LP: ds^T
  float* ls = dss + TILE * LP;   // TILE: lse of the streamed queries
  float* dms = ls + TILE;        // TILE: dm of the streamed queries

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * TILE;
  const int lane = threadIdx.x & 7;
  const int row = (threadIdx.x >> 3) * 2;   // first local key row of mine
  const float* qb = q + (size_t)bh * tq * D;
  const float* gb = g + (size_t)bh * tq * D;

  stage_rows_f32<D>(ks, k + (size_t)bh * tk * D, k0, tk);
  stage_rows_f32<D>(vs, v + (size_t)bh * tk * D, k0, tk);

  float dk_[2][DPT], dv_[2][DPT];
  int kpos[2];
  bool kin[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kin[i] = k0 + row + i < tk;
    kpos[i] = k_offset + k0 + row + i;
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk_[i][j] = dv_[i][j] = 0.0f;
  }

  const int n_qt = (tq + TILE - 1) / TILE;
  for (int t = dkv_first_tile(k0, tq, causal, q_offset, k_offset); t < n_qt;
       ++t) {
    const int qq0 = t * TILE;
    __syncthreads();  // previous tile's reads are done
    stage_rows_f32<D>(qs, qb, qq0, tq);
    stage_rows_f32<D>(gs, gb, qq0, tq);
    if (threadIdx.x < TILE) {
      const int r = qq0 + threadIdx.x;
      ls[threadIdx.x] = r < tq ? lse[(size_t)bh * tq + r] : 0.0f;
      dms[threadIdx.x] = r < tq ? dm[(size_t)bh * tq + r] : 0.0f;
    }
    __syncthreads();

    // s^T, dp^T: my 2 key rows x the 8 query columns lane + 8j
    float s[2][8], dp[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[2], vv[2], qv[8], gv[8];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        kv[i] = ks[(row + i) * LD + d];
        vv[i] = vs[(row + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        qv[j] = qs[(lane + 8 * j) * LD + d];
        gv[j] = gs[(lane + 8 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = lane + 8 * j;
        const int qi = qq0 + c;
        const bool live = kin[i] && qi < tq &&
                          (!causal || q_offset + qi >= kpos[i]);
        const float p = live ? expf(s[i][j] * scale - ls[c]) : 0.0f;
        ps[(row + i) * LP + c] = p;
        dss[(row + i) * LP + c] = p * (dp[i][j] - dms[c]) * scale;
      }
    __syncthreads();  // p^T and ds^T complete

    const int qn = min(TILE, tq - qq0);
    for (int c = 0; c < qn; ++c) {
      float pv[2], dsv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        pv[i] = ps[(row + i) * LP + c];
        dsv[i] = dss[(row + i) * LP + c];
      }
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float gval = gs[c * LD + lane + 8 * j];
        const float qval = qs[c * LD + lane + 8 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dv_[i][j] = fmaf(pv[i], gval, dv_[i][j]);
          dk_[i][j] = fmaf(dsv[i], qval, dk_[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!kin[i]) continue;
    const size_t off = ((size_t)bh * tk + k0 + row + i) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      dk[off + lane + 8 * j] = dk_[i][j];
      dv[off + lane + 8 * j] = dv_[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 at D = 16 and 32, dq and dk/dv: mma.sync m16n8k16 tensor-core
// kernels
// ---------------------------------------------------------------------------

constexpr int NT16 = 128;   // 4 warps x 16 rows

// Start the copy of rows [row0, row0 + TILE) of a (rows_total, D) matrix
// into shared memory (row stride D + 8 elements: a warp's fragment loads
// hit 32 distinct banks, and rows stay 16-byte aligned for ldmatrix);
// rows past the end are zero-filled.  The caller commits the group.
template <int D>
__device__ __forceinline__ void stage_rows_bf16(bf16* dst, const bf16* src,
                                                int row0, int rows_total) {
  constexpr int LD = D + 8;
  constexpr int C8 = D / 8;         // 16-byte chunks a row
  for (int e = threadIdx.x; e < TILE * C8; e += NT16) {
    const int r = e / C8, c = (e % C8) * 8;
    const bool in = row0 + r < rows_total;
    cp_async16(dst + r * LD + c, src + (size_t)(in ? row0 + r : 0) * D + c,
               in ? 16 : 0);
  }
}

// A fragment of rows [r, r + 16) x cols [c, c + 16) of a staged tile
// (row stride LD) through ldmatrix; `tile` points at (r, c).  Reloaded for
// every sub-step rather than held: the block's own K/V (or Q/G) fragments
// over the whole head dim would take 64 registers at D = 128.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* tile) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + (lane & 15) * LD + (lane >> 4) * 8);
}

template <int D>
constexpr size_t dq_bf16_small_smem() {
  return sizeof(bf16) * (size_t)(2 * TILE * (D + 8)       // Q, G
                                 + 2 * 2 * TILE * (D + 8));  // 2 x (K, V)
}

template <int D>
__global__ void __launch_bounds__(NT16)
    bwd_dq_bf16_small_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ g,
                             const float* __restrict__ lse,
                             const float* __restrict__ dm,
                             bf16* __restrict__ dq, int tq, int tk,
                             float scale, int causal, int q_offset,
                             int k_offset) {
  constexpr int KS = D / 16;        // k-steps over the head dim
  constexpr int NDQ_SUB = DQ_SUB / 8;   // 8-key column tiles a sub-step
  constexpr int NO = D / 8;         // 8-wide column tiles of dq
  constexpr int LD = D + 8;
  constexpr int STAGE = 2 * TILE * LD;  // one stage: K tile then V tile
  extern __shared__ __align__(16) uint16_t smem16[];
  bf16* qs = reinterpret_cast<bf16*>(smem16);
  bf16* gs = qs + TILE * LD;
  bf16* stages = gs + TILE * LD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;         // fragment row group
  const int c2 = (lane & 3) * 2;    // fragment column pair
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  const int wr = warp * 16;         // my first local row
  const int r0 = q0 + wr + gq;      // my rows: r0 and r0 + 8
  const bf16* kb = k + (size_t)bh * tk * D;
  const bf16* vb = v + (size_t)bh * tk * D;

  const int n_tiles = live_tiles(q0, TILE, TILE, tq, tk, causal, q_offset,
                                 k_offset);
  if (n_tiles > 0) {
    stage_rows_bf16<D>(qs, q + (size_t)bh * tq * D, q0, tq);
    stage_rows_bf16<D>(gs, g + (size_t)bh * tq * D, q0, tq);
    cp_async_commit();
    stage_rows_bf16<D>(stages, kb, 0, tk);
    stage_rows_bf16<D>(stages + TILE * LD, vb, 0, tk);
    cp_async_commit();
  }

  float lse_r[2], dm_r[2];
  int qpos[2];
  bool qin[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    qin[h] = r < tq;
    lse_r[h] = qin[h] ? lse[(size_t)bh * tq + r] : 0.0f;
    dm_r[h] = qin[h] ? dm[(size_t)bh * tq + r] : 0.0f;
    qpos[h] = q_offset + r;
  }
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TILE;
    // everyone is done with the stage tile t+1 will overwrite (tile t-1)
    __syncthreads();
    if (t + 1 < n_tiles) {
      bf16* nxt = stages + ((t + 1) & 1) * STAGE;
      stage_rows_bf16<D>(nxt, kb, k0 + TILE, tk);
      stage_rows_bf16<D>(nxt + TILE * LD, vb, k0 + TILE, tk);
      cp_async_commit();
      cp_async_wait<1>();           // Q/G and tile t have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = stages + (t & 1) * STAGE;
    const bf16* vs = ks + TILE * LD;

#pragma unroll
    for (int sub = 0; sub < TILE / DQ_SUB; ++sub) {
      const int kc0 = sub * DQ_SUB;  // first local key of this sub-step
      // S = Q K^T and dP = G V^T for my 16 rows x DQ_SUB keys, in the
      // accumulator layout: [n][0..1] row r0, keys kc0 + n*8 + c2 + {0,1};
      // [n][2..3] row r0 + 8
      float s[NDQ_SUB][4], dp[NDQ_SUB][4];
#pragma unroll
      for (int n = 0; n < NDQ_SUB; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] =
            dp[n][2] = dp[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[4], ga[4];
        load_a<LD>(qa, qs + wr * LD + kk * 16);
        load_a<LD>(ga, gs + wr * LD + kk * 16);
#pragma unroll
        for (int n = 0; n < NDQ_SUB; ++n) {
          const int off = (kc0 + n * 8 + gq) * LD + kk * 16 + c2;
          mma_16816(s[n], qa, ld32(ks + off), ld32(ks + off + 8));
          mma_16816(dp[n], ga, ld32(vs + off), ld32(vs + off + 8));
        }
      }
      // ds = p (dp - dm) scale, in place of s
#pragma unroll
      for (int n = 0; n < NDQ_SUB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kc0 + n * 8 + c2 + (e & 1);
          const int h = e >> 1;
          const bool live = qin[h] && key < tk &&
                            (!causal || qpos[h] >= k_offset + key);
          const float p = live ? expf(s[n][e] * scale - lse_r[h]) : 0.0f;
          s[n][e] = p * (dp[n][e] - dm_r[h]) * scale;
        }
      // dq += ds K: the ds accumulators of key tiles 2c, 2c+1, rounded to
      // bf16, are the A fragment of key chunk c; K's B fragments come
      // from the row-major tile through ldmatrix.trans
#pragma unroll
      for (int c = 0; c < DQ_SUB / 16; ++c) {
        const uint32_t da[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                                pack_bf16(s[2 * c][2], s[2 * c][3]),
                                pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                                pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
        const bf16* krow =
            ks + (kc0 + c * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
            (lane >> 4) * 8;
#pragma unroll
        for (int j = 0; j < NO; j += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, krow + j * 8);
          mma_16816(acc[j], da, b[0], b[1]);
          mma_16816(acc[j + 1], da, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!qin[h]) continue;
    bf16* orow = dq + ((size_t)bh * tq + r0 + 8 * h) * D + c2;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

template <int D>
constexpr size_t dkv_bf16_smem() {
  return sizeof(bf16) * (size_t)(2 * TILE * (D + 8)          // K, V
                                 + 2 * 2 * TILE * (D + 8))   // 2 x (Q, G)
         + sizeof(float) * 2 * 2 * TILE;                     // 2 x (lse, dm)
}

template <int D>
__global__ void __launch_bounds__(NT16)
    bwd_dkv_bf16_small_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ dm, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int tq, int tk, float scale,
                        int causal, int q_offset, int k_offset) {
  constexpr int KS = D / 16;
  constexpr int NDKV_SUB = DKV_SUB / 8;  // 8-query column tiles a sub-step
  constexpr int NO = D / 8;
  constexpr int LD = D + 8;
  constexpr int STAGE = 2 * TILE * LD;  // one stage: Q tile then G tile
  extern __shared__ __align__(16) uint16_t smem16[];
  bf16* ks = reinterpret_cast<bf16*>(smem16);
  bf16* vs = ks + TILE * LD;
  bf16* stages = vs + TILE * LD;
  float* ls = reinterpret_cast<float*>(stages + 2 * STAGE);  // 2 x TILE
  float* dms = ls + 2 * TILE;                                // 2 x TILE

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gk = lane >> 2;
  const int c2 = (lane & 3) * 2;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * TILE;
  const int wk = warp * 16;         // my first local key row
  const int kr0 = k0 + wk + gk;     // my keys: kr0 and kr0 + 8
  const bf16* qb = q + (size_t)bh * tq * D;
  const bf16* gb = g + (size_t)bh * tq * D;
  const float* lb = lse + (size_t)bh * tq;
  const float* mb = dm + (size_t)bh * tq;

  const int n_qt = (tq + TILE - 1) / TILE;
  const int t0 = dkv_first_tile(k0, tq, causal, q_offset, k_offset);
  const int n_live = n_qt - t0;

  // Q/G tile `t` into stage `st` (cp.async, committed); its lse and dm by
  // plain loads, visible after the next __syncthreads
  auto stage_q = [&](int t, int st) {
    bf16* dst = stages + st * STAGE;
    stage_rows_bf16<D>(dst, qb, t * TILE, tq);
    stage_rows_bf16<D>(dst + TILE * LD, gb, t * TILE, tq);
    cp_async_commit();
    if (threadIdx.x < TILE) {
      const int r = t * TILE + threadIdx.x;
      ls[st * TILE + threadIdx.x] = r < tq ? lb[r] : 0.0f;
      dms[st * TILE + threadIdx.x] = r < tq ? mb[r] : 0.0f;
    }
  };
  if (n_live > 0) {
    stage_rows_bf16<D>(ks, k + (size_t)bh * tk * D, k0, tk);
    stage_rows_bf16<D>(vs, v + (size_t)bh * tk * D, k0, tk);
    cp_async_commit();
    stage_q(t0, 0);
  }

  int kpos[2];
  bool kin[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    kin[h] = kr0 + 8 * h < tk;
    kpos[h] = k_offset + kr0 + 8 * h;
  }
  float dk_[NO][4], dv_[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_[j][e] = dv_[j][e] = 0.0f;

  for (int it = 0; it < n_live; ++it) {
    const int qq0 = (t0 + it) * TILE;
    __syncthreads();  // everyone is done with the stage about to refill
    if (it + 1 < n_live) {
      stage_q(t0 + it + 1, (it + 1) & 1);
      cp_async_wait<1>();           // K/V and this tile have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qs = stages + (it & 1) * STAGE;
    const bf16* gs = qs + TILE * LD;
    const float* lt = ls + (it & 1) * TILE;
    const float* mt = dms + (it & 1) * TILE;

#pragma unroll
    for (int sub = 0; sub < TILE / DKV_SUB; ++sub) {
      const int qc0 = sub * DKV_SUB;  // first local query of the sub-step
      // S^T = K Q^T and dP^T = V G^T for my 16 keys x DKV_SUB queries:
      // [n][0..1] key kr0, queries qc0 + n*8 + c2 + {0,1}; [n][2..3] key
      // kr0 + 8
      float s[NDKV_SUB][4], dp[NDKV_SUB][4];
#pragma unroll
      for (int n = 0; n < NDKV_SUB; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] =
            dp[n][2] = dp[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        load_a<LD>(ka, ks + wk * LD + kk * 16);
        load_a<LD>(va, vs + wk * LD + kk * 16);
#pragma unroll
        for (int n = 0; n < NDKV_SUB; ++n) {
          const int off = (qc0 + n * 8 + gk) * LD + kk * 16 + c2;
          mma_16816(s[n], ka, ld32(qs + off), ld32(qs + off + 8));
          mma_16816(dp[n], va, ld32(gs + off), ld32(gs + off + 8));
        }
      }
      // p^T in s, ds^T in dp
#pragma unroll
      for (int n = 0; n < NDKV_SUB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = qc0 + n * 8 + c2 + (e & 1);
          const int qi = qq0 + c;
          const int h = e >> 1;
          const bool live = kin[h] && qi < tq &&
                            (!causal || q_offset + qi >= kpos[h]);
          const float p = live ? expf(s[n][e] * scale - lt[c]) : 0.0f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - mt[c]) * scale;
        }
      // dv += P^T G and dk += dS^T Q over query chunks of 16: P^T and dS^T
      // rounded to bf16 are the A fragments; G's and Q's B fragments come
      // from the row-major tiles through ldmatrix.trans
#pragma unroll
      for (int c = 0; c < DKV_SUB / 16; ++c) {
        const uint32_t pa[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                                pack_bf16(s[2 * c][2], s[2 * c][3]),
                                pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                                pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
        const uint32_t da[4] = {pack_bf16(dp[2 * c][0], dp[2 * c][1]),
                                pack_bf16(dp[2 * c][2], dp[2 * c][3]),
                                pack_bf16(dp[2 * c + 1][0], dp[2 * c + 1][1]),
                                pack_bf16(dp[2 * c + 1][2], dp[2 * c + 1][3])};
        const int trow =
            (qc0 + c * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
            (lane >> 4) * 8;
#pragma unroll
        for (int j = 0; j < NO; j += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, gs + trow + j * 8);
          mma_16816(dv_[j], pa, b[0], b[1]);
          mma_16816(dv_[j + 1], pa, b[2], b[3]);
          ldmatrix_x4_trans(b, qs + trow + j * 8);
          mma_16816(dk_[j], da, b[0], b[1]);
          mma_16816(dk_[j + 1], da, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!kin[h]) continue;
    const size_t off = ((size_t)bh * tk + kr0 + 8 * h) * D + c2;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + j * 8) =
          pack_bf16(dk_[j][2 * h], dk_[j][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + j * 8) =
          pack_bf16(dv_[j][2 * h], dv_[j][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 dk/dv, D = 64 and 128: warp-specialised wgmma kernel fed by TMA
// ---------------------------------------------------------------------------

namespace hp = hopper;

constexpr int WG = 128;               // threads a warpgroup
// two warpgroups and no producer warp, for the register reason in
// flash_fwd.cu
constexpr int HOP_THREADS = 2 * WG;
constexpr int HKEYS = 128;            // keys a block, 64 a warpgroup
constexpr int HSTAGES = 2;            // Q/G stages in the ring

// Shared memory of the Hopper dk/dv kernel, in bytes from a 1024-aligned
// base: K and V of the block (each two 64-row halves, one a warpgroup),
// then the ring of Q tiles, of G tiles, of lse and of dm rows.
template <int D>
struct DkvSmem {
  static constexpr uint32_t SUB = 64 * 128;    // 64 rows x 64 columns
  static constexpr uint32_t T64 = 64 * D * 2;  // a 64-row tile
  static constexpr uint32_t K = 0;
  static constexpr uint32_t V = K + 2 * T64;
  static constexpr uint32_t Q = V + 2 * T64;
  static constexpr uint32_t G = Q + HSTAGES * T64;
  static constexpr uint32_t L = G + HSTAGES * T64;   // f32 [HSTAGES][64]
  static constexpr uint32_t M = L + HSTAGES * 64 * 4;
  static constexpr uint32_t BARS = M + HSTAGES * 64 * 4;
  // kv_full, full[HSTAGES]; released[HSTAGES] (int); 1024 bytes of
  // alignment slack
  static constexpr uint32_t RELEASED = BARS + 8 * (1 + HSTAGES);
  static constexpr uint32_t BYTES = RELEASED + 4 * HSTAGES + 1024;
};

// Q/G tile `t` (64 queries) into ring stage `st`, by one whole warp:
// lane 0 issues the TMA copies, the 32 lanes put the tile's lse (times
// log2 e) and dm beside them; all complete on full[st] (1 + 32 arrivals)
template <int D>
__device__ __forceinline__ void load_qg(uint8_t* smem, uint64_t* full,
                                        const CUtensorMap* qmap,
                                        const CUtensorMap* gmap,
                                        const float* lb, const float* mb,
                                        int t, int st, int bh, int tq) {
  using S = DkvSmem<D>;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    hp::mbar_expect_tx(&full[st], 2 * S::T64);
#pragma unroll
    for (int s = 0; s < D / 64; ++s) {
      hp::tma_load_3d(smem + S::Q + st * S::T64 + s * S::SUB, qmap,
                      &full[st], 64 * s, t * TILE, bh);
      hp::tma_load_3d(smem + S::G + st * S::T64 + s * S::SUB, gmap,
                      &full[st], 64 * s, t * TILE, bh);
    }
  }
  float* ls = reinterpret_cast<float*>(smem + S::L) + st * TILE;
  float* ms = reinterpret_cast<float*>(smem + S::M) + st * TILE;
  for (int i = lane; i < TILE; i += 32) {
    const int r = t * TILE + i;
    ls[i] = r < tq ? lb[r] * hp::LOG2E : 0.0f;
    ms[i] = r < tq ? mb[r] : 0.0f;
  }
  hp::mbar_arrive(&full[st]);
}

template <int D>
__global__ void __launch_bounds__(HOP_THREADS, 1)
    bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap gmap,
                        const __grid_constant__ CUtensorMap dkmap,
                        const __grid_constant__ CUtensorMap dvmap,
                        const float* __restrict__ lse,
                        const float* __restrict__ dm, int tq, int tk,
                        float scale, int causal, int q_offset, int k_offset) {
  using S = DkvSmem<D>;
  constexpr int NSUB = D / 64;        // 64-column sub-tiles a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hp::smem_aligned_1024(smem_raw);
  const float* ls = reinterpret_cast<const float*>(smem + S::L);
  const float* ms = reinterpret_cast<const float*>(smem + S::M);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = kv_full + 1;
  int* released = reinterpret_cast<int*>(smem + S::RELEASED);

  // a head's k tiles run side by side, so its Q and G stay in L2 between
  // them; the heaviest (smallest k0: the most live q tiles) first
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * HKEYS;
  const int t0 = dkv_first_tile(k0, tq, causal, q_offset, k_offset);
  const int n_live = (tq + TILE - 1) / TILE - t0;
  const int wg = threadIdx.x / WG;
  const int tid = threadIdx.x % WG;
  const int lane = tid & 31;
  const float* lb = lse + (size_t)bh * tq;
  const float* mb = dm + (size_t)bh * tq;

  if (threadIdx.x == 0) {
    hp::mbar_init(kv_full, 1);
    for (int s = 0; s < HSTAGES; ++s) {
      hp::mbar_init(&full[s], 1 + 32);  // expect_tx, then the 32 lanes
      released[s] = 0;
    }
    hp::fence_barrier_init();
  }
  __syncthreads();
  // the block's K and V, and the first Q/G tiles, by warp 0; later tiles
  // are loaded by the last warp to release a stage (below), so no thread
  // ever waits for a free stage
  if (threadIdx.x < 32 && n_live > 0) {
    if (lane == 0) {
      hp::mbar_expect_tx(kv_full, 4 * S::T64);
      for (int w = 0; w < 2; ++w)
        for (int s = 0; s < NSUB; ++s) {
          hp::tma_load_3d(smem + S::K + w * S::T64 + s * S::SUB, &kmap,
                          kv_full, 64 * s, k0 + 64 * w, bh);
          hp::tma_load_3d(smem + S::V + w * S::T64 + s * S::SUB, &vmap,
                          kv_full, 64 * s, k0 + 64 * w, bh);
        }
    }
    for (int it = 0; it < min(n_live, HSTAGES); ++it)
      load_qg<D>(smem, full, &qmap, &gmap, lb, mb, t0 + it, it, bh, tq);
  }

  // warpgroup `wg`: 64 key rows
  const int row = (tid >> 5) * 16 + (lane >> 2);  // my keys: row, row + 8
  const int c2 = (lane & 3) * 2;
  const int kw0 = k0 + 64 * wg;                  // my warpgroup's first key
  uint8_t* k_wg = smem + S::K + wg * S::T64;
  uint8_t* v_wg = smem + S::V + wg * S::T64;
  const int kpos[2] = {k_offset + kw0 + row, k_offset + kw0 + row + 8};
  const float c_log2 = scale * hp::LOG2E;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;

  if (n_live > 0) hp::mbar_wait(kv_full, 0);
  for (int it = 0; it < n_live; ++it) {
    const int st = it % HSTAGES;
    const int qq0 = (t0 + it) * TILE;
    hp::mbar_wait(&full[st], (it / HSTAGES) & 1);
    const uint8_t* qs = smem + S::Q + st * S::T64;
    const uint8_t* gs = smem + S::G + st * S::T64;
    const float* lt = ls + st * TILE;
    const float* mt = ms + st * TILE;

    // S^T = K Q^T and dP^T = V G^T, 64 keys x 64 queries each, in the
    // accumulator layout: [4j + e] = (key row + 8 * (e / 2), query
    // qq0 + 8j + c2 + e % 2)
    float s[32], dp[32];
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hp::Wgmma<64>::ss(s, hp::desc_k(k_wg, kk, S::SUB),
                        hp::desc_k(qs, kk, S::SUB), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hp::Wgmma<64>::ss(dp, hp::desc_k(v_wg, kk, S::SUB),
                        hp::desc_k(gs, kk, S::SUB), kk > 0);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(s);
    hp::fence_regs(dp);

    // p^T in s, ds^T in dp; the position test (both masks of the
    // reference, as one) only where the T edge or the diagonal crosses
    // the tile for some of my keys
    const bool edge = qq0 + TILE > tq ||
                      (causal && q_offset + qq0 < k_offset + kw0 + 63);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = (i >> 2) * 8 + c2 + (i & 1);
      float p = hp::ex2(fmaf(s[i], c_log2, -lt[col]));
      if (edge) {
        const int qi = qq0 + col;
        if (qi >= tq || (causal && q_offset + qi < kpos[(i >> 1) & 1]))
          p = 0.0f;
      }
      s[i] = p;
      dp[i] = p * (dp[i] - mt[col]) * scale;
    }

    // dV += P^T G and dK += dS^T Q: P^T and dS^T rounded to bf16 are
    // register A operands, 16 queries a k-step; the staged G and Q tiles
    // (queries x D, D contiguous) are read MN-major
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      hp::acc_to_a(pa[c], s, c);
      hp::acc_to_a(da[c], dp, c);
    }
    hp::wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c)
      hp::Wgmma<D>::rs(dv, pa[c], hp::desc_mn(gs, c, S::SUB), 1);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      hp::Wgmma<D>::rs(dk, da[c], hp::desc_mn(qs, c, S::SUB), 1);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(dv);
    hp::fence_regs(dk);
    hp::fence_regs(pa);
    hp::fence_regs(da);

    // the last of the 8 warps done with the stage refills it (the whole
    // warp: TMA copies, lse and dm)
    if (hp::last_to_release(&released[st], HOP_THREADS / 32) &&
        it + HSTAGES < n_live)
      load_qg<D>(smem, full, &qmap, &gmap, lb, mb, t0 + it + HSTAGES, st, bh,
                 tq);
  }

  // epilogue: dK and dV in bf16 into my K and V tiles (their last reader
  // was my last wgmma), then TMA stores; keys past tk are dropped
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      hp::st_swizzled(k_wg, row + 8 * h, 8 * j + c2, S::SUB,
                      pack_bf16(dk[4 * j + 2 * h], dk[4 * j + 2 * h + 1]));
      hp::st_swizzled(v_wg, row + 8 * h, 8 * j + c2, S::SUB,
                      pack_bf16(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]));
    }
  hp::fence_proxy_async();
  hp::named_sync(1 + wg, WG);
  if (tid == 0) {
    for (int s = 0; s < NSUB; ++s) {
      hp::tma_store_3d(&dkmap, k_wg + s * S::SUB, 64 * s, kw0, bh);
      hp::tma_store_3d(&dvmap, v_wg + s * S::SUB, 64 * s, kw0, bh);
    }
    hp::tma_store_drain();
  }
}

// ---------------------------------------------------------------------------
// bfloat16 dq, D = 64 and 128: wgmma kernel fed by TMA
// ---------------------------------------------------------------------------

constexpr int DQ_ROWS = 128;          // queries a block, 64 a warpgroup
// keys a K/V ring stage and stages in the ring (on an H100 SXM 64-key
// stages were slower, two or three of them; three 128-key stages do not
// fit in shared memory)
constexpr int DQ_BK = 128;
constexpr int DQ_STAGES = 2;

// Shared memory of the Hopper dq kernel, in bytes from a 1024-aligned
// base: Q and G of the block (each two 64-row halves, one a warpgroup),
// then the ring of K/V stages.
template <int D>
struct DqSmem {
  static constexpr uint32_t SUB = 64 * 128;        // 64 rows x 64 columns
  static constexpr uint32_t T64 = 64 * D * 2;      // a warpgroup's rows
  static constexpr uint32_t KV_SUB = DQ_BK * 128;  // DQ_BK keys x 64 cols
  static constexpr uint32_t KV = DQ_BK * D * 2;    // a K (or V) tile
  static constexpr uint32_t STAGE = 2 * KV;        // K tile, then V tile
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t G = Q + 2 * T64;
  static constexpr uint32_t RING = G + 2 * T64;
  static constexpr uint32_t BARS = RING + DQ_STAGES * STAGE;
  // qg_full, full[DQ_STAGES]; released[DQ_STAGES] (int); 1024 bytes of
  // alignment slack
  static constexpr uint32_t RELEASED = BARS + 8 * (1 + DQ_STAGES);
  static constexpr uint32_t BYTES = RELEASED + 4 * DQ_STAGES + 1024;
};

// K/V tile `t` into ring stage `st`, completing on full[st] (one thread)
template <int D>
__device__ __forceinline__ void load_dq_kv(uint8_t* smem, uint64_t* full,
                                           const CUtensorMap* kmap,
                                           const CUtensorMap* vmap, int t,
                                           int st, int bh) {
  using S = DqSmem<D>;
  uint8_t* ks = smem + S::RING + st * S::STAGE;
  hp::mbar_expect_tx(&full[st], S::STAGE);
#pragma unroll
  for (int s = 0; s < D / 64; ++s) {
    hp::tma_load_3d(ks + s * S::KV_SUB, kmap, &full[st], 64 * s, t * DQ_BK,
                    bh);
    hp::tma_load_3d(ks + S::KV + s * S::KV_SUB, vmap, &full[st], 64 * s,
                    t * DQ_BK, bh);
  }
}

template <int D>
__global__ void __launch_bounds__(HOP_THREADS, 1)
    bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap gmap,
                       const __grid_constant__ CUtensorMap dqmap,
                       const float* __restrict__ lse,
                       const float* __restrict__ dm, int tq, int tk,
                       float scale, int causal, int q_offset, int k_offset) {
  using S = DqSmem<D>;
  constexpr int NSUB = D / 64;        // 64-column sub-tiles a row
  constexpr int NS = DQ_BK / 2;       // S (and dP) accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hp::smem_aligned_1024(smem_raw);
  uint64_t* qg_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = qg_full + 1;
  int* released = reinterpret_cast<int*>(smem + S::RELEASED);

  // a head's q tiles run side by side, so its K/V stays in L2 between
  // them; the heaviest (largest q0) first
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * DQ_ROWS;
  const int n_tiles = live_tiles(q0, DQ_ROWS, DQ_BK, tq, tk, causal,
                                 q_offset, k_offset);
  const int wg = threadIdx.x / WG;
  const int tid = threadIdx.x % WG;
  const int lane = tid & 31;
  const int wq0 = q0 + 64 * wg;                  // my warpgroup's first row
  // my warpgroup's live tiles: the lower one may end a tile earlier
  const int n_mine = wq0 < tq ? live_tiles(wq0, 64, DQ_BK, tq, tk, causal,
                                           q_offset, k_offset)
                              : 0;

  if (threadIdx.x == 0) {
    hp::mbar_init(qg_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      released[s] = 0;
    }
    hp::fence_barrier_init();
  }
  __syncthreads();
  // Q and G of the block and the first K/V tiles; later tiles are issued
  // by the last warp to release a stage (below), so no thread ever waits
  // for a free stage
  if (threadIdx.x == 0 && n_tiles > 0) {
    hp::mbar_expect_tx(qg_full, 4 * S::T64);
    for (int w = 0; w < 2; ++w)
      for (int s = 0; s < NSUB; ++s) {
        hp::tma_load_3d(smem + S::Q + w * S::T64 + s * S::SUB, &qmap,
                        qg_full, 64 * s, q0 + 64 * w, bh);
        hp::tma_load_3d(smem + S::G + w * S::T64 + s * S::SUB, &gmap,
                        qg_full, 64 * s, q0 + 64 * w, bh);
      }
    for (int t = 0; t < min(n_tiles, DQ_STAGES); ++t)
      load_dq_kv<D>(smem, full, &kmap, &vmap, t, t, bh);
  }

  // warpgroup `wg`: 64 query rows; lse (times log2 e) and dm of my two
  // rows in registers (rows past tq read 0: their dq is dropped)
  const int row = (tid >> 5) * 16 + (lane >> 2);  // my rows: row, row + 8
  const int c2 = (lane & 3) * 2;
  uint8_t* q_wg = smem + S::Q + wg * S::T64;
  const uint8_t* g_wg = smem + S::G + wg * S::T64;
  const int qpos[2] = {q_offset + wq0 + row, q_offset + wq0 + row + 8};
  float lse2[2], dmr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wq0 + row + 8 * h;
    lse2[h] = r < tq ? lse[(size_t)bh * tq + r] * hp::LOG2E : 0.0f;
    dmr[h] = r < tq ? dm[(size_t)bh * tq + r] : 0.0f;
  }
  const float c_log2 = scale * hp::LOG2E;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;

  if (n_tiles > 0) hp::mbar_wait(qg_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % DQ_STAGES;
    const int k0 = t * DQ_BK;
    // a warpgroup past its last live tile still waits for the stage, so
    // its releases never run a ring round ahead of the other's
    hp::mbar_wait(&full[st], (t / DQ_STAGES) & 1);
    const uint8_t* ks = smem + S::RING + st * S::STAGE;
    const uint8_t* vs = ks + S::KV;

    if (t < n_mine) {
      // S = Q K^T and dP = G V^T, 64 rows x DQ_BK keys each, in the
      // accumulator layout: [4j + e] = (row + 8 * (e / 2), key
      // k0 + 8j + c2 + e % 2)
      float s[NS], dp[NS];
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hp::Wgmma<DQ_BK>::ss(s, hp::desc_k(q_wg, kk, S::SUB),
                             hp::desc_k(ks, kk, S::KV_SUB), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hp::Wgmma<DQ_BK>::ss(dp, hp::desc_k(g_wg, kk, S::SUB),
                             hp::desc_k(vs, kk, S::KV_SUB), kk > 0);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(s);
      hp::fence_regs(dp);

      // ds = p (dp - dm) scale in place of s, p = 2^(s scale log2 e -
      // lse log2 e); the position test (both masks of the reference, as
      // one) only where the T edge or the diagonal crosses the tile for
      // some of my rows
      const bool edge = k0 + DQ_BK > tk ||
                        (causal && q_offset + wq0 < k_offset + k0 + DQ_BK - 1);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int h = (i >> 1) & 1;
        float p = hp::ex2(fmaf(s[i], c_log2, -lse2[h]));
        if (edge) {
          const int key = k0 + (i >> 2) * 8 + c2 + (i & 1);
          if (key >= tk || (causal && qpos[h] < k_offset + key)) p = 0.0f;
        }
        s[i] = p * (dp[i] - dmr[h]) * scale;
      }

      // dQ += dS K: dS rounded to bf16 is the register A operand, 16 keys
      // a k-step; the staged K tile (keys x D, D contiguous) is read
      // MN-major, the same tile S read K-major
      uint32_t da[DQ_BK / 16][4];
#pragma unroll
      for (int c = 0; c < DQ_BK / 16; ++c) hp::acc_to_a(da[c], s, c);
      hp::wgmma_fence();
#pragma unroll
      for (int c = 0; c < DQ_BK / 16; ++c)
        hp::Wgmma<D>::rs(dq, da[c], hp::desc_mn(ks, c, S::KV_SUB), 1);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(dq);
      hp::fence_regs(da);
    }

    // the last of the 8 warps done with the stage refills it
    if (hp::last_to_release(&released[st], HOP_THREADS / 32) && lane == 0 &&
        t + DQ_STAGES < n_tiles)
      load_dq_kv<D>(smem, full, &kmap, &vmap, t + DQ_STAGES, st, bh);
  }

  // epilogue: dQ in bf16 into my Q tile (its last reader was my last S
  // wgmma, and its TMA load has landed), then one TMA store a sub-tile;
  // rows past tq are dropped by the store
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      hp::st_swizzled(q_wg, row + 8 * h, 8 * j + c2, S::SUB,
                      pack_bf16(dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]));
  hp::fence_proxy_async();
  hp::named_sync(1 + wg, WG);
  if (tid == 0) {
    for (int s = 0; s < NSUB; ++s)
      hp::tma_store_3d(&dqmap, q_wg + s * S::SUB, 64 * s, wq0, bh);
    hp::tma_store_drain();
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *g, *lse, *dm;
  int bh, tq, tk;
  float scale;
  int causal, q_offset, k_offset;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
cudaError_t dq_f32(const Args& a, void* dq, cudaStream_t st) {
  const size_t smem = dq_f32_smem<D>();
  cudaError_t err = prepare(bwd_dq_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tq + TILE - 1) / TILE, a.bh);
  bwd_dq_f32_kernel<D><<<grid, NT32, smem, st>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.g, (const float*)a.lse, (const float*)a.dm,
      (float*)dq, a.tq, a.tk, a.scale, a.causal, a.q_offset, a.k_offset);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq_bf16_small(const Args& a, void* dq, cudaStream_t st) {
  const size_t smem = dq_bf16_small_smem<D>();
  cudaError_t err = prepare(bwd_dq_bf16_small_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tq + TILE - 1) / TILE, a.bh);
  bwd_dq_bf16_small_kernel<D><<<grid, NT16, smem, st>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (const bf16*)a.g,
      (const float*)a.lse, (const float*)a.dm, (bf16*)dq, a.tq, a.tk,
      a.scale, a.causal, a.q_offset, a.k_offset);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq_bf16_hopper(const Args& a, void* dq, cudaStream_t st) {
  CUtensorMap qm, km, vm, gm, dqm;
  cudaError_t err;
  if ((err = hp::make_map(&qm, a.q, a.bh, a.tq, D, 64)) != cudaSuccess ||
      (err = hp::make_map(&km, a.k, a.bh, a.tk, D, DQ_BK)) != cudaSuccess ||
      (err = hp::make_map(&vm, a.v, a.bh, a.tk, D, DQ_BK)) != cudaSuccess ||
      (err = hp::make_map(&gm, a.g, a.bh, a.tq, D, 64)) != cudaSuccess ||
      (err = hp::make_map(&dqm, dq, a.bh, a.tq, D, 64)) != cudaSuccess)
    return err;
  const size_t smem = DqSmem<D>::BYTES;
  err = prepare(bwd_dq_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tq + DQ_ROWS - 1) / DQ_ROWS, a.bh);
  bwd_dq_bf16_kernel<D><<<grid, HOP_THREADS, smem, st>>>(
      qm, km, vm, gm, dqm, (const float*)a.lse, (const float*)a.dm, a.tq,
      a.tk, a.scale, a.causal, a.q_offset, a.k_offset);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_f32(const Args& a, void* dk, void* dv, cudaStream_t st) {
  const size_t smem = dkv_f32_smem<D>();
  cudaError_t err = prepare(bwd_dkv_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tk + TILE - 1) / TILE, a.bh);
  bwd_dkv_f32_kernel<D><<<grid, NT32, smem, st>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.g, (const float*)a.lse, (const float*)a.dm,
      (float*)dk, (float*)dv, a.tq, a.tk, a.scale, a.causal, a.q_offset,
      a.k_offset);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_bf16_small(const Args& a, void* dk, void* dv, cudaStream_t st) {
  const size_t smem = dkv_bf16_smem<D>();
  cudaError_t err = prepare(bwd_dkv_bf16_small_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tk + TILE - 1) / TILE, a.bh);
  bwd_dkv_bf16_small_kernel<D><<<grid, NT16, smem, st>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (const bf16*)a.g,
      (const float*)a.lse, (const float*)a.dm, (bf16*)dk, (bf16*)dv, a.tq,
      a.tk, a.scale, a.causal, a.q_offset, a.k_offset);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_bf16_hopper(const Args& a, void* dk, void* dv,
                            cudaStream_t st) {
  CUtensorMap qm, km, vm, gm, dkm, dvm;
  cudaError_t err;
  if ((err = hp::make_map(&qm, a.q, a.bh, a.tq, D, 64)) != cudaSuccess ||
      (err = hp::make_map(&km, a.k, a.bh, a.tk, D, 64)) != cudaSuccess ||
      (err = hp::make_map(&vm, a.v, a.bh, a.tk, D, 64)) != cudaSuccess ||
      (err = hp::make_map(&gm, a.g, a.bh, a.tq, D, 64)) != cudaSuccess ||
      (err = hp::make_map(&dkm, dk, a.bh, a.tk, D, 64)) != cudaSuccess ||
      (err = hp::make_map(&dvm, dv, a.bh, a.tk, D, 64)) != cudaSuccess)
    return err;
  const size_t smem = DkvSmem<D>::BYTES;
  err = prepare(bwd_dkv_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tk + HKEYS - 1) / HKEYS, a.bh);
  bwd_dkv_bf16_kernel<D><<<grid, HOP_THREADS, smem, st>>>(
      qm, km, vm, gm, dkm, dvm, (const float*)a.lse, (const float*)a.dm,
      a.tq, a.tk, a.scale, a.causal, a.q_offset, a.k_offset);
  return cudaGetLastError();
}

using dq_fn = cudaError_t (*)(const Args&, void*, cudaStream_t);
using dkv_fn = cudaError_t (*)(const Args&, void*, void*, cudaStream_t);

dq_fn pick_dq(int dtype, int d) {
  switch (dtype * 1000 + d) {
    case 16: return dq_f32<16>;
    case 32: return dq_f32<32>;
    case 64: return dq_f32<64>;
    case 128: return dq_f32<128>;
    case 1016: return dq_bf16_small<16>;
    case 1032: return dq_bf16_small<32>;
    case 1064: return dq_bf16_hopper<64>;
    case 1128: return dq_bf16_hopper<128>;
  }
  return nullptr;
}

dkv_fn pick_dkv(int dtype, int d) {
  switch (dtype * 1000 + d) {
    case 16: return dkv_f32<16>;
    case 32: return dkv_f32<32>;
    case 64: return dkv_f32<64>;
    case 128: return dkv_f32<128>;
    case 1016: return dkv_bf16_small<16>;
    case 1032: return dkv_bf16_small<32>;
    case 1064: return dkv_bf16_hopper<64>;
    case 1128: return dkv_bf16_hopper<128>;
  }
  return nullptr;
}

bool valid(int bh, int tq, int tk, int dtype) {
  return bh > 0 && bh <= 65535 && tq > 0 && tk > 0 &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

// q, g: (bh, tq, d); k, v: (bh, tk, d); all contiguous in the storage
// dtype (0 = float32, 1 = bfloat16); lse, dm: (bh, tq) float32.  dq is
// (bh, tq, d), dk/dv (bh, tk, d), in the storage dtype.  Each returns
// cudaGetLastError() after its launch (0 on success).
extern "C" int ompi_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* dm, void* dq, int bh, int tq,
                                 int tk, int d, int dtype, float scale,
                                 int causal, int q_offset, int k_offset,
                                 void* stream) {
  const dq_fn fn = pick_dq(dtype, d);
  if (fn == nullptr || !valid(bh, tq, tk, dtype))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, g, lse, dm, bh, tq, tk, scale, causal, q_offset,
               k_offset};
  return (int)fn(a, dq, static_cast<cudaStream_t>(stream));
}

extern "C" int ompi_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* g, const void* lse,
                                  const void* dm, void* dk, void* dv, int bh,
                                  int tq, int tk, int d, int dtype,
                                  float scale, int causal, int q_offset,
                                  int k_offset, void* stream) {
  const dkv_fn fn = pick_dkv(dtype, d);
  if (fn == nullptr || !valid(bh, tq, tk, dtype))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, g, lse, dm, bh, tq, tk, scale, causal, q_offset,
               k_offset};
  return (int)fn(a, dk, dv, static_cast<cudaStream_t>(stream));
}
