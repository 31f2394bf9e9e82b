// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces: ompi_tpu/ops/flash_attention.py `_fwd_kernel` (the Pallas
// kernel launched by `_flash_fwd_raw`).  Same function: exact attention
// over one batch*head for a tile of query rows, K/V streamed in tiles, an
// online softmax in f32 (running max m, normaliser l, accumulator acc),
// a causal mask on GLOBAL positions q_offset + i >= k_offset + j with the
// offsets as runtime ints (a ring hop does not rebuild), O written in the
// storage dtype and lse = m + log(max(l, 1e-30)) in f32, laid out
// (B*H, Tq) = (B, H, Tq).  The TPU's (BH, nq, 8, block_q) lse layout was a
// sublane-tiling workaround and is not carried over.
//
// Kept exactly as in the reference:
//   - masked scores are -1e30, not -inf, and the mask is applied twice:
//     to s, and again to p (a row whose first tile is fully masked would
//     otherwise give weight exp(0) = 1 to masked keys);
//   - a fully masked row yields O = 0 and a finite lse;
//   - in bf16, p is rounded to the storage dtype before P*V, while l sums
//     the unrounded p.
//
// What bounds it on this card.  At the decode prefill shape (B*H = 256,
// T = 512, D = 128, bf16, causal) the function moves 134.7 MB (q, k, v
// read, o and lse written) and does 17.2 GFLOP on its 131,328 live pairs
// a head: 40.2 us of HBM traffic at 3.35 TB/s against 17.4 us of bf16
// tensor-core math at 989 TFLOP/s, so bytes bound it.  At the training
// shape (T = 1024) it is 269.5 MB and 68.8 GFLOP: 80.4 against 69.6 us,
// bytes again, with the two close.
//
// What the design does about it.  Each K/V element is read from HBM once
// per 128-row q tile, scores and weights never leave the SM, tiles wholly
// above the causal diagonal are skipped (their contribution is exactly
// zero), and m, l and the O accumulator stay in registers.  Three kernels,
// chosen by dtype and head dim (a dispatch by shape, not a fallback):
//
//   - bf16, D = 64 and 128 (the serving and training paths): Hopper's
//     tensor cores through wgmma, fed by TMA.  A block owns 128 query
//     rows, two warpgroups of 64 rows each.  Thread 0 loads the block's Q
//     once and the first two 128-key K/V tiles into a ring of 2 stages,
//     each a 3-D TMA box (64 columns, rows, 1 head) of the (D, T, B*H)
//     tensor, 128-byte swizzled, completing on the stage's "full"
//     mbarrier (expect_tx).  Rows past T come in as zeros and are dropped
//     on the store, so no tile reaches into the next head.  A stage is
//     refilled by the last of the 8 warps to finish with it (a shared
//     counter), so no thread ever waits for a free stage and no warp is
//     spent on a producer: with wgmma in the kernel, ptxas budgets
//     registers for whole warpgroups, and a third (producer) warpgroup
//     would cut every thread to 168 registers, which serialises the
//     wgmmas; 256 threads get 255 (setmaxnreg did not lift that budget).
//     A warpgroup computes S = Q K^T (64 x 128) with wgmma m64n128k16,
//     both operands K-major in shared memory; the softmax runs on the
//     accumulator registers (row max and sum across the 4 threads of a
//     row by shuffles, exp2 with scale*log2(e) folded into one FMA, masked
//     entries set to -inf so exp2 gives the second mask's 0 by itself) and
//     tests positions only on tiles that the diagonal or the T edge
//     crosses; P rounded to bf16 is the register A operand of O += P V
//     (wgmma m64nDk16, V read MN-major with the transpose bit).  Within a
//     warpgroup the two products and the softmax run in turn, and the two
//     warpgroups interleave on the tensor cores (a version that ran tile
//     t's P V under tile t + 1's softmax was slower: ptxas serialised its
//     wgmmas, as the P fragments are written by ordinary instructions).
//     The epilogue scales O by 1/max(l, 1e-30), rounds it into the
//     warpgroup's own (now unused) Q tile in the swizzled layout and
//     stores it with TMA; lse goes out with plain stores.  Shared memory:
//     Q 2 x 64 x D + 2 stages x (K, V) 128 x D, bf16 = 160 KB at D = 128
//     (80 KB at D = 64): one block an SM.  The grid runs a head's q
//     tiles side by side, so its K and V come from HBM about once and
//     from L2 for the rest (ordered head by head, the causal q tiles'
//     re-reads of K and V would make the traffic at the prefill shape
//     about 1.75x its minimum), the heaviest causal q tile (the largest
//     q0) of a head first.
//   - bf16, D = 16 and 32 (test sizes only): mma.sync m16n8k16, 4 warps
//     each owning 16 query rows whose Q fragments stay in registers; S in
//     the accumulator layout is, rounded to bf16, P's A fragment; K/V
//     tiles of 64 keys through two cp.async stages, V's B fragments
//     through ldmatrix.trans.
//   - f32: products on the f32 CUDA cores (the tensor cores would round
//     f32 inputs to TF32, which breaks float32 parity).  256 threads as 32
//     row groups x 8 column lanes; a thread owns 2 query rows, the 8 key
//     columns lane + 8*j of the scores and the D/8 columns lane + 8*j of
//     O; Q, K, V and P are staged in shared memory as f32, rows padded by
//     one word against bank conflicts.
//
// All allocate nothing, launch on the caller's stream and do not
// synchronise; the bf16 D = 64/128 launch builds its four tensor maps on
// the host first (cuTensorMapEncodeTiled, looked up through the CUDA
// runtime's entry-point query: no -lcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <math.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per streamed tile

// ---------------------------------------------------------------------------
// float32: CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int NT32 = 256;           // threads per block
constexpr int RPT = BQ / 32;        // query rows per thread
constexpr int CPT = BK / 8;         // score columns per thread

// Stage rows [row0, row0 + 64) of a (rows_total, D) matrix into shared
// memory with row stride D + 1; rows past the end are zero so that
// 0 * garbage never makes a NaN.
template <int D>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src,
                                               int row0, int rows_total) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < 64 * D; e += NT32) {
    const int r = e / D;
    const int c = e % D;
    const int g = row0 + r;
    dst[r * LD + c] = g < rows_total ? src[(size_t)g * D + c] : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(NT32)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int tq, int tk, float scale,
                         int causal, int q_offset, int k_offset) {
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int DPT = D / 8;
  extern __shared__ float smem[];
  float* qs = smem;             // BQ x LD
  float* ks = qs + BQ * LD;     // BK x LD
  float* vs = ks + BK * LD;     // BK x LD
  float* ps = vs + BK * LD;     // BQ x LP

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int lane = threadIdx.x & 7;
  const int row = (threadIdx.x >> 3) * RPT;  // first local row of mine
  const float* kb = k + (size_t)bh * tk * D;
  const float* vb = v + (size_t)bh * tk * D;

  stage_rows_f32<D>(qs, q + (size_t)bh * tq * D, q0, tq);

  float m[RPT], l[RPT], acc[RPT][DPT];
  int qpos[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
    qpos[i] = q_offset + q0 + row + i;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.0f;
  }

  const int n_tiles =
      live_tiles(q0, BQ, BK, tq, tk, causal, q_offset, k_offset);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // previous tile's K/V/P reads are done
    stage_rows_f32<D>(ks, kb, k0, tk);
    stage_rows_f32<D>(vs, vb, k0, tk);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(row + i) * LD + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = ks[(lane + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      bool live[CPT];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kk = k0 + lane + 8 * j;
        live[j] = kk < tk && (!causal || qpos[i] >= k_offset + kk);
        s[i][j] = live[j] ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.0f;
        rs += p;
        ps[(row + i) * LP + lane + 8 * j] = p;
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, w);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // P tile complete

    const int kn = min(BK, tk - k0);
    for (int c = 0; c < kn; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(row + i) * LP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = vs[c * LD + lane + 8 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + row + i;
    if (r >= tq) continue;
    const float safe_l = fmaxf(l[i], 1e-30f);
    float* orow = o + ((size_t)bh * tq + r) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[lane + 8 * j] = acc[i][j] / safe_l;
    if (lane == 0) lse[(size_t)bh * tq + r] = m[i] + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// bfloat16, D = 16 and 32: mma.sync m16n8k16 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int NT16 = 128;           // 4 warps x 16 query rows

// Start the copy of K/V rows [k0, k0 + 64) into one stage (row stride
// D + 8 elements); rows past tk are zero-filled.
template <int D>
__device__ __forceinline__ void stage_kv(bf16* ks, bf16* vs, const bf16* kb,
                                         const bf16* vb, int k0, int tk) {
  constexpr int LD = D + 8;
  constexpr int C8 = D / 8;         // 16-byte chunks a row
  for (int e = threadIdx.x; e < BK * C8; e += NT16) {
    const int r = e / C8, c = (e % C8) * 8;
    const bool in = k0 + r < tk;
    const size_t off = (size_t)(in ? k0 + r : 0) * D + c;
    cp_async16(ks + r * LD + c, kb + off, in ? 16 : 0);
    cp_async16(vs + r * LD + c, vb + off, in ? 16 : 0);
  }
  cp_async_commit();
}

template <int D>
constexpr size_t bf16_smem_bytes() {
  return 2 * 2 * (size_t)BK * (D + 8) * sizeof(bf16);  // 2 stages x K, V
}

template <int D>
__global__ void __launch_bounds__(NT16)
    flash_fwd_bf16_small_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int tq, int tk,
                          float scale, int causal, int q_offset,
                          int k_offset) {
  constexpr int KS = D / 16;        // k-steps of S = Q K^T over the head dim
  constexpr int NS = BK / 8;        // 8-key column tiles of S
  constexpr int NO = D / 8;         // 8-wide column tiles of O
  constexpr int LD = D + 8;         // K/V row stride in smem (elements)
  constexpr int STAGE = 2 * BK * LD;  // one stage: K tile then V tile
  extern __shared__ __align__(16) uint16_t smem16[];
  bf16* stages = reinterpret_cast<bf16*>(smem16);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;          // fragment row (and B column) group
  const int c2 = (lane & 3) * 2;    // fragment column pair
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int r0 = q0 + warp * 16 + g;  // my rows: r0 and r0 + 8
  const bf16* qb = q + (size_t)bh * tq * D;
  const bf16* kb = k + (size_t)bh * tk * D;
  const bf16* vb = v + (size_t)bh * tk * D;

  const int n_tiles =
      live_tiles(q0, BQ, BK, tq, tk, causal, q_offset, k_offset);
  if (n_tiles > 0) stage_kv<D>(stages, stages + BK * LD, kb, vb, 0, tk);

  // Q as A fragments, held for the whole stream
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 16 + c2;
    qa[kk][0] = r0 < tq ? ld32(qb + (size_t)r0 * D + c) : 0u;
    qa[kk][1] = r0 + 8 < tq ? ld32(qb + (size_t)(r0 + 8) * D + c) : 0u;
    qa[kk][2] = r0 < tq ? ld32(qb + (size_t)r0 * D + c + 8) : 0u;
    qa[kk][3] = r0 + 8 < tq ? ld32(qb + (size_t)(r0 + 8) * D + c + 8) : 0u;
  }

  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  const int qpos[2] = {q_offset + r0, q_offset + r0 + 8};

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    // everyone is done with the stage tile t+1 will overwrite (tile t-1)
    __syncthreads();
    if (t + 1 < n_tiles) {
      bf16* nxt = stages + ((t + 1) & 1) * STAGE;
      stage_kv<D>(nxt, nxt + BK * LD, kb, vb, k0 + BK, tk);
      cp_async_wait<1>();           // tile t has landed, t+1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = stages + (t & 1) * STAGE;
    const bf16* vs = ks + BK * LD;

    // S = Q K^T for my 16 rows x 64 keys, in accumulator layout:
    // s[n][0..1] row r0, keys n*8 + c2 + {0,1}; s[n][2..3] row r0 + 8
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      const bf16* krow = ks + (n * 8 + g) * LD + c2;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_16816(s[n], qa[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
    }

    float mx[2] = {NEG, NEG};
    bool live[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + c2 + (e & 1);
        const int h = e >> 1;
        live[n][e] = key < tk && (!causal || qpos[h] >= k_offset + key);
        s[n][e] = live[n][e] ? s[n][e] * scale : NEG;
        mx[h] = fmaxf(mx[h], s[n][e]);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      mx[h] = fmaxf(m[h], mx[h]);            // the new running max
      corr[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        s[n][e] = live[n][e] ? expf(s[n][e] - m[h]) : 0.0f;  // p, f32
        rs[h] += s[n][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l[h] = l[h] * corr[h] + rs[h];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P V: the S accumulators of key tiles 2c and 2c+1 are the A
    // fragment of key chunk c (P rounds to bf16 here); V's B fragments
    // come from the row-major tile through ldmatrix.trans, two O column
    // tiles at a time
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      const uint32_t pa[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                              pack_bf16(s[2 * c][2], s[2 * c][3]),
                              pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                              pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
      const bf16* vrow =
          vs + (c * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
          (lane >> 4) * 8;
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vrow + j * 8);
        mma_16816(acc[j], pa, b[0], b[1]);
        mma_16816(acc[j + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= tq) continue;
    const float safe_l = fmaxf(l[h], 1e-30f);
    bf16* orow = o + ((size_t)bh * tq + r) * D + c2;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) = pack_bf16(
          acc[j][2 * h] / safe_l, acc[j][2 * h + 1] / safe_l);
    if ((lane & 3) == 0) lse[(size_t)bh * tq + r] = m[h] + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// bfloat16, D = 64 and 128: warp-specialised wgmma kernel fed by TMA
// ---------------------------------------------------------------------------

namespace hp = hopper;

constexpr int WG = 128;               // threads a warpgroup
// two consumer warpgroups and no producer warp: with wgmma in the kernel
// ptxas budgets registers for whole warpgroups (a 288-thread block gets
// 168 a thread, too few for the accumulators, and serialises the
// wgmmas), while 256 threads get the full 255
constexpr int HOP_THREADS = 2 * WG;
constexpr int HQ = 128;               // query rows a block, 64 a warpgroup
constexpr int HK = 128;               // keys a K/V tile
constexpr int HSTAGES = 2;            // K/V stages in the ring

// Shared memory of the Hopper kernel, in bytes from a 1024-aligned base.
template <int D>
struct FwdSmem {
  static constexpr uint32_t Q_SUB = 64 * 128;    // 64 rows x 64 columns
  static constexpr uint32_t Q_WG = 64 * D * 2;   // a warpgroup's Q rows
  static constexpr uint32_t KV_SUB = HK * 128;   // 128 keys x 64 columns
  static constexpr uint32_t KV = HK * D * 2;     // a K (or V) tile
  static constexpr uint32_t STAGE = 2 * KV;      // K tile, then V tile
  static constexpr uint32_t RING = 2 * Q_WG;     // offset of the ring
  static constexpr uint32_t BARS = RING + HSTAGES * STAGE;
  // q_full, full[HSTAGES]; released[HSTAGES] (int); 1024 bytes of
  // alignment slack
  static constexpr uint32_t RELEASED = BARS + 8 * (1 + HSTAGES);
  static constexpr uint32_t BYTES = RELEASED + 4 * HSTAGES + 1024;
};

// K/V tile `t` into ring stage `st`, completing on full[st]
template <int D>
__device__ __forceinline__ void load_kv(uint8_t* smem, uint64_t* full,
                                        const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, int t,
                                        int st, int bh) {
  using S = FwdSmem<D>;
  uint8_t* ks = smem + S::RING + st * S::STAGE;
  hp::mbar_expect_tx(&full[st], S::STAGE);
#pragma unroll
  for (int s = 0; s < D / 64; ++s) {
    hp::tma_load_3d(ks + s * S::KV_SUB, kmap, &full[st], 64 * s, t * HK, bh);
    hp::tma_load_3d(ks + S::KV + s * S::KV_SUB, vmap, &full[st], 64 * s,
                    t * HK, bh);
  }
}

template <int D>
__global__ void __launch_bounds__(HOP_THREADS, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap omap,
                          float* __restrict__ lse, int tq, int tk,
                          float scale, int causal, int q_offset,
                          int k_offset) {
  using S = FwdSmem<D>;
  constexpr int NSUB = D / 64;        // 64-column sub-tiles a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hp::smem_aligned_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = q_full + 1;
  int* released = reinterpret_cast<int*>(smem + S::RELEASED);

  // a head's q tiles run side by side, so its K/V stays in L2 between
  // them; the heaviest (largest q0) first
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * HQ;
  const int n_tiles =
      live_tiles(q0, HQ, HK, tq, tk, causal, q_offset, k_offset);
  const int wg = threadIdx.x / WG;
  const int tid = threadIdx.x % WG;
  const int lane = tid & 31;

  if (threadIdx.x == 0) {
    hp::mbar_init(q_full, 1);
    for (int s = 0; s < HSTAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      released[s] = 0;
    }
    hp::fence_barrier_init();
  }
  __syncthreads();
  // Q and the first K/V tiles; later tiles are issued by the last warp to
  // release a stage (below), so no thread ever waits for a free stage
  if (threadIdx.x == 0 && n_tiles > 0) {
    hp::mbar_expect_tx(q_full, 2 * S::Q_WG);
    for (int w = 0; w < 2; ++w)
      for (int s = 0; s < NSUB; ++s)
        hp::tma_load_3d(smem + w * S::Q_WG + s * S::Q_SUB, &qmap, q_full,
                        64 * s, q0 + 64 * w, bh);
    for (int t = 0; t < min(n_tiles, HSTAGES); ++t)
      load_kv<D>(smem, full, &kmap, &vmap, t, t, bh);
  }

  // warpgroup `wg`: 64 query rows
  const int row = (tid >> 5) * 16 + (lane >> 2);  // my rows: row, row + 8
  const int c2 = (lane & 3) * 2;
  const int wq0 = q0 + 64 * wg;                  // my warpgroup's first row
  uint8_t* q_wg = smem + wg * S::Q_WG;
  const int qpos[2] = {q_offset + wq0 + row, q_offset + wq0 + row + 8};
  const float c_log2 = scale * hp::LOG2E;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};

  if (n_tiles > 0) hp::mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % HSTAGES;
    const int k0 = t * HK;
    hp::mbar_wait(&full[st], (t / HSTAGES) & 1);
    const uint8_t* ks = smem + S::RING + st * S::STAGE;
    const uint8_t* vs = ks + S::KV;

    // S = Q K^T, 64 rows x 128 keys, f32 in the accumulator layout:
    // s[4j + e] = (row + 8 * (e / 2), key k0 + 8j + c2 + e % 2)
    float s[HK / 2];
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hp::Wgmma<HK>::ss(s, hp::desc_k(q_wg, kk, S::Q_SUB),
                        hp::desc_k(ks, kk, S::KV_SUB), kk > 0);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(s);

    // the position test only where the T edge or the diagonal crosses
    // the tile for some of my rows; a masked score becomes -inf, so its
    // exp2 below is exactly 0 (the reference's second mask) and it never
    // raises the max (the reference's masked -1e30 never exceeds m,
    // which starts at -1e30)
    if (k0 + HK > tk || (causal && q_offset + wq0 < k_offset + k0 + HK - 1)) {
#pragma unroll
      for (int i = 0; i < HK / 2; ++i) {
        const int key = k0 + (i >> 2) * 8 + c2 + (i & 1);
        if (key >= tk || (causal && qpos[(i >> 1) & 1] < k_offset + key))
          s[i] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < HK / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float corr[2], mlog[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * scale);
      corr[h] = hp::ex2((m[h] - m_new) * hp::LOG2E);
      m[h] = m_new;
      mlog[h] = m_new * hp::LOG2E;
    }
    // p = exp(s * scale - m) = 2^(s * scale * log2 e - m * log2 e)
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < HK / 2; ++i) {
      const int h = (i >> 1) & 1;
      s[i] = hp::ex2(fmaf(s[i], c_log2, -mlog[h]));
      rs[h] += s[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l[h] = l[h] * corr[h] + rs[h];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += P V: P rounded to bf16 is the register A operand, 16 keys a
    // k-step; V (keys x D, D contiguous) is read MN-major
    uint32_t pa[HK / 16][4];
#pragma unroll
    for (int c = 0; c < HK / 16; ++c) hp::acc_to_a(pa[c], s, c);
    hp::wgmma_fence();
#pragma unroll
    for (int c = 0; c < HK / 16; ++c)
      hp::Wgmma<D>::rs(o, pa[c], hp::desc_mn(vs, c, S::KV_SUB), 1);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(o);
    hp::fence_regs(pa);

    // the last of the 8 warps done with the stage refills it
    if (hp::last_to_release(&released[st], HOP_THREADS / 32) && lane == 0 &&
        t + HSTAGES < n_tiles)
      load_kv<D>(smem, full, &kmap, &vmap, t + HSTAGES, st, bh);
  }

  // epilogue: O / max(l, 1e-30) in bf16 into my Q tile (its last reader
  // was my last wgmma), then one TMA store a sub-tile; rows past tq are
  // dropped by the store
  float inv[2], lse_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float safe_l = fmaxf(l[h], 1e-30f);
    inv[h] = 1.0f / safe_l;
    lse_r[h] = m[h] + logf(safe_l);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      hp::st_swizzled(q_wg, row + 8 * h, 8 * j + c2, S::Q_SUB,
                      pack_bf16(o[4 * j + 2 * h] * inv[h],
                                    o[4 * j + 2 * h + 1] * inv[h]));
  hp::fence_proxy_async();
  hp::named_sync(1 + wg, WG);
  if (tid == 0) {
    for (int s = 0; s < NSUB; ++s)
      hp::tma_store_3d(&omap, q_wg + s * S::Q_SUB, 64 * s, wq0, bh);
    hp::tma_store_drain();
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wq0 + row + 8 * h;
      if (r < tq) lse[(size_t)bh * tq + r] = lse_r[h];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int tq, int tk, float scale,
                       int causal, int q_offset, int k_offset,
                       cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem =
      sizeof(float) * (size_t)(BQ * LD + 2 * BK * LD + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  flash_fwd_f32_kernel<D><<<grid, NT32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), tq, tk, scale, causal, q_offset, k_offset);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16_small(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int tq, int tk,
                              float scale, int causal, int q_offset,
                              int k_offset, cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_small_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  flash_fwd_bf16_small_kernel<D><<<grid, NT16, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), tq, tk, scale, causal, q_offset, k_offset);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16_hopper(const void* q, const void* k, const void* v,
                               void* o, void* lse, int bh, int tq, int tk,
                               float scale, int causal, int q_offset,
                               int k_offset, cudaStream_t stream) {
  CUtensorMap qm, km, vm, om;
  cudaError_t err;
  if ((err = hp::make_map(&qm, q, bh, tq, D, 64)) != cudaSuccess ||
      (err = hp::make_map(&km, k, bh, tk, D, HK)) != cudaSuccess ||
      (err = hp::make_map(&vm, v, bh, tk, D, HK)) != cudaSuccess ||
      (err = hp::make_map(&om, o, bh, tq, D, 64)) != cudaSuccess)
    return err;
  const uint32_t smem = FwdSmem<D>::BYTES;
  err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + HQ - 1) / HQ, bh);
  flash_fwd_bf16_kernel<D><<<grid, HOP_THREADS, smem, stream>>>(
      qm, km, vm, om, static_cast<float*>(lse), tq, tk, scale, causal,
      q_offset, k_offset);
  return cudaGetLastError();
}

using launch_fn = cudaError_t (*)(const void*, const void*, const void*,
                                  void*, void*, int, int, int, float, int,
                                  int, int, cudaStream_t);

launch_fn pick(int dtype, int d) {
  if (dtype == 0) {
    switch (d) {
      case 16: return launch_f32<16>;
      case 32: return launch_f32<32>;
      case 64: return launch_f32<64>;
      case 128: return launch_f32<128>;
    }
  } else if (dtype == 1) {
    switch (d) {
      case 16: return launch_bf16_small<16>;
      case 32: return launch_bf16_small<32>;
      case 64: return launch_bf16_hopper<64>;
      case 128: return launch_bf16_hopper<128>;
    }
  }
  return nullptr;
}

}  // namespace

// q: (bh, tq, d), k/v: (bh, tk, d), o: (bh, tq, d), all contiguous in the
// storage dtype (0 = float32, 1 = bfloat16); lse: (bh, tq) float32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ompi_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int tq, int tk,
                              int d, int dtype, float scale, int causal,
                              int q_offset, int k_offset, void* stream) {
  const launch_fn fn = pick(dtype, d);
  if (fn == nullptr || bh <= 0 || bh > 65535 || tq <= 0 || tk <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)fn(q, k, v, o, lse, bh, tq, tk, scale, causal, q_offset,
                 k_offset, static_cast<cudaStream_t>(stream));
}
