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
// What bounds it on this card.  At the decode prefill shape (B=16, H=16,
// T=512, D=128, bf16, causal) the function moves ~135 MB (q, k, v, o, lse)
// and does ~17 GFLOP: at H100 SXM peaks that is ~40 us of HBM traffic
// against ~17 us of tensor-core math, so the card's bound is bytes.
//
// What the design does about it.  Each K/V element is read from HBM once
// per 64-row q tile, scores and weights never leave the SM, tiles wholly
// above the causal diagonal are skipped (their contribution is exactly
// zero), and m, l and the O accumulator stay in registers.  Two kernels:
//
//   - bf16 (the serving path): tensor cores through mma.sync m16n8k16
//     (bf16 in, f32 accumulate).  4 warps, each owning 16 query rows whose
//     Q fragments stay in registers for the whole K/V stream.  S = Q K^T
//     comes out in the accumulator layout, which is also the A-operand
//     layout of P V, so P is rounded to bf16 and fed back from registers
//     without touching shared memory.  K/V tiles are copied 16 bytes at a
//     time with cp.async into two shared-memory stages, so the next
//     tile's copy runs under this tile's math; both stay row-major, padded
//     by 8 elements a row so that a warp's fragment loads hit 32 distinct
//     banks, and V's B fragments come out transposed through ldmatrix.
//     wgmma with TMA-fed tiles is the later step towards the byte bound.
//   - f32: products on the f32 CUDA cores (the tensor cores would round
//     f32 inputs to TF32, which breaks float32 parity).  256 threads as 32
//     row groups x 8 column lanes; a thread owns 2 query rows, the 8 key
//     columns lane + 8*j of the scores and the D/8 columns lane + 8*j of
//     O; Q, K, V and P are staged in shared memory as f32, rows padded by
//     one word against bank conflicts.
//
// Both allocate nothing, launch on the caller's stream and do not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per streamed tile

// Number of K/V tiles a block must visit: with a causal mask, tiles past
// the last key any of its rows may see are wholly masked and skipped.
__device__ __forceinline__ int live_tiles(int q0, int tq, int tk, int causal,
                                          int q_offset, int k_offset) {
  const int n_tiles = (tk + BK - 1) / BK;
  if (!causal) return n_tiles;
  const int span = q_offset + min(q0 + BQ, tq) - 1 - k_offset;
  return span < 0 ? 0 : min(n_tiles, span / BK + 1);
}

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

  const int n_tiles = live_tiles(q0, tq, tk, causal, q_offset, k_offset);
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
// bfloat16: tensor-core kernel (mma.sync m16n8k16, f32 accumulate)
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
    flash_fwd_bf16_kernel(const bf16* __restrict__ q,
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

  const int n_tiles = live_tiles(q0, tq, tk, causal, q_offset, k_offset);
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
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        void* lse, int bh, int tq, int tk, float scale,
                        int causal, int q_offset, int k_offset,
                        cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  flash_fwd_bf16_kernel<D><<<grid, NT16, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), tq, tk, scale, causal, q_offset, k_offset);
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
      case 16: return launch_bf16<16>;
      case 32: return launch_bf16<32>;
      case 64: return launch_bf16<64>;
      case 128: return launch_bf16<128>;
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
