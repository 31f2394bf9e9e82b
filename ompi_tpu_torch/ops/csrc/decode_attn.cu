// Cached decode attention for Hopper (sm_90a), CUDA C++.
//
// Replaces no TPU kernel: the JAX package computes this block with plain
// jnp.einsum (ompi_tpu/models/decode.py `_step_layer`), and no Pallas
// kernel stands behind it.  It was added because, run the same way in
// the port (a cast of the whole K/V cache to f32, layout copies for the
// einsums, a softmax over every slot), the block took 97% of the device
// time of a cached decode step at batch 256.
//
// What it computes, for each batch row b and head h of one new token at
// slot `pos`: it stores the token's k and v (already in the cache's
// dtype) into slot pos of the layer's caches, then, in f32,
//     s_j = (q . k_j) * scale,   w = softmax(s_0..s_pos),   o = sum_j w_j v_j
// over the slots 0..pos, and writes o rounded to nearest in the storage
// dtype.  bf16 -> f32 is exact and a bf16 x bf16 product is exact in
// f32, so against the plain version (models/decode.py's block, kept in
// ops/decode_attention.py) only the order of summation differs.  Slots
// after pos are not read: the plain version masks them to -1e30, whose
// exp is exactly 0 in f32, so skipping them drops no term.
//
// What bounds it on this card: bytes.  Each K and V row is read once and
// used for 2 FLOPs an element.  At the benchmark's shape (B = 256, H =
// 16, D = 128, bf16, Tmax = 640, pos 512..638) a slot's K and V over all
// rows are 2.10 MB, so a layer at pos = 576 reads 1.21 GB: 361 us at
// 3.35 TB/s.  The rows are 256 bytes long and 4 KB apart (the cache is
// (B, Tmax, H, D)).
//
// What the design does about it.  A block of 4 warps owns one (b, h) row
// and all its slots.  A lane owns 8 consecutive elements of a row
// (16 bytes of bf16, 32 of f32); LPK = D/8 rounded up to a power of two
// lanes take one key, so a warp takes 32 / LPK keys at a time.  Each
// warp streams its keys through a private ring of cp.async stages in
// shared memory (8 for bf16, 4 for f32: 32 KB a block): a lane copies
// and later reads back only its own 16 or 32 bytes, so the ring needs no
// barrier, only the lane's own cp.async.wait_group, and several KB a
// warp stay in flight.  The dot product is 8 FMAs a lane and a shuffle
// tree over the LPK lanes; every key group keeps its own online softmax
// (max m, sum l, its 8 columns of the accumulator) in f32 registers.  The
// groups of a warp, then the 4 warps (through shared memory), are merged
// at the end.
// The new token is folded in by warp 0 from the k/v it was handed (not
// read back from the cache) after the cached slots, and stored into the
// cache by the same lanes: the write and the attention are one launch.
//
// The grid is B*H blocks at every batch and never depends on pos, which
// is a launch argument.  At batch 16 (256 rows on 132 SMs) one block a
// row measured no slower than splitting each row's slots over blocks and
// merging them in a second kernel.
//
// The kernel allocates nothing, launches on the caller's stream and does
// not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::bf16;
using flash::cp_async16;
using flash::cp_async_commit;
using flash::cp_async_wait;

constexpr int NW = 4;               // warps a block
constexpr int NT = NW * 32;         // threads a block
constexpr int MAX_D = 256;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Stages;
template <>
struct Stages<bf16> {
  static constexpr int N = 8;       // 8 x 4 warps x 1 KB = 32 KB
};
template <>
struct Stages<float> {
  static constexpr int N = 4;       // 4 x 4 warps x 2 KB = 32 KB
};

// 8 elements at p (16-byte aligned) as f32
__device__ __forceinline__ void load8(const bf16* p, float f[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float f[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store1(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

// the 8 elements of a lane's chunk, global -> global (the new k/v into
// the cache) and global -> shared (cp.async, 16 bytes a copy)
template <typename T>
__device__ __forceinline__ void copy8(T* dst, const T* src) {
#pragma unroll
  for (int i = 0; i < (int)sizeof(T) / 2; ++i)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
}
template <typename T>
__device__ __forceinline__ void cp_chunk(T* dst, const T* src) {
#pragma unroll
  for (int i = 0; i < (int)sizeof(T) / 2; ++i)
    cp_async16(reinterpret_cast<char*>(dst) + 16 * i,
               reinterpret_cast<const char*>(src) + 16 * i, 16);
}

// the dot product of a lane's 8 columns, summed over the LPK lanes of its
// key group (every lane of the warp takes part)
template <int LPK>
__device__ __forceinline__ float group_dot(const float q[8],
                                           const float k[8]) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s = fmaf(q[i], k[i], s);
#pragma unroll
  for (int off = LPK / 2; off > 0; off /= 2) s += __shfl_xor_sync(FULL, s, off);
  return s;
}

// one key into a group's online softmax
__device__ __forceinline__ void online(float s, const float v[8], float& m,
                                       float& l, float acc[8]) {
  const float mn = fmaxf(m, s);
  const float corr = expf(m - mn);          // m = -inf: exp(-inf) = 0
  const float p = expf(s - mn);
  l = l * corr + p;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, v[i], acc[i] * corr);
  m = mn;
}

// weight of a partial state of max m under the merged max mn (0 for an
// empty state, whose m is -inf)
__device__ __forceinline__ float rescale(float m, float mn) {
  return m == -INFINITY ? 0.0f : expf(m - mn);
}

// q, kn, vn, o: (B, H, D); kc, vc: (B, Tmax, H, D), all contiguous in T.
template <typename T, int LPK>
__global__ void __launch_bounds__(NT)
    decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                       const T* __restrict__ vn, T* __restrict__ kc,
                       T* __restrict__ vc, int pos, T* __restrict__ o,
                       int H, int tmax, int d, float scale) {
  constexpr int S = Stages<T>::N;
  constexpr int G = 32 / LPK;       // keys a warp takes at a time
  constexpr int CH = sizeof(T) / 2; // 16-byte pieces of a lane's chunk
  // [stage][warp][K, V][lane][piece]; a lane's own 16 or 32 bytes
  __shared__ uint4 ring[S][NW][2][32][CH];
  __shared__ float red[NW][2 + MAX_D];

  const int row = blockIdx.x;       // b * H + h
  const int b = row / H, h = row % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / LPK;         // the lane's key group
  const int col = (lane % LPK) * 8; // its first column
  const bool live = col < d;
  const size_t slot = (size_t)H * d;
  const size_t row0 = ((size_t)b * tmax * H + h) * d + col;

  float qf[8];
  if (live) {
    load8(q + (size_t)row * d + col, qf);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) qf[i] = 0.0f;
  }
  float m = -INFINITY, l = 0.0f, acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;

  // warp-iteration t takes the keys (t * NW + warp) * G + [0, G), one a
  // key group, of the cached slots [0, pos); empty commit groups keep the
  // count uniform
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const int j = (t * NW + warp) * G + g;
    if (live && j < pos) {
      cp_chunk(reinterpret_cast<T*>(ring[t][warp][0][lane]),
               kc + row0 + j * slot);
      cp_chunk(reinterpret_cast<T*>(ring[t][warp][1][lane]),
               vc + row0 + j * slot);
    }
    cp_async_commit();
  }
  for (int t = 0; (t * NW + warp) * G < pos; ++t) {
    cp_async_wait<S - 1>();         // this lane's copies of stage t landed
    const int j = (t * NW + warp) * G + g;
    const T* sk = reinterpret_cast<const T*>(ring[t % S][warp][0][lane]);
    const T* sv = reinterpret_cast<const T*>(ring[t % S][warp][1][lane]);
    float kf[8];
    if (live) {
      load8(sk, kf);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) kf[i] = 0.0f;
    }
    const float s = group_dot<LPK>(qf, kf) * scale;
    if (j < pos) {
      float vf[8];
      if (live) {
        load8(sv, vf);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) vf[i] = 0.0f;
      }
      online(s, vf, m, l, acc);
    }
    // the stage's values are in registers and used: refill it
    const int jn = j + S * NW * G;
    if (live && jn < pos) {
      cp_chunk(const_cast<T*>(sk), kc + row0 + jn * slot);
      cp_chunk(const_cast<T*>(sv), vc + row0 + jn * slot);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

  // the new token, last; its lanes store it into the cache
  if (warp == 0) {
    float kf[8], vf[8];
    const size_t at = (size_t)row * d + col;
    if (live) {
      load8(kn + at, kf);
      load8(vn + at, vf);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) kf[i] = vf[i] = 0.0f;
    }
    const float s = group_dot<LPK>(qf, kf) * scale;
    if (g == 0) {
      online(s, vf, m, l, acc);
      if (live) {
        copy8(kc + row0 + pos * slot, kn + at);
        copy8(vc + row0 + pos * slot, vn + at);
      }
    }
  }

  // merge the warp's key groups ...
#pragma unroll
  for (int off = LPK; off < 32; off *= 2) {
    const float mo = __shfl_xor_sync(FULL, m, off);
    const float lother = __shfl_xor_sync(FULL, l, off);
    const float mn = fmaxf(m, mo);
    const float a = rescale(m, mn), c = rescale(mo, mn);
    l = l * a + lother * c;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      acc[i] = acc[i] * a + __shfl_xor_sync(FULL, acc[i], off) * c;
    m = mn;
  }
  if (lane == 0) {
    red[warp][0] = m;
    red[warp][1] = l;
  }
  if (g == 0 && live) {
#pragma unroll
    for (int i = 0; i < 8; ++i) red[warp][2 + col + i] = acc[i];
  }
  __syncthreads();

  // ... then the block's warps, a column a thread
  float mn = -INFINITY;
#pragma unroll
  for (int w = 0; w < NW; ++w) mn = fmaxf(mn, red[w][0]);
  float wt[NW], lsum = 0.0f;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    wt[w] = rescale(red[w][0], mn);
    lsum += red[w][1] * wt[w];
  }
  for (int c = threadIdx.x; c < d; c += NT) {
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) a += red[w][2 + c] * wt[w];
    store1(o + (size_t)row * d + c, a / lsum);
  }
}

template <typename T, int LPK>
cudaError_t launch(const void* q, const void* kn, const void* vn, void* kc,
                   void* vc, int pos, void* o, int rows, int H, int tmax,
                   int d, float scale, cudaStream_t stream) {
  decode_attn_kernel<T, LPK><<<rows, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<T*>(kc), static_cast<T*>(vc),
      pos, static_cast<T*>(o), H, tmax, d, scale);
  return cudaGetLastError();
}

using launch_fn = cudaError_t (*)(const void*, const void*, const void*,
                                  void*, void*, int, void*, int, int, int,
                                  int, float, cudaStream_t);

template <typename T>
launch_fn pick_lanes(int lanes) {
  switch (lanes) {
    case 1: return launch<T, 1>;
    case 2: return launch<T, 2>;
    case 4: return launch<T, 4>;
    case 8: return launch<T, 8>;
    case 16: return launch<T, 16>;
    case 32: return launch<T, 32>;
  }
  return nullptr;
}

}  // namespace

// q, kn, vn, o: (b, h, d) contiguous; kc, vc: (b, tmax, h, d) contiguous,
// all in the storage dtype (0 = float32, 1 = bfloat16), 16-byte aligned;
// pos: the new token's slot (< tmax).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ompi_decode_attn(const void* q, const void* kn, const void* vn,
                                void* kc, void* vc, int pos, void* o, int b,
                                int h, int tmax, int d, int dtype,
                                float scale, void* stream) {
  if (b <= 0 || h <= 0 || tmax <= 0 || d <= 0 || d > MAX_D || d % 8 != 0 ||
      pos < 0 || pos >= tmax || (long long)b * h > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int lanes = 1;
  while (lanes * 8 < d) lanes *= 2;
  const launch_fn fn = dtype == 0   ? pick_lanes<float>(lanes)
                       : dtype == 1 ? pick_lanes<bf16>(lanes)
                                    : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)fn(q, kn, vn, kc, vc, pos, o, b * h, h, tmax, d, scale,
                 static_cast<cudaStream_t>(stream));
}
