// One-sided copies between ranks' symmetric windows: put, get and a
// root's push to every peer (kernels #4-#6 of the port).
//
// Replaces the three Pallas remote-DMA kernels of the JAX package:
//   ompi_tpu/ops/remote_dma.py:55   _put_kernel   (launched by window_put :105)
//   ompi_tpu/ops/remote_dma.py:120  _get_kernel   (launched by window_get :163)
//   ompi_tpu/ops/remote_dma.py:178  _bcast_kernel (launched by fetch_bcast :219)
// The TPU kernels start an inter-chip DMA and wait on a send and a receive
// semaphore.  Here a rank's window is one cudaMalloc (ops/symmetric.py)
// that every other rank has mapped through a CUDA IPC handle, so the
// copying rank's SMs move the peer's memory directly.
//
// What bounds it on one H100: bytes.  A put or get reads and writes B bytes
// of the same HBM, 2B / 3.35 TB/s; a root's push to n-1 peers reads B and
// writes (n-1)B.  Ranks on separate cards move B over NVLink at 450 GB/s
// each way.  Small messages are bound by the launch and the handshake
// instead: one launch, one flag acquired, one counter, one flag released.
//
// Put and get: Hopper's counterpart of the TPU's DMA engine, the TMA's 1-D
// bulk copy (cp.async.bulk).  A persistent grid of at most one block per
// SM.  The message is cut into 16 KiB chunks, dealt round-robin to the
// blocks (chunk g to block g % grid: the SMs work on neighbouring chunks,
// which measured faster than one contiguous range a block), and each
// block runs its chunks through a ring of `stages` stages in dynamic
// shared memory.  One thread keeps `ahead` bulk loads in flight (each
// completes on its stage's mbarrier); as a load lands it issues the
// stage's bulk store, and before it refills a stage it waits
// (wait_group.read) until the store that last used it has read it.  No
// byte passes through registers.  The thread-per-16-bytes loop this
// replaced kept one 16-byte load a thread in flight behind stores the
// compiler could not reorder, and a system fence in every block.  The
// host computes the plan (ops/remote_dma.py copy_plan): bulk where the
// source and the landing are both 16-byte aligned, the body
// floor(n/16)*16 by bulk copies and a tail of under 16 bytes by threads of
// the last block; any other pair takes a grid-stride byte loop.  Above
// 48 KB a block's shared memory must be allowed once per process and
// device (cudaFuncSetAttribute); a launch without it is refused, and the
// entry returns the error.
//
// The push keeps the thread-per-16-bytes copy (copy_body): it loads each
// 16 bytes of the source once and stores them to every landing, and it is
// faster than n-1 library copies.
//
// The flag protocol stands in for the DMA semaphores.  Each rank's window
// ends in int64 words ready[n], done[n], status and an arrival counter.
// Every rank makes every call (SPMD), so each counts calls itself and the
// call's sequence number is the same on all ranks; flags only grow, and a
// wait is "flag >= seq", so nothing is ever zeroed between calls.
//   ready[p] at rank r: peer p has reached call seq on its own stream and
//     lets r access p's window (the receive side of the semaphore pair:
//     p's earlier work on its window is done).
//   done[p] at rank r: peer p has finished accessing r's window for call
//     seq (the send semaphore: r may return, and reuse its window).
// put  (src -> dst): dst releases src.ready[dst] and waits on dst.done[src];
//      src waits on ready[dst], stores into dst's window, releases
//      dst.done[src].  dst returning after done is the reference's implicit
//      per-op quiet.
// get  (dst pulls src): src releases dst.ready[src] and waits on
//      src.done[dst]; dst waits on ready[src], loads src's window into its
//      own output and releases src.done[dst], so src cannot overwrite a
//      window that dst is still reading.
// bcast (root -> all): each peer p releases root.ready[p] and waits on
//      p.done[root]; root waits on every ready, stores to every peer and
//      releases each p.done[root].
// A release is __threadfence_system() then st.release.sys.global.u64 of
// the sequence number; a wait is one thread spinning on
// ld.acquire.sys.global.u64 with __nanosleep backoff.  The blocks of a copy
// arrive at a counter that only grows (the caller passes the value it
// reaches when this call's last block arrives); that last block publishes
// done.  Put and get: a bulk copy runs in the async proxy, so its thread
// fences (fence.proxy.async.global) after acquiring ready and, before
// arriving, waits for the full completion of its stores (wait_group 0:
// `.read` would let done be released before the landing is written) and
// fences again; the arrival is an acq_rel atomic at GPU scope, and the
// last block's st.release.sys hands the copy on to the peer.
// Every spin is bounded (kSpinNs of %globaltimer, wall time: a rank whose
// context is time-sliced off the card still counts toward the bound, which
// the SM's clock64 would not promise); past it the kernel writes a status
// code that the wrapper reads and raises on, so a protocol fault fails
// instead of hanging.
//
// Plain C interface, loaded with ctypes (ops/_build.py).  Every entry sets
// the device and returns cudaGetLastError() (or the failing call's error).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPeers = 8;
constexpr int kMaxStages = 8;
constexpr int kMaxRingBytes = 200 * 1024;   // a block's ring, at most
constexpr int kMaxDevices = 64;
constexpr unsigned long long kSpinNs = 5000000000ull;  // 5 s
constexpr long long kWaitTimeout = 1;   // a ready flag never came
constexpr long long kDoneTimeout = 2;   // a done flag never came

struct CopyArgs {
  const unsigned char* src;
  unsigned char* land[kMaxPeers];
  const long long* wait[kMaxPeers];
  long long* release[kMaxPeers];
  unsigned long long* counter;
  long long* status;
  unsigned long long nbytes;
  unsigned long long target;
  long long seq;
  int n_land;
  int n_wait;
  int n_release;
};

// The launch plan of a put or get, made on the host (ops/remote_dma.py
// CopyPlan, field for field).
struct Plan {
  unsigned long long nbytes;
  unsigned long long body;       // bytes by bulk copies, a multiple of 16
  int stage;                     // bytes of a chunk and a ring stage (x16)
  int stages;                    // ring stages
  int ahead;                     // bulk loads in flight
  int grid;
  int threads;
  int smem;                      // dynamic shared memory of a block
  int bulk;                      // 0: the byte loop
};

// One put or get call as the host packs it (ops/remote_dma.py _CALL,
// field for field): one pointer crosses ctypes, not twelve arguments.
struct RingCall {
  const void* src;
  void* land;
  const void* wait;              // null: no wait
  void* release;                 // null: no release (and no arrival)
  void* counter;
  void* status;
  long long seq;
  unsigned long long target;     // the counter once every block arrived
  const Plan* plan;
  void* stream;
  int kind;                      // 0 put, 1 get
  int device;
};

struct RingArgs {
  const unsigned char* src;
  unsigned char* land;
  const long long* wait;         // null: no wait
  long long* release;            // null: no release (and no arrival)
  unsigned long long* counter;
  long long* status;
  unsigned long long nbytes;
  unsigned long long body;
  unsigned long long target;
  long long seq;
  int stage;
  int stages;
  int ahead;
};

struct SignalArgs {
  long long* release;
  const long long* wait;
  long long* status;
  long long seq;
};

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ long long ld_acquire(const long long* p) {
  long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void release_flag(long long* p, long long v) {
  __threadfence_system();
  asm volatile("st.release.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Spin until *flag >= seq; false once the bound has passed.
__device__ bool wait_flag(const long long* flag, long long seq) {
  const unsigned long long t0 = now_ns();
  unsigned ns = 32;
  while (ld_acquire(flag) < seq) {
    if (now_ns() - t0 > kSpinNs) return false;
    __nanosleep(ns);
    if (ns < 8192) ns <<= 1;
  }
  return true;
}

__device__ __forceinline__ void set_status(long long* status, long long v) {
  atomicExch(reinterpret_cast<unsigned long long*>(status),
             static_cast<unsigned long long>(v));
}

// Wait (thread 0 of each block) for every ready flag, copy the block's
// share of the bytes to every landing, then arrive; the last block to
// arrive releases every done flag.
template <bool kVec>
__device__ __forceinline__ void copy_body(const CopyArgs& a) {
  __shared__ int go;
  if (threadIdx.x == 0) {
    int ok = 1;
#pragma unroll
    for (int i = 0; i < kMaxPeers; ++i)
      if (i < a.n_wait && ok && !wait_flag(a.wait[i], a.seq)) ok = 0;
    if (!ok) atomicExch(reinterpret_cast<unsigned long long*>(a.status),
                        static_cast<unsigned long long>(kWaitTimeout));
    go = ok;
  }
  __syncthreads();
  if (!go) return;

  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  const unsigned long long tid =
      static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  unsigned long long head = 0;
  if (kVec) {
    const unsigned long long nvec = a.nbytes / 16;
    const uint4* s = reinterpret_cast<const uint4*>(a.src);
    for (unsigned long long i = tid; i < nvec; i += stride) {
      const uint4 v = s[i];
#pragma unroll
      for (int p = 0; p < kMaxPeers; ++p)
        if (p < a.n_land) reinterpret_cast<uint4*>(a.land[p])[i] = v;
    }
    head = nvec * 16;
  }
  for (unsigned long long i = head + tid; i < a.nbytes; i += stride) {
    const unsigned char v = a.src[i];
#pragma unroll
    for (int p = 0; p < kMaxPeers; ++p)
      if (p < a.n_land) a.land[p][i] = v;
  }

  if (a.n_release == 0) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    const unsigned long long arrived = atomicAdd(a.counter, 1ull) + 1ull;
    if (arrived == a.target) {
      __threadfence_system();
#pragma unroll
      for (int i = 0; i < kMaxPeers; ++i)
        if (i < a.n_release) release_flag(a.release[i], a.seq);
    }
  }
}

// cp.async.bulk.wait_group.read takes an immediate
__device__ __forceinline__ void bulk_wait_read(int n) {
  switch (n) {
    case 0: hopper::bulk_wait_read<0>(); break;
    case 1: hopper::bulk_wait_read<1>(); break;
    case 2: hopper::bulk_wait_read<2>(); break;
    case 3: hopper::bulk_wait_read<3>(); break;
    case 4: hopper::bulk_wait_read<4>(); break;
    case 5: hopper::bulk_wait_read<5>(); break;
    case 6: hopper::bulk_wait_read<6>(); break;
    default: hopper::bulk_wait_read<7>(); break;
  }
}

// One thread moves this block's chunks of the body through the ring: the
// body is cut into chunks of `stage` bytes, chunk g goes to block
// g % gridDim.x, and the block's i-th chunk to stage i % stages; the loads
// run `ahead` chunks before the stores.  Ends with every store complete.
__device__ __forceinline__ void ring_copy(const RingArgs& a,
                                          unsigned char* ring,
                                          uint64_t* bar) {
  const unsigned long long c = static_cast<unsigned long long>(a.stage);
  const unsigned long long total = (a.body + c - 1) / c;
  if (blockIdx.x >= total) return;
  const unsigned chunks = static_cast<unsigned>(
      (total - blockIdx.x + gridDim.x - 1) / gridDim.x);
  const unsigned s_n = static_cast<unsigned>(a.stages);
  const unsigned ahead = static_cast<unsigned>(a.ahead);
  for (unsigned s = 0; s < s_n; ++s) hopper::mbar_init(&bar[s], 1);
  hopper::fence_barrier_init();

  auto at = [&](unsigned i) {   // offset of the block's i-th chunk
    return (blockIdx.x + static_cast<unsigned long long>(i) * gridDim.x) * c;
  };
  auto bytes = [&](unsigned i) {
    const unsigned long long left = a.body - at(i);
    return static_cast<uint32_t>(left < c ? left : c);
  };
  auto load = [&](unsigned i) {
    const unsigned s = i % s_n;
    hopper::mbar_expect_tx(&bar[s], bytes(i));
    hopper::bulk_load(ring + s * c, a.src + at(i), bytes(i), &bar[s]);
  };
  for (unsigned i = 0; i < ahead && i < chunks; ++i) load(i);
  for (unsigned i = 0; i < chunks; ++i) {
    const unsigned s = i % s_n;
    hopper::mbar_wait(&bar[s], (i / s_n) & 1u);
    hopper::bulk_store(a.land + at(i), ring + s * c, bytes(i));
    hopper::bulk_commit();
    if (i + ahead < chunks) {
      // the stage of chunk i + ahead last held chunk i + ahead - stages,
      // whose store is read once at most stages - ahead groups are pending
      bulk_wait_read(static_cast<int>(s_n - ahead));
      load(i + ahead);
    }
  }
  hopper::bulk_wait_all();
}

// A put or get: wait for ready, copy (bulk ring or byte loop), arrive.
template <bool kBulk>
__device__ __forceinline__ void ring_body(const RingArgs& a) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bar[kMaxStages];
  __shared__ int go;
  if (threadIdx.x == 0) {
    const bool ok = a.wait == nullptr || wait_flag(a.wait, a.seq);
    if (!ok) set_status(a.status, kWaitTimeout);
    go = ok;
  }
  __syncthreads();
  if (!go) return;

  if (kBulk) {
    if (threadIdx.x == 0) {
      hopper::fence_proxy_async_global();   // the bulk copies follow ready
      ring_copy(a, ring, bar);
      hopper::fence_proxy_async_global();   // ... and precede done
    }
    const unsigned long long tail = a.nbytes - a.body;   // under 16 bytes
    if (blockIdx.x == gridDim.x - 1 && threadIdx.x < tail)
      a.land[a.body + threadIdx.x] = a.src[a.body + threadIdx.x];
  } else {
    const unsigned long long stride =
        static_cast<unsigned long long>(gridDim.x) * blockDim.x;
    for (unsigned long long i =
             static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
             threadIdx.x;
         i < a.nbytes; i += stride)
      a.land[i] = a.src[i];
  }

  // Arrive: a release at GPU scope (the blocks of one kernel) orders the
  // block's copy before its arrival, and the last block's acquire sees
  // every block's; its release of done at system scope then hands the
  // whole copy on to the peer.  (A system fence in every block, as the
  // push does, cost several µs a call.)
  if (a.release == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long before;
    asm volatile("atom.add.acq_rel.gpu.global.u64 %0, [%1], 1;"
                 : "=l"(before) : "l"(a.counter) : "memory");
    if (before + 1ull == a.target)
      asm volatile("st.release.sys.global.u64 [%0], %1;"
                   :: "l"(a.release), "l"(a.seq) : "memory");
  }
}

template <bool kBulk>
__global__ void __launch_bounds__(kThreads) rma_put_kernel(RingArgs a) {
  ring_body<kBulk>(a);
}

template <bool kBulk>
__global__ void __launch_bounds__(kThreads) rma_get_kernel(RingArgs a) {
  ring_body<kBulk>(a);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) rma_bcast_kernel(CopyArgs a) {
  copy_body<kVec>(a);
}

// The passive side of a call: release ready to the peer that will access
// this rank's window, then wait until it is done.
__global__ void rma_signal_wait_kernel(SignalArgs a) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  release_flag(a.release, a.seq);
  if (!wait_flag(a.wait, a.seq)) set_status(a.status, kDoneTimeout);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// cudaSetDevice, skipped when this thread's device is already `device`
// (every entry of this library sets it through here)
cudaError_t use_device(int device) {
  static thread_local int current = -1;
  if (device == current) return cudaSuccess;
  const cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) current = device;
  return err;
}

// Let the bulk put and get kernels take up to kMaxRingBytes of dynamic
// shared memory (once per device; a launch above 48 KB is refused without)
cudaError_t allow_ring(int device) {
  static bool allowed[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (allowed[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      rma_put_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxRingBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rma_get_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxRingBytes);
  if (err == cudaSuccess) allowed[device] = true;
  return err;
}

bool plan_ok(const Plan& p, const void* src, const void* land) {
  if (p.grid < 1 || p.threads < 1 || p.threads > kThreads) return false;
  if (!p.bulk) return true;
  return aligned16(src) && aligned16(land) && p.body % 16 == 0 &&
         p.body <= p.nbytes && p.nbytes - p.body < 16 && p.threads >= 16 &&
         p.stage >= 16 && p.stage % 16 == 0 && p.stages >= 1 &&
         p.stages <= kMaxStages && p.ahead >= 1 && p.ahead <= p.stages &&
         p.smem >= p.stages * p.stage && p.smem <= kMaxRingBytes;
}

}  // namespace

extern "C" {

int ompi_rma_handle_bytes() { return static_cast<int>(sizeof(cudaIpcMemHandle_t)); }

int ompi_rma_max_peers() { return kMaxPeers; }

int ompi_rma_threads() { return kThreads; }

// The device's SM count (cudaDevAttrMultiProcessorCount), or -1.
int ompi_rma_sms(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return -1;
  return n;
}

int ompi_rma_call_bytes() { return static_cast<int>(sizeof(RingCall)); }

int ompi_rma_plan_bytes() { return static_cast<int>(sizeof(Plan)); }

// A put or get (a RingCall): `land` <- `src` by the host's plan.  `wait`
// and `release` may be null; a release needs `counter`, a wait or a
// release needs `status`.
int ompi_rma_ring(const void* call) {
  if (call == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const RingCall& c = *static_cast<const RingCall*>(call);
  if (c.plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Plan& p = *c.plan;
  if ((c.kind != 0 && c.kind != 1) || !plan_ok(p, c.src, c.land) ||
      (c.release != nullptr && c.counter == nullptr) ||
      ((c.wait != nullptr || c.release != nullptr) && c.status == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(c.device);
  if (err == cudaSuccess && p.bulk) err = allow_ring(c.device);
  if (err != cudaSuccess) return static_cast<int>(err);
  RingArgs a;
  a.src = static_cast<const unsigned char*>(c.src);
  a.land = static_cast<unsigned char*>(c.land);
  a.wait = static_cast<const long long*>(c.wait);
  a.release = static_cast<long long*>(c.release);
  a.counter = static_cast<unsigned long long*>(c.counter);
  a.status = static_cast<long long*>(c.status);
  a.nbytes = p.nbytes;
  a.body = p.body;
  a.target = c.target;
  a.seq = c.seq;
  a.stage = p.stage;
  a.stages = p.stages;
  a.ahead = p.ahead;
  cudaStream_t s = static_cast<cudaStream_t>(c.stream);
  if (c.kind == 0) {
    if (p.bulk) rma_put_kernel<true><<<p.grid, p.threads, p.smem, s>>>(a);
    else rma_put_kernel<false><<<p.grid, p.threads, 0, s>>>(a);
  } else {
    if (p.bulk) rma_get_kernel<true><<<p.grid, p.threads, p.smem, s>>>(a);
    else rma_get_kernel<false><<<p.grid, p.threads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// A root's push (kind 2; 0 and 1 are refused: put and get go through
// ompi_rma_ring).  land/wait/release are host arrays of n_land/n_wait/
// n_release device pointers (each at most kMaxPeers).
int ompi_rma_copy(int kind, int device, const void* src, void* const* land,
                  int n_land, unsigned long long nbytes, void* const* wait,
                  int n_wait, void* const* release, int n_release,
                  void* counter, unsigned long long target, void* status,
                  long long seq, int grid, void* stream) {
  if (n_land < 1 || n_land > kMaxPeers || n_wait < 0 || n_wait > kMaxPeers ||
      n_release < 0 || n_release > kMaxPeers || grid < 1 || kind != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((n_release > 0 && counter == nullptr) ||
      ((n_wait > 0 || n_release > 0) && status == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CopyArgs a = {};
  a.src = static_cast<const unsigned char*>(src);
  bool vec = aligned16(src);
  for (int i = 0; i < n_land; ++i) {
    a.land[i] = static_cast<unsigned char*>(land[i]);
    vec = vec && aligned16(land[i]);
  }
  for (int i = 0; i < n_wait; ++i)
    a.wait[i] = static_cast<const long long*>(wait[i]);
  for (int i = 0; i < n_release; ++i)
    a.release[i] = static_cast<long long*>(release[i]);
  a.counter = static_cast<unsigned long long*>(counter);
  a.status = static_cast<long long*>(status);
  a.nbytes = nbytes;
  a.target = target;
  a.seq = seq;
  a.n_land = n_land;
  a.n_wait = n_wait;
  a.n_release = n_release;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) rma_bcast_kernel<true><<<grid, kThreads, 0, s>>>(a);
  else rma_bcast_kernel<false><<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The passive side of a call: set *release to seq, then wait until
// *wait >= seq (a timeout lands in *status).
int ompi_rma_signal(int device, void* release, const void* wait,
                    void* status, long long seq, void* stream) {
  if (release == nullptr || wait == nullptr || status == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  SignalArgs a;
  a.release = static_cast<long long*>(release);
  a.wait = static_cast<const long long*>(wait);
  a.status = static_cast<long long*>(status);
  a.seq = seq;
  rma_signal_wait_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One window: cudaMalloc of `bytes` (data, then the flag words), zeroed,
// and its IPC handle written to `handle` (ompi_rma_handle_bytes() bytes).
int ompi_win_alloc(int device, unsigned long long bytes, void** ptr,
                   void* handle) {
  cudaError_t err = use_device(device);
  if (err == cudaSuccess) err = cudaMalloc(ptr, bytes);
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  return static_cast<int>(err);
}

// Map a peer's window from its handle (never this process's own).
int ompi_win_open(int device, const void* handle, void** ptr) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  const unsigned char* b = static_cast<const unsigned char*>(handle);
  unsigned char* d = reinterpret_cast<unsigned char*>(&h);
  for (size_t i = 0; i < sizeof(h); ++i) d[i] = b[i];
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

int ompi_win_close(int device, void* ptr) {
  cudaError_t err = use_device(device);
  if (err == cudaSuccess) err = cudaIpcCloseMemHandle(ptr);
  return static_cast<int>(err);
}

int ompi_win_free(int device, void* ptr) {
  cudaError_t err = use_device(device);
  if (err == cudaSuccess) err = cudaFree(ptr);
  return static_cast<int>(err);
}

}  // extern "C"
