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
// copying rank's threads load and store the peer's memory directly.
//
// What bounds it on one H100: bytes.  A put or get reads and writes B bytes
// of the same HBM, 2B / 3.35 TB/s; a root's push to n-1 peers reads B and
// writes (n-1)B.  Ranks on separate cards move B over NVLink at 450 GB/s
// each way.  The copy is grid-stride, 16 bytes a thread (uint4) where the
// source and every landing are 16-byte aligned, with a byte loop for the
// ragged tail (and for unaligned pointers); it works on bytes, so one
// kernel serves every dtype.  A push loads each 16 bytes of the source
// once and stores them to every landing.
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
// done.  Every spin is bounded (kSpinNs of %globaltimer, wall time: a rank
// whose context is time-sliced off the card still counts toward the bound,
// which the SM's clock64 would not promise); past it the kernel writes a
// status code that the wrapper reads and raises on, so a protocol fault
// fails instead of hanging.
//
// Plain C interface, loaded with ctypes (ops/_build.py).  Every entry sets
// the device and returns cudaGetLastError() (or the failing call's error).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPeers = 8;
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

struct SignalArgs {
  long long* release[kMaxPeers];
  const long long* wait[kMaxPeers];
  long long* status;
  long long seq;
  int n_release;
  int n_wait;
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

template <bool kVec>
__global__ void __launch_bounds__(kThreads) rma_put_kernel(CopyArgs a) {
  copy_body<kVec>(a);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) rma_get_kernel(CopyArgs a) {
  copy_body<kVec>(a);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) rma_bcast_kernel(CopyArgs a) {
  copy_body<kVec>(a);
}

// The passive side of a call: release ready to the peer that will access
// this rank's window, then wait until it is done.
__global__ void rma_signal_wait_kernel(SignalArgs a) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
#pragma unroll
  for (int i = 0; i < kMaxPeers; ++i)
    if (i < a.n_release) release_flag(a.release[i], a.seq);
#pragma unroll
  for (int i = 0; i < kMaxPeers; ++i) {
    if (i < a.n_wait && !wait_flag(a.wait[i], a.seq)) {
      atomicExch(reinterpret_cast<unsigned long long*>(a.status),
                 static_cast<unsigned long long>(kDoneTimeout));
      return;
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

int ompi_rma_handle_bytes() { return static_cast<int>(sizeof(cudaIpcMemHandle_t)); }

int ompi_rma_max_peers() { return kMaxPeers; }

int ompi_rma_threads() { return kThreads; }

// kind: 0 put, 1 get, 2 bcast.  land/wait/release are host arrays of
// n_land/n_wait/n_release device pointers (each at most kMaxPeers).
int ompi_rma_copy(int kind, int device, const void* src, void* const* land,
                  int n_land, unsigned long long nbytes, void* const* wait,
                  int n_wait, void* const* release, int n_release,
                  void* counter, unsigned long long target, void* status,
                  long long seq, int grid, void* stream) {
  if (n_land < 1 || n_land > kMaxPeers || n_wait < 0 || n_wait > kMaxPeers ||
      n_release < 0 || n_release > kMaxPeers || grid < 1 || kind < 0 ||
      kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((n_release > 0 && counter == nullptr) ||
      ((n_wait > 0 || n_release > 0) && status == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
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
  if (kind == 0) {
    if (vec) rma_put_kernel<true><<<grid, kThreads, 0, s>>>(a);
    else rma_put_kernel<false><<<grid, kThreads, 0, s>>>(a);
  } else if (kind == 1) {
    if (vec) rma_get_kernel<true><<<grid, kThreads, 0, s>>>(a);
    else rma_get_kernel<false><<<grid, kThreads, 0, s>>>(a);
  } else {
    if (vec) rma_bcast_kernel<true><<<grid, kThreads, 0, s>>>(a);
    else rma_bcast_kernel<false><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

int ompi_rma_signal_wait(int device, void* const* release, int n_release,
                         void* const* wait, int n_wait, void* status,
                         long long seq, void* stream) {
  if (n_release < 0 || n_release > kMaxPeers || n_wait < 0 ||
      n_wait > kMaxPeers || status == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  SignalArgs a = {};
  for (int i = 0; i < n_release; ++i)
    a.release[i] = static_cast<long long*>(release[i]);
  for (int i = 0; i < n_wait; ++i)
    a.wait[i] = static_cast<const long long*>(wait[i]);
  a.status = static_cast<long long*>(status);
  a.seq = seq;
  a.n_release = n_release;
  a.n_wait = n_wait;
  rma_signal_wait_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One window: cudaMalloc of `bytes` (data, then the flag words), zeroed,
// and its IPC handle written to `handle` (ompi_rma_handle_bytes() bytes).
int ompi_win_alloc(int device, unsigned long long bytes, void** ptr,
                   void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(ptr, bytes);
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  return static_cast<int>(err);
}

// Map a peer's window from its handle (never this process's own).
int ompi_win_open(int device, const void* handle, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  const unsigned char* b = static_cast<const unsigned char*>(handle);
  unsigned char* d = reinterpret_cast<unsigned char*>(&h);
  for (size_t i = 0; i < sizeof(h); ++i) d[i] = b[i];
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

int ompi_win_close(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaIpcCloseMemHandle(ptr);
  return static_cast<int>(err);
}

int ompi_win_free(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaFree(ptr);
  return static_cast<int>(err);
}

}  // extern "C"
