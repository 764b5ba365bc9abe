// halo_exchange: the ring exchange of W halos between the ranks of spatially
// sharded inference. Rank r sends the last `left` columns of its NHWC shard
// to its right ring neighbour, which takes them as its left halo, and its
// first `right` columns to its left neighbour, which takes them as its right
// halo. Where W is not periodic, the halos that cross the global edge are
// zeros: the sender writes zeros in their place.
//
// Replaces the Pallas TPU kernel biasgan_tpu/ops/pallas_halo.py::
// halo_exchange_w (wrapper :96, pallas_call :119, body _halo_kernel :44),
// whose two remote DMAs ride the two ICI ring directions at once and whose
// receiver waits on its own DMA semaphores, on the device. It feeds the W
// pad of every conv of the sharded generator (24 exchanges per
// resnet_9blocks forward).
//
// What bounds it: it moves N*H*(left+right)*C elements, a few hundred KB at
// the globe shapes, and does no arithmetic, so it is bound by bytes: on one
// card the device memory (read + write at 3.35 TB/s, well under a
// microsecond), across cards NVLink (450 GB/s each way). At these sizes the
// launches and the synchronisation around them cost more than the copy.
//
// Common to both routes:
//   * each rank's receive slab is one cudaMalloc (so an IPC handle maps its
//     base, with no offset inside a caching-allocator block), zeroed, opened
//     by the neighbours with cudaIpcOpenMemHandle; IPC works between
//     processes on one card and between cards with peer access (NVLink).
//     It holds four buffers of `cap` bytes, a ping-pong pair per direction
//     (left halo slots 0, 1; right halo slots 0, 1), then FLAG_WORDS 64-bit
//     flag words, each on a 128-byte line of its own;
//   * a row's slice of `k` columns is k*C contiguous elements of the NHWC
//     shard, so a send is a strided gather of contiguous chunks, stored
//     packed, (N*H, k*C), straight into the neighbour's slot through a peer
//     pointer, 16 bytes per access where every chunk and base is 16-byte
//     aligned (else 8, 4, 2 or 1); one launch does both directions: blocks
//     [0, blocks_l) copy the columns that go right (the right neighbour's
//     left halo), the rest those that go left; each block walks its
//     direction's rows with a grid stride.
//
// The host-synchronised route (halo_exchange_launch, halo_read), where
// ranks share a card: processes sharing a card are time-sliced, and a
// kernel spinning on a flag could wait out a whole slice or never see it.
// So nothing spins: the wrapper launches the send, syncs its stream, meets
// the other ranks at a host barrier and reads its own slots (two device
// copies); two slots per direction make one barrier per exchange enough.
//
// The signalled route (halo_signal_send, halo_signal_recv), where every
// rank has a card of its own: the exchange is ordered on the device, with
// no host synchronisation. The flag words of a rank's slab are counters
// that only grow (zeroed once, at allocation):
//   ARRIVE_L / ARRIVE_R: a block of the left / right neighbour's send adds
//     1 once its part of this rank's left / right halo has landed;
//   FREED_L / FREED_R: a block of the right / left neighbour's receive adds
//     1 once it has read its part of the left / right halo this rank sent.
// Every word a rank spins on lives in its own memory and is written by a
// neighbour over NVLink, so spinning never crosses the link. The wrapper
// computes each wait's target from the exchange's sequence number and the
// blocks per direction (which it passes, the same on every rank: the
// exchange is collective); since the counters never reset, a stale count
// never passes for a fresh one.
//   * send: one thread per block waits (ld.acquire.sys) until the slot it
//     is about to overwrite, written two exchanges ago, has been read
//     (FREED >= target); the block copies its rows, then fence.acq_rel.sys
//     and red.release.sys.add of 1 onto the neighbour's ARRIVE word;
//   * receive, a second launch after the send on the same stream: one
//     thread per block waits until its direction's ARRIVE word reaches the
//     target, the block copies its slot into the halo tensor (ld.global.cg:
//     the slot's lines are never cached in L1, so no stale line is read),
//     then a system-scope release adds 1 onto the sender's FREED word.
// Two launches, so that a receiving block never holds an SM that a send of
// the same rank needs; stream order then does what the host barrier did.
// A wait traps after 20 s in a check build (common.cuh, watchdog_check). The
// blocks per direction are capped (SIGNAL_BLOCKS in the wrapper), so the
// kernels of a few ranks sharing one card in a single process (a loopback
// check) stay co-resident.
//
// Interface: plain C, loaded with ctypes. Launches and copies go on the
// caller's stream; every function returns a cudaError_t (0 = ok).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_BLOCKS = 512;  // per direction on the host route; the grid strides beyond
constexpr int FLAG_LINE = 128;   // bytes between flag words
enum Flag { ARRIVE_L = 0, ARRIVE_R = 1, FREED_L = 2, FREED_R = 3, FLAG_WORDS = 4 };

__device__ __forceinline__ uint64_t ld_acquire_sys(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// This block's writes (made before the preceding __syncthreads) visible
// system-wide, then 1 added to *flag with release semantics.
__device__ __forceinline__ void signal_sys(uint64_t* flag) {
  asm volatile("fence.acq_rel.sys;\n" ::: "memory");
  asm volatile("red.release.sys.global.add.u64 [%0], %1;\n" ::"l"(flag), "l"(1ull)
               : "memory");
}

// One thread: spin until *flag >= target.
__device__ __forceinline__ void wait_at_least(const uint64_t* flag, uint64_t target) {
  if (ld_acquire_sys(flag) >= target) return;
  const uint64_t t0 = port::watchdog_start();
  while (ld_acquire_sys(flag) < target) port::watchdog_check(t0);
}

// Rows of `chunk` bytes: from x at row * row_bytes + src_off to dst at
// row * chunk, or zeros in their place.
template <typename U>
__device__ __forceinline__ void copy_rows(const unsigned char* __restrict__ x,
                                          unsigned char* dst, int rows,
                                          long long row_bytes,
                                          long long src_off, int chunk,
                                          bool zero, int block, int blocks) {
  const int units = chunk / (int)sizeof(U);
  const long long total = (long long)rows * units;
  for (long long i = (long long)block * NTHREADS + threadIdx.x; i < total;
       i += (long long)blocks * NTHREADS) {
    const long long row = i / units;
    const int u = (int)(i - row * units);
    U v{};
    if (!zero) v = reinterpret_cast<const U*>(x + row * row_bytes + src_off)[u];
    reinterpret_cast<U*>(dst + row * chunk)[u] = v;
  }
}

// Blocks [0, blocks_l): the last left_bytes of each row to dst_l (the right
// neighbour's left-halo buffer); the rest: the first right_bytes of each row
// to dst_r (the left neighbour's right-halo buffer).
template <typename U>
__global__ void __launch_bounds__(NTHREADS)
    halo_exchange_kernel(const unsigned char* __restrict__ x,
                         unsigned char* dst_l, unsigned char* dst_r, int rows,
                         long long row_bytes, int left_bytes, int right_bytes,
                         int zero_l, int zero_r, int blocks_l) {
  if ((int)blockIdx.x < blocks_l) {
    copy_rows<U>(x, dst_l, rows, row_bytes, row_bytes - left_bytes, left_bytes,
                 zero_l != 0, blockIdx.x, blocks_l);
  } else {
    copy_rows<U>(x, dst_r, rows, row_bytes, 0, right_bytes, zero_r != 0,
                 blockIdx.x - blocks_l, gridDim.x - blocks_l);
  }
}

// The signalled send: halo_exchange_kernel's copy, behind a wait on this
// rank's FREED word and ahead of a release onto the neighbour's ARRIVE word.
template <typename U>
__global__ void __launch_bounds__(NTHREADS)
    signal_send_kernel(const unsigned char* __restrict__ x, unsigned char* dst_l,
                       unsigned char* dst_r, int rows, long long row_bytes,
                       int left_bytes, int right_bytes, int zero_l, int zero_r,
                       int blocks_l, const uint64_t* freed_l,
                       const uint64_t* freed_r, unsigned long long want_l,
                       unsigned long long want_r, uint64_t* arrive_l,
                       uint64_t* arrive_r) {
  const bool is_l = (int)blockIdx.x < blocks_l;
  if (threadIdx.x == 0) wait_at_least(is_l ? freed_l : freed_r, is_l ? want_l : want_r);
  __syncthreads();
  if (is_l) {
    copy_rows<U>(x, dst_l, rows, row_bytes, row_bytes - left_bytes, left_bytes,
                 zero_l != 0, blockIdx.x, blocks_l);
  } else {
    copy_rows<U>(x, dst_r, rows, row_bytes, 0, right_bytes, zero_r != 0,
                 blockIdx.x - blocks_l, gridDim.x - blocks_l);
  }
  __syncthreads();
  if (threadIdx.x == 0) signal_sys(is_l ? arrive_l : arrive_r);
}

// `bytes` from src to dst (both packed), read at L2 (ld.global.cg).
template <typename U>
__device__ __forceinline__ void copy_packed(const unsigned char* src, unsigned char* dst,
                                            long long bytes, int block, int blocks) {
  const long long units = bytes / (long long)sizeof(U);
  const U* s = reinterpret_cast<const U*>(src);
  U* d = reinterpret_cast<U*>(dst);
  for (long long i = (long long)block * NTHREADS + threadIdx.x; i < units;
       i += (long long)blocks * NTHREADS)
    d[i] = __ldcg(s + i);
}

// The signalled receive: blocks [0, blocks_l) the left halo out of src_l,
// the rest the right halo out of src_r, each behind a wait on this rank's
// ARRIVE word and ahead of a release onto the sender's FREED word.
template <typename U>
__global__ void __launch_bounds__(NTHREADS)
    signal_recv_kernel(unsigned char* lh, unsigned char* rh, const unsigned char* src_l,
                       const unsigned char* src_r, long long bytes_l, long long bytes_r,
                       int blocks_l, const uint64_t* arrive_l, const uint64_t* arrive_r,
                       unsigned long long want_l, unsigned long long want_r,
                       uint64_t* freed_l, uint64_t* freed_r) {
  const bool is_l = (int)blockIdx.x < blocks_l;
  if (threadIdx.x == 0) wait_at_least(is_l ? arrive_l : arrive_r, is_l ? want_l : want_r);
  __syncthreads();
  if (is_l)
    copy_packed<U>(src_l, lh, bytes_l, blockIdx.x, blocks_l);
  else
    copy_packed<U>(src_r, rh, bytes_r, blockIdx.x - blocks_l, gridDim.x - blocks_l);
  __syncthreads();
  if (threadIdx.x == 0) signal_sys(is_l ? freed_l : freed_r);
}

int blocks_for(int rows, int chunk, int unit) {
  if (chunk == 0) return 0;
  const long long units = (long long)rows * (chunk / unit);
  const long long b = (units + NTHREADS - 1) / NTHREADS;
  return (int)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

template <typename U>
cudaError_t launch(const void* x, void* dst_l, void* dst_r, int rows,
                   long long row_bytes, int left_bytes, int right_bytes,
                   int zero_l, int zero_r, cudaStream_t s) {
  const int bl = blocks_for(rows, left_bytes, sizeof(U));
  const int br = blocks_for(rows, right_bytes, sizeof(U));
  if (bl + br == 0) return cudaSuccess;
  halo_exchange_kernel<U><<<bl + br, NTHREADS, 0, s>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(dst_l),
      static_cast<unsigned char*>(dst_r), rows, row_bytes, left_bytes,
      right_bytes, zero_l, zero_r, bl);
  return cudaGetLastError();
}

// The widest access (16, 8, 4, 2 or 1 bytes) that divides every one of the
// OR-ed pointers and sizes in `bits`.
int unit_of(uintptr_t bits) {
  for (int u = 16; u > 1; u /= 2)
    if ((bits & (uintptr_t)(u - 1)) == 0) return u;
  return 1;
}

unsigned char* slot(void* slab, size_t cap, int buffer) {
  return static_cast<unsigned char*>(slab) + (size_t)buffer * cap;
}

uint64_t* flag(void* slab, size_t cap, int word) {
  return reinterpret_cast<uint64_t*>(static_cast<unsigned char*>(slab) + 4 * cap +
                                     (size_t)word * FLAG_LINE);
}

template <typename U>
cudaError_t launch_send(const void* x, void* own, void* to_left, void* to_right, size_t cap,
                 int k, int rows, long long row_bytes, int left_bytes,
                 int right_bytes, int zero_l, int zero_r, int bl, int br,
                 unsigned long long freed_l, unsigned long long freed_r,
                 cudaStream_t s) {
  signal_send_kernel<U><<<bl + br, NTHREADS, 0, s>>>(
      static_cast<const unsigned char*>(x), slot(to_right, cap, k),
      slot(to_left, cap, 2 + k), rows, row_bytes, left_bytes, right_bytes, zero_l,
      zero_r, bl, flag(own, cap, FREED_L), flag(own, cap, FREED_R), freed_l, freed_r,
      flag(to_right, cap, ARRIVE_L), flag(to_left, cap, ARRIVE_R));
  return cudaGetLastError();
}

template <typename U>
cudaError_t launch_recv(void* lh, void* rh, void* own, void* from_left, void* from_right,
                 size_t cap, int k, long long bytes_l, long long bytes_r, int bl,
                 int br, unsigned long long arrived_l, unsigned long long arrived_r,
                 cudaStream_t s) {
  signal_recv_kernel<U><<<bl + br, NTHREADS, 0, s>>>(
      static_cast<unsigned char*>(lh), static_cast<unsigned char*>(rh),
      slot(own, cap, k), slot(own, cap, 2 + k), bytes_l, bytes_r, bl,
      flag(own, cap, ARRIVE_L), flag(own, cap, ARRIVE_R), arrived_l, arrived_r,
      flag(from_left, cap, FREED_L), flag(from_right, cap, FREED_R));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of a slab of four `cap`-byte buffers and the flag words.
size_t halo_slab_bytes(size_t cap) { return 4 * cap + FLAG_WORDS * FLAG_LINE; }

// x: the local shard, rows = N*H rows of row_bytes = W*C*element bytes.
// dst_l / dst_r: the neighbours' receive buffers (null where that
// direction's byte count is 0). zero_l / zero_r: write zeros in place of
// that direction's columns (the global edge of a non-periodic W).
int halo_exchange_launch(const void* x, void* dst_l, void* dst_r, int rows,
                         long long row_bytes, int left_bytes, int right_bytes,
                         int zero_l, int zero_r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the widest access that divides every chunk, row stride and base
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(dst_l) |
                         reinterpret_cast<uintptr_t>(dst_r) |
                         static_cast<uintptr_t>(row_bytes) |
                         static_cast<uintptr_t>(left_bytes) |
                         static_cast<uintptr_t>(right_bytes);
  cudaError_t err;
  switch (unit_of(bits)) {
    case 16:
      err = launch<uint4>(x, dst_l, dst_r, rows, row_bytes, left_bytes,
                          right_bytes, zero_l, zero_r, s);
      break;
    case 8:
      err = launch<uint2>(x, dst_l, dst_r, rows, row_bytes, left_bytes,
                          right_bytes, zero_l, zero_r, s);
      break;
    case 4:
      err = launch<uint32_t>(x, dst_l, dst_r, rows, row_bytes, left_bytes,
                             right_bytes, zero_l, zero_r, s);
      break;
    case 2:
      err = launch<uint16_t>(x, dst_l, dst_r, rows, row_bytes, left_bytes,
                             right_bytes, zero_l, zero_r, s);
      break;
    default:
      err = launch<uint8_t>(x, dst_l, dst_r, rows, row_bytes, left_bytes,
                            right_bytes, zero_l, zero_r, s);
  }
  return static_cast<int>(err);
}

// The signalled send of one exchange into slot k of the neighbours' slabs
// (to_left, to_right: the left and right neighbours' slab bases as this
// process maps them; own: this rank's). bl / br: blocks for the columns
// that go right (the left halos) / left (0 where that direction moves no
// bytes). freed_l / freed_r: the FREED counts to wait for before
// overwriting slot k.
int halo_signal_send(const void* x, void* own, void* to_left, void* to_right,
                     size_t cap, int k, int rows, long long row_bytes,
                     int left_bytes, int right_bytes, int zero_l, int zero_r,
                     int bl, int br, unsigned long long freed_l,
                     unsigned long long freed_r, void* stream) {
  if (bl + br == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | static_cast<uintptr_t>(cap) |
                         reinterpret_cast<uintptr_t>(to_left) |
                         reinterpret_cast<uintptr_t>(to_right) |
                         static_cast<uintptr_t>(row_bytes) |
                         static_cast<uintptr_t>(left_bytes) |
                         static_cast<uintptr_t>(right_bytes);
  cudaError_t err;
#define PORT_SEND(U)                                                            \
  launch_send<U>(x, own, to_left, to_right, cap, k, rows, row_bytes, left_bytes,       \
          right_bytes, zero_l, zero_r, bl, br, freed_l, freed_r, s)
  switch (unit_of(bits)) {
    case 16: err = PORT_SEND(uint4); break;
    case 8: err = PORT_SEND(uint2); break;
    case 4: err = PORT_SEND(uint32_t); break;
    case 2: err = PORT_SEND(uint16_t); break;
    default: err = PORT_SEND(uint8_t);
  }
#undef PORT_SEND
  return static_cast<int>(err);
}

// The signalled receive of one exchange out of slot k of this rank's slab
// into lh (bytes_l) and rh (bytes_r), after the send on the same stream.
// from_left, from_right: the neighbours' slab bases (their FREED words).
// arrived_l / arrived_r: the ARRIVE counts that mean slot k holds this
// exchange's halos.
int halo_signal_recv(void* lh, void* rh, void* own, void* from_left, void* from_right,
                     size_t cap, int k, long long bytes_l, long long bytes_r, int bl,
                     int br, unsigned long long arrived_l,
                     unsigned long long arrived_r, void* stream) {
  if (bl + br == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(lh) | reinterpret_cast<uintptr_t>(rh) |
                         reinterpret_cast<uintptr_t>(own) | static_cast<uintptr_t>(cap) |
                         static_cast<uintptr_t>(bytes_l) | static_cast<uintptr_t>(bytes_r);
  cudaError_t err;
#define PORT_RECV(U)                                                              \
  launch_recv<U>(lh, rh, own, from_left, from_right, cap, k, bytes_l, bytes_r, bl, br, \
          arrived_l, arrived_r, s)
  switch (unit_of(bits)) {
    case 16: err = PORT_RECV(uint4); break;
    case 8: err = PORT_RECV(uint2); break;
    case 4: err = PORT_RECV(uint32_t); break;
    case 2: err = PORT_RECV(uint16_t); break;
    default: err = PORT_RECV(uint8_t);
  }
#undef PORT_RECV
  return static_cast<int>(err);
}

// `bytes` of zeroed device memory on `device` at *ptr, and its IPC handle
// (a cudaIpcMemHandle_t, 64 bytes) in `handle`. The zeros have landed when
// it returns: a neighbour may add to the flag words as soon as it has the
// handle.
int halo_buffer_alloc(int device, size_t bytes, void** ptr, void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(ptr, bytes);
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  return static_cast<int>(err);
}

// Another process's buffer, by its IPC handle, mapped at *ptr.
int halo_buffer_open(int device, const void* handle, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaIpcOpenMemHandle(
        ptr, *static_cast<const cudaIpcMemHandle_t*>(handle),
        cudaIpcMemLazyEnablePeerAccess);
  return static_cast<int>(err);
}

int halo_buffer_close(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaIpcCloseMemHandle(ptr);
  return static_cast<int>(err);
}

int halo_buffer_free(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaFree(ptr);
  return static_cast<int>(err);
}

// Whether `device` can address `peer`'s memory with native atomics (the
// flag words' adds), as over NVLink: 1 or 0 in *ok.
int halo_can_access_peer(int device, int peer, int* ok) {
  int access = 0, atomics = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&access, device, peer);
  if (err == cudaSuccess && access)
    err = cudaDeviceGetP2PAttribute(&atomics, cudaDevP2PAttrNativeAtomicSupported,
                                    device, peer);
  *ok = access && atomics;
  return static_cast<int>(err);
}

// The received halos out of this rank's own buffers: two device copies on
// the stream (a size of 0 skips one).
int halo_read(void* dst_l, const void* src_l, size_t bytes_l, void* dst_r,
              const void* src_r, size_t bytes_r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (bytes_l)
    err = cudaMemcpyAsync(dst_l, src_l, bytes_l, cudaMemcpyDeviceToDevice, s);
  if (err == cudaSuccess && bytes_r)
    err = cudaMemcpyAsync(dst_r, src_r, bytes_r, cudaMemcpyDeviceToDevice, s);
  return static_cast<int>(err);
}

}  // extern "C"
