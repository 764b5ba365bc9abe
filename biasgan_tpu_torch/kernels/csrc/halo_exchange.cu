// halo_exchange: the ring exchange of W halos between the ranks of spatially
// sharded inference. Rank r sends the last `left` columns of its NHWC shard
// to its right ring neighbour, which takes them as its left halo, and its
// first `right` columns to its left neighbour, which takes them as its right
// halo. Where W is not periodic, the halos that cross the global edge are
// zeros: the sender writes zeros in their place.
//
// Replaces the Pallas TPU kernel biasgan_tpu/ops/pallas_halo.py::
// halo_exchange_w (wrapper :96, pallas_call :119, body _halo_kernel :44),
// whose two remote DMAs ride the two ICI ring directions at once. It feeds
// the W pad of every conv of the sharded generator (24 exchanges per
// resnet_9blocks forward).
//
// What bounds it: it moves N*H*(left+right)*C elements, a few hundred KB at
// the globe shapes, and does no arithmetic, so it is bound by bytes: on one
// card the device memory (read + write at 3.35 TB/s, well under a
// microsecond), across cards NVLink (450 GB/s each way). At these sizes the
// launch and the host-side synchronisation around it cost more than the
// copy.
//
// Design:
//   * one launch does both directions: blocks [0, blocks_l) copy the
//     columns that go right (the right neighbour's left halo), the remaining
//     blocks those that go left; each block walks its direction's rows with
//     a grid stride;
//   * a row's slice of `k` columns is k*C contiguous elements of the NHWC
//     shard, so the copy is a strided gather of contiguous chunks, stored
//     packed, (N*H, k*C), straight into the neighbour's receive buffer
//     through a peer pointer, 16 bytes per access where every chunk and base
//     is 16-byte aligned (else 8, 4, 2 or 1);
//   * the receive buffers are one cudaMalloc per rank (so an IPC handle maps
//     its base, with no offset inside a caching-allocator block), opened by
//     the neighbours with cudaIpcOpenMemHandle. IPC works between processes
//     on one card and between cards with peer access (NVLink);
//   * no flag is spun on in device memory: processes sharing a card are
//     time-sliced, and a spinning kernel could wait out a whole slice or
//     never see its flag. Synchronisation is on the host (launch, stream
//     sync, group barrier, read), and two buffers per direction (ping-pong)
//     make one barrier per exchange enough.
//
// Interface: plain C, loaded with ctypes. Launches and copies go on the
// caller's stream; every function returns a cudaError_t (0 = ok).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_BLOCKS = 512;  // per direction; the grid strides beyond

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

}  // namespace

extern "C" {

const char* port_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

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
  if ((bits & 15) == 0)
    err = launch<uint4>(x, dst_l, dst_r, rows, row_bytes, left_bytes,
                        right_bytes, zero_l, zero_r, s);
  else if ((bits & 7) == 0)
    err = launch<uint2>(x, dst_l, dst_r, rows, row_bytes, left_bytes,
                        right_bytes, zero_l, zero_r, s);
  else if ((bits & 3) == 0)
    err = launch<uint32_t>(x, dst_l, dst_r, rows, row_bytes, left_bytes,
                           right_bytes, zero_l, zero_r, s);
  else if ((bits & 1) == 0)
    err = launch<uint16_t>(x, dst_l, dst_r, rows, row_bytes, left_bytes,
                           right_bytes, zero_l, zero_r, s);
  else
    err = launch<uint8_t>(x, dst_l, dst_r, rows, row_bytes, left_bytes,
                          right_bytes, zero_l, zero_r, s);
  return static_cast<int>(err);
}

// `bytes` of zeroed device memory on `device` at *ptr, and its IPC handle
// (a cudaIpcMemHandle_t, 64 bytes) in `handle`.
int halo_buffer_alloc(int device, size_t bytes, void** ptr, void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(ptr, bytes);
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, bytes);
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
