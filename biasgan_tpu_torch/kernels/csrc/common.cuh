// Device helpers shared by the port's kernels: element conversion, 16-byte
// vector moves, cp.async staging, ldmatrix, weight staging, the fixed-order
// moment reduction, the spin waits' watchdog, and Hopper's asynchronous
// machinery (port::sm90: TMA tensor maps and loads, mbarrier rings, wgmma
// descriptors, fences and named barriers). Header-only; each kernel source
// includes it and build.py hashes it with the source.

#pragma once

#include <cuda.h>  // the CUtensorMap type and its enums only: nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace port {

enum PadMode { PAD_ZERO = 0, PAD_REFLECT = 1, PAD_WRAP = 2 };
enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LRELU = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// act(a*x + b) in f32, one multiply and one add (no fused multiply-add, as
// the plain versions compute it), rounded once to T: the prologue of the
// fused convs. a and b are f32: rounding them to bf16, as the Pallas
// down/up kernels do, moves a bf16 generator further from its f32 result.
template <typename T>
__device__ __forceinline__ T affine_act(T x, float a, float b, int act) {
  float f = __fadd_rn(__fmul_rn(to_f(x), a), b);
  if (act == ACT_RELU) f = fmaxf(f, 0.f);
  else if (act == ACT_LRELU) f = f > 0.f ? f : 0.2f * f;
  return from_f<T>(f);
}

// The prologue on a packed pair of bf16 (low half first), activation fixed
// at compile time, for the tensor-core kernels' register path: a*x + b in
// f32 as one fused multiply-add (f32 a and b, one rounding in f32), then
// one rounding of the pair to bf16 (cvt.rn.bf16x2, which also applies a
// ReLU). affine_act's separate multiply and add may differ from it by one
// f32 ulp before that rounding.
template <int ACT>
__device__ __forceinline__ uint32_t affine_act_bf16x2(uint32_t w, float a0,
                                                      float b0, float a1,
                                                      float b1) {
  float lo = fmaf(__uint_as_float(w << 16), a0, b0);
  float hi = fmaf(__uint_as_float(w & 0xffff0000u), a1, b1);
  if (ACT == ACT_LRELU) {
    lo = fmaxf(lo, 0.2f * lo);
    hi = fmaxf(hi, 0.2f * hi);
  }
  uint32_t r;
  if (ACT == ACT_RELU)
    asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  else
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Eight consecutive elements; 16-byte vector moves when aligned.
template <typename T>
struct alignas(16) Vec8 {
  T v[8];
};

template <typename T>
__device__ __forceinline__ Vec8<T> load8(const T* __restrict__ src, int valid,
                                         bool vec) {
  Vec8<T> r;
  if (vec && valid == 8) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(Vec8<T>) / 16); ++i)
      reinterpret_cast<uint4*>(&r)[i] = s[i];
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[i] = i < valid ? src[i] : from_f<T>(0.f);
  }
  return r;
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const Vec8<T>& r) {
#pragma unroll
  for (int i = 0; i < (int)(sizeof(Vec8<T>) / 16); ++i)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(&r)[i];
}

// ---------------------------------------------------------------------------
// Asynchronous copies into shared memory. Groups of 8 consecutive elements
// move as 16-byte cp.async copies (zero-filled where out of range) when the
// tensor is 16-byte aligned at every group (C or Cout % 8 == 0); otherwise
// element by element.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One group of 8 elements: asynchronous when `vec`, else copied now.
template <typename T>
__device__ __forceinline__ void copy8(T* dst, const T* __restrict__ src,
                                      const T* __restrict__ base, int valid,
                                      bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < (int)(sizeof(Vec8<T>) / 16); ++i)
      cp_async16(reinterpret_cast<uint4*>(dst) + i,
                 valid == 8 ? reinterpret_cast<const uint4*>(src) + i
                            : reinterpret_cast<const uint4*>(base),
                 valid == 8);
  } else {
    store8(dst, load8(src, valid, false));
  }
}

// Weights of taps 0..8, channels [k0, k0+KCC), couts [co0, co0+NT) from w9
// (9, C, Cout) into s_w[tap][k][ldw].
template <typename T, int KCC, int NT, int NTH>
__device__ __forceinline__ void issue_weights(T* s_w, int ldw,
                                              const T* __restrict__ w9, int C,
                                              int Cout, int k0, int co0,
                                              bool vec) {
  constexpr int GROUPS = 9 * KCC * (NT / 8);
  for (int g = threadIdx.x; g < GROUPS; g += NTH) {
    const int n8 = (g % (NT / 8)) * 8;
    const int row = g / (NT / 8);  // tap * KCC + k
    const int tap = row / KCC, k = row % KCC;
    const int kc = k0 + k, co = co0 + n8;
    const int valid = kc < C ? max(min(8, Cout - co), 0) : 0;
    const T* src = w9 + ((size_t)tap * C + min(kc, C - 1)) * Cout + co;
    copy8(s_w + row * ldw + n8, src, w9, valid, vec);
  }
}

// One chunk of KCC input channels of a kernel's input halo, PIX staged pixels,
// into shared memory: staged pixel p sits at s_in + p * ASTR. `map(p, &iy,
// &ix)` gives the input pixel that slot p holds, or false where it holds a
// zero (a zero pad, or a pixel that only masked outputs read). An optional
// prologue act(a*x + b) (affine_act; a, b are (N, C) f32) applies to the
// real values only: a zero pad is a zero of the normalized input. With `vec`
// the copies are asynchronous (issue), and the prologue runs in place once
// they have landed (finish); otherwise issue copies and transforms at once.
// All of a thread's groups hold the same 8 channels, so it loads their
// prologue scales once.
template <typename T, int PIX, int KCC, int ASTR, int NTH>
struct HaloChunk {
  static constexpr int GROUPS = PIX * (KCC / 8);
  static_assert(NTH % (KCC / 8) == 0, "one channel group per thread");

  // Channels [kc, kc+8) of staged pixel `pix`: source offset and how many
  // are real (0 where the slot is zero or the channels ran out).
  template <class Map>
  __device__ __forceinline__ static int source(const Map& map, int pix, int n,
                                               int H, int W, int C, int kc,
                                               size_t* src) {
    int iy = 0, ix = 0;
    const bool real = map(pix, &iy, &ix);
    *src = (((size_t)n * H + (real ? iy : 0)) * W + (real ? ix : 0)) * C + kc;
    return real ? max(min(8, C - kc), 0) : 0;
  }

  __device__ __forceinline__ static void scales(const float* __restrict__ pa,
                                                const float* __restrict__ pb,
                                                int n, int C, int kc,
                                                float (&a)[8], float (&b)[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = min(kc + i, C - 1);
      a[i] = pa[(size_t)n * C + k];
      b[i] = pb[(size_t)n * C + k];
    }
  }

  __device__ __forceinline__ static void transform(Vec8<T>& v, int valid,
                                                   const float (&a)[8],
                                                   const float (&b)[8],
                                                   int act) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < valid) v.v[i] = affine_act(v.v[i], a[i], b[i], act);
  }

  template <class Map>
  __device__ __forceinline__ static void issue(
      T* s_in, const T* __restrict__ x, const float* __restrict__ pa,
      const float* __restrict__ pb, const Map& map, int n, int H, int W, int C,
      int k0, int act, bool vec) {
    const int kc = k0 + (threadIdx.x % (KCC / 8)) * 8;
    float a[8], b[8];
    if (!vec && pa != nullptr) scales(pa, pb, n, C, kc, a, b);
    for (int g = threadIdx.x; g < GROUPS; g += NTH) {
      const int pix = g / (KCC / 8);
      size_t src;
      const int valid = source(map, pix, n, H, W, C, kc, &src);
      T* dst = s_in + pix * ASTR + (kc - k0);
      if (vec) {
        copy8(dst, x + src, x, valid, true);
      } else {
        Vec8<T> v = load8(x + src, valid, false);
        if (pa != nullptr) transform(v, valid, a, b, act);
        store8(dst, v);
      }
    }
  }

  // After an asynchronous copy has landed (cp_async_wait_*): the prologue,
  // in place, on the real values this thread copied.
  template <class Map>
  __device__ __forceinline__ static void finish(
      T* s_in, const float* __restrict__ pa, const float* __restrict__ pb,
      const Map& map, int n, int H, int W, int C, int k0, int act, bool vec) {
    if (!vec || pa == nullptr) return;
    const int kc = k0 + (threadIdx.x % (KCC / 8)) * 8;
    float a[8], b[8];
    scales(pa, pb, n, C, kc, a, b);
    for (int g = threadIdx.x; g < GROUPS; g += NTH) {
      const int pix = g / (KCC / 8);
      size_t src;
      const int valid = source(map, pix, n, H, W, C, kc, &src);
      if (valid == 0) continue;
      T* p = s_in + pix * ASTR + (kc - k0);
      Vec8<T> v = load8(p, 8, true);
      transform(v, valid, a, b, act);
      store8(p, v);
    }
  }
};

// Four 8x8 b16 matrices from shared memory into registers (each lane gives
// one row address): the A fragments the wgmma kernels take from registers.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Sum the per-thread moment partials of one column group across row groups
// in a fixed order and write this block's tile partials:
// red = [sum|sq][group][nt], part = (2, N, n_tiles, Cout).
template <int NTH>
__device__ __forceinline__ void write_tile_moments(
    const float* red, int groups, int nt, float* __restrict__ part, int n,
    int N, int tile, int n_tiles, int co0, int Cout) {
  for (int t = threadIdx.x; t < nt; t += NTH) {
    const int co = co0 + t;
    if (co >= Cout) continue;
    float s = 0.f, q = 0.f;
    for (int gi = 0; gi < groups; ++gi) {
      s += red[gi * nt + t];
      q += red[(groups + gi) * nt + t];
    }
    const size_t o = ((size_t)n * n_tiles + tile) * Cout + co;
    part[o] = s;
    part[(size_t)N * n_tiles * Cout + o] = q;
  }
}

// Sums over the tiles of per-tile partials, on a (RED_CH, RED_LANES) block:
// thread (c, l) takes channel c of the block and tiles l, l + RED_LANES, ...
// (reads coalesced across the channels), then lane 0 adds the lanes' sums
// in order. The order is fixed: deterministic, no float atomics.
constexpr int RED_CH = 32, RED_LANES = 8;

// The sum over t < n_tiles of p[t * stride], in the threadIdx.y == 0 threads.
__device__ __forceinline__ float sum_tiles(const float* __restrict__ p,
                                           int n_tiles, int stride,
                                           bool active) {
  __shared__ float red[RED_LANES][RED_CH];
  float s = 0.f;
  if (active)
    for (int t = threadIdx.y; t < n_tiles; t += RED_LANES) s += p[(size_t)t * stride];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.y == 0)
    for (int l = 0; l < RED_LANES; ++l) total += red[l][threadIdx.x];
  __syncthreads();  // red is reused by the next call
  return total;
}

// moments[which][n][co] = sum over tiles of part[which][n][tile][co].
__global__ void __launch_bounds__(RED_CH * RED_LANES)
    reduce_moments_kernel(const float* __restrict__ part,
                          float* __restrict__ moments, int N, int n_tiles,
                          int Cout) {
  const int co = blockIdx.x * RED_CH + threadIdx.x;
  const int n = blockIdx.y, which = blockIdx.z;
  const bool active = co < Cout;
  const float* p = part + ((size_t)which * N + n) * n_tiles * Cout + co;
  const float s = sum_tiles(p, n_tiles, Cout, active);
  if (threadIdx.y == 0 && active) moments[((size_t)which * N + n) * Cout + co] = s;
}

inline cudaError_t launch_reduce_moments(const float* part, float* moments,
                                         int N, int n_tiles, int Cout,
                                         cudaStream_t s) {
  dim3 grid((Cout + RED_CH - 1) / RED_CH, N, 2);
  reduce_moments_kernel<<<grid, dim3(RED_CH, RED_LANES), 0, s>>>(
      part, moments, N, n_tiles, Cout);
  return cudaGetLastError();
}

// The deadline of a spin wait (an mbarrier's phase, a flag in device
// memory). A wait whose count is wrong would spin forever. A check build
// (PORT_WATCHDOG, see kernels/build.py) traps after 20 s instead of
// holding the card; a trap is sticky, the process's CUDA context is lost
// and every later call fails, and a slow but valid wait (a card shared in
// time slices) could trip it, so the program's own build leaves it out.
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
__device__ __forceinline__ uint64_t watchdog_start() {
#ifdef PORT_WATCHDOG
  return global_ns();
#else
  return 0;
#endif
}
__device__ __forceinline__ void watchdog_check(uint64_t t0) {
#ifdef PORT_WATCHDOG
  if (global_ns() - t0 > 20000000000ull) __trap();
#else
  (void)t0;
#endif
}

// ---------------------------------------------------------------------------
// Hopper (sm_90a): TMA, mbarriers, wgmma. The pieces a warp-specialised
// kernel is built from: one producer thread keeps TMA loads of a ring of
// shared-memory stages in flight, each stage guarded by a "full" mbarrier
// (the loads' bytes have landed) and an "empty" one (every consumer warp
// is done with it); consumer warpgroups run wgmma on the stages that have
// landed. K4 (conv3x3s2_fused.cu), K1's and K6's bf16 kernel
// (conv3x3_tma.cuh) and K3's (conv7x7.cu) are built on them.
// ---------------------------------------------------------------------------
namespace sm90 {

// Host: cuTensorMapEncodeTiled, fetched through the runtime's entry-point
// query (no -lcuda at link time). Null where the installed CUDA lacks it.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                   void*, const cuuint64_t*, const cuuint64_t*,
                                   const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn tensor_map_encoder() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A tiled tensor map over a bf16 tensor of `rank` dimensions, innermost
// first: dims[rank], byte strides of dims 1.. (strides[rank - 1]), the box
// a load brings (box[rank]). With `swizzle128` the box's inner extent must
// be 128 bytes and shared memory receives it in the 128-byte swizzle that
// sw128_desc describes; without, row after row. Out-of-bounds elements of
// a box (negative coordinates included) arrive as zeros.
inline cudaError_t encode_bf16_map(CUtensorMap* map, const void* base, int rank,
                                   const cuuint64_t* dims,
                                   const cuuint64_t* strides,
                                   const cuuint32_t* box, bool swizzle128) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
      const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers (64-bit words in shared memory).
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}
// after the inits, before any thread uses the barriers (then a block sync)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrive once and expect `bytes` more from the TMA loads that name it
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait until the barrier's phase of this parity has completed. A ring
// whose arrivals were miscounted would wait forever; a check build traps
// instead (watchdog_check).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  if (mbar_try_wait(a, parity)) return;
  const uint64_t t0 = watchdog_start();
  while (!mbar_try_wait(a, parity)) watchdog_check(t0);
}

// TMA loads of one box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// TMA store of one box from shared memory (bulk-group completion): issue,
// commit, and wait until the reads of shared memory (wait_read) or the
// whole stores (wait) of all but N committed groups are done.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy writes to shared memory (st.shared) made visible to the
// async proxy (wgmma operand reads, TMA): after the writes, before the
// barrier that orders them with the reader.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// bar.sync on named barrier `id` (1..15; 0 is __syncthreads) by `count`
// threads, a multiple of 32.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// Where chunk `cc` (16 bytes) of row `row` of a 128-byte-swizzled tile
// lies, in bytes from the tile's start (1024-aligned): what TMA writes
// under CU_TENSOR_MAP_SWIZZLE_128B and what sw128_desc reads.
__device__ __forceinline__ int sw128_offset(int row, int cc) {
  return row * 128 + ((cc ^ (row & 7)) << 4);
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle: rows of
// 64 bf16 (128 bytes), eight-row groups 1024 bytes apart (SBO), the tile
// 1024-aligned. A step of 16 along K adds 2 (32 bytes >> 4); a step of 128
// rows adds 1024.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |            // LBO (unused here)
         (static_cast<uint64_t>(1024 >> 4) << 32) |    // SBO
         (static_cast<uint64_t>(1) << 62);             // SWIZZLE_128B
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D (64 x 128, f32) += A (64 x 16) B (16 x 128), bf16 in: A from registers,
// B from shared memory through its descriptor (K-major). Thread t of the
// warpgroup holds a[0..3] as mma.sync's m16n8k16 A fragment of rows
// 16 (t / 32) .. + 15 (ldmatrix_x4 of those rows gives it), and d[j] at row
// 16 (t / 32) + (t % 32) / 4 + 8 ((j / 2) % 2) and column 8 (j / 4) +
// 2 (t % 4) + j % 2. A register written since the last wgmma_fence needs
// one before this reads it.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// wgmma descriptor of an MN-major operand in the 128-byte swizzle (K rows
// of 64 bf16 along M or N, 128 bytes each, as a TMA box of 64 channels by
// pixels lands): eight-row groups along K 1024 bytes apart (SBO), 64-wide
// blocks along M or N `lbo` bytes apart (LBO), the tile 1024-aligned. A
// step of 16 along K adds 2048 bytes to the start.
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* tile, uint32_t lbo) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |     // LBO
         (static_cast<uint64_t>(1024 >> 4) << 32) |    // SBO
         (static_cast<uint64_t>(1) << 62);             // SWIZZLE_128B
}

// D (64 x 128, f32) += A (64 x 16) B (16 x 128), bf16 in, both from shared
// memory through their descriptors: K-major (TA / TB 0, sw128_desc) or
// MN-major (1, sw128_mn_desc); d[j] as in wgmma_m64n128k16_rs.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D (64 x 256, f32) += A (64 x 16) B (16 x 256), bf16 in, A from registers
// as in wgmma_m64n128k16_rs (read once for all 256 columns); d[j] at row
// 16 (t / 32) + (t % 32) / 4 + 8 ((j / 2) % 2) and column 8 (j / 4) +
// 2 (t % 4) + j % 2.
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x N, f32) = A (64 x 16) B (16 x N) + (scale_d ? D : 0), bf16 in, for
// the narrow N of the 7x7 convs (conv7x7.cu): A from registers and d[j] at
// row 16 (t / 32) + (t % 32) / 4 + 8 ((j / 2) % 2) and column 8 (j / 4) +
// 2 (t % 4) + j % 2, as in wgmma_m64n128k16_rs; scale_d 0 starts a sum
// without zeroing d first.
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n56k16_rs(float (&d)[28],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, "
      "{%28, %29, %30, %31}, %32, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

}  // namespace sm90

}  // namespace port

// Every kernel library exports this (each is loaded on its own with ctypes).
extern "C" const char* port_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
