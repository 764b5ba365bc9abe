// Device helpers shared by the port's convolution kernels: element
// conversion, 16-byte vector moves, cp.async staging, the tensor-core
// primitives (ldmatrix, mma.sync m16n8k16 bf16), weight staging and the
// fixed-order moment reduction. Header-only; each kernel source includes it
// and build.py hashes it with the source.

#pragma once

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

// Tensor-core primitives (sm_80+): four 8x8 b16 matrices from shared memory
// (each lane gives one row address), optionally transposed, and the
// m16n8k16 bf16 MMA with f32 accumulation.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

}  // namespace port

// Every kernel library exports this (each is loaded on its own with ctypes).
extern "C" const char* port_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
