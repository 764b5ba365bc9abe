// instance_norm_act: affine-free instance norm of an NHWC tensor over H x W
// (f32 statistics, biased variance max(E[x^2] - E[x]^2, 0), eps), an
// optional residual added in f32, then none / ReLU / LeakyReLU(0.2), one
// cast to the input's dtype.
//
// Replaces the Pallas TPU kernel biasgan_tpu/ops/pallas_fused.py::
// fused_instance_norm_act (:149; _pallas_forward :113, bodies _fused_kernel
// :94 and _fused_kernel_res :103). It carries every norm_act of the resnet
// generator under --force_pallas_norm.
//
// What bounds it on an H100: it reads x (and the residual) and writes y, a
// few operations per element: memory. At the globe shapes a block norm with
// its residual moves 100 MB, a (1, 724, 1440, 64) norm 267 MB.
//
// Design. The Pallas kernel holds a whole (H, W, 128-channel) block in VMEM
// and reduces it in one pass; an H100 block holds far less, and blocks run
// in no order. So three launches, deterministic, with no float atomics:
//   1. partial sums: block (tile, channel block, n) sums x and x^2 over its
//      share of the H x W pixels for up to 256 channels, 8 per thread with
//      16-byte loads, and writes them per tile;
//   2. statistics: per (n, c), the tile partials in a fixed order -> mean
//      and 1 / sqrt(var + eps);
//   3. apply: one elementwise pass, 8 channels per thread, reading x, the
//      residual and the statistics, writing y.
// x is read twice (a tensor that fits the 50 MB L2 may be served from it
// the second time).
//
// Interface: plain C, loaded with ctypes; launches go on the caller's stream
// and the function returns the cudaError_t of the launches (0 = ok).

#include <algorithm>

#include "common.cuh"

namespace {

using namespace port;

constexpr int NTH = 256;
constexpr int GB = 32;           // channel groups (of 8) per partial-sum block
constexpr int TARGET_BLOCKS = 1056;  // 8 per SM on 132 SMs

struct Plan {
  int groups;   // channel groups of 8
  int gy;       // channel blocks
  int tiles;    // pixel tiles per image
  int tile_px;  // pixels per tile
};

Plan make_plan(int N, int HW, int C) {
  Plan p;
  p.groups = (C + 7) / 8;
  p.gy = (p.groups + GB - 1) / GB;
  const int want = std::max(1, TARGET_BLOCKS / std::max(1, N * p.gy));
  p.tile_px = std::max(1, (HW + want - 1) / want);
  p.tiles = (HW + p.tile_px - 1) / p.tile_px;
  return p;
}

// part (2, N, tiles, C): sums of x and x^2 over the tile's pixels. Thread
// t takes channel group t % gb of the block and pixel lanes t / gb.
template <typename T>
__global__ void __launch_bounds__(NTH)
    partial_kernel(const T* __restrict__ x, float* __restrict__ part, int N,
                   int HW, int C, int tiles, int tile_px) {
  __shared__ float red[2][NTH][8];
  const int tile = blockIdx.x, n = blockIdx.z;
  const int g0 = blockIdx.y * GB;
  const int gb = min(GB, (C + 7) / 8 - g0);
  const int lanes = NTH / gb;
  const int g = threadIdx.x % gb, lane = threadIdx.x / gb;
  const int c = (g0 + g) * 8;
  const int valid = min(8, C - c);
  const bool vec = (C % 8) == 0 && aligned16(x);
  float s[8], q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = q[i] = 0.f;
  if (lane < lanes) {
    const int p0 = tile * tile_px, p1 = min(HW, p0 + tile_px);
    for (int p = p0 + lane; p < p1; p += lanes) {
      const Vec8<T> v = load8(x + ((size_t)n * HW + p) * C + c, valid, vec);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float f = to_f(v.v[i]);
        s[i] += f;
        q[i] += f * f;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    red[0][threadIdx.x][i] = s[i];
    red[1][threadIdx.x][i] = q[i];
  }
  __syncthreads();
  // thread (which, group, i) sums its column over the pixel lanes in order
  for (int t = threadIdx.x; t < 2 * gb * 8; t += NTH) {
    const int which = t / (gb * 8), gi = (t / 8) % gb, i = t % 8;
    const int ch = (g0 + gi) * 8 + i;
    if (ch >= C) continue;
    float acc = 0.f;
    for (int l = 0; l < lanes; ++l) acc += red[which][l * gb + gi][i];
    part[(((size_t)which * N + n) * tiles + tile) * C + ch] = acc;
  }
}

// stats (2, N, C): mean and 1 / sqrt(var + eps) from the partials, summed
// over the tiles in order.
__global__ void __launch_bounds__(RED_CH * RED_LANES)
    stats_kernel(const float* __restrict__ part, float* __restrict__ stats,
                 int N, int HW, int C, int tiles, float eps) {
  const int c = blockIdx.x * RED_CH + threadIdx.x;
  const int n = blockIdx.y;
  const bool active = c < C;
  const float s = sum_tiles(part + (size_t)n * tiles * C + c, tiles, C, active);
  const float q = sum_tiles(part + ((size_t)N + n) * tiles * C + c, tiles, C, active);
  if (threadIdx.y != 0 || !active) return;
  const float mean = s / HW;
  // mean^2 rounded before the subtraction, as the plain version computes
  // it: a contracted fma would leave x^2's rounding error as the variance
  // of a one-pixel plane
  const float var = fmaxf(q / HW - __fmul_rn(mean, mean), 0.f);
  stats[(size_t)n * C + c] = mean;
  stats[((size_t)N + n) * C + c] = rsqrtf(var + eps);
}

template <typename T>
__global__ void __launch_bounds__(NTH)
    apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                 const float* __restrict__ stats, T* __restrict__ y, int N,
                 int HW, int C, int act) {
  const int groups = (C + 7) / 8;
  const bool vec = (C % 8) == 0 && aligned16(x) && aligned16(y) &&
                   (res == nullptr || aligned16(res));
  const size_t total = (size_t)N * HW * groups;
  for (size_t i = (size_t)blockIdx.x * NTH + threadIdx.x; i < total;
       i += (size_t)gridDim.x * NTH) {
    const int g = i % groups;
    const size_t pix = i / groups;  // n * HW + p
    const int n = pix / HW;
    const int c = g * 8, valid = min(8, C - c);
    const size_t off = pix * C + c;
    const Vec8<T> v = load8(x + off, valid, vec);
    Vec8<T> r;
    if (res != nullptr) r = load8(res + off, valid, vec);
    Vec8<T> out;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int ch = min(c + k, C - 1);
      float z = (to_f(v.v[k]) - stats[(size_t)n * C + ch]) *
                stats[((size_t)N + n) * C + ch];
      if (res != nullptr) z += to_f(r.v[k]);
      if (act == ACT_RELU) z = fmaxf(z, 0.f);
      else if (act == ACT_LRELU) z = z > 0.f ? z : 0.2f * z;
      out.v[k] = from_f<T>(z);
    }
    if (vec) {
      store8(y + off, out);
    } else {
      for (int k = 0; k < valid; ++k) y[off + k] = out.v[k];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* res, void* y, float* part,
                   float* stats, int N, int HW, int C, int act, float eps,
                   cudaStream_t s) {
  const Plan p = make_plan(N, HW, C);
  partial_kernel<T><<<dim3(p.tiles, p.gy, N), NTH, 0, s>>>(
      static_cast<const T*>(x), part, N, HW, C, p.tiles, p.tile_px);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_kernel<<<dim3((C + RED_CH - 1) / RED_CH, N), dim3(RED_CH, RED_LANES), 0,
                 s>>>(part, stats, N, HW, C, p.tiles, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)N * HW * p.groups;
  const int blocks = (int)std::min<size_t>((total + NTH - 1) / NTH, 132 * 32);
  apply_kernel<T><<<blocks, NTH, 0, s>>>(static_cast<const T*>(x),
                                         static_cast<const T*>(res), stats,
                                         static_cast<T*>(y), N, HW, C, act);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Pixel tiles per image: the middle dimension of the partial sums.
int instance_norm_act_num_tiles(int N, int HW, int C) {
  return make_plan(N, HW, C).tiles;
}

// dtype: 0 = float32, 1 = bfloat16. act: 0 none, 1 relu, 2 lrelu. x, res
// (or null) and y (N, HW, C) in dtype; part (2, N, tiles, C) and stats
// (2, N, C) f32 scratch.
int instance_norm_act_launch(const void* x, const void* res, void* y,
                             void* part, void* stats, int N, int HW, int C,
                             int dtype, int act, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  float* st = static_cast<float*>(stats);
  cudaError_t err;
  if (dtype == 1)
    err = launch<__nv_bfloat16>(x, res, y, pp, st, N, HW, C, act, eps, s);
  else if (dtype == 0)
    err = launch<float>(x, res, y, pp, st, N, HW, C, act, eps, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
