// instance_norm_act_bwd: the backward of instance_norm_act (K7,
// instance_norm_act.cu): from the forward's input x, its stored output
// out, the cotangent g of out and the forward's f32 statistics (mean and
// inv = 1 / sqrt(max(E[x^2] - mean^2, 0) + eps) per (n, c)), the gradient
// of x and, with a residual, of the residual:
//   dz    = f32(g) act'(out)   (1; out > 0; 1 or 0.2: read from the output)
//   xhat  = (f32(x) - mean) inv
//   m_dz  = sum dz / HW,  m_dzx = sum dz xhat / HW   (over H x W, f32)
//   dx    = cast(inv (dz - m_dz - xhat m_dzx))
//   d_res = cast(dz)
//
// Replaces biasgan_tpu/ops/pallas_fused.py::_bwd (:188-197), the custom VJP
// of fused_instance_norm_act (:149), which the reference runs as XLA ops
// (with _fwd :175 recomputing mean and 1/std from x; here the forward
// kernel's statistics come in, so x is not reduced again).
//
// What bounds it on an H100: it reads x, out and g and writes dx (and
// d_res), a few operations per element: memory. At the 256x256 CycleGAN
// step's largest norm, (3, 256, 256, 64) bf16, each tensor is 25 MB.
//
// Design. The two sums need every pixel of a (n, c) plane before any dx can
// be written, and blocks run in no order. Deterministic, no float atomics,
// 8 channels per thread with 16-byte loads; two paths:
//   * one launch, on thread-block clusters, where a (n, channel block) slice
//     of g, out and x fits the shared memory of a cluster of CS blocks (the
//     discriminators' norms and the generator's 64x64x256 ones): block r of
//     the cluster stages its 1/CS of the slice's pixels in shared memory
//     while it sums dz and dz xhat over them; the blocks meet at a cluster
//     barrier, each reads the CS partial sums through distributed shared
//     memory in rank order (so all get the same sums), meet again, and each
//     writes dx and d_res from its staged pixels: every input read once;
//   * two launches otherwise: (1) block (tile, channel block, n) reads g,
//     out and x over its pixel tile and writes the sums of dz and dz xhat
//     per (n, tile, c); (2) the same grid, each block first summing the
//     tile partials of its channels in a fixed order (every block of a
//     (n, channel block) gets the same sums), then reading g, out and x of
//     its tile again and writing dx and d_res. The fold in (2) reads
//     tiles^2 partials per (n, c) over all blocks, so the plan keeps tiles
//     small (8 tiles^2 bytes under ~1/4 of a plane's input bytes), narrows
//     the channel blocks (down to 64-byte rows) for enough blocks, and
//     sizes the grid to one wave of resident blocks.
//
// Interface: plain C, loaded with ctypes; launches go on the caller's stream
// and the function returns the cudaError_t of the launches (0 = ok).

#include <cooperative_groups.h>

#include <algorithm>
#include <cmath>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace port;

constexpr int NTH = 256;
constexpr int MIN_BLOCKS = 3;       // two-pass blocks per SM: registers <= 85
constexpr int GB = 32;              // channel groups (of 8) per block, at most
constexpr int CS = 8;               // blocks per cluster (the portable most)
constexpr int CLUSTER_BYTES = 96 * 1024;  // staged slice per block, at most

enum Path { AUTO = 0, TWO_PASS = 1 };

struct Plan {
  bool cluster;  // the one-launch path
  int groups;    // channel groups of 8
  int gb;        // channel groups per block
  int gy;        // channel blocks
  int tiles;     // pixel tiles per image (the cluster's size on that path)
  int tile_px;   // pixels per tile
  size_t smem;   // dynamic shared memory per block (the cluster path)
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The channel groups per block: from up to GB, halved while the grid
// would have fewer than `target` blocks and rows stay >= gmin groups.
template <class Tiles>
int choose_gb(int N, int groups, int gmin, int target, const Tiles& tiles) {
  int gb = std::min(groups, GB);
  while (gb > gmin && N * ceil_div(groups, gb) * tiles(gb) < target)
    gb = std::max(gmin, (gb + 1) / 2);
  return gb;
}

Plan make_plan(int N, int HW, int C, int es, int target, int path) {
  Plan p;
  p.groups = ceil_div(C, 8);
  // the cluster path: CS blocks per (n, channel block), two channel groups
  // (32-byte bf16 rows) at the least, a slice that fits
  p.tiles = std::min(CS, HW);
  p.tile_px = ceil_div(HW, p.tiles);
  p.tiles = ceil_div(HW, p.tile_px);
  p.gb = choose_gb(N, p.groups, std::min(p.groups, 2), target,
                   [&](int) { return p.tiles; });
  p.smem = (size_t)3 * p.tile_px * p.gb * 8 * es;
  p.cluster = path == AUTO && p.smem <= CLUSTER_BYTES;
  if (p.cluster) {
    p.gy = ceil_div(p.groups, p.gb);
    return p;
  }
  p.smem = 0;
  const int tcap = std::max(1, (int)std::sqrt(0.09375 * HW * es));
  auto tmax = [&](int gb) { return std::min(tcap, ceil_div(HW, NTH / gb)); };
  p.gb = choose_gb(N, p.groups, std::min(p.groups, 64 / (8 * es)), target, tmax);
  p.gy = ceil_div(p.groups, p.gb);
  const int want = std::max(1, target / std::max(1, N * p.gy));
  const int t = std::max(1, std::min(want, tmax(p.gb)));
  p.tile_px = ceil_div(HW, t);
  p.tiles = ceil_div(HW, p.tile_px);
  return p;
}

__device__ __forceinline__ float act_grad(float o, int act) {
  if (act == ACT_RELU) return o > 0.f ? 1.f : 0.f;
  if (act == ACT_LRELU) return o > 0.f ? 1.f : 0.2f;
  return 1.f;
}

// The block's place: channel groups [g0, g0 + gbb) of image n, pixels
// [p0, p1) of tile blockIdx.x; thread t takes group t % gbb and pixel lanes
// t / gbb.
struct Slot {
  int n, g0, gbb, lanes, gi, lane, c, valid, p0, p1;
  __device__ Slot(int HW, int C, int gb, int tile_px) {
    n = blockIdx.z;
    g0 = blockIdx.y * gb;
    gbb = min(gb, (C + 7) / 8 - g0);
    lanes = NTH / gbb;
    gi = threadIdx.x % gbb;
    lane = threadIdx.x / gbb;
    c = (g0 + gi) * 8;
    valid = min(8, C - c);
    p0 = blockIdx.x * tile_px;
    p1 = min(HW, p0 + tile_px);
  }
};

// mean and inv of this thread's 8 channels (the last real channel repeated
// past C, where the values are zeros and never stored)
__device__ __forceinline__ void load_stats(const float* __restrict__ stats,
                                           int N, int C, int n, int c,
                                           float (&mean)[8], float (&inv)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ch = min(c + i, C - 1);
    mean[i] = stats[(size_t)n * C + ch];
    inv[i] = stats[((size_t)N + n) * C + ch];
  }
}

// One pixel's 8 channels of g, out and x.
template <typename T>
struct Px {
  Vec8<T> g, o, x;
  __device__ __forceinline__ void load(const T* __restrict__ g_,
                                       const T* __restrict__ o_,
                                       const T* __restrict__ x_, size_t off,
                                       int valid, bool vec) {
    g = load8(g_ + off, valid, vec);
    o = load8(o_ + off, valid, vec);
    x = load8(x_ + off, valid, vec);
  }
  // sums of dz and dz xhat
  __device__ __forceinline__ void sum(const float (&mean)[8],
                                      const float (&inv)[8], int act,
                                      float (&sz)[8], float (&szx)[8]) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float dz = to_f(g.v[i]) * act_grad(to_f(o.v[i]), act);
      sz[i] += dz;
      szx[i] += dz * ((to_f(x.v[i]) - mean[i]) * inv[i]);
    }
  }
  // dx and d_res, written to global memory
  __device__ __forceinline__ void apply(const float (&mean)[8],
                                        const float (&inv)[8],
                                        const float (&m_dz)[8],
                                        const float (&m_dzx)[8], int act,
                                        T* __restrict__ dx, T* __restrict__ dres,
                                        size_t off, int valid, bool vec) const {
    Vec8<T> rx, rr;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float dz = to_f(g.v[i]) * act_grad(to_f(o.v[i]), act);
      const float xhat = (to_f(x.v[i]) - mean[i]) * inv[i];
      rx.v[i] = from_f<T>(inv[i] * (dz - m_dz[i] - xhat * m_dzx[i]));
      rr.v[i] = from_f<T>(dz);
    }
    if (vec) {
      store8(dx + off, rx);
      if (dres != nullptr) store8(dres + off, rr);
    } else {
      for (int i = 0; i < valid; ++i) {
        dx[off + i] = rx.v[i];
        if (dres != nullptr) dres[off + i] = rr.v[i];
      }
    }
  }
};

// The block's sums of dz and dz xhat per channel, over its pixel lanes in
// order: out[which * gbb * 8 + gi * 8 + i]. Ends with a block barrier.
__device__ __forceinline__ void block_sums(float (*red)[NTH][8],
                                           const float (&sz)[8],
                                           const float (&szx)[8],
                                           const Slot& s, float* out) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    red[0][threadIdx.x][i] = sz[i];
    red[1][threadIdx.x][i] = szx[i];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * s.gbb * 8; t += NTH) {
    const int which = t / (s.gbb * 8), gi = (t / 8) % s.gbb, i = t % 8;
    float acc = 0.f;
    for (int l = 0; l < s.lanes; ++l) acc += red[which][l * s.gbb + gi][i];
    out[t] = acc;
  }
  __syncthreads();
}

__device__ __forceinline__ bool vec_ok(int C, const void* a, const void* b,
                                       const void* c) {
  return (C % 8) == 0 && aligned16(a) && aligned16(b) && aligned16(c);
}

// ---------------------------------------------------------------------------
// The two-pass path
// ---------------------------------------------------------------------------

// part (2, N, tiles, C): sums of dz and dz xhat over the tile's pixels.
template <typename T>
__global__ void __launch_bounds__(NTH, MIN_BLOCKS)
    partial_kernel(const T* __restrict__ x, const T* __restrict__ out,
                   const T* __restrict__ g, const float* __restrict__ stats,
                   float* __restrict__ part, int N, int HW, int C, int act,
                   int gb, int tiles, int tile_px) {
  __shared__ float red[2][NTH][8];
  __shared__ float sums[2 * GB * 8];
  const Slot s(HW, C, gb, tile_px);
  const bool vec = vec_ok(C, x, out, g);
  float mean[8], inv[8], sz[8], szx[8];
  load_stats(stats, N, C, s.n, s.c, mean, inv);
#pragma unroll
  for (int i = 0; i < 8; ++i) sz[i] = szx[i] = 0.f;
  if (s.lane < s.lanes) {
    const size_t base = (size_t)s.n * HW * C + s.c;
    int p = s.p0 + s.lane;
    // two pixels per trip: six 16-byte loads in flight
    for (; p + s.lanes < s.p1; p += 2 * s.lanes) {
      Px<T> a, b;
      a.load(g, out, x, base + (size_t)p * C, s.valid, vec);
      b.load(g, out, x, base + (size_t)(p + s.lanes) * C, s.valid, vec);
      a.sum(mean, inv, act, sz, szx);
      b.sum(mean, inv, act, sz, szx);
    }
    if (p < s.p1) {
      Px<T> a;
      a.load(g, out, x, base + (size_t)p * C, s.valid, vec);
      a.sum(mean, inv, act, sz, szx);
    }
  }
  block_sums(red, sz, szx, s, sums);
  for (int t = threadIdx.x; t < 2 * s.gbb * 8; t += NTH) {
    const int which = t / (s.gbb * 8), ch = s.g0 * 8 + t % (s.gbb * 8);
    if (ch < C) part[(((size_t)which * N + s.n) * tiles + blockIdx.x) * C + ch] = sums[t];
  }
}

template <typename T>
__global__ void __launch_bounds__(NTH, MIN_BLOCKS)
    apply_kernel(const T* __restrict__ x, const T* __restrict__ out,
                 const T* __restrict__ g, const float* __restrict__ stats,
                 const float* __restrict__ part, T* __restrict__ dx,
                 T* __restrict__ dres, int N, int HW, int C, int act, int gb,
                 int tiles, int tile_px) {
  // the fold: item (which, k) of the block's 2 x gbb x 8 sums, rl lanes per
  // item each summing tiles l, l + rl, ..., then the lanes in order
  __shared__ float lanesum[2 * NTH];
  __shared__ float msum[2][GB * 8];
  const Slot s(HW, C, gb, tile_px);
  const int width = s.gbb * 8, items = 2 * width;
  const int rl = max(1, NTH / items);
  for (int t = threadIdx.x; t < items * rl; t += NTH) {
    const int item = t % items, l = t / items;
    const int which = item / width, ch = s.g0 * 8 + item % width;
    float acc = 0.f;
    if (ch < C) {
      const float* p = part + ((size_t)which * N + s.n) * tiles * C + ch;
      for (int tile = l; tile < tiles; tile += rl) acc += p[(size_t)tile * C];
    }
    lanesum[t] = acc;
  }
  __syncthreads();
  for (int item = threadIdx.x; item < items; item += NTH) {
    float acc = 0.f;
    for (int l = 0; l < rl; ++l) acc += lanesum[l * items + item];
    msum[item / width][item % width] = acc / HW;
  }
  __syncthreads();
  if (s.lane >= s.lanes) return;
  const bool vec = vec_ok(C, x, out, g) && aligned16(dx) &&
                   (dres == nullptr || aligned16(dres));
  float mean[8], inv[8], m_dz[8], m_dzx[8];
  load_stats(stats, N, C, s.n, s.c, mean, inv);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_dz[i] = msum[0][s.gi * 8 + i];
    m_dzx[i] = msum[1][s.gi * 8 + i];
  }
  const size_t base = (size_t)s.n * HW * C + s.c;
  int p = s.p0 + s.lane;
  for (; p + s.lanes < s.p1; p += 2 * s.lanes) {
    Px<T> a, b;
    const size_t oa = base + (size_t)p * C, ob = base + (size_t)(p + s.lanes) * C;
    a.load(g, out, x, oa, s.valid, vec);
    b.load(g, out, x, ob, s.valid, vec);
    a.apply(mean, inv, m_dz, m_dzx, act, dx, dres, oa, s.valid, vec);
    b.apply(mean, inv, m_dz, m_dzx, act, dx, dres, ob, s.valid, vec);
  }
  if (p < s.p1) {
    Px<T> a;
    const size_t oa = base + (size_t)p * C;
    a.load(g, out, x, oa, s.valid, vec);
    a.apply(mean, inv, m_dz, m_dzx, act, dx, dres, oa, s.valid, vec);
  }
}

// ---------------------------------------------------------------------------
// The one-launch path: a cluster of gridDim.x blocks per (n, channel block)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NTH)
    cluster_kernel(const T* __restrict__ x, const T* __restrict__ out,
                   const T* __restrict__ g, const float* __restrict__ stats,
                   T* __restrict__ dx, T* __restrict__ dres, int N, int HW,
                   int C, int act, int gb, int tile_px) {
  extern __shared__ __align__(16) unsigned char staged_raw[];
  __shared__ float red[2][NTH][8];
  __shared__ float sums[2 * GB * 8];  // this block's, read by the cluster
  __shared__ float msum[2 * GB * 8];
  cg::cluster_group cluster = cg::this_cluster();
  const Slot s(HW, C, gb, tile_px);
  const int width = gb * 8;  // staged row: the block's channels
  T* staged = reinterpret_cast<T*>(staged_raw);  // [pixel][g | out | x][width]
  const bool vec = vec_ok(C, x, out, g);
  float mean[8], inv[8], sz[8], szx[8];
  load_stats(stats, N, C, s.n, s.c, mean, inv);
#pragma unroll
  for (int i = 0; i < 8; ++i) sz[i] = szx[i] = 0.f;
  const size_t base = (size_t)s.n * HW * C + s.c;
  if (s.lane < s.lanes) {
    for (int p = s.p0 + s.lane; p < s.p1; p += s.lanes) {
      Px<T> a;
      a.load(g, out, x, base + (size_t)p * C, s.valid, vec);
      T* row = staged + (size_t)(p - s.p0) * 3 * width + s.gi * 8;
      store8(row, a.g);
      store8(row + width, a.o);
      store8(row + 2 * width, a.x);
      a.sum(mean, inv, act, sz, szx);
    }
  }
  block_sums(red, sz, szx, s, sums);
  cluster.sync();  // every block's sums are written
  const int items = 2 * s.gbb * 8;
  for (int t = threadIdx.x; t < items; t += NTH) {
    float acc = 0.f;
    for (int r = 0; r < (int)cluster.num_blocks(); ++r)
      acc += cluster.map_shared_rank(sums, r)[t];
    msum[t] = acc / HW;
  }
  cluster.sync();  // every block is done reading the others' sums
  if (s.lane >= s.lanes) return;
  const bool vec_out = vec && aligned16(dx) && (dres == nullptr || aligned16(dres));
  float m_dz[8], m_dzx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_dz[i] = msum[s.gi * 8 + i];
    m_dzx[i] = msum[s.gbb * 8 + s.gi * 8 + i];
  }
  for (int p = s.p0 + s.lane; p < s.p1; p += s.lanes) {
    const T* row = staged + (size_t)(p - s.p0) * 3 * width + s.gi * 8;
    Px<T> a;
    a.g = load8(row, 8, true);
    a.o = load8(row + width, 8, true);
    a.x = load8(row + 2 * width, 8, true);
    a.apply(mean, inv, m_dz, m_dzx, act, dx, dres, base + (size_t)p * C, s.valid,
            vec_out);
  }
}

// Resident blocks of the two-pass kernels on the whole card: the grid is
// one wave of the pass that fits fewer.
template <typename T>
int resident_blocks() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, sms = 0, partial = 0, apply = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&partial, partial_kernel<T>, NTH, 0);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&apply, apply_kernel<T>, NTH, 0);
    n = std::max(1, sms * std::max(1, std::min(partial, apply)));
  }
  return n;
}

template <typename T>
Plan plan_for(int N, int HW, int C, int path) {
  return make_plan(N, HW, C, sizeof(T), resident_blocks<T>(), path);
}

template <typename T>
cudaError_t launch(const void* x, const void* out, const void* g,
                   const float* stats, void* dx, void* dres, float* part, int N,
                   int HW, int C, int act, int path, cudaStream_t s) {
  const Plan p = plan_for<T>(N, HW, C, path);
  const T* xt = static_cast<const T*>(x);
  const T* ot = static_cast<const T*>(out);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  T* drt = static_cast<T*>(dres);
  const dim3 grid(p.tiles, p.gy, N);
  if (p.cluster) {
    cudaError_t err = cudaFuncSetAttribute(
        cluster_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(NTH);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.tiles;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, cluster_kernel<T>, xt, ot, gt, stats, dxt, drt, N,
                             HW, C, act, p.gb, p.tile_px);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  partial_kernel<T><<<grid, NTH, 0, s>>>(xt, ot, gt, stats, part, N, HW, C, act,
                                         p.gb, p.tiles, p.tile_px);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  apply_kernel<T><<<grid, NTH, 0, s>>>(xt, ot, gt, stats, part, dxt, drt, N, HW, C,
                                       act, p.gb, p.tiles, p.tile_px);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Pixel tiles per image, the middle dimension of the partial sums: 0 on
// the one-launch cluster path, which keeps its partials in shared memory.
// path: 0 = the plan's choice, 1 = the two-pass path.
int instance_norm_act_bwd_num_tiles(int N, int HW, int C, int dtype, int path) {
  const Plan p = dtype == 1 ? plan_for<__nv_bfloat16>(N, HW, C, path)
                            : plan_for<float>(N, HW, C, path);
  return p.cluster ? 0 : p.tiles;
}

// dtype: 0 = float32, 1 = bfloat16. act: 0 none, 1 relu, 2 lrelu. x, out,
// g, dx and dres (or null: no residual gradient) (N, HW, C) in dtype;
// stats (2, N, C) f32 (mean, inv); part (2, N, tiles, C) f32 scratch
// (tiles from instance_norm_act_bwd_num_tiles with the same path).
int instance_norm_act_bwd_launch(const void* x, const void* out, const void* g,
                                 const void* stats, void* dx, void* dres,
                                 void* part, int N, int HW, int C, int dtype,
                                 int act, int path, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(stats);
  float* pp = static_cast<float*>(part);
  cudaError_t err;
  if (dtype == 1)
    err = launch<__nv_bfloat16>(x, out, g, st, dx, dres, pp, N, HW, C, act, path, s);
  else if (dtype == 0)
    err = launch<float>(x, out, g, st, dx, dres, pp, N, HW, C, act, path, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
