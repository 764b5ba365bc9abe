// instance_norm_act: affine-free instance norm of an NHWC tensor over H x W
// (f32 statistics, biased variance max(E[x^2] - E[x]^2, 0), eps), an
// optional residual added in f32, then none / ReLU / LeakyReLU(0.2), one
// cast to the input's dtype; the statistics (mean, 1 / sqrt(var + eps)) go
// to a (2, N, C) f32 buffer for the backward where one is given.
//
// Replaces the Pallas TPU kernel biasgan_tpu/ops/pallas_fused.py::
// fused_instance_norm_act (:149; _pallas_forward :113, bodies _fused_kernel
// :94 and _fused_kernel_res :103). It carries every norm_act of the resnet
// generator under --force_pallas_norm, and the forward of every instance
// norm of CycleGAN training on the all-kernel route.
//
// What bounds it on an H100: it reads x (and the residual) and writes y, a
// few operations per element: memory. The least traffic is x read once and
// y written once, but the statistics need every pixel of a plane before any
// y. The Pallas kernel holds a whole (H, W, 128-channel) plane in VMEM and
// does both in one pass. Here too a call is one launch, with the plane held
// across the shared memory of many blocks: blocks run in no order, so their
// sums meet at a barrier, and every sum is folded in a fixed order (no float
// atomics: the result is deterministic, bit for bit from call to call).
//
// Design. A task is an image and a block of up to 16 channel groups of 16
// bytes (8 bf16 or 4 f32 channels); `ranges` blocks share a task, each over
// a contiguous pixel range, so a warp's loads are whole rows of up to 256
// bytes (16-byte rows, one group per task, ran at under half the rate on an
// H100). A block copies its pixels into shared memory with cp.async (no
// registers, all in flight where they fit), sums x and x^2 as they land,
// and after the barrier and the fold writes y from shared memory. Where a
// range does not fit (the globe's largest planes), it streams through the
// same buffer as a ring, keeps its last steps, and in pass 2 reads the rest
// again newest first, so the lines pass 1 left in the 50 MB L2 are hit
// first. The wrapper (kernels/instance_norm_act.py, norm_plan) picks the
// path, the row width, the cluster size or grid, the pixels per block and
// the shared memory, and passes them in:
//
//   * cluster: where a slice with rows of at least 64 bytes fits a cluster
//     of at most 8 blocks (every norm of the 256x256 training step but its
//     256x256 planes). The sums meet through distributed shared memory, read
//     in rank order by every block; nothing passes through device memory but
//     x, the residual and y.
//   * persistent: one cooperative launch, a block per SM (the globe's four
//     shapes and the training step's 256x256 planes). The blocks' partial
//     sums go to a (2, N, ranges, C) f32 buffer; a grid barrier; every block
//     of a task folds them in range order (the same statistics everywhere,
//     no separate launch). With more tasks than blocks, the tasks go in
//     rounds, a grid barrier each. A grid that cannot be co-resident is
//     refused by the launch, never hung.
//
// y is stored, and the residual read, with the streaming cache hint: each
// is touched once, and leaving L2 to x is what pass 2 needs.
//
// Interface: plain C, loaded with ctypes; one launch on the caller's stream;
// the function returns the cudaError_t of the launch (0 = ok).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace port;

constexpr int NTH = 512;
constexpr int WARPS = NTH / 32;
constexpr int CLUSTER_MAX = 8;  // blocks per cluster (the portable most)
constexpr int GB_MAX = 16;      // channel groups per task
constexpr int DEPTH = 8;  // steps in flight where a range is streamed
constexpr int U = 8;      // pass-2 residual rows in flight, in registers
constexpr int FOLD = 32;  // partial sums in flight per thread in the fold

enum Path { PATH_CLUSTER = 0, PATH_PERSISTENT = 1 };

// 16 bytes of one pixel's channels: 8 bf16 or 4 f32.
template <typename T>
struct alignas(16) Row {
  static constexpr int V = 16 / sizeof(T);
  T v[V];
};

// A row of `valid` channels at src: one 16-byte load when `vec` (the
// tensor is aligned and C a multiple of V, so every row is whole), else
// element by element with zeros past `valid`. `stream`: evict-first.
template <typename T>
__device__ __forceinline__ Row<T> load_row(const T* __restrict__ src, int valid, bool vec,
                                           bool stream = false) {
  Row<T> r;
  if (vec) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    *reinterpret_cast<uint4*>(&r) = stream ? __ldcs(s) : *s;
  } else {
#pragma unroll
    for (int i = 0; i < Row<T>::V; ++i) r.v[i] = i < valid ? src[i] : from_f<T>(0.f);
  }
  return r;
}

template <typename T>
__device__ __forceinline__ void store_row(T* __restrict__ dst, const Row<T>& r, int valid,
                                          bool vec) {
  if (vec) {
    __stcs(reinterpret_cast<uint4*>(dst), *reinterpret_cast<const uint4*>(&r));
  } else {
    for (int i = 0; i < valid; ++i) dst[i] = r.v[i];
  }
}

// A row into shared memory: asynchronously when `vec`, else now.
template <typename T>
__device__ __forceinline__ void stage_row(Row<T>* dst, const T* __restrict__ src, int valid,
                                          bool vec) {
  if (vec)
    cp_async16(dst, src, true);
  else
    *dst = load_row(src, valid, false);
}

template <typename T, int V>
__device__ __forceinline__ void add_row(const Row<T>& r, float (&s)[V], float (&q)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float f = to_f(r.v[i]);
    s[i] += f;
    q[i] += f * f;
  }
}

template <typename T, int V>
__device__ __forceinline__ Row<T> apply_row(const Row<T>& x, const Row<T>& r, bool has_res,
                                            const float (&mean)[V], const float (&inv)[V],
                                            int act) {
  Row<T> out;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float z = (to_f(x.v[i]) - mean[i]) * inv[i];
    if (has_res) z += to_f(r.v[i]);
    if (act == ACT_RELU) z = fmaxf(z, 0.f);
    else if (act == ACT_LRELU) z = z > 0.f ? z : 0.2f * z;
    out.v[i] = from_f<T>(z);
  }
  return out;
}

// mean and 1 / sqrt(var + eps) from the plane's sums, as the plain version
// computes them: mean^2 rounded before the subtraction (a contracted fma
// would leave x^2's rounding error as the variance of a one-pixel plane).
__device__ __forceinline__ void finish_stats(float s, float q, int HW, float eps,
                                             float& mean, float& inv) {
  mean = s / HW;
  const float var = fmaxf(q / HW - __fmul_rn(mean, mean), 0.f);
  inv = rsqrtf(var + eps);
}

// The block's sums per channel: out[gi * V + i] of x, out[items + gi * V +
// i] of x^2 (items = gbb * V), from each thread's s and q for group gi = t %
// gbb (threads past (NTH / gbb) * gbb hold zeros). Fixed order: where gbb
// divides 32, a butterfly over each warp's lanes of a group, then the warps
// in order; otherwise the pixel lanes in order. red holds NTH * V floats.
// Begins and ends with a block barrier.
template <int V>
__device__ __forceinline__ void block_sums(float (&s)[V], float (&q)[V], int gbb, float* red,
                                           float* out) {
  const int items = gbb * V, t = threadIdx.x;
  __syncthreads();  // red and out are free
  if (32 % gbb == 0) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      for (int off = gbb; off < 32; off <<= 1) {
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
        q[i] += __shfl_xor_sync(0xffffffffu, q[i], off);
      }
    }
    const int lane = t % 32, w = t / 32;
    if (lane < gbb) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        red[w * items + lane * V + i] = s[i];
        red[(WARPS + w) * items + lane * V + i] = q[i];
      }
    }
    __syncthreads();
    for (int it = t; it < 2 * items; it += NTH) {
      const int which = it / items, k = it % items;
      float acc = 0.f;
      for (int ww = 0; ww < WARPS; ++ww) acc += red[(which * WARPS + ww) * items + k];
      out[it] = acc;
    }
  } else {
    const int lanes = NTH / gbb;
    for (int which = 0; which < 2; ++which) {
#pragma unroll
      for (int i = 0; i < V; ++i) red[t * V + i] = which ? q[i] : s[i];
      __syncthreads();
      for (int it = t; it < items; it += NTH) {
        const int gi = it / V, i = it % V;
        float acc = 0.f;
        for (int l = 0; l < lanes; ++l) acc += red[(l * gbb + gi) * V + i];
        out[which * items + it] = acc;
      }
      __syncthreads();
    }
  }
  __syncthreads();
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// One kernel, both paths. Block r of a task takes pixels [r block_px,
// (r + 1) block_px); thread t takes group gi = t % gbb of the task's gbb and
// pixel lane t / gbb (lanes = NTH / gbb). Step k of a block is its pixels p0
// + k lanes + lane: one row per working thread.
//
// Shared memory: red (NTH V floats), bsum and stat (2 gb V floats each), then
// `layers` layers of NTH rows; thread t's row of step k sits at index t of
// layer (k - nsteps) mod layers, so a thread only ever touches its own rows
// and no block barrier guards them. Pass 1 copies every step into its layer
// (all at once where the range fits, else DEPTH steps in flight, a layer
// reused once the step before it is summed); the last `layers` steps stay.
// Pass 2 writes y from those, the residual U rows ahead in registers; then
// the earlier steps come again, newest first, through the freed layers as a
// ring of DEPTH steps in flight (x, and the residual in the layer beside it).
//
// CLUSTER: grid (ranges, cblocks, N), a cluster of `ranges` blocks per task,
// every step staged. Otherwise a cooperative grid, tasks in rounds of
// gridDim.x / ranges.
// ---------------------------------------------------------------------------

template <typename T, bool CLUSTER>
__global__ void __launch_bounds__(NTH, 1)
    norm_kernel(const T* __restrict__ x, const T* __restrict__ res, T* __restrict__ y,
                float* __restrict__ stats, float* __restrict__ part, int N, int HW, int C,
                int act, float eps, int gb, int ranges, int block_px, int layers) {
  constexpr int V = Row<T>::V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* red = reinterpret_cast<float*>(smem_raw);
  float* bsum = red + NTH * V;
  float* stat = bsum + 2 * gb * V;
  Row<T>* layer = reinterpret_cast<Row<T>*>(stat + 2 * gb * V);
  const int t = threadIdx.x;
  const int groups = (C + V - 1) / V, cblocks = (groups + gb - 1) / gb;
  const int tasks = N * cblocks;
  int per_round, slot, r;
  if constexpr (CLUSTER) {
    per_round = tasks;
    slot = blockIdx.z * cblocks + blockIdx.y;
    r = blockIdx.x;
  } else {
    per_round = gridDim.x / ranges;
    slot = blockIdx.x / ranges;
    r = blockIdx.x % ranges;
  }
  const int rounds = (tasks + per_round - 1) / per_round;
  const bool has_res = res != nullptr;
  const bool vx = C % V == 0 && aligned16(x);
  const bool vr = has_res && C % V == 0 && aligned16(res);
  const bool vy = C % V == 0 && aligned16(y);
  for (int round = 0; round < rounds; ++round) {
    const int task = round * per_round + slot;
    const bool active = slot < per_round && task < tasks;  // uniform in the block
    const int n = active ? task / cblocks : 0, g0 = active ? (task % cblocks) * gb : 0;
    const int gbb = min(gb, groups - g0), items = gbb * V;
    const int lanes = NTH / gbb, gi = t % gbb, lane = t / gbb;
    const bool works = active && lane < lanes;
    const int c = (g0 + gi) * V, valid = min(V, C - c);
    const int p0 = r * block_px, p1 = min(HW, p0 + block_px);
    const int nsteps = (p1 - p0 + lanes - 1) / lanes;
    const int kept = min(nsteps, layers), rot = (layers - nsteps % layers) % layers;
    const size_t base = (size_t)n * HW * C + c;
    auto row_of = [&](int k) { return layer + (size_t)((k + rot) % layers) * NTH + t; };
    auto px = [&](int k) { return p0 + k * lanes + lane; };
    auto issue = [&](int k) {
      const int p = px(k);
      if (works && p < p1) stage_row(row_of(k), x + base + (size_t)p * C, valid, vx);
    };
    float s[V], q[V];
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] = q[i] = 0.f;
    __syncthreads();  // the previous round is done with shared memory
    if (active) {
      // pass 1
      if (nsteps <= layers) {
        for (int k = 0; k < nsteps; ++k) issue(k);
        cp_async_commit();
        cp_async_wait_all();
        for (int k = 0; k < nsteps; ++k)
          if (works && px(k) < p1) add_row(*row_of(k), s, q);
      } else {
        for (int k = 0; k < DEPTH; ++k) {
          issue(k);
          cp_async_commit();
        }
        for (int k = 0; k < nsteps; ++k) {
          if (k + DEPTH < nsteps) issue(k + DEPTH);  // into the layer of step k + DEPTH - layers
          cp_async_commit();
          cp_async_wait<DEPTH>();
          if (works && px(k) < p1) add_row(*row_of(k), s, q);
        }
      }
      block_sums(s, q, gbb, red, bsum);
    }
    if constexpr (CLUSTER) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();  // every block's sums are written
      for (int it = t; it < items; it += NTH) {
        // every rank's sums loaded first, then added in rank order
        float vs[CLUSTER_MAX], vq[CLUSTER_MAX];
#pragma unroll
        for (int rr = 0; rr < CLUSTER_MAX; ++rr) {
          if (rr < ranges) {
            const float* o = cluster.map_shared_rank(bsum, rr);
            vs[rr] = o[it];
            vq[rr] = o[items + it];
          }
        }
        float ss = 0.f, qq = 0.f;
#pragma unroll
        for (int rr = 0; rr < CLUSTER_MAX; ++rr) {
          if (rr < ranges) {
            ss += vs[rr];
            qq += vq[rr];
          }
        }
        float mean, inv;
        finish_stats(ss, qq, HW, eps, mean, inv);
        stat[it] = mean;
        stat[items + it] = inv;
        const int ch = g0 * V + it;
        if (stats != nullptr && r == 0 && ch < C) {
          stats[(size_t)n * C + ch] = mean;
          stats[((size_t)N + n) * C + ch] = inv;
        }
      }
      cluster.sync();  // stat is written; every block is done reading the others' sums
    } else {
      if (active) {
        for (int it = t; it < 2 * items; it += NTH) {
          const int which = it / items, ch = g0 * V + it % items;
          if (ch < C) part[(((size_t)which * N + n) * ranges + r) * C + ch] = bsum[it];
        }
      }
      cg::this_grid().sync();  // every range's partial sums are written
      if (active) {
        // item (which, channel) in k2 sublanes, sublane j summing ranges j,
        // j + k2, ... (FOLD loads in flight), then the sublanes in order
        const int k2 = max(1, NTH / (2 * items));
        for (int it = t; it < 2 * items * k2; it += NTH) {
          const int item = it % (2 * items), j = it / (2 * items);
          const int which = item / items, ch = g0 * V + item % items;
          float acc = 0.f;
          if (ch < C) {
            const float* pp = part + ((size_t)which * N + n) * ranges * C + ch;
            for (int r0 = j; r0 < ranges; r0 += FOLD * k2) {
              float v[FOLD];
#pragma unroll
              for (int u = 0; u < FOLD; ++u) {
                const int rr = r0 + u * k2;
                v[u] = rr < ranges ? __ldcg(pp + (size_t)rr * C) : 0.f;
              }
#pragma unroll
              for (int u = 0; u < FOLD; ++u) acc += v[u];
            }
          }
          red[it] = acc;
        }
        __syncthreads();
        for (int it = t; it < items; it += NTH) {
          float ss = 0.f, qq = 0.f;
          for (int j = 0; j < k2; ++j) {
            ss += red[j * 2 * items + it];
            qq += red[j * 2 * items + items + it];
          }
          float mean, inv;
          finish_stats(ss, qq, HW, eps, mean, inv);
          stat[it] = mean;
          stat[items + it] = inv;
          const int ch = g0 * V + it;
          if (stats != nullptr && r == 0 && ch < C) {
            stats[(size_t)n * C + ch] = mean;
            stats[((size_t)N + n) * C + ch] = inv;
          }
        }
      }
      __syncthreads();
    }
    if (!works) continue;
    float mean[V], inv[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mean[i] = stat[gi * V + i];
      inv[i] = stat[items + gi * V + i];
    }
    // pass 2: the kept steps from shared memory, the residual U rows ahead
    for (int k0 = nsteps - kept; k0 < nsteps; k0 += U) {
      Row<T> rr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = px(k0 + u);
        if (has_res && k0 + u < nsteps && p < p1)
          rr[u] = load_row(res + base + (size_t)p * C, valid, vr, true);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = px(k0 + u);
        if (k0 + u < nsteps && p < p1)
          store_row(y + base + (size_t)p * C,
                    apply_row(*row_of(k0 + u), rr[u], has_res, mean, inv, act), valid, vy);
      }
    }
    if constexpr (!CLUSTER) {
      // then the earlier steps again, newest first, through the layers (now
      // free) as a ring of DEPTH steps in flight: x, and the residual in the
      // layer beside it
      const int head = nsteps - kept, ring = has_res ? layers / 2 : layers;
      auto xrow = [&](int i) {
        return layer + (size_t)(has_res ? 2 * (i % ring) : i % ring) * NTH + t;
      };
      auto reissue = [&](int i) {  // the i-th step back: step head - 1 - i
        if (i < head) {
          const size_t off = base + (size_t)px(head - 1 - i) * C;
          stage_row(xrow(i), x + off, valid, vx);
          if (has_res) stage_row(xrow(i) + NTH, res + off, valid, vr);
        }
        cp_async_commit();
      };
      if (head > 0) {
        for (int i = 0; i < DEPTH; ++i) reissue(i);
        for (int i = 0; i < head; ++i) {
          reissue(i + DEPTH);  // into the slot of step i + DEPTH - ring, written out
          cp_async_wait<DEPTH>();
          store_row(y + base + (size_t)px(head - 1 - i) * C,
                    apply_row(*xrow(i), *(xrow(i) + NTH), has_res, mean, inv, act), valid, vy);
        }
      }
    }
  }
}

// Raise the kernel's dynamic shared memory limit on the current device to
// `bytes` where it is below it (once per size reached, not per call).
// allowed: the limit set so far, per device.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int (&allowed)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) allowed[dev] = bytes;
  return err;
}

template <typename T>
cudaError_t launch(const void* x, const void* res, void* y, float* stats, float* part, int N,
                   int HW, int C, int act, float eps, int path, int grid, int ranges, int gb,
                   int block_px, int layers, int smem, cudaStream_t s) {
  constexpr int V = Row<T>::V;
  static int cluster_smem[64] = {}, persistent_smem[64] = {};
  const int groups = (C + V - 1) / V;
  if (gb < 1 || gb > GB_MAX || ranges < 1 || block_px < 1 || layers < 1 ||
      (size_t)ranges * block_px < (size_t)HW || (size_t)(ranges - 1) * block_px >= (size_t)HW ||
      (size_t)smem < (size_t)(NTH + 4 * gb) * V * sizeof(float) + (size_t)layers * NTH * 16)
    return cudaErrorInvalidValue;
  // steps of the widest block: all kept on the cluster path, else at least
  // DEPTH + 1 layers to stream through
  const int nsteps = (block_px + NTH / gb - 1) / (NTH / gb);
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  T* yt = static_cast<T*>(y);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if (path == PATH_CLUSTER) {
    if (ranges > CLUSTER_MAX || nsteps > layers) return cudaErrorInvalidValue;
    err = allow_smem(norm_kernel<T, true>, smem, cluster_smem);
    if (err != cudaSuccess) return err;
    cfg.gridDim = dim3(ranges, (groups + gb - 1) / gb, N);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ranges;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    err = cudaLaunchKernelEx(&cfg, norm_kernel<T, true>, xt, rt, yt, stats, (float*)nullptr,
                             N, HW, C, act, eps, gb, ranges, block_px, layers);
  } else if (path == PATH_PERSISTENT) {
    if (grid < ranges || (nsteps > layers && layers <= 2 * DEPTH + 1)) return cudaErrorInvalidValue;
    err = allow_smem(norm_kernel<T, false>, smem, persistent_smem);
    if (err != cudaSuccess) return err;
    cfg.gridDim = dim3(grid);
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    err = cudaLaunchKernelEx(&cfg, norm_kernel<T, false>, xt, rt, yt, stats, part, N, HW, C,
                             act, eps, gb, ranges, block_px, layers);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. act: 0 none, 1 relu, 2 lrelu. x, res
// (or null) and y (N, HW, C) in dtype; stats (2, N, C) f32 or null; part
// (2, N, ranges, C) f32 scratch on the persistent path (else unused). The
// plan (kernels/instance_norm_act.py, norm_plan): path 0 = cluster (a
// cluster of `ranges` blocks per task), 1 = persistent (a cooperative grid
// of `grid` blocks, `ranges` per task); a task is an image and gb channel
// groups of 16 bytes; block_px pixels per block; `layers` layers of 512
// rows in shared memory; smem: dynamic shared memory per block.
int instance_norm_act_launch(const void* x, const void* res, void* y, void* stats, void* part,
                             int N, int HW, int C, int dtype, int act, float eps, int path,
                             int grid, int ranges, int gb, int block_px, int layers, int smem,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  float* pp = static_cast<float*>(part);
  cudaError_t err;
  if (dtype == 1)
    err = launch<__nv_bfloat16>(x, res, y, st, pp, N, HW, C, act, eps, path, grid, ranges, gb,
                                block_px, layers, smem, s);
  else if (dtype == 0)
    err = launch<float>(x, res, y, st, pp, N, HW, C, act, eps, path, grid, ranges, gb,
                        block_px, layers, smem, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
