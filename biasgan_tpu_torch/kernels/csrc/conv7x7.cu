// conv7x7: VALID 7x7 stride-1 conv of an already padded NHWC input
// (N, H+6, W+6, Cin) -> (N, H, W, Cout) with one channel side of at most 8,
// f32 accumulation, an f32 bias added before the single cast.
//
// Replaces the Pallas TPU kernel biasgan_tpu/ops/pallas_conv7.py::
// conv7x7_valid (:197; bodies _k_smallcin :142 for the stem, _k_smallcout
// :169 for the head). It carries the resnet generator's 7x7 stem
// (3 -> 64) and head (64 -> 3) under --conv7_pallas; the caller pads first
// (reflect H, wrap W), as the JAX route does.
//
// What bounds it on an H100: at the full-globe shapes each is ~19.6 GFLOP
// against ~140 MB of bf16 traffic (stem: a 6 MB input, a 133 MB output;
// head the reverse), ~140 FLOP per byte: memory-bound against the tensor
// cores' ridge, but a 3-wide channel side fills no tensor-core tile (the
// TPU kernels exist to fill the matrix unit's passes). This first version
// runs on the CUDA cores in f32, so at its ~67 TFLOP/s f32 peak the
// arithmetic, and not the bytes, is what limits it.
//
// Design (simple and correct first): a block owns a 16-row by 16 PX-column
// output tile and COB output channels; thread (ty, tx) owns the PX pixels
// (ty, tx + 16 p) and COB accumulators for each. Per chunk of KCH input
// channels the block stages the (16+6) x (16 PX + 6) input halo as f32
// channel planes (neighbouring threads read neighbouring words) and the
// chunk's weights [tap][ci][COB]; each thread then runs 49 taps x KCH
// channels, reading PX input values from the planes and COB weights as
// warp-wide broadcasts that serve all PX pixels. The two TPU variants become
// two instantiations: smallcin (the stem: Cin in chunks of 4, COB 16) and
// smallcout (the head: Cin in chunks of 8, COB 4).
//
// Interface: plain C, loaded with ctypes; launches go on the caller's stream
// and the function returns the cudaError_t of the launch (0 = ok).

#include "common.cuh"

namespace {

using namespace port;

constexpr int K = 7;
constexpr int T = 16;  // output rows per block, and threads along x
constexpr int NTH = T * T;

template <typename Tv, int COB, int KCH, int PX>
__global__ void __launch_bounds__(NTH)
    conv7x7_kernel(const Tv* __restrict__ xp, const Tv* __restrict__ w49,
                   const float* __restrict__ bias, Tv* __restrict__ y, int Hp,
                   int Wp, int Cin, int Cout, int tiles_x) {
  constexpr int HALO_H = T + K - 1, HALO_W = T * PX + K - 1;
  __shared__ float s_x[KCH][HALO_H * HALO_W];
  __shared__ __align__(16) float s_w[K * K][KCH][COB];

  const int H = Hp - (K - 1), W = Wp - (K - 1);
  const int n = blockIdx.z, co0 = blockIdx.y * COB;
  const int oy0 = (blockIdx.x / tiles_x) * T, ox0 = (blockIdx.x % tiles_x) * T * PX;
  const int ty = threadIdx.x / T, tx = threadIdx.x % T;

  float acc[PX][COB];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int j = 0; j < COB; ++j) acc[p][j] = 0.f;

  for (int k0 = 0; k0 < Cin; k0 += KCH) {
    const int kc = min(KCH, Cin - k0);
    // the halo, channel fastest on the read side (coalesced), planes in smem
    for (int i = threadIdx.x; i < HALO_H * HALO_W * KCH; i += NTH) {
      const int ci = i % KCH, pix = i / KCH;
      const int gy = oy0 + pix / HALO_W, gx = ox0 + pix % HALO_W;
      float v = 0.f;
      if (ci < kc && gy < Hp && gx < Wp)
        v = to_f(xp[(((size_t)n * Hp + gy) * Wp + gx) * Cin + k0 + ci]);
      s_x[ci][pix] = v;
    }
    for (int i = threadIdx.x; i < K * K * KCH * COB; i += NTH) {
      const int j = i % COB, ci = (i / COB) % KCH, tap = i / (COB * KCH);
      float v = 0.f;
      if (ci < kc && co0 + j < Cout)
        v = to_f(w49[((size_t)tap * Cin + k0 + ci) * Cout + co0 + j]);
      s_w[tap][ci][j] = v;
    }
    __syncthreads();
    for (int ci = 0; ci < kc; ++ci) {
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          float v[PX];
#pragma unroll
          for (int p = 0; p < PX; ++p)
            v[p] = s_x[ci][(ty + dy) * HALO_W + tx + T * p + dx];
          const float4* wv = reinterpret_cast<const float4*>(s_w[dy * K + dx][ci]);
#pragma unroll
          for (int j4 = 0; j4 < COB / 4; ++j4) {
            const float4 w = wv[j4];
#pragma unroll
            for (int p = 0; p < PX; ++p) {
              acc[p][4 * j4] = fmaf(v[p], w.x, acc[p][4 * j4]);
              acc[p][4 * j4 + 1] = fmaf(v[p], w.y, acc[p][4 * j4 + 1]);
              acc[p][4 * j4 + 2] = fmaf(v[p], w.z, acc[p][4 * j4 + 2]);
              acc[p][4 * j4 + 3] = fmaf(v[p], w.w, acc[p][4 * j4 + 3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  const int oy = oy0 + ty;
  if (oy >= H) return;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int ox = ox0 + tx + T * p;
    if (ox >= W) continue;
    Tv* dst = y + (((size_t)n * H + oy) * W + ox) * Cout + co0;
#pragma unroll
    for (int j = 0; j < COB; ++j)
      if (co0 + j < Cout)
        dst[j] = from_f<Tv>(acc[p][j] + (bias != nullptr ? bias[co0 + j] : 0.f));
  }
}

constexpr int PX = 2;  // output pixels per thread

template <typename Tv, int COB, int KCH>
cudaError_t launch(const void* xp, const void* w49, const float* bias, void* y,
                   int N, int Hp, int Wp, int Cin, int Cout, cudaStream_t s) {
  const int H = Hp - (K - 1), W = Wp - (K - 1);
  const int tiles_x = (W + T * PX - 1) / (T * PX);
  dim3 grid(((H + T - 1) / T) * tiles_x, (Cout + COB - 1) / COB, N);
  conv7x7_kernel<Tv, COB, KCH, PX><<<grid, NTH, 0, s>>>(
      static_cast<const Tv*>(xp), static_cast<const Tv*>(w49), bias,
      static_cast<Tv*>(y), Hp, Wp, Cin, Cout, tiles_x);
  return cudaGetLastError();
}

template <typename Tv>
cudaError_t launch_variant(int smallcin, const void* xp, const void* w49,
                           const float* bias, void* y, int N, int Hp, int Wp,
                           int Cin, int Cout, cudaStream_t s) {
  return smallcin ? launch<Tv, 16, 4>(xp, w49, bias, y, N, Hp, Wp, Cin, Cout, s)
                  : launch<Tv, 4, 8>(xp, w49, bias, y, N, Hp, Wp, Cin, Cout, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. smallcin: 1 for Cin <= 8 (the stem),
// 0 for Cout <= 8 (the head). xp (N, Hp, Wp, Cin) NHWC, y
// (N, Hp-6, Wp-6, Cout); w49 (49, Cin, Cout) in xp's dtype, tap dy * 7 + dx
// of the OIHW weight; bias (Cout) f32 or null.
int conv7x7_launch(const void* xp, const void* w49, const void* bias, void* y,
                   int N, int Hp, int Wp, int Cin, int Cout, int dtype,
                   int smallcin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  cudaError_t err;
  if (dtype == 1)
    err = launch_variant<__nv_bfloat16>(smallcin, xp, w49, b, y, N, Hp, Wp, Cin,
                                        Cout, s);
  else if (dtype == 0)
    err = launch_variant<float>(smallcin, xp, w49, b, y, N, Hp, Wp, Cin, Cout, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
