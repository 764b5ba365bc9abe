// conv3x3_fused: SAME 3x3 stride-1 conv on an unpadded NHWC input, with the
// pad built in the kernel (h_mode reflect / zero / wrap; w_mode the same, or
// halo: x carries its two exchanged W columns), an optional per-(N, C)
// affine + activation prologue on the input (f32 a and b, applied to real
// values and the reflected or wrapped copies, never to a zero pad, rounded
// once to the input's dtype before the taps, pallas_conv.py:695-703), an
// f32 bias, one cast, and optional per-(N, Cout) moments (sum and sum of
// squares) of the stored output (pallas_conv.py:763-768), summed over the
// tiles in a fixed order (launch_reduce_moments): no float atomics.
//
// Replaces the Pallas TPU kernel biasgan_tpu/ops/pallas_conv.py::
// conv3x3_fused (wrapper :771, body _fused_kernel :576). It carries the 18
// convs of the resnet generator's residual blocks at inference, and is the
// forward of their training form (conv3x3_fused_t).
//
// What bounds it on an H100: at the full-globe block shape (1, 181, 360,
// 256) -> 256 one conv is 2 * 65,160 * 2,304 * 256 = 76.9 GFLOP against
// 67.9 MB of bf16 traffic, ~1,130 FLOP per byte: the tensor cores, by a
// wide margin (the bf16 ridge is ~295), 0.0777 ms at the card's peak. The
// f32 kernel, which exists for checking, is a CUDA-core loop.
//
// The bf16 kernel is conv_tma_kernel of conv3x3_tma.cuh (TMA boxes of the
// tile and its halo, side boxes for the pads that hold data, the prologue by
// spare warps, wgmma from registers, a persistent grid; its header says how
// and why), with the pad built here: a box origin one row and column up-left
// of the tile (the halo mode's carried columns: one row up), TMA's zero fill
// for a zero pad, and K1's epilogue (bias, one cast, moments). Where it
// stands (PERF.md): at cuDNN's time at the globe shape, twice the bound;
// four rounds of 3.94 waves, each tile's steps at about two thirds of the
// tensor cores' peak. The f32 kernel (below) is the CUDA-core checker.
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream; the function returns the cudaError_t of the launches (0 = ok).

#include "conv3x3_tma.cuh"

namespace {

using namespace port;

constexpr int TW = 16;  // output columns of the f32 kernel's tile
constexpr int HALO_W = TW + 2;
constexpr int TH = 8;   // output rows of the f32 kernel's tile
constexpr int KC = 16;  // input channels per chunk, f32 kernel
constexpr int NTHREADS = 256;
constexpr int NT_F32 = 64;  // Cout slice of the CUDA-core kernel

// Source index of padded coordinate g along an axis of size n, or -1 where
// the staged value is zero: a zero pad, or a row/column past the pad that
// only masked outputs read.
__device__ __forceinline__ int resolve(int g, int n, int mode) {
  if (g >= 0 && g < n) return g;
  if (g == -1) return mode == PAD_REFLECT ? 1 : (mode == PAD_WRAP ? n - 1 : -1);
  if (g == n) return mode == PAD_REFLECT ? n - 2 : (mode == PAD_WRAP ? 0 : -1);
  return -1;
}

// W mode of an input that carries its own pad columns: the spatially
// sharded path's halo-exchanged neighbour columns (the Pallas kernel's
// w_mode='halo', pallas_conv.py:565, 714), at input columns 0 and Win-1.
constexpr int W_HALO = 3;

// The (th+2) x (TW+2) input halo of output tile (y0, x0): the SAME pad
// resolved by index on H, and on W too unless the input carries its pad
// columns (W_HALO: output column x reads input columns x..x+2). Win is the
// input's width: the output's, or the output's + 2 under W_HALO.
struct SameMap {
  int y0, x0, H, Win, h_mode, w_mode;
  __device__ __forceinline__ bool operator()(int pix, int* iy, int* ix) const {
    *iy = resolve(y0 + pix / HALO_W - 1, H, h_mode);
    const int gx = x0 + pix % HALO_W;
    *ix = w_mode == W_HALO ? (gx < Win ? gx : -1) : resolve(gx - 1, Win, w_mode);
    return *iy >= 0 && *ix >= 0;
  }
};

// ---------------------------------------------------------------------------
// bf16: the TMA / wgmma tile loop of conv3x3_tma.cuh, with the pad built in
// the kernel, the prologue and the moments (K1's epilogue).
// ---------------------------------------------------------------------------
template <int NH>
cudaError_t launch_tma(const void* x, const void* wp, const float* bias,
                       const float* pa, const float* pb, void* y, float* part,
                       int N, int H, int W, int C, int Cout, int h_mode,
                       int w_mode, int act, int blocks, cudaStream_t stream) {
  namespace ct = port::conv_tma;
  const bool halo = w_mode == W_HALO;  // x carries its pad columns: a box from x0
  ct::ConvShape s{x, wp, nullptr, y, bias, pa, pb, part, N, H, W, H, halo ? W + 2 : W, C, Cout,
                  -1, halo ? 0 : -1, h_mode, halo ? PAD_ZERO : w_mode, 0, blocks};
  CUtensorMap maps[ct::N_MAPS];
  ct::ConvArgs a;
  int grid = 0;
  const cudaError_t err = ct::prepare<NH>(s, maps, &a, &grid);
  if (err != cudaSuccess) return err;
  constexpr int OUT = ct::BIAS_MOMENTS;
  if (pa == nullptr) return ct::launch_conv<NH, ct::NO_PROLOGUE, OUT>(maps, a, grid, stream);
  if (act == ACT_RELU) return ct::launch_conv<NH, ACT_RELU, OUT>(maps, a, grid, stream);
  if (act == ACT_LRELU) return ct::launch_conv<NH, ACT_LRELU, OUT>(maps, a, grid, stream);
  return ct::launch_conv<NH, ACT_NONE, OUT>(maps, a, grid, stream);
}

// ---------------------------------------------------------------------------
// f32: CUDA cores in full f32. Thread (tp, tn) owns 8 consecutive pixels of
// one tile row (row tp / 2, columns 8 (tp % 2) ..) and 4 consecutive couts.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NTHREADS)
    conv3x3_fused_f32_kernel(const float* __restrict__ x,
                             const float* __restrict__ w9,
                             const float* __restrict__ bias,
                             const float* __restrict__ pa,
                             const float* __restrict__ pb,
                             float* __restrict__ y, float* __restrict__ part,
                             int N, int H, int W, int Win, int C, int Cout,
                             int tiles_x, int n_tiles, int h_mode, int w_mode,
                             int act) {
  constexpr int IN_ELEMS = (TH + 2) * HALO_W * KC;
  constexpr int W_ELEMS = 9 * KC * NT_F32;
  __shared__ __align__(128) float smem[IN_ELEMS + W_ELEMS];
  float* s_in = smem;
  float* s_w = smem + IN_ELEMS;

  const int tile = blockIdx.x, n = blockIdx.z;
  const int co0 = blockIdx.y * NT_F32;
  const int y0 = (tile / tiles_x) * TH, x0 = (tile % tiles_x) * TW;
  const int tn = threadIdx.x % 16, tp = threadIdx.x / 16;
  const int ty = tp / 2, tx0 = (tp % 2) * 8;
  const bool vec_in = (C % 8) == 0 && aligned16(x);
  const bool vec_w = (Cout % 8) == 0 && aligned16(w9);

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  using Input = HaloChunk<float, (TH + 2) * HALO_W, KC, KC, NTHREADS>;
  const SameMap map{y0, x0, H, Win, h_mode, w_mode};
  for (int k0 = 0; k0 < C; k0 += KC) {
    issue_weights<float, KC, NT_F32, NTHREADS>(s_w, NT_F32, w9, C, Cout, k0,
                                               co0, vec_w);
    Input::issue(s_in, x, pa, pb, map, n, H, Win, C, k0, act, vec_in);
    cp_async_commit();
    cp_async_wait_all();
    Input::finish(s_in, pa, pb, map, n, H, Win, C, k0, act, vec_in);
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const float* a_base = s_in + ((ty + dy) * HALO_W + tx0 + dx) * KC;
      const float* b_base = s_w + tap * KC * NT_F32 + tn * 4;
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        const float4 b = *reinterpret_cast<const float4*>(b_base + k * NT_F32);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = a_base[i * KC + k];
          acc[i][0] = fmaf(a, b.x, acc[i][0]);
          acc[i][1] = fmaf(a, b.y, acc[i][1]);
          acc[i][2] = fmaf(a, b.z, acc[i][2]);
          acc[i][3] = fmaf(a, b.w, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }

  float* red = smem;  // [sum|sq][tp][NT_F32]
  const int oy = y0 + ty;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + tn * 4 + j;
    const bool co_ok = co < Cout;
    const float bv = (bias != nullptr && co_ok) ? bias[co] : 0.f;
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ox = x0 + tx0 + i;
      const float v = acc[i][j] + bv;
      if (co_ok && oy < H && ox < W) {
        y[(((size_t)n * H + oy) * W + ox) * Cout + co] = v;
        s += v;
        q += v * v;
      }
    }
    red[tp * NT_F32 + tn * 4 + j] = s;
    red[(16 + tp) * NT_F32 + tn * 4 + j] = q;
  }
  if (part == nullptr) return;
  __syncthreads();
  write_tile_moments<NTHREADS>(red, 16, NT_F32, part, n, N, tile, n_tiles,
                              co0, Cout);
}

}  // namespace

extern "C" {

// The float32 kernel's spatial tiles per image: the middle dimension of its
// moment partials.
int conv3x3_fused_num_tiles(int H, int W) {
  return ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

// dtype: 0 = float32, 1 = bfloat16. h_mode: 0 zero, 1 reflect, 2 wrap;
// w_mode the same, or 3 (W_HALO): x carries its W pad columns. act: 0 none,
// 1 relu, 2 lrelu (only read with a prologue). x (N, H, W, C), or
// (N, H, W+2, C) under W_HALO, and y (N, H, W, Cout) NHWC; bias (Cout) f32
// or null; part (2, N, n_parts, Cout) and moments (2, N, Cout) f32, or both
// null for no moments. float32: w the w9 (9, C, Cout), pa and pb (N, C) f32
// or both null, n_parts conv3x3_fused_num_tiles(H, W), bn unread.
// bfloat16: w the packed weight (9 n_kc, cout_pad, 64) of the wrapper's
// pack_block_weight (n_kc = C / 64 rounded up, cout_pad Cout rounded up to
// bn), bn the tile's couts (128 or 256), C and Cout multiples of 8, pa and
// pb (N, 64 n_kc) zero past C or both null, x, w, y, pa and pb 16-byte
// aligned; n_parts the blocks of the persistent grid at most (the card's
// SM count), a slot of part each (zeroed here).
int conv3x3_fused_launch(const void* x, const void* w, const void* bias,
                         const void* pa, const void* pb, void* y, void* part,
                         void* moments, int N, int H, int W, int C, int Cout,
                         int n_parts, int dtype, int h_mode, int w_mode, int act,
                         int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* a0 = static_cast<const float*>(pa);
  const float* b0 = static_cast<const float*>(pb);
  float* pp = static_cast<float*>(part);
  if (n_parts < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 1 && (bn == 128 || bn == 256)) {
    // the blocks add their sums into their slots
    err = part == nullptr ? cudaSuccess
                          : cudaMemsetAsync(part, 0, sizeof(float) * 2 * N * n_parts * Cout, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = bn == 128 ? launch_tma<1>(x, w, b, a0, b0, y, pp, N, H, W, C, Cout, h_mode,
                                    w_mode, act, n_parts, s)
                    : launch_tma<2>(x, w, b, a0, b0, y, pp, N, H, W, C, Cout, h_mode,
                                    w_mode, act, n_parts, s);
  } else if (dtype == 0) {
    const int n_tiles = conv3x3_fused_num_tiles(H, W);
    if (n_parts != n_tiles) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid(n_tiles, (Cout + NT_F32 - 1) / NT_F32, N);
    conv3x3_fused_f32_kernel<<<grid, NTHREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), b, a0, b0,
        static_cast<float*>(y), pp, N, H, W, w_mode == W_HALO ? W + 2 : W, C, Cout,
        (W + TW - 1) / TW, n_tiles, h_mode, w_mode, act);
    err = cudaGetLastError();
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  return static_cast<int>(port::launch_reduce_moments(
      pp, static_cast<float*>(moments), N, n_parts, Cout, s));
}

}  // extern "C"
