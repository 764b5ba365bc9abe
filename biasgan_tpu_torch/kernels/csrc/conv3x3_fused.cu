// conv3x3_fused: SAME 3x3 stride-1 conv on an unpadded NHWC input, with the
// pad assembled in the kernel, an optional per-(N, C) affine + activation
// prologue on the input, a bias, and optional per-(N, Cout) moments (sum and
// sum of squares) of the stored output.
//
// Replaces the Pallas TPU kernel biasgan_tpu/ops/pallas_conv.py::
// conv3x3_fused (wrapper :771, body _fused_kernel :576). It carries the 18
// convs of the resnet generator's residual blocks at inference.
//
// What bounds it on an H100: at the full-globe block shape (1, 181, 360, 256)
// one conv is 2 * 65,160 * 2,304 * 256 = 76.9 GFLOP against ~67 MB of bf16
// traffic (input, output, weights), ~1,150 FLOP per byte: compute-bound by a
// wide margin (the card's bf16 ridge is ~295 FLOP/B). So the bf16 path runs
// its products on the tensor cores (mma.sync m16n8k16, f32 accumulation);
// the f32 path, which exists for checking, runs on the CUDA cores in full
// f32.
//
// Design (simple and correct first; the fast Hopper shape with TMA, wgmma
// and warp-specialized producers is later work):
//   * a block owns a TH x TW output tile and an NT-wide Cout slice; ragged
//     tiles are masked on store and in the moments, so H and W need no
//     alignment and there is no padded row tail;
//   * per chunk of input channels, the (TH+2) x (TW+2) halo tile is staged
//     in shared memory with the SAME pad resolved by index (reflect / zero /
//     wrap on each axis), or, for the spatially sharded path, W taken from
//     the neighbour columns the input carries (the halo mode: an input of
//     W+2 columns, exchanged by halo_exchange.cu; the prologue applies to
//     those columns too, since they hold the neighbour's raw conv output);
//     the prologue is applied to the staged values and its result cast
//     back to the storage type before the taps (as the Pallas kernel does,
//     pallas_conv.py:695-703);
//   * bf16: three shared-memory stages; the weights and input of chunks
//     k+1 and k+2 stream in with cp.async while the tensor cores work on
//     chunk k, and chunk k+1's prologue runs between chunk k's MMAs;
//   * the 9 taps read shifted windows of the staged tile directly (no im2col
//     copy): a row of TW output pixels at tap (dy, dx) is TW consecutive
//     staged pixels;
//   * the epilogue adds the f32 bias, casts to the storage type, stores, and
//     takes the moments from the STORED (down-cast) value (pallas_conv.py:
//     763-768) as per-tile partials; a second small kernel sums the partials
//     over tiles in a fixed order. No float atomics: results are
//     deterministic.
// Measured on an H100 80GB HBM3 (700 W) at the globe shape with prologue and
// moments: ~0.43 ms per conv (~180 TFLOP/s), where a bf16 cuDNN conv alone
// takes ~0.11 ms (PERF.md). The MMAs are not what limits it (removing them
// left the time unchanged in an earlier version); the chunk-by-chunk
// staging and barriers are, with the prologue pass (~0.07 ms) and a grid
// of 552 blocks on 132 SMs (4.18 waves).
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream; the function returns the cudaError_t of the launches (0 = ok).

#include "common.cuh"

namespace {

using namespace port;

constexpr int TW = 16;  // output columns per block (one m16 row of pixels)
constexpr int HALO_W = TW + 2;
constexpr int TH = 8;   // output rows per block, f32 kernel
constexpr int KC = 16;  // input channels per chunk, f32 kernel
constexpr int NTHREADS = 256;

constexpr int NT_BF16 = 128;           // Cout slice of the tensor-core kernel
constexpr int LDW_BF16 = NT_BF16 + 8;  // padded smem row of staged weights
constexpr int NT_F32 = 64;             // Cout slice of the CUDA-core kernel

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
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulation), 8 warps, one
// block per SM. The block tile is TH_BF16 x TW = 256 pixels by NT_BF16 = 128
// couts; warp (wm, wn) owns tile rows 4wm..4wm+3 (one m16 fragment of 16
// pixels each) and couts [64 wn, 64 wn + 64) (eight n8 fragments). A
// 256-pixel tile halves the weight traffic from L2 per output pixel against
// a 128-pixel one. Three shared-memory stages: chunks k+1 and k+2 are in
// flight while chunk k is computed. Shared-memory rows are padded (input
// pixel stride A_STRIDE = KC_BF16 + 8, weight row LDW_BF16 = NT_BF16 + 8
// elements) so every ldmatrix phase hits 8 distinct 16-byte bank groups.
// ---------------------------------------------------------------------------
constexpr int TH_BF16 = 16;
constexpr int NTH_BF16 = 256;
constexpr int KC_BF16 = 16;
constexpr int STAGES_BF16 = 3;
constexpr int A_STRIDE = KC_BF16 + 8;
constexpr int IN_ELEMS_BF16 = (TH_BF16 + 2) * HALO_W * A_STRIDE;
constexpr int STAGE_BF16 = IN_ELEMS_BF16 + 9 * KC_BF16 * LDW_BF16;  // elements
constexpr int SMEM_BF16 = STAGES_BF16 * STAGE_BF16 * 2;              // bytes

__global__ void __launch_bounds__(NTH_BF16, 1)
    conv3x3_fused_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                              const __nv_bfloat16* __restrict__ w9,
                              const float* __restrict__ bias,
                              const float* __restrict__ pa,
                              const float* __restrict__ pb,
                              __nv_bfloat16* __restrict__ y,
                              float* __restrict__ part, int N, int H, int W,
                              int Win, int C, int Cout, int tiles_x,
                              int n_tiles, int h_mode, int w_mode, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* stage0 = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tile = blockIdx.x, n = blockIdx.z;
  const int co0 = blockIdx.y * NT_BF16;
  const int y0 = (tile / tiles_x) * TH_BF16, x0 = (tile % tiles_x) * TW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp & 3, wn = warp >> 2;
  const bool vec_in = (C % 8) == 0 && aligned16(x);
  const bool vec_w = (Cout % 8) == 0 && aligned16(w9);
  const int n_chunks = (C + KC_BF16 - 1) / KC_BF16;

  // ldmatrix lane roles: lane l addresses row (l & 7) + 8 * ((l >> 3) & 1)
  // of a 16-row operand at column 8 * (l >> 4)
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lcol = 8 * (lane >> 4);

  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  using Input =
      HaloChunk<__nv_bfloat16, (TH_BF16 + 2) * HALO_W, KC_BF16, A_STRIDE, NTH_BF16>;
  const SameMap map{y0, x0, H, Win, h_mode, w_mode};
  auto stage = [&](int ch) { return stage0 + (ch % STAGES_BF16) * STAGE_BF16; };
  auto issue = [&](int ch) {  // start chunk ch's copies as one group
    __nv_bfloat16* st = stage(ch);
    issue_weights<__nv_bfloat16, KC_BF16, NT_BF16, NTH_BF16>(
        st + IN_ELEMS_BF16, LDW_BF16, w9, C, Cout, ch * KC_BF16, co0, vec_w);
    Input::issue(st, x, pa, pb, map, n, H, Win, C, ch * KC_BF16, act, vec_in);
    cp_async_commit();
  };
  auto finish = [&](int ch) {
    Input::finish(stage(ch), pa, pb, map, n, H, Win, C, ch * KC_BF16, act, vec_in);
  };

  issue(0);
  if (n_chunks > 1) {
    issue(1);
    cp_async_wait_one();
  } else {
    cp_async_wait_all();
  }
  finish(0);
  __syncthreads();

  for (int ch = 0; ch < n_chunks; ++ch) {
    // stage (ch+2) % 3 was last read in iteration ch-1, before its barrier
    if (ch + 2 < n_chunks) issue(ch + 2);
    const __nv_bfloat16* s_in = stage(ch);
    const __nv_bfloat16* s_w = s_in + IN_ELEMS_BF16;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      // B: k16 x n16 per ldmatrix.x4.trans -> two n8 fragments
      uint32_t b[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        ldmatrix_x4_trans(
            b[jj], s_w + (tap * KC_BF16 + lrow) * LDW_BF16 + wn * 64 + jj * 16 + lcol);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // A: 16 pixels of tile row 4wm+i (shifted by the tap) x 16 channels
        uint32_t a[4];
        ldmatrix_x4(a, s_in + ((4 * wm + i + dy) * HALO_W + lrow + dx) * A_STRIDE + lcol);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          mma_bf16(acc[i][2 * jj], a, b[jj][0], b[jj][1]);
          mma_bf16(acc[i][2 * jj + 1], a, b[jj][2], b[jj][3]);
        }
      }
      // halfway through the taps: chunk ch+1 must have landed (ch+2 may
      // fly); its prologue runs while the MMAs above drain
      if (tap == 4 && ch + 1 < n_chunks) {
        if (ch + 2 < n_chunks) cp_async_wait_one();
        else cp_async_wait_all();
        finish(ch + 1);
      }
    }
    __syncthreads();
  }

  // epilogue straight from the accumulators: acc[i][j] holds pixels
  // (lane / 4, lane / 4 + 8) of tile row 4wm+i and couts 2 (lane % 4), +1 of
  // n8 fragment j
  float* red = reinterpret_cast<float*>(smem);  // [sum|sq][wm][NT_BF16]
  constexpr int WM = NTH_BF16 / 64;               // warps along the pixels
  const int pr = lane / 4, pc = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = co0 + wn * 64 + j * 8 + pc;
    const bool ok0 = co < Cout, ok1 = co + 1 < Cout;
    const float bv0 = (bias != nullptr && ok0) ? bias[co] : 0.f;
    const float bv1 = (bias != nullptr && ok1) ? bias[co + 1] : 0.f;
    float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int oy = y0 + 4 * wm + i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ox = x0 + pr + 8 * h;
        const __nv_bfloat16 v0 = __float2bfloat16_rn(acc[i][j][2 * h] + bv0);
        const __nv_bfloat16 v1 = __float2bfloat16_rn(acc[i][j][2 * h + 1] + bv1);
        if (oy < H && ox < W) {
          __nv_bfloat16* dst = y + (((size_t)n * H + oy) * W + ox) * Cout + co;
          if (ok1 && (Cout % 2) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(dst) = __halves2bfloat162(v0, v1);
          } else {
            if (ok0) dst[0] = v0;
            if (ok1) dst[1] = v1;
          }
          const float f0 = __bfloat162float(v0), f1 = __bfloat162float(v1);
          s0 += f0;
          q0 += f0 * f0;
          s1 += f1;
          q1 += f1 * f1;
        }
      }
    }
    // sum over the 8 lanes sharing lane % 4 (the pixel rows), fixed order
#pragma unroll
    for (int m = 4; m < 32; m <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, m);
      s1 += __shfl_xor_sync(0xffffffffu, s1, m);
      q0 += __shfl_xor_sync(0xffffffffu, q0, m);
      q1 += __shfl_xor_sync(0xffffffffu, q1, m);
    }
    if (part != nullptr && lane < 4) {
      const int t = wn * 64 + j * 8 + pc;
      red[wm * NT_BF16 + t] = s0;
      red[wm * NT_BF16 + t + 1] = s1;
      red[(WM + wm) * NT_BF16 + t] = q0;
      red[(WM + wm) * NT_BF16 + t + 1] = q1;
    }
  }
  if (part == nullptr) return;
  __syncthreads();
  write_tile_moments<NTH_BF16>(red, WM, NT_BF16, part, n, N, tile, n_tiles,
                               co0, Cout);
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

// Spatial tiles per image (dtype as in conv3x3_fused_launch): the middle
// dimension of the moment partials.
int conv3x3_fused_num_tiles(int H, int W, int dtype) {
  const int th = dtype == 1 ? TH_BF16 : TH;
  return ((H + th - 1) / th) * ((W + TW - 1) / TW);
}

// dtype: 0 = float32, 1 = bfloat16. h_mode: 0 zero, 1 reflect, 2 wrap;
// w_mode the same, or 3 (W_HALO): x carries its W pad columns. act: 0 none,
// 1 relu, 2 lrelu (only read with a prologue). x (N, H, W, C), or
// (N, H, W+2, C) under W_HALO, and y (N, H, W, Cout) NHWC; w9 (9, C, Cout);
// bias (Cout) f32 or null; pa, pb (N, C) f32 or both null; part
// (2, N, n_tiles, Cout) and moments (2, N, Cout) f32, or both null for no
// moments.
int conv3x3_fused_launch(const void* x, const void* w9, const void* bias,
                         const void* pa, const void* pb, void* y, void* part,
                         void* moments, int N, int H, int W, int C, int Cout,
                         int dtype, int h_mode, int w_mode, int act,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_x = (W + TW - 1) / TW;
  const int n_tiles = conv3x3_fused_num_tiles(H, W, dtype);
  const int Win = w_mode == W_HALO ? W + 2 : W;
  const float* b = static_cast<const float*>(bias);
  const float* a0 = static_cast<const float*>(pa);
  const float* b0 = static_cast<const float*>(pb);
  float* pp = static_cast<float*>(part);
  if (dtype == 1) {
    dim3 grid(n_tiles, (Cout + NT_BF16 - 1) / NT_BF16, N);
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_fused_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BF16);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv3x3_fused_bf16_kernel<<<grid, NTH_BF16, SMEM_BF16, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w9), b, a0, b0,
        static_cast<__nv_bfloat16*>(y), pp, N, H, W, Win, C, Cout, tiles_x,
        n_tiles, h_mode, w_mode, act);
  } else if (dtype == 0) {
    dim3 grid(n_tiles, (Cout + NT_F32 - 1) / NT_F32, N);
    conv3x3_fused_f32_kernel<<<grid, NTHREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w9), b, a0, b0,
        static_cast<float*>(y), pp, N, H, W, Win, C, Cout, tiles_x, n_tiles,
        h_mode, w_mode, act);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  return static_cast<int>(port::launch_reduce_moments(
      pp, static_cast<float*>(moments), N, n_tiles, Cout, s));
}

}  // extern "C"
