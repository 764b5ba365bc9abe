// convt3x3s2_fused: torch ConvTranspose2d(3, stride 2, padding 1,
// output_padding 1) on an NHWC input (N, h, w, C) -> (N, 2h, 2w, Cout), with
// the H axis zero padded and the W axis periodic (wrap) or zero padded, an
// optional per-(N, C) affine + activation prologue on the input (f32 a and
// b, one rounding to the input's dtype, as in conv3x3_fused.cu, where the
// Pallas kernel computes it in the input's dtype: see conv3x3s2_fused.cu),
// an f32 bias, one cast, and optional per-(N, Cout) moments (sum and sum of
// squares) of the stored output.
//
// Replaces the Pallas TPU kernel biasgan_tpu/ops/pallas_conv.py::
// convt3x3s2_fused (wrapper :1318, body _convt_kernel :1150) together with
// interleave_phases (:1813). It carries the resnet generator's two
// upsampling convs at inference under --fused_updown; up0's instance norm
// + ReLU rides into up1 as its prologue.
//
// What bounds it on an H100: at the full-globe shapes, up0
// (1, 181, 360, 256) -> (1, 362, 720, 128) is 38.4 GFLOP against 100 MB of
// bf16 traffic (tensor cores); up1 (1, 362, 720, 128) -> (1, 724, 1440, 64)
// is 38.4 GFLOP against 200 MB (memory). The bf16 path runs on the tensor
// cores (mma.sync m16n8k16, f32 accumulation) and writes each output once;
// the f32 path, which exists for checking, is a direct CUDA-core loop.
//
// The transposed conv has four output phases, each a dense conv of the
// undilated input (y[2i - 1 + ky, 2j - 1 + kx] += x[i, j] W[ky, kx]):
//   out(2m,   2j)   = W11 x(m, j)
//   out(2m,   2j+1) = W10 x(m, j+1) + W12 x(m, j)
//   out(2m+1, 2j)   = W01 x(m+1, j) + W21 x(m, j)
//   out(2m+1, 2j+1) = W00 x(m+1, j+1) + W02 x(m+1, j) + W20 x(m, j+1)
//                     + W22 x(m, j)
// so tap (ky, kx) feeds phase (ky != 1, kx != 1) from the input shifted by
// (ky == 0, kx == 0): 9 taps in all, no dilated buffer. The halo is one
// bottom row (zero, the H pad) and one right column (column 0 under wrap,
// else zero). The Pallas kernel merges the column phases onto the channel
// axis and emits even- and odd-row tensors for Mosaic's DMA rules; here
// each phase's pixels are written straight to their (2m+py, 2j+px) places
// in the NHWC output.
//
// Design (simple and correct first): a block owns TH x 16 input pixels (the
// 2TH x 32 output pixels they make) and 64 * WN couts; warp (wm, wn) owns
// input row wm and, for each of the four phases, one m16 fragment of 16
// output pixels by 64 couts. Per chunk of 16 input channels the (TH+1) x 17
// halo is staged in shared memory (three cp.async stages, as in
// conv3x3_fused.cu) with the prologue applied after it lands and the pads
// resolved by index after the prologue. The moments of the stored values
// go out as per-tile partials, summed in a fixed order by a second kernel.
//
// Interface: plain C, loaded with ctypes; launches go on the caller's stream
// and the function returns the cudaError_t of the launches (0 = ok).

#include "common.cuh"

namespace {

using namespace port;

constexpr int TW = 16;     // input columns per block (one m16 fragment)
constexpr int KC = 16;     // input channels per chunk
constexpr int NTH = 256;   // 8 warps
constexpr int STAGES = 3;
constexpr int A_STRIDE = KC + 8;  // padded staged pixel (elements)
constexpr int HALO_W = TW + 1;

// The input halo of rows [y0, y0 + th] and columns [x0, x0 + 16]: row h
// (zero below it), column w = column 0 (wrap) or zero; columns past w are
// read only by masked outputs.
struct UpMap {
  int y0, x0, H, W, w_mode;
  __device__ __forceinline__ bool operator()(int pix, int* iy, int* ix) const {
    *iy = y0 + pix / HALO_W;
    *ix = x0 + pix % HALO_W;
    if (*iy >= H || *ix > W) return false;
    if (*ix == W) {
      if (w_mode != PAD_WRAP) return false;
      *ix = 0;
    }
    return true;
  }
};

template <int WN>
struct UpGeom {
  static constexpr int WM = 8 / WN;  // warps along the input rows
  static constexpr int TH = WM;      // one input row per warp
  static constexpr int NT = 64 * WN;
  static constexpr int LDW = NT + 8;
  static constexpr int IN_ELEMS = (TH + 1) * HALO_W * A_STRIDE;
  static constexpr int STAGE = IN_ELEMS + 9 * KC * LDW;  // elements
  static constexpr int SMEM = STAGES * STAGE * 2;         // bytes
};

template <int WN>
__global__ void __launch_bounds__(NTH, 1)
    up_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w9,
                   const float* __restrict__ bias,
                   const float* __restrict__ pa,
                   const float* __restrict__ pb,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                   int N, int H, int W, int C, int Cout, int tiles_x,
                   int n_tiles, int w_mode, int act) {
  using G = UpGeom<WN>;
  using Input = HaloChunk<__nv_bfloat16, (G::TH + 1) * HALO_W, KC, A_STRIDE, NTH>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* stage0 = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tile = blockIdx.x, n = blockIdx.z;
  const int co0 = blockIdx.y * G::NT;
  const int y0 = (tile / tiles_x) * G::TH, x0 = (tile % tiles_x) * TW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % G::WM, wn = warp / G::WM;
  const bool vec_in = (C % 8) == 0 && aligned16(x);
  const bool vec_w = (Cout % 8) == 0 && aligned16(w9);
  const int n_chunks = (C + KC - 1) / KC;
  const UpMap map{y0, x0, H, W, w_mode};

  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lcol = 8 * (lane >> 4);

  float acc[4][8][4];  // [phase 2 py + px][n8 fragment][fragment element]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  auto stage = [&](int ch) { return stage0 + (ch % STAGES) * G::STAGE; };
  auto issue = [&](int ch) {
    __nv_bfloat16* st = stage(ch);
    issue_weights<__nv_bfloat16, KC, G::NT, NTH>(st + G::IN_ELEMS, G::LDW, w9,
                                                  C, Cout, ch * KC, co0, vec_w);
    Input::issue(st, x, pa, pb, map, n, H, W, C, ch * KC, act, vec_in);
    cp_async_commit();
  };
  auto finish = [&](int ch) {
    Input::finish(stage(ch), pa, pb, map, n, H, W, C, ch * KC, act, vec_in);
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
    if (ch + 2 < n_chunks) issue(ch + 2);
    const __nv_bfloat16* s_in = stage(ch);
    const __nv_bfloat16* s_w = s_in + G::IN_ELEMS;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      const int ph = 2 * (ky != 1) + (kx != 1);
      const int sy = ky == 0, sx = kx == 0;
      uint32_t b[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        ldmatrix_x4_trans(
            b[jj], s_w + (tap * KC + lrow) * G::LDW + wn * 64 + jj * 16 + lcol);
      uint32_t a[4];
      ldmatrix_x4(a, s_in + ((wm + sy) * HALO_W + sx + lrow) * A_STRIDE + lcol);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        mma_bf16(acc[ph][2 * jj], a, b[jj][0], b[jj][1]);
        mma_bf16(acc[ph][2 * jj + 1], a, b[jj][2], b[jj][3]);
      }
      if (tap == 4 && ch + 1 < n_chunks) {
        if (ch + 2 < n_chunks) cp_async_wait_one();
        else cp_async_wait_all();
        finish(ch + 1);
      }
    }
    __syncthreads();
  }

  // epilogue: acc[ph][j] holds input pixels (lane / 4, lane / 4 + 8) of
  // input row wm, phase ph, couts 2 (lane % 4), +1 of n8 fragment j
  float* red = reinterpret_cast<float*>(smem);  // [sum|sq][wm][NT]
  const int pr = lane / 4, pc = 2 * (lane % 4);
  const int Ho = 2 * H, Wo = 2 * W;
  const int m = y0 + wm;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = co0 + wn * 64 + j * 8 + pc;
    const bool ok0 = co < Cout, ok1 = co + 1 < Cout;
    const float bv0 = (bias != nullptr && ok0) ? bias[co] : 0.f;
    const float bv1 = (bias != nullptr && ok1) ? bias[co + 1] : 0.f;
    float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int ph = 0; ph < 4; ++ph) {
      const int oy = 2 * m + (ph >> 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jx = x0 + pr + 8 * h;
        const int ox = 2 * jx + (ph & 1);
        const __nv_bfloat16 v0 = __float2bfloat16_rn(acc[ph][j][2 * h] + bv0);
        const __nv_bfloat16 v1 = __float2bfloat16_rn(acc[ph][j][2 * h + 1] + bv1);
        if (m < H && jx < W) {
          __nv_bfloat16* dst = y + (((size_t)n * Ho + oy) * Wo + ox) * Cout + co;
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
#pragma unroll
    for (int mm = 4; mm < 32; mm <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, mm);
      s1 += __shfl_xor_sync(0xffffffffu, s1, mm);
      q0 += __shfl_xor_sync(0xffffffffu, q0, mm);
      q1 += __shfl_xor_sync(0xffffffffu, q1, mm);
    }
    if (part != nullptr && lane < 4) {
      const int t = wn * 64 + j * 8 + pc;
      red[wm * G::NT + t] = s0;
      red[wm * G::NT + t + 1] = s1;
      red[(G::WM + wm) * G::NT + t] = q0;
      red[(G::WM + wm) * G::NT + t + 1] = q1;
    }
  }
  if (part == nullptr) return;
  __syncthreads();
  write_tile_moments<NTH>(red, G::WM, G::NT, part, n, N, tile, n_tiles, co0,
                          Cout);
}

// f32 on the CUDA cores, for checking: warp cg of a block takes couts
// [64 blockIdx.y + 8 cg, +8) of 32 consecutive input pixels (one per lane)
// and writes the 4 output pixels each makes.
constexpr int F32_PIX = 32;
constexpr int F32_NT = 64;

__global__ void __launch_bounds__(NTH)
    up_f32_kernel(const float* __restrict__ x, const float* __restrict__ w9,
                  const float* __restrict__ bias, const float* __restrict__ pa,
                  const float* __restrict__ pb, float* __restrict__ y,
                  float* __restrict__ part, int N, int H, int W, int C,
                  int Cout, int n_tiles, int w_mode, int act) {
  const int lane = threadIdx.x % 32, cg = threadIdx.x / 32;
  const int tile = blockIdx.x, n = blockIdx.z;
  const int p = tile * F32_PIX + lane;
  const int co = blockIdx.y * F32_NT + cg * 8;
  const bool ok = p < H * W && co < Cout;
  const int m = p / W, jx = p % W;
  // the four inputs x(m + sy, j + sx); the right column wraps or is zero
  const int xr = jx + 1 < W ? jx + 1 : (w_mode == PAD_WRAP ? 0 : -1);
  const bool has_m1 = m + 1 < H;
  float acc[4][8];
#pragma unroll
  for (int ph = 0; ph < 4; ++ph)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[ph][j] = 0.f;
  if (ok) {
    const float* row0 = x + ((size_t)n * H + m) * W * C;
    const float* row1 = row0 + (size_t)W * C;
    for (int c = 0; c < C; ++c) {
      float v[2][2];  // [sy][sx]
      v[0][0] = row0[(size_t)jx * C + c];
      v[0][1] = xr >= 0 ? row0[(size_t)xr * C + c] : 0.f;
      v[1][0] = has_m1 ? row1[(size_t)jx * C + c] : 0.f;
      v[1][1] = has_m1 && xr >= 0 ? row1[(size_t)xr * C + c] : 0.f;
      if (pa != nullptr) {
        const float a = pa[(size_t)n * C + c], b = pb[(size_t)n * C + c];
        v[0][0] = affine_act(v[0][0], a, b, act);
        if (xr >= 0) v[0][1] = affine_act(v[0][1], a, b, act);
        if (has_m1) v[1][0] = affine_act(v[1][0], a, b, act);
        if (has_m1 && xr >= 0) v[1][1] = affine_act(v[1][1], a, b, act);
      }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        const int ph = 2 * (ky != 1) + (kx != 1);
        const float u = v[ky == 0][kx == 0];
        const float* wp = w9 + ((size_t)tap * C + c) * Cout + co;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (co + j < Cout) acc[ph][j] = fmaf(u, wp[j], acc[ph][j]);
      }
    }
  }
  const int Ho = 2 * H, Wo = 2 * W;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool okj = ok && co + j < Cout;
    const float bv = okj && bias != nullptr ? bias[co + j] : 0.f;
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int ph = 0; ph < 4; ++ph) {
      const float v = acc[ph][j] + bv;
      if (okj) {
        const int oy = 2 * m + (ph >> 1), ox = 2 * jx + (ph & 1);
        y[(((size_t)n * Ho + oy) * Wo + ox) * Cout + co + j] = v;
        s += v;
        q += v * v;
      }
    }
#pragma unroll
    for (int mm = 16; mm > 0; mm >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, mm);
      q += __shfl_xor_sync(0xffffffffu, q, mm);
    }
    if (part != nullptr && lane == 0 && co + j < Cout) {
      const size_t o = ((size_t)n * n_tiles + tile) * Cout + co + j;
      part[o] = s;
      part[(size_t)N * n_tiles * Cout + o] = q;
    }
  }
}

template <int WN>
cudaError_t launch_bf16(const void* x, const void* w9, const float* bias,
                        const void* pa, const void* pb, void* y, float* part,
                        int N, int H, int W, int C, int Cout, int w_mode,
                        int act, cudaStream_t s, int* n_tiles) {
  using G = UpGeom<WN>;
  const int tiles_x = (W + TW - 1) / TW;
  *n_tiles = ((H + G::TH - 1) / G::TH) * tiles_x;
  cudaError_t err = cudaFuncSetAttribute(
      up_bf16_kernel<WN>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(*n_tiles, (Cout + G::NT - 1) / G::NT, N);
  up_bf16_kernel<WN><<<grid, NTH, G::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w9), bias,
      static_cast<const float*>(pa), static_cast<const float*>(pb),
      static_cast<__nv_bfloat16*>(y),
      part, N, H, W, C, Cout, tiles_x, *n_tiles, w_mode, act);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tiles per image (dtype as in convt3x3s2_fused_launch): the middle
// dimension of the moment partials.
int convt3x3s2_fused_num_tiles(int H, int W, int Cout, int dtype) {
  if (dtype == 0) return (H * W + F32_PIX - 1) / F32_PIX;
  const int th = Cout <= 64 ? UpGeom<1>::TH : UpGeom<2>::TH;
  return ((H + th - 1) / th) * ((W + TW - 1) / TW);
}

// dtype: 0 = float32, 1 = bfloat16. w_mode: 0 zero, 2 wrap. act: 0 none,
// 1 relu, 2 lrelu (only read with a prologue). x (N, H, W, C) NHWC, y
// (N, 2H, 2W, Cout); w9 (9, C, Cout) in x's dtype, tap ky * 3 + kx of the
// IOHW weight; bias (Cout) f32 or null; pa, pb (N, C) f32 or both null;
// part (2, N, n_tiles, Cout) and moments (2, N, Cout) f32, or both null.
int convt3x3s2_fused_launch(const void* x, const void* w9, const void* bias,
                            const void* pa, const void* pb, void* y, void* part,
                            void* moments, int N, int H, int W, int C, int Cout,
                            int dtype, int w_mode, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* pp = static_cast<float*>(part);
  int n_tiles = convt3x3s2_fused_num_tiles(H, W, Cout, dtype);
  cudaError_t err;
  if (dtype == 1) {
    err = Cout <= 64
              ? launch_bf16<1>(x, w9, b, pa, pb, y, pp, N, H, W, C, Cout, w_mode,
                               act, s, &n_tiles)
              : launch_bf16<2>(x, w9, b, pa, pb, y, pp, N, H, W, C, Cout, w_mode,
                               act, s, &n_tiles);
  } else if (dtype == 0) {
    dim3 grid(n_tiles, (Cout + F32_NT - 1) / F32_NT, N);
    up_f32_kernel<<<grid, NTH, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w9), b,
        static_cast<const float*>(pa), static_cast<const float*>(pb),
        static_cast<float*>(y), pp, N, H, W, C, Cout, n_tiles, w_mode, act);
    err = cudaGetLastError();
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  return static_cast<int>(port::launch_reduce_moments(
      pp, static_cast<float*>(moments), N, n_tiles, Cout, s));
}

}  // extern "C"
