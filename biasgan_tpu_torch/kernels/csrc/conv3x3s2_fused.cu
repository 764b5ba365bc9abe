// conv3x3s2_fused: torch Conv2d(3, stride 2, padding 1) on an NHWC input of
// even H and W (H zero pad, W wrap or zero pad), with an optional per-(N, C)
// affine + activation prologue on the input (f32 a and b, one rounding to
// the input's dtype, as in conv3x3_fused.cu), an f32 bias, one cast, and
// optional per-(N, Cout) moments (sum and sum of squares) of the stored
// output.
//
// One deliberate difference from the Pallas kernel: it casts the prologue's
// a and b to the input's dtype and computes the affine in it. In bf16 that
// moved the served globe generator past the repository's bf16 rule against
// the plain path on an H100 (mean |dy| 0.0135 std, limit 0.01); with f32
// a and b the generator stays as close to its f32 result as the plain path.
//
// Replaces the Pallas TPU kernel biasgan_tpu/ops/pallas_conv.py::
// conv3x3s2_fused (wrapper :1663, body _down_kernel :1487). It carries the
// resnet generator's two downsampling convs at inference under
// --fused_updown: the stem's instance norm + ReLU rides into down0 as its
// prologue, down0's into down1.
//
// What bounds it on an H100: at the full-globe shapes, down0
// (1, 724, 1440, 64) -> (1, 362, 720, 128) is 38.4 GFLOP against 200 MB of
// bf16 traffic (~190 FLOP per byte, below the bf16 ridge of ~295: memory);
// down1 (1, 362, 720, 128) -> (1, 181, 360, 256) is 38.4 GFLOP against
// 100 MB (~380 FLOP per byte: tensor cores). So the bf16 path runs its
// products on the tensor cores (mma.sync m16n8k16, f32 accumulation) and
// reads the input once per block; the f32 path, which exists for checking,
// is a direct CUDA-core loop.
//
// Design (simple and correct first). The Pallas kernel reads the input
// through a (H/2, 2, W/2, 2C) view and merges the column phases onto the
// channel axis for Mosaic's 128-lane DMA rule; here the stride-2 taps are
// indexed directly:
//   * a block owns TH x 16 output pixels and 64 * WN couts; ragged tiles are
//     masked on store and in the moments;
//   * per chunk of 16 input channels the (2TH+1) x 33 input halo is staged
//     in shared memory, its even and odd columns apart, so that the 16
//     pixels of an MMA fragment at any tap are 16 consecutive staged pixels
//     (conflict-free ldmatrix); the top pad row is zero and the left pad
//     column is column W-1 (wrap) or zero, resolved by index, after the
//     prologue; even H and W read no bottom or right pad;
//   * three shared-memory stages stream with cp.async, as in
//     conv3x3_fused.cu;
//   * the epilogue adds the f32 bias, casts, stores, and takes the moments
//     of the stored value (pallas_conv.py:1621-1630) as per-tile partials,
//     summed over tiles in a fixed order by a second kernel.
//
// Interface: plain C, loaded with ctypes; launches go on the caller's stream
// and the function returns the cudaError_t of the launches (0 = ok).

#include "common.cuh"

namespace {

using namespace port;

constexpr int TW = 16;     // output columns per block (one m16 fragment)
constexpr int RW = 2;      // output rows per warp
constexpr int KC = 16;     // input channels per chunk
constexpr int NTH = 256;   // 8 warps
constexpr int STAGES = 3;
constexpr int A_STRIDE = KC + 8;         // padded staged pixel (elements)
constexpr int HALO_W = 2 * TW + 1;       // 33 input columns
constexpr int ODD0 = TW + 1;             // slot of the first odd halo column

// The input halo of output rows [oy0, oy0 + th) and columns [ox0, ox0 + 16):
// input rows 2 oy0 - 1 + r (r < 2 th + 1) and columns 2 ox0 - 1 + c
// (c < 33). Slot s = r * 33 + k holds column c = 2k for k < ODD0 and
// c = 2 (k - ODD0) + 1 after it.
struct DownMap {
  int oy0, ox0, H, W, w_mode;
  __device__ __forceinline__ bool operator()(int pix, int* iy, int* ix) const {
    const int r = pix / HALO_W, k = pix % HALO_W;
    const int c = k < ODD0 ? 2 * k : 2 * (k - ODD0) + 1;
    *iy = 2 * oy0 - 1 + r;
    *ix = 2 * ox0 - 1 + c;
    if (*iy < 0 || *iy >= H || *ix >= W) return false;
    if (*ix < 0) {
      if (w_mode != PAD_WRAP) return false;
      *ix = W - 1;
    }
    return true;
  }
};

// bf16 on the tensor cores. WN warps along the couts (64 each), 8 / WN along
// the output rows (RW each): TH = RW * 8 / WN output rows per block.
template <int WN>
struct DownGeom {
  static constexpr int WM = 8 / WN;
  static constexpr int TH = RW * WM;
  static constexpr int NT = 64 * WN;
  static constexpr int LDW = NT + 8;
  static constexpr int HALO_H = 2 * TH + 1;
  static constexpr int IN_ELEMS = HALO_H * HALO_W * A_STRIDE;
  static constexpr int STAGE = IN_ELEMS + 9 * KC * LDW;  // elements
  static constexpr int SMEM = STAGES * STAGE * 2;         // bytes
};

template <int WN>
__global__ void __launch_bounds__(NTH, 1)
    down_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w9,
                     const float* __restrict__ bias,
                     const float* __restrict__ pa,
                     const float* __restrict__ pb,
                     __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                     int N, int H, int W, int C, int Cout, int tiles_x,
                     int n_tiles, int w_mode, int act) {
  using G = DownGeom<WN>;
  using Input = HaloChunk<__nv_bfloat16, G::HALO_H * HALO_W, KC, A_STRIDE, NTH>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* stage0 = reinterpret_cast<__nv_bfloat16*>(smem);

  const int Ho = H / 2, Wo = W / 2;
  const int tile = blockIdx.x, n = blockIdx.z;
  const int co0 = blockIdx.y * G::NT;
  const int oy0 = (tile / tiles_x) * G::TH, ox0 = (tile % tiles_x) * TW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % G::WM, wn = warp / G::WM;
  const bool vec_in = (C % 8) == 0 && aligned16(x);
  const bool vec_w = (Cout % 8) == 0 && aligned16(w9);
  const int n_chunks = (C + KC - 1) / KC;
  const DownMap map{oy0, ox0, H, W, w_mode};

  // ldmatrix lane roles: lane l addresses row (l & 7) + 8 * ((l >> 3) & 1)
  // of a 16-row operand at column 8 * (l >> 4)
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lcol = 8 * (lane >> 4);

  float acc[RW][8][4];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  auto stage = [&](int ch) { return stage0 + (ch % STAGES) * G::STAGE; };
  auto issue = [&](int ch) {  // start chunk ch's copies as one group
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
    // stage (ch+2) % 3 was last read in iteration ch-1, before its barrier
    if (ch + 2 < n_chunks) issue(ch + 2);
    const __nv_bfloat16* s_in = stage(ch);
    const __nv_bfloat16* s_w = s_in + G::IN_ELEMS;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      // output column c reads halo column 2c + dx: even slots c (dx 0) and
      // c + 1 (dx 2), odd slots ODD0 + c (dx 1)
      const int slot0 = dx == 1 ? ODD0 : dx / 2;
      uint32_t b[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        ldmatrix_x4_trans(
            b[jj], s_w + (tap * KC + lrow) * G::LDW + wn * 64 + jj * 16 + lcol);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int r = 2 * (RW * wm + i) + dy;  // halo row of output row
        uint32_t a[4];
        ldmatrix_x4(a, s_in + (r * HALO_W + slot0 + lrow) * A_STRIDE + lcol);
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

  // epilogue from the accumulators: acc[i][j] holds pixels (lane / 4,
  // lane / 4 + 8) of output row RW wm + i and couts 2 (lane % 4), +1 of n8
  // fragment j
  float* red = reinterpret_cast<float*>(smem);  // [sum|sq][wm][NT]
  const int pr = lane / 4, pc = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = co0 + wn * 64 + j * 8 + pc;
    const bool ok0 = co < Cout, ok1 = co + 1 < Cout;
    const float bv0 = (bias != nullptr && ok0) ? bias[co] : 0.f;
    const float bv1 = (bias != nullptr && ok1) ? bias[co + 1] : 0.f;
    float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int oy = oy0 + RW * wm + i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ox = ox0 + pr + 8 * h;
        const __nv_bfloat16 v0 = __float2bfloat16_rn(acc[i][j][2 * h] + bv0);
        const __nv_bfloat16 v1 = __float2bfloat16_rn(acc[i][j][2 * h + 1] + bv1);
        if (oy < Ho && ox < Wo) {
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
// [64 blockIdx.y + 8 cg, +8) of 32 consecutive output pixels (one per lane).
constexpr int F32_PIX = 32;
constexpr int F32_NT = 64;

__global__ void __launch_bounds__(NTH)
    down_f32_kernel(const float* __restrict__ x, const float* __restrict__ w9,
                    const float* __restrict__ bias, const float* __restrict__ pa,
                    const float* __restrict__ pb, float* __restrict__ y,
                    float* __restrict__ part, int N, int H, int W, int C,
                    int Cout, int n_tiles, int w_mode, int act) {
  const int Ho = H / 2, Wo = W / 2;
  const int lane = threadIdx.x % 32, cg = threadIdx.x / 32;
  const int tile = blockIdx.x, n = blockIdx.z;
  const int p = tile * F32_PIX + lane;
  const int co = blockIdx.y * F32_NT + cg * 8;
  const bool ok = p < Ho * Wo && co < Cout;
  const int oy = p / Wo, ox = p % Wo;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  if (ok) {
    for (int tap = 0; tap < 9; ++tap) {
      const int iy = 2 * oy - 1 + tap / 3;
      int ix = 2 * ox - 1 + tap % 3;
      if (iy < 0) continue;  // the zero top pad
      if (ix < 0) {
        if (w_mode != PAD_WRAP) continue;
        ix = W - 1;
      }
      const float* xp = x + (((size_t)n * H + iy) * W + ix) * C;
      const float* wp = w9 + (size_t)tap * C * Cout + co;
      for (int c = 0; c < C; ++c) {
        float v = xp[c];
        if (pa != nullptr)
          v = affine_act(v, pa[(size_t)n * C + c], pb[(size_t)n * C + c], act);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (co + j < Cout) acc[j] = fmaf(v, wp[(size_t)c * Cout + j], acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool okj = ok && co + j < Cout;
    const float v = okj ? acc[j] + (bias != nullptr ? bias[co + j] : 0.f) : 0.f;
    if (okj) y[(((size_t)n * Ho + oy) * Wo + ox) * Cout + co + j] = v;
    float s = v, q = v * v;
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, m);
      q += __shfl_xor_sync(0xffffffffu, q, m);
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
  using G = DownGeom<WN>;
  const int tiles_x = (W / 2 + TW - 1) / TW;
  *n_tiles = ((H / 2 + G::TH - 1) / G::TH) * tiles_x;
  cudaError_t err = cudaFuncSetAttribute(
      down_bf16_kernel<WN>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(*n_tiles, (Cout + G::NT - 1) / G::NT, N);
  down_bf16_kernel<WN><<<grid, NTH, G::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w9), bias,
      static_cast<const float*>(pa), static_cast<const float*>(pb),
      static_cast<__nv_bfloat16*>(y),
      part, N, H, W, C, Cout, tiles_x, *n_tiles, w_mode, act);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Spatial tiles per image (dtype as in conv3x3s2_fused_launch): the middle
// dimension of the moment partials.
int conv3x3s2_fused_num_tiles(int H, int W, int Cout, int dtype) {
  const int ho = H / 2, wo = W / 2;
  if (dtype == 0) return (ho * wo + F32_PIX - 1) / F32_PIX;
  const int th = Cout <= 64 ? DownGeom<1>::TH : DownGeom<2>::TH;
  return ((ho + th - 1) / th) * ((wo + TW - 1) / TW);
}

// dtype: 0 = float32, 1 = bfloat16. w_mode: 0 zero, 2 wrap. act: 0 none,
// 1 relu, 2 lrelu (only read with a prologue). x (N, H, W, C) NHWC with H and
// W even, y (N, H/2, W/2, Cout); w9 (9, C, Cout) in x's dtype; bias (Cout)
// f32 or null; pa, pb (N, C) f32 or both null; part
// (2, N, n_tiles, Cout) and moments (2, N, Cout) f32, or both null.
int conv3x3s2_fused_launch(const void* x, const void* w9, const void* bias,
                           const void* pa, const void* pb, void* y, void* part,
                           void* moments, int N, int H, int W, int C, int Cout,
                           int dtype, int w_mode, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* pp = static_cast<float*>(part);
  int n_tiles = conv3x3s2_fused_num_tiles(H, W, Cout, dtype);
  cudaError_t err;
  if (dtype == 1) {
    err = Cout <= 64
              ? launch_bf16<1>(x, w9, b, pa, pb, y, pp, N, H, W, C, Cout, w_mode,
                               act, s, &n_tiles)
              : launch_bf16<2>(x, w9, b, pa, pb, y, pp, N, H, W, C, Cout, w_mode,
                               act, s, &n_tiles);
  } else if (dtype == 0) {
    dim3 grid(n_tiles, (Cout + F32_NT - 1) / F32_NT, N);
    down_f32_kernel<<<grid, NTH, 0, s>>>(
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
