// conv3x3_valid: VALID 3x3 stride-1 conv on an NHWC input the caller has
// already padded, (N, H+2, W+2, C) -> (N, H, W, Cout), f32 accumulation,
// then an epilogue in f32: + bias, + residual, none / ReLU / LReLU(0.2), one
// cast to the storage type.
//
// Replaces the Pallas TPU kernel biasgan_tpu/ops/pallas_conv.py::
// conv3x3_valid (wrapper :279, body _kernel :66, epilogue _epilogue :52),
// the tap9 variant. It carries `--pallas_conv 1`: the forward of every 3x3
// s1 pad-1 conv of the resnet generator's blocks, and, run again on the
// 2-padded cotangent with the flipped, channel-transposed weights, their
// input gradient (conv3x3_op, pallas_conv.py:405-454).
//
// What bounds it on an H100: at the 256x256 CycleGAN block shape
// (B, 66, 66, 256) -> 256 one sample is 2 * 4,096 * 2,304 * 256 = 4.83
// GFLOP against ~4.5 MB of bf16 traffic, ~1,000 FLOP per byte: compute
// bound (the bf16 ridge is ~295 FLOP/B), 4.9 us per sample at the peak.
// So bf16 runs its products on the tensor cores (mma.sync m16n8k16, f32
// accumulation); f32, which exists for checking, on the CUDA cores.
//
// Design: conv3x3_fused.cu's tile loop (see there), without its pad
// assembly, prologue and moments. A block owns a 16 x 16 output tile and a
// 128-wide Cout slice (bf16; 8 x 16 by 64 couts in f32); per 16-channel
// chunk the (16+2) x (16+2) input window is staged by cp.async in three
// shared-memory stages, and the 9 taps read shifted windows of it. Ragged
// tiles are masked on store, so H and W need no alignment: the Mosaic
// width rounding (pallas_conv.py:295-307) and the h_run row tail (:317-323)
// are not carried. At batch 1-3 and 64x64 outputs the grid is 16-48 tiles
// x 2 Cout slices, well under one wave of 132 SMs: the kernel is launch-
// and latency-bound at the training shape (PERF.md).
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream; the function returns the cudaError_t of the launch (0 = ok).

#include "common.cuh"

namespace {

using namespace port;

constexpr int TW = 16;  // output columns per block (one m16 row of pixels)
constexpr int HALO_W = TW + 2;
constexpr int TH = 8;   // output rows per block, f32 kernel
constexpr int KC = 16;  // input channels per chunk, f32 kernel
constexpr int NTHREADS = 256;

constexpr int NT_BF16 = 128;
constexpr int LDW_BF16 = NT_BF16 + 8;
constexpr int NT_F32 = 64;

// The (th+2) x (TW+2) input window of output tile (y0, x0) in the padded
// input (Hp, Wp): no pad to resolve, only the rows and columns past the
// input's end (read by masked outputs alone) stage as zero.
struct ValidMap {
  int y0, x0, Hp, Wp;
  __device__ __forceinline__ bool operator()(int pix, int* iy, int* ix) const {
    *iy = y0 + pix / HALO_W;
    *ix = x0 + pix % HALO_W;
    return *iy < Hp && *ix < Wp;
  }
};

// The epilogue of pallas_conv.py::_epilogue on an f32 accumulator.
__device__ __forceinline__ float epilogue(float acc, float bias, float res,
                                          int act) {
  float v = acc + bias + res;
  if (act == ACT_RELU) v = fmaxf(v, 0.f);
  else if (act == ACT_LRELU) v = v > 0.f ? v : 0.2f * v;
  return v;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, 8 warps, a 256-pixel x 128-cout block tile; warp
// (wm, wn) owns tile rows 4wm..4wm+3 and couts [64 wn, 64 wn + 64). Three
// cp.async stages; padded shared-memory rows keep ldmatrix conflict-free
// (conv3x3_fused.cu).
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
    conv3x3_valid_bf16_kernel(const __nv_bfloat16* __restrict__ xp,
                              const __nv_bfloat16* __restrict__ w9,
                              const float* __restrict__ bias,
                              const __nv_bfloat16* __restrict__ res,
                              __nv_bfloat16* __restrict__ y, int Hp, int Wp,
                              int C, int Cout, int tiles_x, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* stage0 = reinterpret_cast<__nv_bfloat16*>(smem);

  const int H = Hp - 2, W = Wp - 2;
  const int tile = blockIdx.x, n = blockIdx.z;
  const int co0 = blockIdx.y * NT_BF16;
  const int y0 = (tile / tiles_x) * TH_BF16, x0 = (tile % tiles_x) * TW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp & 3, wn = warp >> 2;
  const bool vec_in = (C % 8) == 0 && aligned16(xp);
  const bool vec_w = (Cout % 8) == 0 && aligned16(w9);
  const int n_chunks = (C + KC_BF16 - 1) / KC_BF16;

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
  const ValidMap map{y0, x0, Hp, Wp};
  auto stage = [&](int ch) { return stage0 + (ch % STAGES_BF16) * STAGE_BF16; };
  auto issue = [&](int ch) {
    __nv_bfloat16* st = stage(ch);
    issue_weights<__nv_bfloat16, KC_BF16, NT_BF16, NTH_BF16>(
        st + IN_ELEMS_BF16, LDW_BF16, w9, C, Cout, ch * KC_BF16, co0, vec_w);
    Input::issue(st, xp, nullptr, nullptr, map, n, Hp, Wp, C, ch * KC_BF16,
                 ACT_NONE, vec_in);
    cp_async_commit();
  };

  issue(0);
  if (n_chunks > 1) {
    issue(1);
    cp_async_wait_one();
  } else {
    cp_async_wait_all();
  }
  __syncthreads();

  for (int ch = 0; ch < n_chunks; ++ch) {
    // stage (ch+2) % 3 was last read in iteration ch-1, before its barrier
    if (ch + 2 < n_chunks) issue(ch + 2);
    const __nv_bfloat16* s_in = stage(ch);
    const __nv_bfloat16* s_w = s_in + IN_ELEMS_BF16;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t b[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        ldmatrix_x4_trans(
            b[jj], s_w + (tap * KC_BF16 + lrow) * LDW_BF16 + wn * 64 + jj * 16 + lcol);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t a[4];
        ldmatrix_x4(a, s_in + ((4 * wm + i + dy) * HALO_W + lrow + dx) * A_STRIDE + lcol);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          mma_bf16(acc[i][2 * jj], a, b[jj][0], b[jj][1]);
          mma_bf16(acc[i][2 * jj + 1], a, b[jj][2], b[jj][3]);
        }
      }
    }
    // chunk ch+1 must have landed before the barrier (ch+2 may fly)
    if (ch + 1 < n_chunks) {
      if (ch + 2 < n_chunks) cp_async_wait_one();
      else cp_async_wait_all();
    }
    __syncthreads();
  }

  // acc[i][j] holds pixels (lane / 4, lane / 4 + 8) of tile row 4wm+i and
  // couts 2 (lane % 4), +1 of n8 fragment j
  const int pr = lane / 4, pc = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = co0 + wn * 64 + j * 8 + pc;
    const bool ok0 = co < Cout, ok1 = co + 1 < Cout;
    const float bv0 = (bias != nullptr && ok0) ? bias[co] : 0.f;
    const float bv1 = (bias != nullptr && ok1) ? bias[co + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int oy = y0 + 4 * wm + i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ox = x0 + pr + 8 * h;
        if (oy >= H || ox >= W) continue;
        const size_t o = (((size_t)n * H + oy) * W + ox) * Cout + co;
        float r0 = 0.f, r1 = 0.f;
        if (res != nullptr) {
          if (ok0) r0 = __bfloat162float(res[o]);
          if (ok1) r1 = __bfloat162float(res[o + 1]);
        }
        const __nv_bfloat16 v0 =
            __float2bfloat16_rn(epilogue(acc[i][j][2 * h], bv0, r0, act));
        const __nv_bfloat16 v1 =
            __float2bfloat16_rn(epilogue(acc[i][j][2 * h + 1], bv1, r1, act));
        if (ok1 && (Cout % 2) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(y + o) = __halves2bfloat162(v0, v1);
        } else {
          if (ok0) y[o] = v0;
          if (ok1) y[o + 1] = v1;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores in full f32. Thread (tp, tn) owns 8 consecutive pixels of
// one tile row (row tp / 2, columns 8 (tp % 2) ..) and 4 consecutive couts.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NTHREADS)
    conv3x3_valid_f32_kernel(const float* __restrict__ xp,
                             const float* __restrict__ w9,
                             const float* __restrict__ bias,
                             const float* __restrict__ res,
                             float* __restrict__ y, int Hp, int Wp, int C,
                             int Cout, int tiles_x, int act) {
  constexpr int IN_ELEMS = (TH + 2) * HALO_W * KC;
  constexpr int W_ELEMS = 9 * KC * NT_F32;
  __shared__ __align__(128) float smem[IN_ELEMS + W_ELEMS];
  float* s_in = smem;
  float* s_w = smem + IN_ELEMS;

  const int H = Hp - 2, W = Wp - 2;
  const int tile = blockIdx.x, n = blockIdx.z;
  const int co0 = blockIdx.y * NT_F32;
  const int y0 = (tile / tiles_x) * TH, x0 = (tile % tiles_x) * TW;
  const int tn = threadIdx.x % 16, tp = threadIdx.x / 16;
  const int ty = tp / 2, tx0 = (tp % 2) * 8;
  const bool vec_in = (C % 8) == 0 && aligned16(xp);
  const bool vec_w = (Cout % 8) == 0 && aligned16(w9);

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  using Input = HaloChunk<float, (TH + 2) * HALO_W, KC, KC, NTHREADS>;
  const ValidMap map{y0, x0, Hp, Wp};
  for (int k0 = 0; k0 < C; k0 += KC) {
    issue_weights<float, KC, NT_F32, NTHREADS>(s_w, NT_F32, w9, C, Cout, k0,
                                               co0, vec_w);
    Input::issue(s_in, xp, nullptr, nullptr, map, n, Hp, Wp, C, k0, ACT_NONE,
                 vec_in);
    cp_async_commit();
    cp_async_wait_all();
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

  const int oy = y0 + ty;
  if (oy >= H) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + tn * 4 + j;
    if (co >= Cout) continue;
    const float bv = bias != nullptr ? bias[co] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ox = x0 + tx0 + i;
      if (ox >= W) continue;
      const size_t o = (((size_t)n * H + oy) * W + ox) * Cout + co;
      y[o] = epilogue(acc[i][j], bv, res != nullptr ? res[o] : 0.f, act);
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. act: 0 none, 1 relu, 2 lrelu.
// xp (N, Hp, Wp, C) and y (N, Hp-2, Wp-2, Cout) NHWC; w9 (9, C, Cout) in
// xp's dtype; bias (Cout) f32 or null; res like y, or null.
int conv3x3_valid_launch(const void* xp, const void* w9, const void* bias,
                         const void* res, void* y, int N, int Hp, int Wp, int C,
                         int Cout, int dtype, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int H = Hp - 2, W = Wp - 2;
  if (H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (W + TW - 1) / TW;
  const float* b = static_cast<const float*>(bias);
  if (dtype == 1) {
    dim3 grid(((H + TH_BF16 - 1) / TH_BF16) * tiles_x, (Cout + NT_BF16 - 1) / NT_BF16, N);
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_valid_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BF16);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv3x3_valid_bf16_kernel<<<grid, NTH_BF16, SMEM_BF16, s>>>(
        static_cast<const __nv_bfloat16*>(xp),
        static_cast<const __nv_bfloat16*>(w9), b,
        static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(y),
        Hp, Wp, C, Cout, tiles_x, act);
  } else if (dtype == 0) {
    dim3 grid(((H + TH - 1) / TH) * tiles_x, (Cout + NT_F32 - 1) / NT_F32, N);
    conv3x3_valid_f32_kernel<<<grid, NTHREADS, 0, s>>>(
        static_cast<const float*>(xp), static_cast<const float*>(w9), b,
        static_cast<const float*>(res), static_cast<float*>(y), Hp, Wp, C, Cout,
        tiles_x, act);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
