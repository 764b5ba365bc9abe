// conv3x3_valid: VALID 3x3 stride-1 conv on an NHWC input the caller has
// already padded, (N, H+2, W+2, C) -> (N, H, W, Cout), f32 accumulation,
// then an epilogue in f32: + bias, + residual, none / ReLU / LReLU(0.2), one
// cast to the storage type. With pad 2 and flip it is the input gradient of
// such a conv: the full conv of the unpadded cotangent (N, H, W, Cout) ->
// (N, H+2, W+2, C), a zero pad of 2 on each side, the taps read in reverse
// from the channel-transposed weight.
//
// Replaces the Pallas TPU kernel biasgan_tpu/ops/pallas_conv.py::
// conv3x3_valid (wrapper :279, body _kernel :66, epilogue _epilogue :52),
// the tap9 variant. It carries `--pallas_conv 1`: the forward of every 3x3
// s1 pad-1 conv of the resnet generator's blocks, and, run again on the
// cotangent with the flipped, channel-transposed weights, their input
// gradient (conv3x3_op, pallas_conv.py:405-454), whose 2-pad the JAX op
// builds with jnp.pad and this kernel with TMA's zero fill.
//
// What bounds it on an H100: at the 256x256 CycleGAN block shape
// (B, 66, 66, 256) -> 256 one sample is 2 * 4,096 * 2,304 * 256 = 4.83
// GFLOP against ~5.5 MB of bf16 traffic, ~880 FLOP per byte: the tensor
// cores (the bf16 ridge is ~295 FLOP/B), 4.9 us per sample at the peak; at
// the globe block shape (1, 183, 362, 256) -> 256, 76.9 GFLOP, 0.0777 ms.
// The f32 kernel, which exists for checking, is a CUDA-core loop.
//
// The bf16 kernel is K1's: conv_tma_kernel of conv3x3_tma.cuh (its header
// says how and why: 7 x 18-pixel tiles by 128 or 256 couts on a persistent
// grid, a TMA box of the tile and its halo per 64 channels for all nine
// taps, K-major weight slabs by TMA, wgmma with A from registers, the
// epilogue by TMA store). Here the box origin is the tile's own (the input
// carries its pad on both axes: no side loads), or two rows and columns
// up-left of it for the input gradient; TMA's zero fill covers that pad,
// the ragged tiles and the channels past C, so H and W need no alignment
// (the Mosaic width rounding, pallas_conv.py:295-307, and the h_run row
// tail, :317-323, are not carried). No prologue and no moments: the
// producer warpgroup's three helper warps only store each tile and load the
// next tile's residual by TMA into the staging tile, where the consumers
// add it with the f32 bias before the activation and the one cast. The
// grid: the training forward (B, 64, 64) and input gradient (B, 66, 66)
// are 40 tiles per image, one round of the grid at B 1-3; the globe block
// shape 520 tiles, four rounds.
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream; the function returns the cudaError_t of the launch (0 = ok).

#include "conv3x3_tma.cuh"

namespace {

using namespace port;

constexpr int TW = 16;  // output columns of the f32 kernel's tile
constexpr int HALO_W = TW + 2;
constexpr int TH = 8;   // output rows of the f32 kernel's tile
constexpr int KC = 16;  // input channels per chunk, f32 kernel
constexpr int NTHREADS = 256;
constexpr int NT_F32 = 64;

// The (TH+2) x (TW+2) input window of output tile (y0, x0), its first row
// and column at input (y0 - pad, x0 - pad): the rows and columns outside
// the input (the zero pad, or past the end where only masked outputs read)
// stage as zero.
struct ValidMap {
  int y0, x0, Hin, Win;  // y0, x0: the window's first input row and column
  __device__ __forceinline__ bool operator()(int pix, int* iy, int* ix) const {
    *iy = y0 + pix / HALO_W;
    *ix = x0 + pix % HALO_W;
    return *iy >= 0 && *iy < Hin && *ix >= 0 && *ix < Win;
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
// f32: CUDA cores in full f32. Thread (tp, tn) owns 8 consecutive pixels of
// one tile row (row tp / 2, columns 8 (tp % 2) ..) and 4 consecutive couts.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NTHREADS)
    conv3x3_valid_f32_kernel(const float* __restrict__ xp,
                             const float* __restrict__ w9,
                             const float* __restrict__ bias,
                             const float* __restrict__ res,
                             float* __restrict__ y, int Hin, int Win, int H, int W,
                             int C, int Cout, int pad, int flip, int tiles_x, int act) {
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
  const bool vec_in = (C % 8) == 0 && aligned16(xp);
  const bool vec_w = (Cout % 8) == 0 && aligned16(w9);

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  using Input = HaloChunk<float, (TH + 2) * HALO_W, KC, KC, NTHREADS>;
  const ValidMap map{y0 - pad, x0 - pad, Hin, Win};
  for (int k0 = 0; k0 < C; k0 += KC) {
    issue_weights<float, KC, NT_F32, NTHREADS>(s_w, NT_F32, w9, C, Cout, k0,
                                               co0, vec_w);
    Input::issue(s_in, xp, nullptr, nullptr, map, n, Hin, Win, C, k0, ACT_NONE,
                 vec_in);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const float* a_base = s_in + ((ty + dy) * HALO_W + tx0 + dx) * KC;
      const float* b_base = s_w + (flip ? 8 - tap : tap) * KC * NT_F32 + tn * 4;
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

// ---------------------------------------------------------------------------
// bf16: the TMA / wgmma tile loop of conv3x3_tma.cuh with the input's own
// pad (or the input gradient's zero pad of 2) and K6's epilogue.
// ---------------------------------------------------------------------------
template <int NH>
cudaError_t launch_tma(const port::conv_tma::ConvShape& s, int act, cudaStream_t stream) {
  namespace ct = port::conv_tma;
  CUtensorMap maps[ct::N_MAPS];
  ct::ConvArgs a;
  int grid = 0;
  const cudaError_t err = ct::prepare<NH>(s, maps, &a, &grid);
  if (err != cudaSuccess) return err;
  constexpr int NP = ct::NO_PROLOGUE;
  if (act == ACT_RELU) return ct::launch_conv<NH, NP, ACT_RELU>(maps, a, grid, stream);
  if (act == ACT_LRELU) return ct::launch_conv<NH, NP, ACT_LRELU>(maps, a, grid, stream);
  return ct::launch_conv<NH, NP, ACT_NONE>(maps, a, grid, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. act: 0 none, 1 relu, 2 lrelu. x
// (N, Hin, Win, C) and y (N, H, W, Cout) NHWC with H = Hin + 2 pad - 2 and
// W = Win + 2 pad - 2: pad 0 for a VALID conv of an input that carries its
// pad, 2 for the input gradient (the full conv); with flip, tap (dy, dx)
// takes the weight of tap (2 - dy, 2 - dx). bias (Cout) f32 or null; res
// like y, or null. float32: w the w9 (9, C, Cout), bn and blocks unread.
// bfloat16: w the packed weight (9 n_kc, cout_pad, 64) of the wrapper's
// pack_block_weight (n_kc = C / 64 rounded up, cout_pad Cout rounded up to
// bn), bn the tile's couts (128 or 256), C and Cout multiples of 8, x, w, y
// and res 16-byte aligned; blocks the persistent grid's blocks at most
// (the card's SM count).
int conv3x3_valid_launch(const void* x, const void* w, const void* bias, const void* res,
                         void* y, int N, int Hin, int Win, int C, int Cout, int pad, int flip,
                         int dtype, int act, int bn, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int H = Hin + 2 * pad - 2, W = Win + 2 * pad - 2;
  if (H <= 0 || W <= 0 || pad < 0 || pad > 2 || act < 0 || act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 1 && (bn == 128 || bn == 256)) {
    const port::conv_tma::ConvShape shape{
        x, w, res, y, b, nullptr, nullptr, nullptr, N, H, W, Hin, Win, C, Cout,
        -pad, -pad, PAD_ZERO, PAD_ZERO, flip != 0, blocks};
    return static_cast<int>(bn == 128 ? launch_tma<1>(shape, act, s)
                                      : launch_tma<2>(shape, act, s));
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (W + TW - 1) / TW;
  dim3 grid(((H + TH - 1) / TH) * tiles_x, (Cout + NT_F32 - 1) / NT_F32, N);
  conv3x3_valid_f32_kernel<<<grid, NTHREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), b,
      static_cast<const float*>(res), static_cast<float*>(y), Hin, Win, H, W, C, Cout, pad,
      flip != 0, tiles_x, act);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
