// conv3x3_fused_bwd: the backward of the fused resnet-block conv
// (conv3x3_fused.cu, K1): from the cotangents of its output y and of y's
// moments, the gradients of its input x, the weight, the bias and the
// instance-norm prologue's a and b, for every H pad mode and every W mode
// (a pad built in the kernel, or the halo W mode of the spatially sharded
// path, whose input carries its two W pad columns).
//
// Replaces biasgan_tpu/ops/pallas_conv.py::_fused_diff_bwd (:972-1085), the
// custom VJP of conv3x3_fused_t (:1091). The reference runs it as XLA ops
// (its forward is the Pallas kernel); this file computes the same function:
//   1. dYf = f32(dy) + ds + 2 dq f32(y), of the STORED y (the moments'
//      pullback), then cast once to the compute type: dYc;
//   2. u = cdt(act(a x + b)) as the forward stages it (u = x without a
//      prologue);
//   3. dU and dW, the VJP of "pad u, VALID 3x3 conv" at dYc: dU is the full
//      conv of dYc with the flipped, channel-transposed weight followed by
//      the pad's adjoint; dW[tap][c][co] = sum over pixels of the padded
//      u at p + tap times dYc at p; each rounded once to the compute type,
//      as the reference's preferred_element_type=cdt;
//   4. dbias = sum of dYf, in f32;
//   5. dpre = f32(dU) act'(a x + b), dx = cdt(dpre a), da = sum_hw dpre x,
//      db = sum_hw dpre (without a prologue dx = dU).
//
// What bounds it on an H100: at the 256x256 CycleGAN block shape
// (2, 64, 64, 256) -> 256 the two products (dU and dW) are 2 x 9.66 GFLOP
// against ~19 MB of bf16 traffic (x, y, dy and dx 4.2 MB each, the weight
// and its gradient 1.2 MB each, each once): ~1,000 FLOP per byte,
// operations-bound (the bf16 ridge is ~295 FLOP/B; 0.0195 ms per call at
// the peak). So in bf16 both products run on the tensor cores through
// wgmma, fed by TMA, on Hopper's machinery (common.cuh port::sm90,
// conv3x3_tma.cuh); the f32 path, which exists for checking, runs on the
// CUDA cores in full f32. Four launches:
//   * prep: dYc = cdt(dYf) with per-block f32 column sums of dYf (dbias
//      partials): one elementwise pass over dy and y, so that both products
//      load dYc by TMA. In bf16 it also writes u_pad, the forward's padded
//      input after the prologue (N, H+2, W+2, C), for the wgrad; in f32 it
//      transposes the weight to (9, Cout, C) for the CUDA-core dgrad; in
//      bf16 it packs the channel-transposed weight into the shared loop's
//      slabs (PackW: conv_tma.pack_block_weight(weight.transpose(0, 1))'s
//      layout), which costs the wrapper no host work.
//   * dgrad (bf16): conv_tma_kernel of conv3x3_tma.cuh, K1's and K6's tile
//      loop: 7 x 18-pixel tiles of dU by 128 or 256 channels on a
//      persistent grid, a TMA box of dYc's tile and halo per 64 couts for
//      all nine taps (origin one row and column up-left of the tile, two
//      columns in the halo mode, whose dU has the W + 2 columns of x), the
//      weight slabs read in reverse (flip), wgmma with A from registers.
//      The pad's adjoint: a zero pad's is TMA's zero fill, a wrap pad's the
//      circular conv (K1's wrap side loads), a reflect pad's the zero-padded
//      conv onto the padded output with the pad rows (columns) folded onto
//      rows 1 and n-2 in the epilogue, in f32, before the one rounding
//      (FOLD: conv3x3_tma.cuh's header says how; the tap loop is K1's).
//      Epilogue (DGRAD): x loaded by TMA into the staging tile, dx =
//      bf16(act'(pre) dU a) in place and stored, the tile's sums of dpre x
//      and dpre per channel in a fixed order into its slot; without a
//      prologue, K6's epilogue with no bias: dx = bf16(dU).
//   * wgrad (bf16): wgrad_tma_kernel below, a GEMM of M = 9 C (tap,
//      channel), N = Cout, K = pixels, split over the pixel tiles, both
//      operands from shared memory by descriptor: u_pad's box loaded once
//      per tap column, shifted by the column, makes every tap's A rows an
//      aligned run (no register fragments); f32 partials per split;
//   * reduce: the weight-gradient partials over the splits, the dbias
//      partials over the prep blocks and the da / db partials over the
//      dgrad's tiles, each in a fixed order, with the casts to the outputs'
//      types.
// No float atomics: the results are deterministic.
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream; the function returns the cudaError_t of the launches (0 = ok).

#include "conv3x3_tma.cuh"

namespace {

using namespace port;
namespace ct = port::conv_tma;

constexpr int W_HALO = 3;  // the W mode whose input carries its pad columns
constexpr int TW = 16;     // output columns per tile (one m16 row of pixels)
constexpr int HALO_W = TW + 2;
constexpr int SMS = 132;   // the f32 weight gradient's splits fill the card

// ---------------------------------------------------------------------------
// Staging maps (HaloChunk's `map`: staged pixel -> source pixel, or false)
// ---------------------------------------------------------------------------

// The forward's pad, as conv3x3_fused.cu resolves it: source index of
// padded coordinate g along an axis of size n, or -1 for a zero.
__device__ __forceinline__ int resolve(int g, int n, int mode) {
  if (g >= 0 && g < n) return g;
  if (g == -1) return mode == PAD_REFLECT ? 1 : (mode == PAD_WRAP ? n - 1 : -1);
  if (g == n) return mode == PAD_REFLECT ? n - 2 : (mode == PAD_WRAP ? 0 : -1);
  return -1;
}

// The padded u of the forward (conv3x3_fused.cu SameMap): the (th+2) x
// (TW+2) input halo of output tile (y0, x0).
struct SameMap {
  int y0, x0, H, Win, h_mode, w_mode;
  __device__ __forceinline__ bool operator()(int pix, int* iy, int* ix) const {
    *iy = resolve(y0 + pix / HALO_W - 1, H, h_mode);
    const int gx = x0 + pix % HALO_W;
    *ix = w_mode == W_HALO ? (gx < Win ? gx : -1) : resolve(gx - 1, Win, w_mode);
    return *iy >= 0 && *ix >= 0;
  }
};

// One tap's window of SameMap for a th x TW tile: pixel (r, s) of the tile
// reads halo pixel (r + dy, s + dx).
struct TapMap {
  SameMap same;
  int dy, dx;
  __device__ __forceinline__ bool operator()(int pix, int* iy, int* ix) const {
    return same((pix / TW + dy) * HALO_W + pix % TW + dx, iy, ix);
  }
};

// The th x TW pixels of a dYc tile; past the edge: zero.
struct TileMap {
  int y0, x0, H, W;
  __device__ __forceinline__ bool operator()(int pix, int* iy, int* ix) const {
    *iy = y0 + pix / TW;
    *ix = x0 + pix % TW;
    return *iy < H && *ix < W;
  }
};

// dYc index g along an axis of size n for the dgrad's halo: the wrap pad's
// adjoint stages circularly; zero and reflect stage zeros (reflect's folds
// are extra products).
__device__ __forceinline__ int fold_index(int g, int n, int mode) {
  if (g >= 0 && g < n) return g;
  if (mode == PAD_WRAP && (g == -1 || g == n)) return g < 0 ? n - 1 : 0;
  return -1;
}

// The (th+2) x (TW+2) halo of dYc around dU tile (y0, x0) (in x's
// coordinates): staged (r, s) holds dYc row y0 - 1 + r, column x0 - 1 + s
// (x0 - 2 + s in the halo mode, whose dU has the W+2 columns of x), so dU
// pixel (ty, tx) takes window offset (a, b) with the weight tap
// (2 - a, 2 - b).
struct DgradMap {
  int y0, x0, H, W, h_mode, w_mode;
  __device__ __forceinline__ bool operator()(int pix, int* iy, int* ix) const {
    *iy = fold_index(y0 - 1 + pix / HALO_W, H, h_mode);
    if (w_mode == W_HALO) {
      const int gx = x0 - 2 + pix % HALO_W;
      *ix = gx >= 0 && gx < W ? gx : -1;
    } else {
      *ix = fold_index(x0 - 1 + pix % HALO_W, W, w_mode);
    }
    return *iy >= 0 && *ix >= 0;
  }
};

// A reflect pad's folds in one dU tile. Pad row 0 copies u row 1 and pad
// row H+1 u row H-2, so dU row 1 gains dYc row 0 through weight row 0, and
// dU row H-2 dYc row H-1 through weight row 2: in the tile's window terms,
// target tile row rt reads window row rs (0 or 2) with the weight of window
// row rw (2 or 0). Columns likewise (not in the halo mode). -1: no fold.
struct Folds {
  int rt[2], rs[2], rw[2];  // rows: target tile row, source window, weight window
  int ct[2], cs[2], cw[2];  // columns
  __device__ __forceinline__ Folds(int y0, int x0, int th, int H, int Win,
                                   int h_mode, int w_mode) {
    const bool rr = h_mode == PAD_REFLECT, rc = w_mode == PAD_REFLECT;
    const int r0 = 1 - y0, r1 = H - 2 - y0, c0 = 1 - x0, c1 = Win - 2 - x0;
    rt[0] = rr && r0 >= 0 && r0 < th ? r0 : -1;
    rt[1] = rr && r1 >= 0 && r1 < th ? r1 : -1;
    ct[0] = rc && c0 >= 0 && c0 < TW ? c0 : -1;
    ct[1] = rc && c1 >= 0 && c1 < TW ? c1 : -1;
    rs[0] = cs[0] = 0;
    rw[0] = cw[0] = 2;
    rs[1] = cs[1] = 2;
    rw[1] = cw[1] = 0;
  }
};

// The chain of the epilogue on one dU value (already rounded to the
// compute type): dx, and with a prologue the terms of da (dpre * x) and db
// (dpre). Plain float multiplies and adds, as the plain version rounds.
struct Chain {
  __device__ __forceinline__ static float dx(float du, float xv, float a,
                                             float b, int act, bool pro,
                                             float* sa, float* sb) {
    if (!pro) return du;
    const float pre = __fadd_rn(__fmul_rn(xv, a), b);
    float dpre = du;
    if (act == ACT_RELU) dpre = __fmul_rn(du, pre > 0.f ? 1.f : 0.f);
    else if (act == ACT_LRELU) dpre = __fmul_rn(du, pre > 0.f ? 1.f : 0.2f);
    *sa += __fmul_rn(dpre, xv);
    *sb += dpre;
    return __fmul_rn(dpre, a);
  }
};

// ---------------------------------------------------------------------------
// prep: dYc and the dbias partials; in bf16 u_pad, in f32 the transposed
// weight
// ---------------------------------------------------------------------------
constexpr int PREP_THREADS = 256;
constexpr int PREP_GROUPS = 8;  // 8-channel groups of a pullback block: 64 channels
constexpr int PREP_LANES = PREP_THREADS / PREP_GROUPS;  // its pixel lanes
constexpr int PREP_CH = 8 * PREP_GROUPS;
constexpr int PREP_PIX = 64;  // pixels of a pullback block: two per lane, many blocks in flight

// bf16: u_pad (N, H+2, W+2, C), the forward's pad of u =
// bf16(act(a x + b)) (u = x without a prologue), as the plain version
// computes it (a multiply and an add in f32, one rounding): the wgrad's A.
struct PadU {
  const __nv_bfloat16* x;
  const float* pa;  // (N, C) or null
  const float* pb;
  __nv_bfloat16* u;  // (N, H+2, W+2, C); W: the output's
  int N, H, W, Wx, C, h_mode, w_mode, act, blocks;
};

// bf16: the dgrad's weight, the OIHW weight (Cout, C, 3, 3) channel-
// transposed into the shared loop's K-major slabs (9 ceil(Cout / 64),
// C rounded up to bn, 64): slab 9 cb + t row o column k holds weight[64 cb
// + k][o][t / 3][t % 3], zero past C and Cout (conv_tma.pack_block_weight
// of weight.transpose(0, 1)); the kernel reads tap t's from slab 8 - t.
struct PackW {
  const void* weight;
  int wdtype;              // 1: bf16, 0: f32
  __nv_bfloat16* packed;
  int C, Cout, rows;       // rows: C rounded up to bn
  int blocks;
};

// Thread i of PackW's blocks: 8 consecutive k of one slab row.
__device__ __forceinline__ void pack_w(const PackW& p, int i) {
  const int n_kc = (p.Cout + 63) / 64;
  if (i >= 9 * n_kc * p.rows * 8) return;
  const int g = i % 8, r = i / 8, o = r % p.rows, slab = r / p.rows;
  const int cb = slab / 9, t = slab % 9;
  Vec8<__nv_bfloat16> v;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = 64 * cb + 8 * g + j;
    float w = 0.f;
    if (o < p.C && co < p.Cout) {
      const size_t src = ((size_t)co * p.C + o) * 9 + t;
      w = p.wdtype == 1 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.weight)[src])
                        : static_cast<const float*>(p.weight)[src];
    }
    v.v[j] = __float2bfloat16_rn(w);
  }
  store8(p.packed + (size_t)r * 64 + 8 * g, v);
}

// Thread i of PadU's blocks: 8 channels of one u_pad pixel (C % 8 == 0).
__device__ __forceinline__ void pad_u(const PadU& p, int i) {
  const int groups = p.C / 8, wp = p.W + 2;
  if (i >= p.N * (p.H + 2) * wp * groups) return;
  const int c = (i % groups) * 8, pix = i / groups;
  const int n = pix / ((p.H + 2) * wp), r = pix % ((p.H + 2) * wp);
  const int sy = resolve(r / wp - 1, p.H, p.h_mode);
  const int sx = p.w_mode == W_HALO ? r % wp : resolve(r % wp - 1, p.W, p.w_mode);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);  // a zero pad: zero, not act(b)
  if (sy >= 0 && sx >= 0) {
    v = *reinterpret_cast<const uint4*>(p.x + (((size_t)n * p.H + sy) * p.Wx + sx) * p.C + c);
    if (p.pa != nullptr) {
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        e[k] = affine_act(e[k], p.pa[(size_t)n * p.C + c + k], p.pb[(size_t)n * p.C + c + k],
                          p.act);
    }
  }
  *reinterpret_cast<uint4*>(p.u + (size_t)pix * p.C + c) = v;
}

// Pullback block (pb, cb) takes pixels [pb PREP_PIX, +PREP_PIX) and channels
// [cb PREP_CH, +PREP_CH): thread (lane, group) moves 8 consecutive channels
// of every PREP_LANES-th pixel (16-byte moves where aligned) and keeps their
// f32 sums; the block then sums its lanes in order into part_b[pb][co].
// Then u's blocks (PadU) and the weight's (PackW) in bf16, or blocks that
// transpose the weight, a (co, c) pair per thread, in f32.
template <typename T>
__global__ void __launch_bounds__(PREP_THREADS)
    prep_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                const float* __restrict__ ds, const float* __restrict__ dq,
                T* __restrict__ dyc, float* __restrict__ part_b,
                const void* __restrict__ weight, int wdtype, T* __restrict__ wt9,
                int pixels, int HW, int C, int Cout, int pull_blocks, const PadU u,
                const PackW pw) {
  const int ch_blocks = (Cout + PREP_CH - 1) / PREP_CH;
  if ((int)blockIdx.x < pull_blocks) {
    __shared__ float red[PREP_LANES][PREP_CH];
    const int pb = blockIdx.x / ch_blocks, cb = blockIdx.x % ch_blocks;
    const int group = threadIdx.x % PREP_GROUPS, lane = threadIdx.x / PREP_GROUPS;
    const int co = cb * PREP_CH + group * 8;
    const int valid = max(min(8, Cout - co), 0);
    const bool vec = (Cout % 8) == 0 && aligned16(dy) && aligned16(y) && aligned16(dyc);
    const int p1 = min(pixels, (pb + 1) * PREP_PIX);
    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
    for (int p = pb * PREP_PIX + lane; valid > 0 && p < p1; p += PREP_LANES) {
      const size_t o = (size_t)p * Cout + co;
      const Vec8<T> d = load8(dy + o, valid, vec);
      Vec8<T> yv, out;
      if (ds != nullptr) yv = load8(y + o, valid, vec);
      const int nc = (p / HW) * Cout + co;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v = to_f(d.v[i]);
        if (ds != nullptr && i < valid)
          v = __fadd_rn(v, __fadd_rn(ds[nc + i],
                                     __fmul_rn(__fmul_rn(2.f, dq[nc + i]), to_f(yv.v[i]))));
        out.v[i] = from_f<T>(v);
        s[i] += v;
      }
      if (vec && valid == 8) {
        store8(dyc + o, out);
      } else {
        for (int i = 0; i < valid; ++i) dyc[o + i] = out.v[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) red[lane][group * 8 + i] = s[i];
    __syncthreads();
    const int c = cb * PREP_CH + threadIdx.x;
    if (threadIdx.x < PREP_CH && c < Cout && part_b != nullptr) {
      float t = 0.f;
      for (int l = 0; l < PREP_LANES; ++l) t += red[l][threadIdx.x];
      part_b[(size_t)pb * Cout + c] = t;
    }
    return;
  }
  if ((int)blockIdx.x < pull_blocks + u.blocks) {
    pad_u(u, (blockIdx.x - pull_blocks) * PREP_THREADS + threadIdx.x);
    return;
  }
  if ((int)blockIdx.x < pull_blocks + u.blocks + pw.blocks) {
    pack_w(pw, (blockIdx.x - pull_blocks - u.blocks) * PREP_THREADS + threadIdx.x);
    return;
  }
  // wt9[tap][co][c] = weight[co][c][tap / 3][tap % 3] in T
  const int i = (blockIdx.x - pull_blocks - u.blocks - pw.blocks) * PREP_THREADS + threadIdx.x;
  if (i >= Cout * C) return;
  const int co = i / C, c = i % C;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const size_t src = (size_t)i * 9 + tap;
    const float w = wdtype == 1 ? to_f(static_cast<const __nv_bfloat16*>(weight)[src])
                                : static_cast<const float*>(weight)[src];
    wt9[((size_t)tap * Cout + co) * C + c] = from_f<T>(w);
  }
}

// ---------------------------------------------------------------------------
// dgrad, f32: CUDA cores in full f32 (conv3x3_fused.cu's f32 tile loop).
// Thread (tp, tn) owns 8 consecutive pixels of one tile row (row tp / 2,
// columns 8 (tp % 2) ..) and 4 consecutive channels.
// ---------------------------------------------------------------------------
constexpr int TH_F = 8;
constexpr int KC_F = 16;
constexpr int NT_F = 64;
constexpr int NTH_F = 256;

__global__ void __launch_bounds__(NTH_F)
    dgrad_f32_kernel(const float* __restrict__ dyc, const float* __restrict__ wt9,
                     const float* __restrict__ x, const float* __restrict__ pa,
                     const float* __restrict__ pb, float* __restrict__ dx,
                     float* __restrict__ part, int N, int H, int W, int Win, int C,
                     int Cout, int tiles_x, int n_tiles, int h_mode, int w_mode,
                     int act) {
  constexpr int IN_ELEMS = (TH_F + 2) * HALO_W * KC_F;
  __shared__ __align__(128) float smem[IN_ELEMS + 9 * KC_F * NT_F];
  float* s_in = smem;
  float* s_w = smem + IN_ELEMS;

  const int tile = blockIdx.x, n = blockIdx.z;
  const int c0 = blockIdx.y * NT_F;
  const int y0 = (tile / tiles_x) * TH_F, x0 = (tile % tiles_x) * TW;
  const int tn = threadIdx.x % 16, tp = threadIdx.x / 16;
  const int ty = tp / 2, tx0 = (tp % 2) * 8;
  const bool vec_in = (Cout % 8) == 0 && aligned16(dyc);
  const bool vec_w = (C % 8) == 0 && aligned16(wt9);
  const Folds fold(y0, x0, TH_F, H, Win, h_mode, w_mode);

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // acc[i] += window (a, b) of pixel i times weight tap `wtap`
  auto product = [&](float (&ac)[4], int i, int a, int b, int wtap) {
    const float* a_base = s_in + ((ty + a) * HALO_W + tx0 + i + b) * KC_F;
    const float* b_base = s_w + wtap * KC_F * NT_F + tn * 4;
#pragma unroll 4
    for (int k = 0; k < KC_F; ++k) {
      const float4 w = *reinterpret_cast<const float4*>(b_base + k * NT_F);
      const float v = a_base[k];
      ac[0] = fmaf(v, w.x, ac[0]);
      ac[1] = fmaf(v, w.y, ac[1]);
      ac[2] = fmaf(v, w.z, ac[2]);
      ac[3] = fmaf(v, w.w, ac[3]);
    }
  };

  using Input = HaloChunk<float, (TH_F + 2) * HALO_W, KC_F, KC_F, NTH_F>;
  const DgradMap map{y0, x0, H, W, h_mode, w_mode};
  for (int k0 = 0; k0 < Cout; k0 += KC_F) {
    issue_weights<float, KC_F, NT_F, NTH_F>(s_w, NT_F, wt9, Cout, C, k0, c0, vec_w);
    Input::issue(s_in, dyc, nullptr, nullptr, map, n, H, W, Cout, k0, ACT_NONE, vec_in);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int a = tap / 3, b = tap % 3;
      const float* a_base = s_in + ((ty + a) * HALO_W + tx0 + b) * KC_F;
      const float* b_base = s_w + (8 - tap) * KC_F * NT_F + tn * 4;
#pragma unroll 4
      for (int k = 0; k < KC_F; ++k) {
        const float4 w = *reinterpret_cast<const float4*>(b_base + k * NT_F);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float v = a_base[i * KC_F + k];
          acc[i][0] = fmaf(v, w.x, acc[i][0]);
          acc[i][1] = fmaf(v, w.y, acc[i][1]);
          acc[i][2] = fmaf(v, w.z, acc[i][2]);
          acc[i][3] = fmaf(v, w.w, acc[i][3]);
        }
      }
    }
    // a reflect pad's folds, as in the bf16 kernel
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int f = 0; f < 2; ++f)
        if (ty == fold.rt[f])
#pragma unroll
          for (int b = 0; b < 3; ++b)
            product(acc[i], i, fold.rs[f], b, 8 - 3 * fold.rw[f] - b);
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        if (tx0 + i != fold.ct[g]) continue;
#pragma unroll
        for (int a = 0; a < 3; ++a) product(acc[i], i, a, fold.cs[g], 8 - 3 * a - fold.cw[g]);
#pragma unroll
        for (int f = 0; f < 2; ++f)
          if (ty == fold.rt[f])
            product(acc[i], i, fold.rs[f], fold.cs[g], 8 - 3 * fold.rw[f] - fold.cw[g]);
      }
    }
    __syncthreads();
  }

  const bool pro = pa != nullptr;
  float* red = smem;  // [da|db][tp][NT_F]
  const int oy = y0 + ty;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + tn * 4 + j;
    const bool ok = c < C;
    const float a = pro && ok ? pa[(size_t)n * C + c] : 0.f;
    const float b = pro && ok ? pb[(size_t)n * C + c] : 0.f;
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ox = x0 + tx0 + i;
      if (!ok || oy >= H || ox >= Win) continue;
      const size_t o = (((size_t)n * H + oy) * Win + ox) * C + c;
      dx[o] = Chain::dx(acc[i][j], pro ? x[o] : 0.f, a, b, act, pro, &sa, &sb);
    }
    red[tp * NT_F + tn * 4 + j] = sa;
    red[(16 + tp) * NT_F + tn * 4 + j] = sb;
  }
  if (!pro) return;
  __syncthreads();
  write_tile_moments<NTH_F>(red, 16, NT_F, part, n, N, tile, n_tiles, c0, C);
}

// ---------------------------------------------------------------------------
// wgrad, bf16: a wgmma GEMM over the pixels with both operands in shared
// memory. prep writes u_pad, the forward's padded input (N, H+2, W+2, C)
// after the prologue, once. Block (cb, tb, nb, split) takes the three taps
// (ta, tb) of channel block cb, consumer warpgroup ta the tap (ta, tb), by
// the couts from 128 nb (a 64 x 128 f32 accumulator a warpgroup), over the
// pixel tiles split, split + S, ... of 8 x 16 dYc pixels. Per tile, by TMA
// into one of four stages: u_pad's box of rows y0 .. y0 + 9 and columns
// x0 + tb .. x0 + tb + 15, so that tap (ta, tb)'s A rows for tile row ty
// are the box's 16 rows from (ty + ta) 16, a run that starts on a 2 KB
// boundary (the shifted load makes every tap's operand a plain descriptor:
// no register fragments, no per-lane addressing), and dYc's tile (a box per
// 64 couts). Per tile row one wgmma m64n128k16: A MN-major (channels
// contiguous, pixels along K), B MN-major (couts contiguous); a commit group
// per tile, and a stage goes back to the producer once the next tile's
// group is issued and its own is done. Each split's f32 sums go to its
// partials; the reduce adds the splits in order.
// ---------------------------------------------------------------------------
constexpr int WG_TH = 8, WG_TW = 16;  // a tile's dYc pixels: a k16 step per row
constexpr int WG_BN = 128;            // couts of a block
constexpr int WG_CONSUMERS = 3;       // warpgroups: the three taps of a column tb
constexpr int WG_THREADS = 128 * (WG_CONSUMERS + 1);
constexpr int WG_STAGES = 4;
constexpr int U_BYTES = (WG_TH + 2) * WG_TW * 128;  // u_pad's box: 10 rows of 16 pixels
constexpr int G_BYTES = WG_TH * WG_TW * 128;        // dYc's box, 64 couts
constexpr int WG_STAGE = U_BYTES + (WG_BN / 64) * G_BYTES;
constexpr int WG_SMEM = 1024 + WG_STAGES * WG_STAGE + 2 * WG_STAGES * 8;
static_assert(U_BYTES % 1024 == 0 && G_BYTES % 1024 == 0, "the swizzle's alignment");
static_assert(WG_SMEM <= 232448, "shared memory");

struct WgradArgs {
  float* part;  // (S, 9, C, Cout)
  int N, C, Cout;
  int tiles_x, n_sp;  // dYc's tiles per tile row, per image
  int n_kc, n_nb, S;  // channel blocks, cout blocks, splits
};

__global__ void __launch_bounds__(WG_THREADS, 1)
    wgrad_tma_kernel(const __grid_constant__ CUtensorMap umap,
                     const __grid_constant__ CUtensorMap gmap, const WgradArgs w) {
  using namespace port::sm90;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  auto ubox = [&](int s) { return smem + s * WG_STAGE; };
  auto gbox = [&](int s) { return smem + s * WG_STAGE + U_BYTES; };
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WG_STAGES * WG_STAGE);
  uint64_t* empty = full + WG_STAGES;

  int b = blockIdx.x;
  const int cb = b % w.n_kc;
  b /= w.n_kc;
  const int tb = b % 3;
  b /= 3;
  const int nb = b % w.n_nb, split = b / w.n_nb;
  const int co0 = nb * WG_BN, nd = min(WG_BN / 64, (w.Cout - co0 + 63) / 64);
  const int total = w.N * w.n_sp;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_CONSUMERS * 4);  // every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (wg == WG_CONSUMERS) {  // the producer warpgroup: one thread issues every load
    if (tid != 0) return;
    int s = 0;
    uint32_t ph = 0;
    for (int t = split; t < total; t += w.S) {
      const int n = t / w.n_sp, sp = t % w.n_sp;
      const int y0 = (sp / w.tiles_x) * WG_TH, x0 = (sp % w.tiles_x) * WG_TW;
      mbar_wait(&empty[s], ph ^ 1);
      mbar_arrive_expect_tx(&full[s], U_BYTES + nd * G_BYTES);  // zero fill counts
      tma_load_4d(ubox(s), &umap, &full[s], cb * 64, x0 + tb, y0, n);
      for (int j = 0; j < nd; ++j)
        tma_load_4d(gbox(s) + j * G_BYTES, &gmap, &full[s], co0 + 64 * j, x0, y0, n);
      if (++s == WG_STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    return;
  }

  const int ta = wg, warp = tid / 32, lane = tid % 32;
  float acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;
  int s = 0, prev = -1;
  uint32_t ph = 0;
  for (int t = split; t < total; t += w.S) {
    mbar_wait(&full[s], ph);
    wgmma_fence();
#pragma unroll
    for (int ty = 0; ty < WG_TH; ++ty)
      wgmma_m64n128k16_ss<1, 1>(acc, sw128_mn_desc(ubox(s) + (ty + ta) * WG_TW * 128, 1024),
                                sw128_mn_desc(gbox(s) + ty * WG_TW * 128, G_BYTES));
    wgmma_commit();
    wgmma_wait<1>();  // the previous tile's products are done: its stage is free
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = s;
    if (++s == WG_STAGES) {
      s = 0;
      ph ^= 1;
    }
  }
  wgmma_wait<0>();

  // the split's sums: acc[j] at channel 16 warp + lane / 4 + 8 ((j / 2) % 2)
  // of block cb and cout co0 + 8 (j / 4) + 2 (lane % 4) + j % 2
  const int tap = 3 * ta + tb;
#pragma unroll
  for (int j = 0; j < 64; j += 2) {
    const int c = cb * 64 + 16 * warp + lane / 4 + 8 * ((j / 2) % 2);
    const int co = co0 + 8 * (j / 4) + 2 * (lane % 4);
    if (c < w.C && co < w.Cout)
      *reinterpret_cast<float2*>(w.part + (((size_t)split * 9 + tap) * w.C + c) * w.Cout + co) =
          make_float2(acc[j], acc[j + 1]);
  }
}

// ---------------------------------------------------------------------------
// wgrad, f32: CUDA cores, one tap per block: block (s, cb, 9 nb + tap) takes
// a 64-channel x 64-cout slice of that tap; thread (ti, tj) owns channels
// 4 ti.. and couts 4 tj..; per 4 x 16 pixel tile the tap's window of u
// (TapMap) and dYc are staged, then reduced over the 64 pixels.
// ---------------------------------------------------------------------------
constexpr int TH_WF = 4;
constexpr int PIX_WF = TH_WF * TW;
constexpr int MC = 64, NC = 64;  // channels and couts of a block's slice

__global__ void __launch_bounds__(256)
    wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ pa,
                     const float* __restrict__ pb, const float* __restrict__ dyc,
                     float* __restrict__ part_w, int H, int W, int Win, int C,
                     int Cout, int tiles_x, int tiles, int total, int h_mode,
                     int w_mode, int act) {
  __shared__ __align__(16) float su[PIX_WF * MC];
  __shared__ __align__(16) float sg[PIX_WF * NC];
  const int s = blockIdx.x, S = gridDim.x;
  const int c0 = blockIdx.y * MC;
  const int tap = blockIdx.z % 9, co0 = (blockIdx.z / 9) * NC;
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  const bool vec_in = (C % 8) == 0 && aligned16(x);
  const bool vec_g = (Cout % 8) == 0 && aligned16(dyc);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  using U = HaloChunk<float, PIX_WF, MC, MC, 256>;
  using G = HaloChunk<float, PIX_WF, NC, NC, 256>;
  for (int t = s; t < total; t += S) {
    const int n = t / tiles, r = t % tiles;
    const int y0 = (r / tiles_x) * TH_WF, x0 = (r % tiles_x) * TW;
    const TapMap map{SameMap{y0, x0, H, Win, h_mode, w_mode}, tap / 3, tap % 3};
    U::issue(su, x, pa, pb, map, n, H, Win, C, c0, act, vec_in);
    G::issue(sg, dyc, nullptr, nullptr, TileMap{y0, x0, H, W}, n, H, W, Cout, co0,
             ACT_NONE, vec_g);
    cp_async_commit();
    cp_async_wait_all();
    U::finish(su, pa, pb, map, n, H, Win, C, c0, act, vec_in);
    __syncthreads();
    for (int p = 0; p < PIX_WF; ++p) {
      const float4 u = *reinterpret_cast<const float4*>(su + p * MC + ti * 4);
      const float4 g = *reinterpret_cast<const float4*>(sg + p * NC + tj * 4);
      const float uv[4] = {u.x, u.y, u.z, u.w}, gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(uv[i], gv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ti * 4 + i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tj * 4 + j;
      if (co < Cout) part_w[(((size_t)s * 9 + tap) * C + c) * Cout + co] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// reduce: every partial sum over its splits, in a fixed order, with the
// casts to the outputs' types. The weight gradient's blocks take 32 couts
// by 8 channels: their 9 x 8 x 32 sums over the splits (reads along the
// couts), rounded to the compute type, through shared memory into OIHW
// order (writes along channel and tap). Then blocks of 32 outputs, 8 lanes
// each over the partials: dbias over the prep blocks, da and db over the
// dgrad's tiles.
// ---------------------------------------------------------------------------
constexpr int RW_CO = 32, RW_C = 8;  // a weight block's couts and channels

// The sum over t < n of p[t * stride] for this thread's column of a block
// of 32 columns by 8 lanes (threadIdx.x = 32 lane + column), each lane
// taking every 8th t, the lanes then added in order; valid in lane 0.
__device__ __forceinline__ float lanes_sum(const float* __restrict__ p, int n, int stride,
                                           bool active, float (*red)[32]) {
  const int col = threadIdx.x % 32, lane = threadIdx.x / 32;
  float s = 0.f;
  if (active)
    for (int t = lane; t < n; t += 8) s += p[(size_t)t * stride];
  red[lane][col] = s;
  __syncthreads();
  float total = 0.f;
  if (lane == 0)
    for (int l = 0; l < 8; ++l) total += red[l][col];
  __syncthreads();  // red is reused by the next call
  return total;
}

__global__ void __launch_bounds__(256)
    reduce_kernel(const float* __restrict__ part_w, int S,
                  const float* __restrict__ part_b, int PB,
                  const float* __restrict__ part_ab, int n_tiles, void* __restrict__ dw,
                  int wdtype, float* __restrict__ dbias, float* __restrict__ da,
                  float* __restrict__ db, int N, int C, int Cout, int dtype) {
  __shared__ float tile[RW_CO][RW_C * 9 + 1];
  const int co_blocks = (Cout + RW_CO - 1) / RW_CO;
  const int wblocks = co_blocks * ((C + RW_C - 1) / RW_C);
  int b = blockIdx.x;
  if (b < wblocks) {
    const int co0 = (b % co_blocks) * RW_CO, c0 = (b / co_blocks) * RW_C;
    const size_t plane = (size_t)9 * C * Cout;
    for (int i = threadIdx.x; i < RW_CO * RW_C * 9; i += blockDim.x) {
      const int col = i % RW_CO, r = i / RW_CO, tap = r / RW_C, cl = r % RW_C;
      const int c = c0 + cl, co = co0 + col;
      float v = 0.f;
      if (c < C && co < Cout) {
        const float* p = part_w + ((size_t)tap * C + c) * Cout + co;
        for (int s = 0; s < S; ++s) v += p[s * plane];
        if (dtype == 1) v = __bfloat162float(__float2bfloat16_rn(v));
      }
      tile[col][cl * 9 + tap] = v;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < RW_CO * RW_C * 9; i += blockDim.x) {
      const int col = i / (RW_C * 9), k = i % (RW_C * 9), c = c0 + k / 9, co = co0 + col;
      if (c >= C || co >= Cout) continue;
      const size_t o = ((size_t)co * C + c0) * 9 + k;
      if (wdtype == 1) static_cast<__nv_bfloat16*>(dw)[o] = __float2bfloat16_rn(tile[col][k]);
      else static_cast<float*>(dw)[o] = tile[col][k];
    }
    return;
  }
  b -= wblocks;
  float(*red)[32] = reinterpret_cast<float(*)[32]>(&tile[0][0]);
  const int col = threadIdx.x % 32;
  if (dbias != nullptr) {
    if (b < co_blocks) {
      const int co = b * 32 + col;
      const float v = lanes_sum(part_b + co, PB, Cout, co < Cout, red);
      if (threadIdx.x < 32 && co < Cout) dbias[co] = v;
      return;
    }
    b -= co_blocks;
  }
  if (da == nullptr) return;
  const int c_blocks = (C + 31) / 32, n = b / c_blocks, c = (b % c_blocks) * 32 + col;
  const float* p = part_ab + (size_t)n * n_tiles * C + c;
  const float sa = lanes_sum(p, n_tiles, C, c < C, red);
  const float sb = lanes_sum(p + (size_t)N * n_tiles * C, n_tiles, C, c < C, red);
  if (threadIdx.x < 32 && c < C) {
    da[(size_t)n * C + c] = sa;
    db[(size_t)n * C + c] = sb;
  }
}

// The sizes the workspace query and the launch share, and the workspace's
// layout: dYc, (bf16) u_pad or (f32) the transposed weight, then the f32
// partials: the weight gradient per split, dbias per prep block, da and db
// per dgrad tile.
struct Plan {
  int Win, dg_tiles_x, dg_tiles, wg_tiles_x, wg_tiles, wg_total, S, PB;
  int pull_blocks, u_blocks, wp_blocks, wt_blocks, wp_rows;
  size_t off_u, off_wp, off_pw, off_pb, off_pab, bytes;

  Plan(int N, int H, int W, int C, int Cout, int dtype, int h_mode, int w_mode, bool pro,
       int blocks, int bn) {
    const size_t es = dtype == 1 ? 2 : 4;
    const bool bf16 = dtype == 1;
    Win = w_mode == W_HALO ? W + 2 : W;
    // the dgrad's tiles over dU (H, Win) and the wgrad's over dYc (H, W):
    // bf16 the shared loop's 7 x 18 (over the padded output on a reflected
    // axis, ct::tile_grid) and the wgrad's 8 x 16, f32 the CUDA-core kernels'
    const int th_w = bf16 ? WG_TH : TH_WF, tw_w = bf16 ? WG_TW : TW;
    if (bf16) {
      int o, tiles_y;
      ct::tile_grid(H, ct::TILE_H, h_mode == PAD_REFLECT, &o, &tiles_y);
      ct::tile_grid(Win, ct::TILE_W, w_mode == PAD_REFLECT, &o, &dg_tiles_x);
      dg_tiles = tiles_y * dg_tiles_x;
    } else {
      dg_tiles_x = (Win + TW - 1) / TW;
      dg_tiles = ((H + TH_F - 1) / TH_F) * dg_tiles_x;
    }
    wg_tiles_x = (W + tw_w - 1) / tw_w;
    wg_tiles = ((H + th_w - 1) / th_w) * wg_tiles_x;
    wg_total = N * wg_tiles;
    // the splits fill the card: bf16 a block per (channel block, tap
    // column, cout block, split), f32 one per (64-channel, 64-cout slice,
    // tap, split)
    const int slices = bf16 ? ((C + 63) / 64) * 3 * ((Cout + WG_BN - 1) / WG_BN)
                            : ((C + MC - 1) / MC) * ((Cout + NC - 1) / NC) * 9;
    S = max(1, min(wg_total, (bf16 ? blocks : SMS) / slices));
    const int pixels = N * H * W;
    PB = (pixels + PREP_PIX - 1) / PREP_PIX;
    pull_blocks = PB * ((Cout + PREP_CH - 1) / PREP_CH);
    const size_t upad = (size_t)N * (H + 2) * (W + 2) * C;
    u_blocks = bf16 ? (int)((upad / 8 + PREP_THREADS - 1) / PREP_THREADS) : 0;
    wt_blocks = bf16 ? 0 : (Cout * C + PREP_THREADS - 1) / PREP_THREADS;
    // bf16: the dgrad's packed weight, (9 ceil(Cout / 64), C rounded up to
    // bn, 64), written by prep
    wp_rows = bf16 && bn > 0 ? (C + bn - 1) / bn * bn : 0;
    const size_t wp = (size_t)9 * ((Cout + 63) / 64) * wp_rows * 64;
    wp_blocks = (int)((wp / 8 + PREP_THREADS - 1) / PREP_THREADS);
    auto up = [](size_t b) { return (b + 255) / 256 * 256; };
    off_u = up((size_t)pixels * Cout * es);
    off_wp = off_u + up(bf16 ? upad * es : (size_t)9 * Cout * C * es);
    off_pw = off_wp + up(wp * 2);
    off_pb = off_pw + up((size_t)S * 9 * C * Cout * 4);
    off_pab = off_pb + up((size_t)PB * Cout * 4);
    bytes = off_pab + (pro ? up((size_t)2 * N * dg_tiles * C * 4) : 0);
  }
};

// The bf16 dgrad on the shared loop (NH: the tile's 128 or 256 channels).
template <int NH>
cudaError_t launch_dgrad(const ct::ConvShape& s, bool pro, int act, cudaStream_t stream) {
  CUtensorMap maps[ct::N_MAPS];
  ct::DgradArgs a;
  int grid = 0;
  const cudaError_t err = ct::prepare<NH>(s, maps, &a, &grid);
  if (err != cudaSuccess) return err;
  constexpr int NP = ct::NO_PROLOGUE, D = ct::DGRAD;
  if (!pro) return ct::launch_conv<NH, NP, ACT_NONE, true>(maps, a, grid, stream);
  if (act == ACT_RELU) return ct::launch_conv<NH, NP, D + ACT_RELU, true>(maps, a, grid, stream);
  if (act == ACT_LRELU) return ct::launch_conv<NH, NP, D + ACT_LRELU, true>(maps, a, grid, stream);
  return ct::launch_conv<NH, NP, D + ACT_NONE, true>(maps, a, grid, stream);
}

// The bf16 wgrad: u_pad (N, H+2, W+2, C) against dYc (N, H, W, Cout).
cudaError_t launch_wgrad(const Plan& pl, const __nv_bfloat16* upad, const __nv_bfloat16* dyc,
                         float* part, int N, int H, int W, int C, int Cout,
                         cudaStream_t stream) {
  using namespace port::sm90;
  CUtensorMap maps[2];
  const cuuint64_t pu = 2ull * C, pg = 2ull * Cout;  // bytes per pixel
  const cuuint64_t udims[4] = {(cuuint64_t)C, (cuuint64_t)W + 2, (cuuint64_t)H + 2,
                               (cuuint64_t)N};
  const cuuint64_t ustrides[3] = {pu, pu * (W + 2), pu * (W + 2) * (H + 2)};
  const cuuint32_t ubox[4] = {64, WG_TW, WG_TH + 2, 1};
  const cuuint64_t gdims[4] = {(cuuint64_t)Cout, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t gstrides[3] = {pg, pg * W, pg * W * H};
  const cuuint32_t gbox[4] = {64, WG_TW, WG_TH, 1};
  cudaError_t err = encode_bf16_map(&maps[0], upad, 4, udims, ustrides, ubox, true);
  if (err == cudaSuccess) err = encode_bf16_map(&maps[1], dyc, 4, gdims, gstrides, gbox, true);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wgrad_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WG_SMEM);
  if (err != cudaSuccess) return err;
  const WgradArgs w{part, N, C, Cout, pl.wg_tiles_x, pl.wg_tiles, (C + 63) / 64,
                    (Cout + WG_BN - 1) / WG_BN, pl.S};
  wgrad_tma_kernel<<<w.n_kc * 3 * w.n_nb * w.S, WG_THREADS, WG_SMEM, stream>>>(maps[0], maps[1],
                                                                            w);
  return cudaGetLastError();
}

// bf16: prep (dYc, the dbias partials, u_pad, the dgrad's packed weight),
// the dgrad on the shared loop, the wgrad GEMM (the reduce follows in the
// caller). weight: OIHW in wdtype; pa, pb (N, C), or null.
cudaError_t launch_bf16(const Plan& pl, const __nv_bfloat16* x, const void* weight, int wdtype,
                        const float* pa, const float* pb, const __nv_bfloat16* y,
                        const __nv_bfloat16* dy, const float* ds, const float* dq,
                        __nv_bfloat16* dx, bool bias, char* work, int N, int H, int W, int C,
                        int Cout, int h_mode, int w_mode, int act, int bn, int blocks,
                        cudaStream_t s) {
  using T = __nv_bfloat16;
  if (C % 8 != 0 || Cout % 8 != 0 || (bn != 128 && bn != 256) || blocks < 1)
    return cudaErrorInvalidValue;
  T* dyc = reinterpret_cast<T*>(work);
  T* upad = reinterpret_cast<T*>(work + pl.off_u);
  T* wp = reinterpret_cast<T*>(work + pl.off_wp);
  float* pw = reinterpret_cast<float*>(work + pl.off_pw);
  float* pbias = bias ? reinterpret_cast<float*>(work + pl.off_pb) : nullptr;
  const bool pro = pa != nullptr;
  float* pab = pro ? reinterpret_cast<float*>(work + pl.off_pab) : nullptr;
  const PadU u{x, pa, pb, upad, N, H, W, pl.Win, C, h_mode, w_mode, act, pl.u_blocks};
  const PackW pk{weight, wdtype, wp, C, Cout, pl.wp_rows, pl.wp_blocks};
  prep_kernel<T><<<pl.pull_blocks + pl.u_blocks + pl.wp_blocks, PREP_THREADS, 0, s>>>(
      dy, y, ds, dq, dyc, pbias, nullptr, 1, nullptr, N * H * W, H * W, C, Cout,
      pl.pull_blocks, u, pk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dU (N, H, Win, C) from dYc (N, H, W, Cout): box origin one row and
  // column up-left (two columns in the halo mode), the taps' weights
  // reversed; a wrapped axis wraps dYc, a reflected one takes the zero pad
  // onto the padded output and folds its pad rows in the epilogue
  const bool halo = w_mode == W_HALO;
  ct::ConvShape d{dyc, wp, pro ? x : nullptr, dx, nullptr, pa, pb, nullptr, N, H, pl.Win, H, W,
                  Cout, C, -1, halo ? -2 : -1, h_mode == PAD_WRAP ? PAD_WRAP : PAD_ZERO,
                  w_mode == PAD_WRAP ? PAD_WRAP : PAD_ZERO, 1, blocks};
  d.fold_h = h_mode == PAD_REFLECT;
  d.fold_w = w_mode == PAD_REFLECT;
  d.dpart = pab;
  err = bn == 256 ? launch_dgrad<2>(d, pro, act, s) : launch_dgrad<1>(d, pro, act, s);
  if (err != cudaSuccess) return err;
  return launch_wgrad(pl, upad, dyc, pw, N, H, W, C, Cout, s);
}

// f32: prep (with the weight transposed), the CUDA-core dgrad and wgrad.
cudaError_t launch_f32(const Plan& pl, const float* x, const void* weight, int wdtype,
                       const float* pa, const float* pb, const float* y, const float* dy,
                       const float* ds, const float* dq, float* dx, bool bias, char* work,
                       int N, int H, int W, int C, int Cout, int h_mode, int w_mode, int act,
                       cudaStream_t s) {
  float* dyc = reinterpret_cast<float*>(work);
  float* wt9 = reinterpret_cast<float*>(work + pl.off_u);
  float* pw = reinterpret_cast<float*>(work + pl.off_pw);
  float* pbias = bias ? reinterpret_cast<float*>(work + pl.off_pb) : nullptr;
  float* pab = pa != nullptr ? reinterpret_cast<float*>(work + pl.off_pab) : nullptr;
  prep_kernel<float><<<pl.pull_blocks + pl.wt_blocks, PREP_THREADS, 0, s>>>(
      dy, y, ds, dq, dyc, pbias, weight, wdtype, wt9, N * H * W, H * W, C, Cout,
      pl.pull_blocks, PadU{}, PackW{});
  dgrad_f32_kernel<<<dim3(pl.dg_tiles, (C + NT_F - 1) / NT_F, N), NTH_F, 0, s>>>(
      dyc, wt9, x, pa, pb, dx, pab, N, H, W, pl.Win, C, Cout, pl.dg_tiles_x, pl.dg_tiles,
      h_mode, w_mode, act);
  wgrad_f32_kernel<<<dim3(pl.S, (C + MC - 1) / MC, 9 * ((Cout + NC - 1) / NC)), 256, 0, s>>>(
      x, pa, pb, dyc, pw, H, W, pl.Win, C, Cout, pl.wg_tiles_x, pl.wg_tiles, pl.wg_total, h_mode,
      w_mode, act);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the workspace conv3x3_fused_bwd_launch takes (arguments as
// there; prologue: 1 with a prologue), or -1 past 2**31.
int conv3x3_fused_bwd_workspace(int N, int H, int W, int C, int Cout, int dtype,
                                int h_mode, int w_mode, int prologue, int blocks, int bn) {
  const Plan pl(N, H, W, C, Cout, dtype, h_mode, w_mode, prologue != 0, blocks, bn);
  return pl.bytes < (size_t(1) << 31) ? static_cast<int>(pl.bytes) : -1;
}

// dtype: 0 = float32, 1 = bfloat16 (x, y, dy and dx); wdtype the weight's
// (and dw's). h_mode: 0 zero, 1 reflect, 2 wrap; w_mode the same, or 3 (the
// halo mode: x and dx carry the W pad columns). act: 0 none, 1 relu, 2
// lrelu (only read with a prologue). x (N, H, W, C), or (N, H, W+2, C) in
// the halo mode; y, dy (N, H, W, Cout); pa, pb f32 or both null (no
// prologue: da, db null); ds, dq (N, Cout) f32 or both null (no moments);
// dbias (Cout) f32 or null (no bias); work: the workspace's bytes, 256-byte
// aligned; weight OIHW (Cout, C, 3, 3); pa and pb (N, C). float32: bn and
// blocks unread. bfloat16: C and Cout multiples of 8; x, y, dy, dx, pa
// and pb 16-byte aligned; bn the dgrad tile's channels (128 or 256; the
// workspace depends on it); blocks the card's SMs (the persistent grid's
// blocks at most). Four launches on the stream.
int conv3x3_fused_bwd_launch(const void* x, const void* weight, const void* pa,
                             const void* pb, const void* y, const void* dy,
                             const void* ds, const void* dq, void* dx, void* dw,
                             void* dbias, void* da, void* db, void* work, int N, int H,
                             int W, int C, int Cout, int dtype, int wdtype, int h_mode,
                             int w_mode, int act, int bn, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan pl(N, H, W, C, Cout, dtype, h_mode, w_mode, pa != nullptr, blocks, bn);
  const float *a0 = static_cast<const float*>(pa), *b0 = static_cast<const float*>(pb);
  const float *ds0 = static_cast<const float*>(ds), *dq0 = static_cast<const float*>(dq);
  float* dbias0 = static_cast<float*>(dbias);
  float *da0 = static_cast<float*>(da), *db0 = static_cast<float*>(db);
  char* w = static_cast<char*>(work);
  cudaError_t err;
  if (dtype == 1) {
    using T = __nv_bfloat16;
    err = launch_bf16(pl, static_cast<const T*>(x), weight, wdtype, a0, b0,
                      static_cast<const T*>(y),
                      static_cast<const T*>(dy), ds0, dq0, static_cast<T*>(dx),
                      dbias != nullptr, w, N, H, W, C, Cout, h_mode, w_mode, act, bn, blocks, s);
  } else if (dtype == 0) {
    err = launch_f32(pl, static_cast<const float*>(x), weight, wdtype, a0, b0,
                     static_cast<const float*>(y), static_cast<const float*>(dy), ds0, dq0,
                     static_cast<float*>(dx), dbias != nullptr, w, N, H, W, C, Cout, h_mode,
                     w_mode, act, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int co_blocks = (Cout + RW_CO - 1) / RW_CO;
  const int blocks_r = co_blocks * ((C + RW_C - 1) / RW_C) + (dbias != nullptr ? co_blocks : 0) +
                       (pa != nullptr ? N * ((C + 31) / 32) : 0);
  reduce_kernel<<<blocks_r, 256, 0, s>>>(
      reinterpret_cast<float*>(w + pl.off_pw), pl.S, reinterpret_cast<float*>(w + pl.off_pb),
      pl.PB, pa != nullptr ? reinterpret_cast<float*>(w + pl.off_pab) : nullptr, pl.dg_tiles,
      dw, wdtype, dbias0, da0, db0, N, C, Cout, dtype);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
