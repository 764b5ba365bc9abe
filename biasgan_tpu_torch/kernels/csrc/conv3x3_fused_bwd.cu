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
// (2, 64, 64, 256) -> 256 the two products (dU and dW) are 2 x 19.3 GFLOP
// against ~13 MB of bf16 traffic (x, y, dy, the weight, dx and the weight
// gradient each once): ~3,000 FLOP per byte, operations-bound (the bf16
// ridge is ~295 FLOP/B; chip_smoke.py bwd_work gives 0.0195 ms per call at
// the peak). So both products run on the tensor cores in bf16 (mma.sync
// m16n8k16, f32 accumulation); the f32 path, which exists for checking,
// runs on the CUDA cores in full f32. The reference's backward ran ~30
// separate passes per call in eager PyTorch (1.09 ms per call against a
// 0.0195 bound, PERF.md); this one is four launches:
//   * prep: dYc = cdt(dYf) with per-block f32 column sums of dYf (dbias
//     partials), and the weight transposed to (9, Cout, C) in the compute
//     type, whose taps the dgrad reads flipped (one elementwise pass over
//     dy and y; it lets both products stage dYc with cp.async, as K1
//     stages x);
//   * dgrad: K1's tile loop (16 x 16 output pixels by a 64-wide channel
//     slice, 16-wide chunks of Cout in three cp.async stages, the 9 taps as
//     shifted windows of the staged (16+2) x (16+2) halo of dYc) with the
//     pad's adjoint folded in: a wrap pad's adjoint is a circular conv, so
//     dYc is staged circularly (the wrapped rows land in the zero slots of
//     a zero pad); a reflect pad adds each pad slot's cotangent onto row
//     (column) 1 and n-2, so the tiles that hold those rows run a few more
//     products on the staged tile, with the source window and the weight
//     tap swapped (rows 0 <-> 2 of the window), masked to the one pixel
//     for a column fold, and once more for a corner; the epilogue rounds
//     dU, recomputes the prologue from x, writes dx and per-tile partials
//     of da and db;
//   * wgrad: per (64-channel, 64-cout) slice and split of the pixel tiles,
//     each of nine warps owns one tap; per 8 x 16 pixel tile the padded
//     u halo is staged with K1's staging (the pad and the prologue
//     resolved by index, nothing padded in device memory) and dYc beside
//     it, and the products reduce over the tile's pixels; f32 partials per
//     split;
//   * reduce: the weight-gradient partials over the splits, the dbias
//     partials over the prep blocks and the da / db partials over the
//     tiles, each in a fixed order, with the casts to the outputs' types.
// No float atomics: the results are deterministic.
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream; the function returns the cudaError_t of the launches (0 = ok).

#include <type_traits>

#include "common.cuh"

namespace {

using namespace port;

constexpr int W_HALO = 3;  // the W mode whose input carries its pad columns
constexpr int TW = 16;     // output columns per tile (one m16 row of pixels)
constexpr int HALO_W = TW + 2;
constexpr int SMS = 132;   // the splits of the weight gradient fill the card

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
// prep: dYc and the dbias partials; the transposed weight
// ---------------------------------------------------------------------------
constexpr int PREP_THREADS = 256;
constexpr int PREP_GROUPS = 8;  // 8-channel groups of a pullback block: 64 channels
constexpr int PREP_LANES = PREP_THREADS / PREP_GROUPS;  // its pixel lanes
constexpr int PREP_CH = 8 * PREP_GROUPS;
constexpr int PREP_PIX = 64;  // pixels of a pullback block: two per lane, many blocks in flight

// Pullback block (pb, cb) takes pixels [pb PREP_PIX, +PREP_PIX) and channels
// [cb PREP_CH, +PREP_CH): thread (lane, group) moves 8 consecutive channels
// of every PREP_LANES-th pixel (16-byte moves where aligned) and keeps their
// f32 sums; the block then sums its lanes in order into part_b[pb][co].
// The other blocks transpose the weight, a (co, c) pair per thread.
template <typename T>
__global__ void __launch_bounds__(PREP_THREADS)
    prep_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                const float* __restrict__ ds, const float* __restrict__ dq,
                T* __restrict__ dyc, float* __restrict__ part_b,
                const void* __restrict__ weight, int wdtype, T* __restrict__ wt9,
                int pixels, int HW, int C, int Cout, int pull_blocks) {
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
  // wt9[tap][co][c] = weight[co][c][tap / 3][tap % 3] in T
  const int i = (blockIdx.x - pull_blocks) * PREP_THREADS + threadIdx.x;
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
// dgrad, bf16: tensor cores, 8 warps, a 16 x 16 pixel tile by a 64-wide
// channel slice; warp (wm, wn) owns tile rows 4wm..4wm+3 and channels
// [32 wn, 32 wn + 32) (four n8 fragments). Two blocks per SM, so the
// 256x256 training shape's 128 blocks at batch 2 fill the card.
// ---------------------------------------------------------------------------
constexpr int TH_D = 16;
constexpr int NTH_D = 256;
constexpr int KC_D = 16;
constexpr int NT_D = 64;
constexpr int STAGES_D = 3;
constexpr int A_STRIDE = KC_D + 8;  // padded rows: ldmatrix hits 8 bank groups
constexpr int LDW_D = NT_D + 8;
constexpr int IN_ELEMS_D = (TH_D + 2) * HALO_W * A_STRIDE;
constexpr int STAGE_D = IN_ELEMS_D + 9 * KC_D * LDW_D;  // elements
constexpr int SMEM_D = STAGES_D * STAGE_D * 2;          // bytes

__global__ void __launch_bounds__(NTH_D, 2)
    dgrad_bf16_kernel(const __nv_bfloat16* __restrict__ dyc,
                      const __nv_bfloat16* __restrict__ wt9,
                      const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ pa, const float* __restrict__ pb,
                      __nv_bfloat16* __restrict__ dx, float* __restrict__ part,
                      int N, int H, int W, int Win, int C, int Cout, int tiles_x,
                      int n_tiles, int h_mode, int w_mode, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* stage0 = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tile = blockIdx.x, n = blockIdx.z;
  const int c0 = blockIdx.y * NT_D;
  const int y0 = (tile / tiles_x) * TH_D, x0 = (tile % tiles_x) * TW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp & 3, wn = warp >> 2;
  const bool vec_in = (Cout % 8) == 0 && aligned16(dyc);
  const bool vec_w = (C % 8) == 0 && aligned16(wt9);
  const int n_chunks = (Cout + KC_D - 1) / KC_D;
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lcol = 8 * (lane >> 4);
  const Folds fold(y0, x0, TH_D, H, Win, h_mode, w_mode);

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  using Input = HaloChunk<__nv_bfloat16, (TH_D + 2) * HALO_W, KC_D, A_STRIDE, NTH_D>;
  const DgradMap map{y0, x0, H, W, h_mode, w_mode};
  auto stage = [&](int ch) { return stage0 + (ch % STAGES_D) * STAGE_D; };
  auto issue = [&](int ch) {
    __nv_bfloat16* st = stage(ch);
    issue_weights<__nv_bfloat16, KC_D, NT_D, NTH_D>(st + IN_ELEMS_D, LDW_D, wt9,
                                                    Cout, C, ch * KC_D, c0, vec_w);
    Input::issue(st, dyc, nullptr, nullptr, map, n, H, W, Cout, ch * KC_D, ACT_NONE,
                 vec_in);
    cp_async_commit();
  };

  // One product of tile row `row` into `ac`: window (a, b) of the staged
  // dYc with weight tap `wtap`; with keep >= 0, of pixel `keep` alone.
  auto product = [&](float (&ac)[4][4], const __nv_bfloat16* s_in,
                     const __nv_bfloat16* s_w, int row, int a, int b, int wtap,
                     int keep) {
    uint32_t bf[2][4], af[4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
      ldmatrix_x4_trans(bf[jj], s_w + (wtap * KC_D + lrow) * LDW_D + wn * 32 + jj * 16 + lcol);
    ldmatrix_x4(af, s_in + ((row + a) * HALO_W + lrow + b) * A_STRIDE + lcol);
    if (keep >= 0) {  // a[0], a[2]: pixel lane / 4; a[1], a[3]: lane / 4 + 8
      if (lane / 4 != keep) af[0] = af[2] = 0u;
      if (lane / 4 + 8 != keep) af[1] = af[3] = 0u;
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      mma_bf16(ac[2 * jj], af, bf[jj][0], bf[jj][1]);
      mma_bf16(ac[2 * jj + 1], af, bf[jj][2], bf[jj][3]);
    }
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
    if (ch + 2 < n_chunks) issue(ch + 2);
    const __nv_bfloat16* s_in = stage(ch);
    const __nv_bfloat16* s_w = s_in + IN_ELEMS_D;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int a = tap / 3, b = tap % 3;
      uint32_t bf[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        ldmatrix_x4_trans(bf[jj], s_w + ((8 - tap) * KC_D + lrow) * LDW_D + wn * 32 +
                                      jj * 16 + lcol);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t af[4];
        ldmatrix_x4(af, s_in + ((4 * wm + i + a) * HALO_W + lrow + b) * A_STRIDE + lcol);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          mma_bf16(acc[i][2 * jj], af, bf[jj][0], bf[jj][1]);
          mma_bf16(acc[i][2 * jj + 1], af, bf[jj][2], bf[jj][3]);
        }
      }
    }
    // a reflect pad's folds: (tap index of window (a, b) is 8 - 3a - b)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * wm + i;
#pragma unroll
      for (int f = 0; f < 2; ++f)
        if (row == fold.rt[f])
#pragma unroll
          for (int b = 0; b < 3; ++b)
            product(acc[i], s_in, s_w, row, fold.rs[f], b, 8 - 3 * fold.rw[f] - b, -1);
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        if (fold.ct[g] < 0) continue;
#pragma unroll
        for (int a = 0; a < 3; ++a)
          product(acc[i], s_in, s_w, row, a, fold.cs[g], 8 - 3 * a - fold.cw[g], fold.ct[g]);
#pragma unroll
        for (int f = 0; f < 2; ++f)  // the corner
          if (row == fold.rt[f])
            product(acc[i], s_in, s_w, row, fold.rs[f], fold.cs[g],
                    8 - 3 * fold.rw[f] - fold.cw[g], fold.ct[g]);
      }
    }
    if (ch + 1 < n_chunks) {
      if (ch + 2 < n_chunks) cp_async_wait_one();
      else cp_async_wait_all();
    }
    __syncthreads();
  }

  // epilogue: acc[i][j] holds pixels (lane / 4, lane / 4 + 8) of tile row
  // 4wm+i and channels 2 (lane % 4), +1 of n8 fragment j
  const bool pro = pa != nullptr;
  float* red = reinterpret_cast<float*>(smem);  // [da|db][wm][NT_D]
  constexpr int WM = 4;
  const int pr = lane / 4, pc = 2 * (lane % 4);
  const bool pairs = (C % 2) == 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + wn * 32 + j * 8 + pc;
    const bool ok0 = c < C, ok1 = c + 1 < C;
    float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
    if (pro) {
      if (ok0) a0 = pa[(size_t)n * C + c], b0 = pb[(size_t)n * C + c];
      if (ok1) a1 = pa[(size_t)n * C + c + 1], b1 = pb[(size_t)n * C + c + 1];
    }
    float sa0 = 0.f, sa1 = 0.f, sb0 = 0.f, sb1 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int oy = y0 + 4 * wm + i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ox = x0 + pr + 8 * h;
        if (oy >= H || ox >= Win || !ok0) continue;
        const size_t o = (((size_t)n * H + oy) * Win + ox) * C + c;
        const float du0 = __bfloat162float(__float2bfloat16_rn(acc[i][j][2 * h]));
        const float du1 = __bfloat162float(__float2bfloat16_rn(acc[i][j][2 * h + 1]));
        float x0v = 0.f, x1v = 0.f;
        if (pro) {
          if (ok1 && pairs) {
            const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + o);
            x0v = __low2float(xv);
            x1v = __high2float(xv);
          } else {
            x0v = __bfloat162float(x[o]);
            if (ok1) x1v = __bfloat162float(x[o + 1]);
          }
        }
        const __nv_bfloat16 v0 =
            __float2bfloat16_rn(Chain::dx(du0, x0v, a0, b0, act, pro, &sa0, &sb0));
        if (ok1) {
          const __nv_bfloat16 v1 =
              __float2bfloat16_rn(Chain::dx(du1, x1v, a1, b1, act, pro, &sa1, &sb1));
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(dx + o) = __halves2bfloat162(v0, v1);
          } else {
            dx[o] = v0;
            dx[o + 1] = v1;
          }
        } else {
          dx[o] = v0;
        }
      }
    }
    if (!pro) continue;
    // sum over the 8 lanes sharing lane % 4 (the pixel rows), fixed order
#pragma unroll
    for (int m = 4; m < 32; m <<= 1) {
      sa0 += __shfl_xor_sync(0xffffffffu, sa0, m);
      sa1 += __shfl_xor_sync(0xffffffffu, sa1, m);
      sb0 += __shfl_xor_sync(0xffffffffu, sb0, m);
      sb1 += __shfl_xor_sync(0xffffffffu, sb1, m);
    }
    if (lane < 4) {
      const int t = wn * 32 + j * 8 + pc;
      red[wm * NT_D + t] = sa0;
      red[wm * NT_D + t + 1] = sa1;
      red[(WM + wm) * NT_D + t] = sb0;
      red[(WM + wm) * NT_D + t + 1] = sb1;
    }
  }
  if (!pro) return;
  __syncthreads();
  write_tile_moments<NTH_D>(red, WM, NT_D, part, n, N, tile, n_tiles, c0, C);
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
// wgrad, bf16: tensor cores, nine warps, warp w owns tap w of a 64-channel
// x 64-cout slice of the weight gradient (4 m16 x 8 n8 fragments). Block
// (s, cb, nb) takes the pixel tiles s, s + S, ...: each an 8 x 16 tile
// whose padded u halo (K1's staging: pad and prologue by index) and dYc
// are staged by cp.async into one of two stages while the other is
// computed; a K-step is one tile row of 16 pixels.
// ---------------------------------------------------------------------------
constexpr int TH_W = 8;
constexpr int NTH_W = 288;
constexpr int MC = 64, NC = 64;
constexpr int U_STRIDE = MC + 8, G_STRIDE = NC + 8;
constexpr int U_ELEMS = (TH_W + 2) * HALO_W * U_STRIDE;
constexpr int STAGE_W = U_ELEMS + TH_W * TW * G_STRIDE;  // elements
constexpr int SMEM_W = 2 * STAGE_W * 2;                  // bytes

__global__ void __launch_bounds__(NTH_W, 1)
    wgrad_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ pa, const float* __restrict__ pb,
                      const __nv_bfloat16* __restrict__ dyc,
                      float* __restrict__ part_w, int H, int W, int Win, int C,
                      int Cout, int tiles_x, int tiles, int total, int h_mode,
                      int w_mode, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* stage0 = reinterpret_cast<__nv_bfloat16*>(smem);

  const int s = blockIdx.x, S = gridDim.x;
  const int c0 = blockIdx.y * MC, co0 = blockIdx.z * NC;
  const int tap = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dy = tap / 3, dx = tap % 3;
  const bool vec_in = (C % 8) == 0 && aligned16(x);
  const bool vec_g = (Cout % 8) == 0 && aligned16(dyc);
  // ldmatrix lanes: A (u, stored [pixel][c]) transposed: pixel rows
  // (lane & 7) + 8 (lane >> 4), channels 8 ((lane >> 3) & 1); B (dYc,
  // [pixel][co]) as the forward's weights
  const int arow = (lane & 7) + 8 * (lane >> 4), acol = 8 * ((lane >> 3) & 1);
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 8 * (lane >> 4);

  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  using U = HaloChunk<__nv_bfloat16, (TH_W + 2) * HALO_W, MC, U_STRIDE, NTH_W>;
  using G = HaloChunk<__nv_bfloat16, TH_W * TW, NC, G_STRIDE, NTH_W>;
  auto same = [&](int t, int* n) {
    *n = t / tiles;
    const int r = t % tiles;
    return SameMap{(r / tiles_x) * TH_W, (r % tiles_x) * TW, H, Win, h_mode, w_mode};
  };
  auto stage = [&](int k) { return stage0 + (k & 1) * STAGE_W; };
  auto issue = [&](int t, int k) {
    int n;
    const SameMap m = same(t, &n);
    U::issue(stage(k), x, pa, pb, m, n, H, Win, C, c0, act, vec_in);
    G::issue(stage(k) + U_ELEMS, dyc, nullptr, nullptr, TileMap{m.y0, m.x0, H, W}, n, H,
             W, Cout, co0, ACT_NONE, vec_g);
    cp_async_commit();
  };

  issue(s, 0);
  for (int t = s, k = 0; t < total; t += S, ++k) {
    if (t + S < total) {
      issue(t + S, k + 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    int n;
    const SameMap m = same(t, &n);
    U::finish(stage(k), pa, pb, m, n, H, Win, C, c0, act, vec_in);
    __syncthreads();
    const __nv_bfloat16* su = stage(k);
    const __nv_bfloat16* sg = su + U_ELEMS;
#pragma unroll 1
    for (int ty = 0; ty < TH_W; ++ty) {
      uint32_t bf[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        ldmatrix_x4_trans(bf[jj], sg + (ty * TW + lrow) * G_STRIDE + jj * 16 + lcol);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t af[4];
        ldmatrix_x4_trans(af, su + ((ty + dy) * HALO_W + dx + arow) * U_STRIDE + mi * 16 + acol);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          mma_bf16(acc[mi][2 * jj], af, bf[jj][0], bf[jj][1]);
          mma_bf16(acc[mi][2 * jj + 1], af, bf[jj][2], bf[jj][3]);
        }
      }
    }
    __syncthreads();  // stage k is refilled by the issue of iteration k + 1
  }

  // acc[mi][j] holds channels (lane / 4, lane / 4 + 8) of m-fragment mi and
  // couts 2 (lane % 4), +1 of n8 fragment j
  const int pr = lane / 4, pc = 2 * (lane % 4);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + mi * 16 + pr + 8 * h, co = co0 + j * 8 + pc;
        if (c >= C) continue;
        float* dst = part_w + (((size_t)s * 9 + tap) * C + c) * Cout + co;
        if (co < Cout) dst[0] = acc[mi][j][2 * h];
        if (co + 1 < Cout) dst[1] = acc[mi][j][2 * h + 1];
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
// reduce: every partial sum over its splits, in a fixed order, one output
// per thread: the weight gradient (rounded to the compute type, written
// OIHW in the weight's type), dbias, then da and db.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
    reduce_kernel(const float* __restrict__ part_w, int S,
                  const float* __restrict__ part_b, int PB,
                  const float* __restrict__ part_ab, int n_tiles, void* __restrict__ dw,
                  int wdtype, float* __restrict__ dbias, float* __restrict__ da,
                  float* __restrict__ db, int N, int C, int Cout, int dtype) {
  const int nw = 9 * C * Cout, nb = dbias != nullptr ? Cout : 0;
  const int nab = da != nullptr ? N * C : 0;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nw) {
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += part_w[(size_t)s * nw + i];
    if (dtype == 1) v = __bfloat162float(__float2bfloat16_rn(v));
    const int tap = i / (C * Cout), c = (i / Cout) % C, co = i % Cout;
    const size_t o = ((size_t)co * C + c) * 9 + tap;
    if (wdtype == 1) static_cast<__nv_bfloat16*>(dw)[o] = __float2bfloat16_rn(v);
    else static_cast<float*>(dw)[o] = v;
    return;
  }
  i -= nw;
  if (i < nb) {
    float v = 0.f;
    for (int p = 0; p < PB; ++p) v += part_b[(size_t)p * Cout + i];
    dbias[i] = v;
    return;
  }
  i -= nb;
  if (i < nab) {
    const int n = i / C, c = i % C;
    const float* p = part_ab + (size_t)n * n_tiles * C + c;
    const size_t half = (size_t)N * n_tiles * C;
    float sa = 0.f, sb = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      sa += p[(size_t)t * C];
      sb += p[half + (size_t)t * C];
    }
    da[i] = sa;
    db[i] = sb;
  }
}

// The sizes the workspace query and the launch share, and the workspace's
// layout: dYc, the transposed weight, then the f32 partials.
struct Plan {
  int Win, dg_tiles_x, dg_tiles, wg_tiles_x, wg_tiles, wg_total, S, PB;
  int pull_blocks, wt_blocks;
  size_t off_wt9, off_pw, off_pb, off_pab, bytes;

  Plan(int N, int H, int W, int C, int Cout, int dtype, int w_mode, bool pro) {
    const size_t es = dtype == 1 ? 2 : 4;
    Win = w_mode == W_HALO ? W + 2 : W;
    const int dg_th = dtype == 1 ? TH_D : TH_F;
    dg_tiles_x = (Win + TW - 1) / TW;
    dg_tiles = ((H + dg_th - 1) / dg_th) * dg_tiles_x;
    const int wg_th = dtype == 1 ? TH_W : TH_WF;
    wg_tiles_x = (W + TW - 1) / TW;
    wg_tiles = ((H + wg_th - 1) / wg_th) * wg_tiles_x;
    wg_total = N * wg_tiles;
    const int slices = ((C + MC - 1) / MC) * ((Cout + NC - 1) / NC) * (dtype == 1 ? 1 : 9);
    S = max(1, min(wg_total, SMS / slices));
    const int pixels = N * H * W;
    PB = (pixels + PREP_PIX - 1) / PREP_PIX;
    pull_blocks = PB * ((Cout + PREP_CH - 1) / PREP_CH);
    wt_blocks = (Cout * C + PREP_THREADS - 1) / PREP_THREADS;
    auto up = [](size_t b) { return (b + 255) / 256 * 256; };
    off_wt9 = up((size_t)pixels * Cout * es);
    off_pw = off_wt9 + up((size_t)9 * Cout * C * es);
    off_pb = off_pw + up((size_t)S * 9 * C * Cout * 4);
    off_pab = off_pb + up((size_t)PB * Cout * 4);
    bytes = off_pab + (pro ? up((size_t)2 * N * dg_tiles * C * 4) : 0);
  }
};

// prep, dgrad and wgrad on the stream (the reduce follows in the caller).
template <typename T>
cudaError_t launch_all(const Plan& pl, const T* x, const void* weight, int wdtype,
                       const float* pa, const float* pb, const T* y, const T* dy,
                       const float* ds, const float* dq, T* dx, bool bias, char* work,
                       int N, int H, int W, int C, int Cout, int h_mode, int w_mode, int act,
                       cudaStream_t s) {
  T* dyc = reinterpret_cast<T*>(work);
  T* wt9 = reinterpret_cast<T*>(work + pl.off_wt9);
  float* pw = reinterpret_cast<float*>(work + pl.off_pw);
  float* pbias = bias ? reinterpret_cast<float*>(work + pl.off_pb) : nullptr;
  float* pab = pa != nullptr ? reinterpret_cast<float*>(work + pl.off_pab) : nullptr;
  prep_kernel<T><<<pl.pull_blocks + pl.wt_blocks, PREP_THREADS, 0, s>>>(
      dy, y, ds, dq, dyc, pbias, weight, wdtype, wt9, N * H * W, H * W, C, Cout,
      pl.pull_blocks);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    cudaError_t err = cudaFuncSetAttribute(
        dgrad_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_D);
    if (err != cudaSuccess) return err;
    dgrad_bf16_kernel<<<dim3(pl.dg_tiles, (C + NT_D - 1) / NT_D, N), NTH_D, SMEM_D, s>>>(
        dyc, wt9, x, pa, pb, dx, pab, N, H, W, pl.Win, C, Cout, pl.dg_tiles_x, pl.dg_tiles,
        h_mode, w_mode, act);
    err = cudaFuncSetAttribute(wgrad_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_W);
    if (err != cudaSuccess) return err;
    wgrad_bf16_kernel<<<dim3(pl.S, (C + MC - 1) / MC, (Cout + NC - 1) / NC), NTH_W,
                        SMEM_W, s>>>(x, pa, pb, dyc, pw, H, W, pl.Win, C, Cout,
                                     pl.wg_tiles_x, pl.wg_tiles, pl.wg_total, h_mode,
                                     w_mode, act);
  } else {
    dgrad_f32_kernel<<<dim3(pl.dg_tiles, (C + NT_F - 1) / NT_F, N), NTH_F, 0, s>>>(
        dyc, wt9, x, pa, pb, dx, pab, N, H, W, pl.Win, C, Cout, pl.dg_tiles_x, pl.dg_tiles,
        h_mode, w_mode, act);
    wgrad_f32_kernel<<<dim3(pl.S, (C + MC - 1) / MC, 9 * ((Cout + NC - 1) / NC)), 256, 0,
                       s>>>(x, pa, pb, dyc, pw, H, W, pl.Win, C, Cout, pl.wg_tiles_x,
                            pl.wg_tiles, pl.wg_total, h_mode, w_mode, act);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the workspace conv3x3_fused_bwd_launch takes (arguments as
// there; prologue: 1 with a prologue), or -1 past 2**31.
int conv3x3_fused_bwd_workspace(int N, int H, int W, int C, int Cout, int dtype,
                                int w_mode, int prologue) {
  const Plan pl(N, H, W, C, Cout, dtype, w_mode, prologue != 0);
  return pl.bytes < (size_t(1) << 31) ? static_cast<int>(pl.bytes) : -1;
}

// dtype: 0 = float32, 1 = bfloat16 (x, y, dy and dx); wdtype the weight's
// (and dw's). h_mode: 0 zero, 1 reflect, 2 wrap; w_mode the same, or 3 (the
// halo mode: x and dx carry the W pad columns). act: 0 none, 1 relu, 2
// lrelu (only read with a prologue). x (N, H, W, C), or (N, H, W+2, C) in
// the halo mode; y, dy (N, H, W, Cout); weight OIHW (Cout, C, 3, 3); pa, pb
// (N, C) f32 or both null (no prologue: da, db null); ds, dq (N, Cout) f32
// or both null (no moments); dbias (Cout) f32 or null (no bias); work: the
// workspace's bytes, 256-byte aligned. Four launches on the stream.
int conv3x3_fused_bwd_launch(const void* x, const void* weight, const void* pa,
                             const void* pb, const void* y, const void* dy,
                             const void* ds, const void* dq, void* dx, void* dw,
                             void* dbias, void* da, void* db, void* work, int N, int H,
                             int W, int C, int Cout, int dtype, int wdtype, int h_mode,
                             int w_mode, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan pl(N, H, W, C, Cout, dtype, w_mode, pa != nullptr);
  const float *a0 = static_cast<const float*>(pa), *b0 = static_cast<const float*>(pb);
  const float *ds0 = static_cast<const float*>(ds), *dq0 = static_cast<const float*>(dq);
  float* dbias0 = static_cast<float*>(dbias);
  float *da0 = static_cast<float*>(da), *db0 = static_cast<float*>(db);
  char* w = static_cast<char*>(work);
  cudaError_t err;
  if (dtype == 1) {
    using T = __nv_bfloat16;
    err = launch_all<T>(pl, static_cast<const T*>(x), weight, wdtype, a0, b0,
                        static_cast<const T*>(y), static_cast<const T*>(dy), ds0, dq0,
                        static_cast<T*>(dx), dbias != nullptr, w, N, H, W, C, Cout, h_mode,
                        w_mode, act, s);
  } else if (dtype == 0) {
    err = launch_all<float>(pl, static_cast<const float*>(x), weight, wdtype, a0, b0,
                            static_cast<const float*>(y), static_cast<const float*>(dy),
                            ds0, dq0, static_cast<float*>(dx), dbias != nullptr, w, N, H, W,
                            C, Cout, h_mode, w_mode, act, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int outputs = 9 * C * Cout + (dbias != nullptr ? Cout : 0) + (pa != nullptr ? N * C : 0);
  reduce_kernel<<<(outputs + 255) / 256, 256, 0, s>>>(
      reinterpret_cast<float*>(w + pl.off_pw), pl.S, reinterpret_cast<float*>(w + pl.off_pb),
      pl.PB, pa != nullptr ? reinterpret_cast<float*>(w + pl.off_pab) : nullptr, pl.dg_tiles,
      dw, wdtype, dbias0, da0, db0, N, C, Cout, dtype);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
