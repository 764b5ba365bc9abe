// conv3x3_tma.cuh: the bf16 tile loop of the 3x3 stride-1 convs on Hopper
// (TMA, mbarriers, wgmma, a persistent grid), shared by three kernels:
//   * K1, conv3x3_fused.cu: SAME, the pad built in the kernel (zero,
//     reflect, wrap on H; those or the halo mode's carried columns on W),
//     an optional affine + activation prologue on the input, bias, one
//     cast, optional moments of the stored output;
//   * K6, conv3x3_valid.cu: VALID on an input that carries its own pad, or
//     with a zero pad of 2 on each side (the full conv of the input
//     gradient, the taps read in reverse), then bias + residual + none /
//     ReLU / LReLU(0.2) in f32 and one cast;
//   * K2's input gradient, conv3x3_fused_bwd.cu: the full conv of the
//     output's cotangent with the flipped, channel-transposed weight, the
//     forward pad's adjoint (a wrap pad's is the circular conv: K1's side
//     loads; a zero pad's TMA's zero fill; a reflect pad's the zero pad
//     plus its folds, FOLD below), and the prologue's chain in the
//     epilogue (OUT DGRAD + act).
// All three are the kernel below: an input box per (tile, channel block) whose
// origin is the output tile's origin plus (y_off, x_off) (-1 for a pad of
// 1 built in the kernel, 0 for a carried pad, -2 for the input gradient's
// pad of 2; TMA's zero fill gives every zero pad), and an epilogue policy
// chosen by a template parameter (OUT: BIAS_MOMENTS for K1, the activation
// for K6 and for K2's input gradient without a prologue, DGRAD + the
// prologue's activation for K2's with one).
//
// Design (times: PERF.md; chip_smoke.py, profile_block_conv). The conv is
// a GEMM of M = output pixels, N = Cout, K = 9C, cut into k16 steps of
// (channel block cb of 64, tap, 16 channels).
//   * Tile: 7 rows x 18 columns of output pixels (126 of the 128 A rows; a
//     consumer warpgroup takes 64) by 256 couts (NH 2: one m64n256k16
//     wgmma a step, 128 f32 accumulators a thread) or 128 (NH 1: 64). The
//     wrapper picks NH per call (kernels/conv_tma.py::tile_geometry)
//     from the rounds of a persistent grid of one block per SM, which walks
//     the tiles, the cout blocks of a pixel tile next to each other. 7 x 18
//     is chosen for the rounds on 132 SMs: 8 x 16, whose 16-pixel rows keep
//     every ldmatrix free of bank conflicts, took a fifth round at the globe
//     and ran slower than 7 x 18, which pays a two-way conflict where a
//     fragment's rows cross a tile row:
//       globe (1, 181, 360): 26 x 20 = 520 tiles, 3.94 waves: 4 rounds
//         (8 x 16: 529, 5 rounds);
//       halo (1, 181, 90 + 2): 26 x 5 = 130 tiles: 1 round (8 x 16: 138, 2);
//       training (B, 64, 64), and K6's input gradient (B, 66, 66): 40 tiles
//         per image: B 1 NH 1 (80 half tiles), B 2 and 3 NH 2 (80, 120):
//         one round each.
//   * Loads, by one producer thread with TMA: per channel block, one 4-D box
//     (1, 9, 20, 64 channels) of x holding the tile and its halo, origin
//     (n, y0 + y_off, x0 + x_off, 64 cb), 128-byte swizzle; TMA's zero fill
//     gives the zero pads, the ragged tiles and the channels past C. Each
//     box feeds all 9 taps: 23 KB of L2 traffic for 126 x 9 x 64 products;
//     the weights, packed by the wrapper into K-major slabs (9 n_kc,
//     Cout_pad, 64), one per (channel block, tap), are a TMA box each
//     (32 KB at NH 2), read by wgmma through sw128_desc; with `flip` tap t
//     reads slab 8 - t (K6's input gradient: the wrapper packs the
//     channel-transposed weight unflipped, one copy). Two rings with their
//     own full / empty mbarriers: 2 input stages, 3 weight stages (NH 2) or
//     6 (NH 1). The next box is issued at tap 3 of the current channel
//     block (the next tile's first box during the last block): its stage
//     was released at the previous block's last ldmatrix, and it has six
//     weight slabs' time to land. L2-to-SM traffic is the weights' 9 C x BN
//     x 2 bytes per tile, 1.18 MB, 0.61 GB per globe conv; it does not
//     bound the kernel: a version that loaded no weight after the first
//     stages ran as long.
//   * Reflect and wrap pads (K1): TMA only zero-fills, so a tile on an edge
//     whose pad holds data also loads its pad row (1 x 20) and pad column
//     (9 x 1) from their source row or column (reflect 1 / n-2, wrap n-1 /
//     0) into unswizzled side buffers, and each corner (1 x 1) it touches
//     from (source row, source column): a side row's pad column and a side
//     column's pad row would come in zero-filled or wrong. A lane whose
//     ldmatrix row is a pad pixel points there instead of into the box
//     (only edge tiles, so their bank conflicts are rare). H <= 7 or W <= 18
//     makes a tile touch both edges at once: both side rows, both columns,
//     four corners. K6 has no side loads.
//   * The prologue (K1), by the three helper warps of the producer
//     warpgroup, on each box as it lands (and its side rows, columns,
//     corners): act(a x + b) in f32 (one FMA, f32 a and b,
//     cvt.rn(.relu).bf16x2: one rounding) where the row holds input data, 0
//     on a zero pad or zero fill (never act(b)), in place; the consumers
//     take the box once the helpers' ready barrier says so. Each staged
//     element is transformed once, where the consumers' registers would
//     transform it once per tap, 9 times: a first version with the prologue
//     in the consumers' registers spent a third of its time on it.
//   * A from registers (wgmma ..k16_rs): each lane knows its tile pixel and
//     so its ldmatrix row in the box at each tap's one-pixel shift (no valid
//     start for a shared-memory descriptor; the side buffers are looked at
//     only on an edge tile) and loads its fragment; two steps' wgmmas stay
//     in flight while the next fragment loads (a group of two steps, or
//     three in flight, ran out of registers and ptxas serialized the
//     wgmmas). The loop is unrolled over a channel block's 36 steps, so the
//     box, tap and slab positions are constants: the consumers' per-step
//     scalar work, not the tensor cores, bounded the loop before. The
//     wgmmas sit on no branch.
//   * Epilogue into a 128-byte-swizzled staging tile (BN / 64 boxes of 128
//     A rows x 64 couts), stored by TMA (a box of the tile's 7 x 18 pixels;
//     TMA clips the ragged tiles). K1: f32 bias and one cast; the helpers
//     read the stored values back for the moments, each column pair by one
//     thread in pixel order, per tile into part[n][block] (zeroed by the
//     launch); launch_reduce_moments sums the blocks in a fixed order. A
//     block's walk may cross into the next image (batch > 1 with more tiles
//     than SMs): the helpers flush their sums when the image or cout block
//     changes, and a and b are read per tile's image. K6: helper 0 loads
//     the tile's residual by TMA into the staging tile (the y box's shape
//     and swizzle, so each consumer lane finds its residual where it writes
//     its output), the next tile's as soon as the store has read the
//     previous one; the consumers add f32 bias and residual, apply the
//     activation and cast once, in place. K6 takes no prologue and no
//     moments: its helper warps only store (and load the residual). The
//     helpers take a tile's epilogue after the next tile's first box, which
//     the consumers need first. K2's input gradient (DGRAD): helper 0 loads
//     the tile's x as K6's residual; the consumers round dU once to bf16,
//     recompute pre = a x + b from it, write dx = bf16(act'(pre) dU a) in
//     place and sum dpre x and dpre over the tile's real pixels in f32: per
//     thread, over the 8 lanes of a warp that share columns (shuffles),
//     then over the 8 warps through a 4 KB buffer, 64 columns at a time,
//     into the tile's slot of dpart (2, N, n_sp, Cout), in a fixed order.
//   * A reflect pad's folds (FOLD, K2's input gradient): the adjoint of a
//     reflected pad is the zero-padded full conv onto the padded output
//     (rows -1 .. n), then pad row -1 added onto row 1 and row n onto n-2
//     (columns alike; a corner through both). On a reflected axis the tile
//     grid covers the padded output from an origin o in -1 .. -5 (rows;
//     columns -1 .. -17) chosen per shape so that one tile holds rows -1
//     and 1 and one tile rows n-2 and n (tile_grid); the epilogue adds the
//     pad row's f32 sums onto the target row's through shared memory, rows
//     before columns, and only then rounds: dU is rounded once, after the
//     folds, and the tap loop carries no fold code. Rows past the output
//     are never stored (TMA clips them).
//   * Shared memory: NH 2: 3 x 32 KB weights + 64 KB staging + 2 x 23.0 KB
//     boxes + 2 x 7.75 KB side buffers + barriers + 1 KB alignment =
//     227,960 of 232,448 bytes; NH 1: 6 x 16 + 32 + the rest = 195,240.
// * Shared memory: K2's input gradient adds a 4 KB buffer for the warps'
//   sums and the folds (232,056 bytes at NH 2).
// TMA needs 16-byte strides and addresses: C % 8 == 0, Cout % 8 == 0, x, y
// and the residual 16-byte aligned (the wrappers pad C and Cout, and raise
// for a misaligned x); a and b come as (N, C rounded up to 64), zero past C.

#pragma once

#include <type_traits>

#include "common.cuh"

namespace port {
namespace conv_tma {

using namespace port::sm90;

constexpr int KW = 64;  // input channels per channel block (128 bytes)
constexpr int TILE_H = 7, TILE_W = 18;  // a tile's output pixels: 126 of its A rows
constexpr int BM = 128;  // A rows of a tile (two consumer warpgroups of 64)
constexpr int BOX_H = TILE_H + 2, BOX_W = TILE_W + 2;
constexpr int BOX_BYTES = BOX_H * BOX_W * 128;
constexpr int BOX_STRIDE = (BOX_BYTES + 1023) / 1024 * 1024;  // the swizzle's alignment
constexpr int OUT_BOX_BYTES = TILE_H * TILE_W * 128;  // one 64-cout box of y (or the residual)
// a stage's side buffer: the pad rows [top, bottom], the pad columns [left,
// right], the corners [top-left, top-right, bottom-left, bottom-right]
constexpr int SROW_BYTES = BOX_W * 128;
constexpr int SCOL_BYTES = BOX_H * 128;
constexpr int CORNERS = 2 * SROW_BYTES + 2 * SCOL_BYTES;
constexpr int SIDE_BYTES = CORNERS + 4 * 128;
constexpr int IN_STAGES = 2;
constexpr int NEXT_BOX_TAP = 3;  // where the producer issues the next box
constexpr int STEPS = 9 * KW / 16;  // k16 steps per channel block
constexpr int CONSUMERS = 256;  // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and one producer warpgroup
constexpr int PRODUCER = CONSUMERS;  // the thread that issues the loads
constexpr int HELPERS = 96;  // warps 1-3 of the producer warpgroup: prologue, epilogues
constexpr int NO_PROLOGUE = -1;  // the kernel's ACT without a prologue
// the kernel's OUT: K1's epilogue (bias, one cast, moments where asked), or
// an activation (ACT_NONE, ACT_RELU, ACT_LRELU): K6's bias + residual + act
constexpr int BIAS_MOMENTS = -1;
// K2's input gradient with the prologue's chain: DGRAD + its activation
constexpr int DGRAD = 8;
constexpr int RED_BYTES = 8 * 2 * 64 * 4;  // DGRAD: [da|db][8 warps][64 columns] f32
constexpr int N_MAPS = 7;  // x, its side row, column and corner; w; y; the residual

template <int NH>
struct Geom {
  static constexpr int BN = 128 * NH;
  static constexpr int W_STAGES = NH == 1 ? 6 : 3;
  static constexpr int W_BYTES = BN * 128;
  static constexpr int OUT_BYTES = BM * BN * 2;  // BN / 64 swizzled boxes
  static constexpr int DEPTH = 2;  // wgmma commit groups (k16 steps) in flight
  static constexpr int NB = DEPTH + 1;  // A fragment buffers
  static constexpr int BARRIERS = 3 * IN_STAGES + 2 * W_STAGES + 3;
  static constexpr int SMEM = 1024 + W_STAGES * W_BYTES + OUT_BYTES +
                              IN_STAGES * (BOX_STRIDE + SIDE_BYTES) + BARRIERS * 8;
};
// K2's input gradient (DGRAD, FOLD) also takes RED_BYTES for its sums; K1's
// and K6's layout stays without them (their L1 keeps the 4 KB)
template <int OUT, bool FOLD>
__host__ __device__ constexpr int red_bytes() { return OUT >= DGRAD || FOLD ? RED_BYTES : 0; }
static_assert(Geom<2>::SMEM + RED_BYTES <= 232448 && Geom<1>::SMEM + RED_BYTES <= 232448,
              "shared memory");

struct ConvArgs {
  const float* bias;  // (Cout) or null
  const float* pa;    // (N, cs), zero past C, 16-byte aligned, or null
  const float* pb;
  float* part;        // (2, N, n_parts, Cout), zeroed, or null
  int N, H, W, Cout, cout_pad;  // the output
  int Hin, Win;                 // the input
  int y_off, x_off;  // the input row and column of output pixel (0, 0)'s first tap
  int tiles_x, n_sp, n_cb, total;  // tiles per tile row, per image; cout blocks
  int n_parts;                     // moment slots per image: at least the grid
  int n_kc, cs;                    // channel blocks; a and b per image
  int h_mode, w_mode;  // PAD_REFLECT / PAD_WRAP: a pad of 1 that holds data
  int flip;            // tap t reads weight slab 8 - t
  int res;             // the residual map holds a residual (K6) or x (DGRAD)
};

// K2's input gradient's arguments (FOLD kernels): ConvArgs and what its
// folds and its epilogue take. A separate type, so that K1's and K6's
// parameters stay as they were: six more fields in ConvArgs alone made
// ptxas allocate K1's NH 2 loop otherwise, 8% slower (an H100 probe).
struct DgradArgs : ConvArgs {
  int fold_h, fold_w;  // the forward reflected H (W): add the folds
  int oy, ox;          // the tile grid's origin (tile_grid)
  void* y;             // the output, for the tiles TMA cannot store
  float* dpart;        // DGRAD: (2, N, n_sp, Cout) sums of dpre x and dpre
};
template <bool FOLD>
using ArgsOf = typename std::conditional<FOLD, DgradArgs, ConvArgs>::type;

struct Tile {
  int n, y0, x0, co0;
};

// Tile t: its cout block first, so that the cout blocks of one pixel tile
// run together and read the same boxes while L2 still holds them. FOLD: the
// grid starts at (oy, ox) (tile_grid); K1 and K6 start at 0.
template <class G, bool FOLD = false, class A>
__device__ __forceinline__ Tile tile_of(int t, const A& a) {
  Tile r;
  r.co0 = (t % a.n_cb) * G::BN;
  const int p = t / a.n_cb;
  const int sp = p % a.n_sp;
  r.n = p / a.n_sp;
  r.y0 = (sp / a.tiles_x) * TILE_H;
  r.x0 = (sp % a.tiles_x) * TILE_W;
  if constexpr (FOLD) {
    r.y0 += a.oy;
    r.x0 += a.ox;
  }
  return r;
}

// The tile grid along an axis of n outputs in tiles of `tile`: its origin
// (0; on a folded axis the one in -1 .. -(tile - 2) nearest -1 whose grid
// puts rows n-2 and n in one tile, as -1 and 1 are in the first; 5
// consecutive origins always hold one) and its tiles.
__host__ __device__ __forceinline__ void tile_grid(int n, int tile, bool fold, int* origin,
                                                   int* tiles) {
  int o = 0;
  if (fold) {
    o = -1;
    while (o > 2 - tile && (n - o) % tile < 2) --o;
  }
  *origin = o;
  *tiles = (n + (fold ? 1 : 0) - o + tile - 1) / tile;
}

__device__ __forceinline__ bool h_data(const ConvArgs& a) {
  return a.h_mode == PAD_REFLECT || a.h_mode == PAD_WRAP;
}
__device__ __forceinline__ bool w_data(const ConvArgs& a) {
  return a.w_mode == PAD_REFLECT || a.w_mode == PAD_WRAP;
}
// The input row and column of the box's first row and column.
__device__ __forceinline__ int box_y(const Tile& tl, const ConvArgs& a) { return tl.y0 + a.y_off; }
__device__ __forceinline__ int box_x(const Tile& tl, const ConvArgs& a) { return tl.x0 + a.x_off; }
// The input row or column a reflected or wrapped pad copies: pad -1 (hi
// false) or n (hi true) of an axis of n.
__device__ __forceinline__ int pad_source(bool hi, int n, int mode) {
  return mode == PAD_REFLECT ? (hi ? n - 2 : 1) : (hi ? 0 : n - 1);
}

// The pad rows and columns of tile tl's box that hold data (reflect,
// wrap, where the input is at the output's size): its side loads.
struct Edges {
  bool row[2], col[2];  // [top, bottom], [left, right]
  __device__ __forceinline__ Edges(const Tile& tl, const ConvArgs& a) {
    row[0] = h_data(a) && tl.y0 == 0;
    row[1] = h_data(a) && tl.y0 + TILE_H >= a.H;
    col[0] = w_data(a) && tl.x0 == 0;
    col[1] = w_data(a) && tl.x0 + TILE_W >= a.W;
  }
  __device__ __forceinline__ bool any() const { return row[0] || row[1] || col[0] || col[1]; }
  __device__ __forceinline__ int bytes() const {
    const int r = row[0] + row[1], c = col[0] + col[1];
    return BOX_BYTES + r * SROW_BYTES + c * SCOL_BYTES + r * c * 128;
  }
};

// The prologue on one 16-byte chunk (8 channels from c) of a staged row, in
// place: act(a x + b) (affine_act_bf16x2: f32 a and b, one FMA, one
// rounding) where the row holds input data, 0 where it holds a zero pad or
// TMA's zero fill (never act(b)).
template <int ACT>
__device__ __forceinline__ void prologue_chunk(unsigned char* p, const float* pa,
                                               const float* pb, bool real) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (real) {
    v = *reinterpret_cast<const uint4*>(p);
    const float4 a0 = __ldg(reinterpret_cast<const float4*>(pa));
    const float4 a1 = __ldg(reinterpret_cast<const float4*>(pa) + 1);
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(pb));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(pb) + 1);
    v.x = affine_act_bf16x2<ACT>(v.x, a0.x, b0.x, a0.y, b0.y);
    v.y = affine_act_bf16x2<ACT>(v.y, a0.z, b0.z, a0.w, b0.w);
    v.z = affine_act_bf16x2<ACT>(v.z, a1.x, b1.x, a1.y, b1.y);
    v.w = affine_act_bf16x2<ACT>(v.w, a1.z, b1.z, a1.w, b1.w);
  }
  *reinterpret_cast<uint4*>(p) = v;
}

// The prologue on channel block cb of tile tl as it landed, by helper
// thread h: the box (swizzled; a row holds data where its pixel lies in the
// input: its pads that hold data are read from the side buffers) and the
// side rows, columns and corners the tile loaded (unswizzled; a side row's
// pad columns and a side column's pad rows are read from the corners).
template <int ACT>
__device__ __forceinline__ void prologue_box(unsigned char* box, unsigned char* side,
                                             const ConvArgs& a, const Tile& tl,
                                             int cb, int h) {
  const float* pa = a.pa + (size_t)tl.n * a.cs + cb * KW;
  const float* pb = a.pb + (size_t)tl.n * a.cs + cb * KW;
  const int xs = box_x(tl, a), ys = box_y(tl, a);
  auto in_h = [&](int y) { return y >= 0 && y < a.Hin; };
  auto in_w = [&](int x) { return x >= 0 && x < a.Win; };
  for (int q = h; q < BOX_H * BOX_W * 8; q += HELPERS) {
    const int row = q / 8, cc = q % 8;
    prologue_chunk<ACT>(box + row * 128 + ((cc ^ (row & 7)) << 4), pa + 8 * cc, pb + 8 * cc,
                        in_h(ys + row / BOX_W) && in_w(xs + row % BOX_W));
  }
  const Edges e(tl, a);
  for (int i = 0; i < 2; ++i) {
    if (e.row[i])
      for (int q = h; q < BOX_W * 8; q += HELPERS)
        prologue_chunk<ACT>(side + i * SROW_BYTES + q * 16, pa + 8 * (q % 8),
                            pb + 8 * (q % 8), in_w(xs + q / 8));
    if (e.col[i])
      for (int q = h; q < BOX_H * 8; q += HELPERS)
        prologue_chunk<ACT>(side + 2 * SROW_BYTES + i * SCOL_BYTES + q * 16,
                            pa + 8 * (q % 8), pb + 8 * (q % 8), in_h(ys + q / 8));
    for (int j = 0; j < 2; ++j)
      if (e.row[i] && e.col[j] && h < 8)
        prologue_chunk<ACT>(side + CORNERS + (2 * i + j) * 128 + h * 16, pa + 8 * h,
                            pb + 8 * h, true);
  }
}

// Where a lane's ldmatrix row lies at one tap: in the box, or in a side
// buffer on a pad that holds data (a tile on an edge).
struct AFrag {
  const unsigned char* row_at;  // chunk 0 of this lane's ldmatrix row
  int sw;                       // its swizzle, or -1 in a side buffer
};

__device__ __forceinline__ AFrag frag_setup(const unsigned char* box,
                                            const unsigned char* side,
                                            const ConvArgs& a, const Tile& tl,
                                            bool edge, int ty, int tx, int tap) {
  const int br = ty + tap / 3, bc = tx + tap % 3;  // the box row and column
  AFrag r;
  r.sw = -1;
  const int y = box_y(tl, a) + br, x = box_x(tl, a) + bc;  // the input's
  const bool row_side = edge && h_data(a) && (y == -1 || y == a.H);
  const bool col_side = edge && w_data(a) && (x == -1 || x == a.W);
  if (row_side && col_side) {
    r.row_at = side + CORNERS + (2 * (y != -1) + (x != -1)) * 128;
  } else if (row_side) {
    r.row_at = side + (y != -1) * SROW_BYTES + bc * 128;
  } else if (col_side) {
    r.row_at = side + 2 * SROW_BYTES + (x != -1) * SCOL_BYTES + br * 128;
  } else {
    const int row = br * BOX_W + bc;
    r.row_at = box + row * 128;
    r.sw = row & 7;
  }
  return r;
}

// The A fragment of k16 step ks (mma.sync's m16n8k16 layout, which
// wgmma_m64n128k16_rs takes).
__device__ __forceinline__ void load_frag(uint32_t (&f)[4], const AFrag& r, int ks,
                                          int lane) {
  const int chunk = 2 * ks + (lane >> 4);
  ldmatrix_x4(f, r.sw < 0 ? r.row_at + chunk * 16
                          : r.row_at + ((chunk ^ r.sw) << 4));
}

template <int ACT>
__device__ __forceinline__ float act_out(float v) {
  if (ACT == ACT_RELU) return fmaxf(v, 0.f);
  if (ACT == ACT_LRELU) return v > 0.f ? v : 0.2f * v;
  return v;
}

// The epilogue into the output staging tile (BN / 64 boxes of 64 couts by
// BM rows, 128-byte swizzled, as the y tensor map stores them): thread t
// of warpgroup g holds acc[h][j] at A row 64 g + 16 (t / 32) + (t % 32) / 4
// + 8 ((j / 2) % 2) and cout 128 h + 8 (j / 4) + 2 (t % 4) + j % 2 (the
// layout of wgmma_m64n128k16_rs). K1 (OUT BIAS_MOMENTS): + f32 bias, one
// cast. K6 (OUT an activation): + f32 bias, + the residual the staging
// tile holds at the same place (TMA loaded it in y's layout), the
// activation, one cast, in place.
template <int NH, int OUT>
__device__ __forceinline__ void stage_out(const float (&acc)[NH][64],
                                          unsigned char* out, const ConvArgs& a,
                                          const Tile& tl, int wg, int tid) {
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      const int col = 128 * hh + 8 * g + 2 * (lane % 4);
      const int co = tl.co0 + col;
      const float b0 = (a.bias != nullptr && co < a.Cout) ? __ldg(a.bias + co) : 0.f;
      const float b1 =
          (a.bias != nullptr && co + 1 < a.Cout) ? __ldg(a.bias + co + 1) : 0.f;
      unsigned char* box = out + (col / 64) * (BM * 128) + (col % 8) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 64 * wg + 16 * warp + lane / 4 + 8 * h;
        __nv_bfloat162* p =
            reinterpret_cast<__nv_bfloat162*>(box + sw128_offset(row, (col % 64) / 8));
        float v0 = acc[hh][4 * g + 2 * h] + b0, v1 = acc[hh][4 * g + 2 * h + 1] + b1;
        if constexpr (OUT != BIAS_MOMENTS) {
          if (a.res) {
            const float2 r = __bfloat1622float2(*p);
            v0 += r.x;
            v1 += r.y;
          }
          v0 = act_out<OUT>(v0);
          v1 = act_out<OUT>(v1);
        }
        *p = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// FOLD: a reflected axis's pad rows (columns) added onto rows 1 and n-2
// (columns), in f32, where the tile holds them: rows first, then columns
// (so a corner reaches (1, 1) through both); 32 channels at a time through
// `red` (the source line's pixels by 32 f32, 2.3 KB), between named
// barriers of the consumer threads. Every consumer thread takes the same
// branches (they depend on the tile only).
template <int NH>
__device__ __forceinline__ void fold_tile(float (&acc)[NH][64], float* red, const DgradArgs& a,
                                          const Tile& tl, int wg, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  int py[2], px[2];  // the tile pixels of the thread's two fragment rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 64 * wg + 16 * warp + lane / 4 + 8 * h;
    py[h] = m < TILE_H * TILE_W ? m / TILE_W : -TILE_W;
    px[h] = m < TILE_H * TILE_W ? m % TILE_W : -TILE_W;
  }
#pragma unroll
  for (int f = 0; f < 4; ++f) {  // rows -1 -> 1, n -> n-2, columns -1 -> 1, n -> n-2
    const bool rows = f < 2;
    if (!(rows ? a.fold_h : a.fold_w)) continue;
    const int src = rows ? (f == 0 ? -1 - tl.y0 : a.H - tl.y0)
                         : (f == 2 ? -1 - tl.x0 : a.W - tl.x0);
    if (src < 0 || src >= (rows ? TILE_H : TILE_W)) continue;
    const int dst = f % 2 == 0 ? src + 2 : src - 2;
#pragma unroll
    for (int q = 0; q < 4 * NH; ++q) {  // columns 32 q .. 32 q + 31
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {  // the sources write, the targets add
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int on = rows ? py[h] : px[h], along = rows ? px[h] : py[h];
          if (on != (pass ? dst : src) || along < 0) continue;
#pragma unroll
          for (int gg = 0; gg < 4; ++gg)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& v = acc[q / 4][4 * (4 * (q % 4) + gg) + 2 * h + e];
              float* r = red + along * 32 + 8 * gg + 2 * (lane % 4) + e;
              if (pass) v += *r;
              else *r = v;
            }
        }
        named_barrier(1, CONSUMERS);
      }
    }
  }
}

// DGRAD's epilogue (K2's input gradient with the prologue act(a x + b)):
// the staging tile holds the tile's x (loaded as K6's residual); per value,
// dU rounded once to bf16, pre = a x + b (a multiply and an add, as the
// plain version), dpre = act'(pre) dU, dx = bf16(dpre a) in place; and the
// tile's sums of dpre x and dpre per column over its real pixels, in f32 in
// a fixed order: this thread's two rows, the 8 lanes that share its columns
// (xor shuffles: every lane ends with the same sum), then the 8 consumer
// warps in order through `red`, 64 columns at a time, into the tile's slot
// of dpart. The accumulators hold the sums after the pass.
template <int NH, int ACTD>
__device__ __forceinline__ void stage_dgrad(float (&acc)[NH][64], unsigned char* out,
                                            float* red, const DgradArgs& a, const Tile& tl,
                                            int wg, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  bool real[2];  // the row's pixel lies in the output (a folded axis's pad rows do not)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 64 * wg + 16 * warp + lane / 4 + 8 * h;
    const int y = tl.y0 + m / TILE_W, x = tl.x0 + m % TILE_W;
    real[h] = m < TILE_H * TILE_W && y >= 0 && y < a.H && x >= 0 && x < a.W;
  }
  const float* pa = a.pa + (size_t)tl.n * a.Cout;  // (N, Cout): over the output's channels
  const float* pb = a.pb + (size_t)tl.n * a.Cout;
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      const int col = 128 * hh + 8 * g + 2 * (lane % 4);
      const int co = tl.co0 + col;
      float av[2], bv[2], sa[2] = {0.f, 0.f}, sb[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        av[e] = co + e < a.Cout ? __ldg(pa + co + e) : 0.f;
        bv[e] = co + e < a.Cout ? __ldg(pb + co + e) : 0.f;
      }
      unsigned char* box = out + (col / 64) * (BM * 128) + (col % 8) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 64 * wg + 16 * warp + lane / 4 + 8 * h;
        __nv_bfloat162* p =
            reinterpret_cast<__nv_bfloat162*>(box + sw128_offset(row, (col % 64) / 8));
        const float2 xv = __bfloat1622float2(*p);
        float dx[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float du = __bfloat162float(__float2bfloat16_rn(acc[hh][4 * g + 2 * h + e]));
          const float x = e ? xv.y : xv.x;
          const float pre = __fadd_rn(__fmul_rn(x, av[e]), bv[e]);
          float dpre = du;
          if (ACTD == ACT_RELU) dpre = __fmul_rn(du, pre > 0.f ? 1.f : 0.f);
          if (ACTD == ACT_LRELU) dpre = __fmul_rn(du, pre > 0.f ? 1.f : 0.2f);
          dx[e] = __fmul_rn(dpre, av[e]);
          if (real[h]) {
            sa[e] = __fadd_rn(sa[e], __fmul_rn(dpre, x));
            sb[e] = __fadd_rn(sb[e], dpre);
          }
        }
        *p = __floats2bfloat162_rn(dx[0], dx[1]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        acc[hh][4 * g + e] = sa[e];
        acc[hh][4 * g + 2 + e] = sb[e];
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      float v = acc[hh][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[hh][j] = v;
    }
  const int slot = 4 * wg + warp, ct = 128 * wg + tid;
  const int sp = (tl.y0 - a.oy) / TILE_H * a.tiles_x + (tl.x0 - a.ox) / TILE_W;
#pragma unroll
  for (int q = 0; q < NH * 2; ++q) {  // columns 64 q .. 64 q + 63
    if (lane < 4) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int g = 8 * (q % 2) + r, cl = 8 * r + 2 * lane + e;
          red[slot * 64 + cl] = acc[q / 2][4 * g + e];
          red[(8 + slot) * 64 + cl] = acc[q / 2][4 * g + 2 + e];
        }
    }
    named_barrier(1, CONSUMERS);
    if (ct < 128) {
      const int which = ct / 64, cl = ct % 64, co = tl.co0 + 64 * q + cl;
      float sum = 0.f;
      for (int w = 0; w < 8; ++w) sum += red[(8 * which + w) * 64 + cl];
      if (co < a.Cout)
        a.dpart[((size_t)(which * a.N + tl.n) * a.n_sp + sp) * a.Cout + co] = sum;
    }
    named_barrier(1, CONSUMERS);
  }
}

// The moments of the stored value, read back from the staging tile by
// helper thread h (0 .. 95) of the producer warpgroup, which owns the
// column pairs h and h + 96 of the tile: each tile's sums over its real
// pixels in order (alternate pixels apart, then added), added in the
// block's tile order to running sums that go to part[n][block] (zeroed by
// the wrapper) whenever the image or the cout block changes, and at the end.
template <class G>
struct Moments {
  static constexpr int OWN = (G::BN / 2 + HELPERS - 1) / HELPERS;  // pairs a thread owns
  float sum[OWN][4] = {};  // [pair][sum0, sum1, sq0, sq1]
  int n = -1, co0 = 0;

  __device__ __forceinline__ void flush(const ConvArgs& a, int h) {
    if (n < 0) return;
    const size_t plane = (size_t)a.N * a.n_parts * a.Cout;
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
      const int cp = h + HELPERS * i;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = co0 + 2 * cp + e;
        if (cp >= G::BN / 2 || co >= a.Cout) continue;
        const size_t o = ((size_t)n * a.n_parts + blockIdx.x) * a.Cout + co;
        a.part[o] += sum[i][e];
        a.part[plane + o] += sum[i][2 + e];
        sum[i][e] = sum[i][2 + e] = 0.f;
      }
    }
  }

  __device__ __forceinline__ void add_tile(const unsigned char* out,
                                           const ConvArgs& a, const Tile& tl,
                                           int h) {
    if (tl.n != n || tl.co0 != co0) {
      flush(a, h);
      n = tl.n;
      co0 = tl.co0;
    }
    const int ny = min(TILE_H, a.H - tl.y0), nx = min(TILE_W, a.W - tl.x0);  // real pixels
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
      const int cp = h + HELPERS * i;
      if (cp >= G::BN / 2) continue;
      const int col = 2 * cp;
      const unsigned char* box = out + (col / 64) * (BM * 128) + (col % 8) * 2;
      const int cc = (col % 64) / 8;
      float m[2][4] = {};  // [pixel parity][sum0, sum1, sq0, sq1]
      auto add = [&](float(&mm)[4], int r) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(box + sw128_offset(r, cc)));
        mm[0] += f.x;
        mm[1] += f.y;
        mm[2] += f.x * f.x;
        mm[3] += f.y * f.y;
      };
      for (int ty = 0; ty < ny; ++ty) {
        int tx = 0;
        for (; tx + 1 < nx; tx += 2) {
          add(m[0], ty * TILE_W + tx);
          add(m[1], ty * TILE_W + tx + 1);
        }
        if (tx < nx) add(m[0], ty * TILE_W + tx);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) sum[i][q] += m[0][q] + m[1][q];
    }
  }
};

// FOLD: the staging tile of tile tl into y by helper thread h, 16 bytes (8
// couts of a pixel) at a time, the pixels and couts inside y only.
template <class G>
__device__ __forceinline__ void store_plain(const unsigned char* out, const DgradArgs& a,
                                            const Tile& tl, int h) {
  constexpr int CHUNKS = G::BN / 8;
  for (int q = h; q < TILE_H * TILE_W * CHUNKS; q += HELPERS) {
    const int m = q / CHUNKS, c = q % CHUNKS;
    const int y = tl.y0 + m / TILE_W, x = tl.x0 + m % TILE_W, co = tl.co0 + 8 * c;
    if (y < 0 || y >= a.H || x < 0 || x >= a.W || co >= a.Cout) continue;
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.y) +
                              (((size_t)tl.n * a.H + y) * a.W + x) * a.Cout + co) =
        *reinterpret_cast<const uint4*>(out + (c / 8) * (BM * 128) + sw128_offset(m, c % 8));
  }
}

// The 64-cout boxes of y that tile tl stores (and, in K6, whose residual
// it loads): those that start below Cout.
template <class G>
__device__ __forceinline__ int out_boxes(const Tile& tl, const ConvArgs& a) {
  return min(G::BN / 64, (a.Cout - tl.co0 + 63) / 64);
}

template <int NH, int ACT, int OUT, bool FOLD = false>
__global__ void __launch_bounds__(THREADS, 1)
    conv_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap rowmap,
                    const __grid_constant__ CUtensorMap colmap,
                    const __grid_constant__ CUtensorMap cornermap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap ymap,
                    const __grid_constant__ CUtensorMap rmap,
                    const ArgsOf<FOLD> a) {
  static_assert(OUT < DGRAD || FOLD, "DGRAD's epilogue takes DgradArgs");
  using G = Geom<NH>;
  constexpr int WS = G::W_STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* wst0 = smem;
  unsigned char* out = wst0 + WS * G::W_BYTES;
  unsigned char* box0 = out + G::OUT_BYTES;
  unsigned char* side0 = box0 + IN_STAGES * BOX_STRIDE;
  float* red = reinterpret_cast<float*>(side0 + IN_STAGES * SIDE_BYTES);  // DGRAD, FOLD
  constexpr int RB = red_bytes<OUT, FOLD>();
  uint64_t* in_full = reinterpret_cast<uint64_t*>(side0 + IN_STAGES * SIDE_BYTES + RB);
  uint64_t* in_ready = in_full + IN_STAGES;  // the helpers' prologue is done
  uint64_t* in_empty = in_ready + IN_STAGES;
  uint64_t* w_full = in_empty + IN_STAGES;
  uint64_t* w_empty = w_full + WS;
  uint64_t* out_full = w_empty + WS;  // the staging tile holds a tile
  uint64_t* out_empty = out_full + 1;  // the helpers are done with it
  uint64_t* res_full = out_empty + 1;  // it holds the next tile's residual (K6)
  auto wstage = [&](int s) { return wst0 + s * G::W_BYTES; };
  auto box = [&](int s) { return box0 + s * BOX_STRIDE; };
  auto side = [&](int s) { return side0 + s * SIDE_BYTES; };
  const bool res = OUT != BIAS_MOMENTS && a.res;

  // two rings, each stage with full (the producer's loads have landed) and
  // empty (every consumer warp is done with it: the box after its last
  // ldmatrix, a weight slab after the wgmmas that read it) barriers, the
  // input stages also with ready (the helpers' prologue pass is done); and
  // the staging tile between the consumers and the helpers
  if (threadIdx.x == 0) {
    for (int s = 0; s < IN_STAGES; ++s) {
      mbar_init(&in_full[s], 1);
      mbar_init(&in_ready[s], HELPERS);
      mbar_init(&in_empty[s], CONSUMERS / 32);
    }
    for (int s = 0; s < WS; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], CONSUMERS / 32);
    }
    mbar_init(out_full, CONSUMERS);
    mbar_init(out_empty, HELPERS);
    mbar_init(res_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (wg == 2 && tid >= 32) {
    // the helpers: the prologue pass on each box as it lands, and each
    // tile's store and moments; a tile's epilogue comes after the next
    // tile's first box, which the consumers need first
    const int h = tid - 32;
    Moments<G> mom;
    uint32_t phase = 0, pi = 0;
    int si = 0;
    // K6: tile t's residual into the staging tile, by helper 0. It runs
    // when no helper reads the tile: K6 takes no moments, and helper 0's
    // own store has read the tile before.
    auto load_res = [&](int t) {
      const Tile tl = tile_of<G, FOLD>(t, a);
      const int nb = out_boxes<G>(tl, a);
      mbar_arrive_expect_tx(res_full, nb * OUT_BOX_BYTES);
      for (int j = 0; j < nb; ++j)
        tma_load_4d(out + j * (BM * 128), &rmap, res_full, tl.co0 + 64 * j, tl.x0, tl.y0,
                    tl.n);
    };
    if (res && h == 0) load_res(blockIdx.x);
    auto epilogue = [&](int t) {
      const Tile tl = tile_of<G, FOLD>(t, a);
      mbar_wait(out_full, phase);
      if constexpr (FOLD) {
        // a tile whose grid starts on a pad row (column) of a folded axis:
        // TMA stores take no negative coordinate, so every helper stores it
        if (tl.y0 < 0 || tl.x0 < 0) {
          store_plain<G>(out, a, tl, h);
          fence_proxy_async();  // the reads, before TMA rewrites the tile
          named_barrier(2, HELPERS);
          if (h == 0 && res && t + (int)gridDim.x < a.total) load_res(t + gridDim.x);
          mbar_arrive(out_empty);
          phase ^= 1;
          return;
        }
      }
      if (h == 0) {
        for (int j = 0; j < out_boxes<G>(tl, a); ++j)
          tma_store_4d(&ymap, out + j * (BM * 128), tl.co0 + 64 * j, tl.x0, tl.y0, tl.n);
        bulk_commit();
      }
      if (a.part != nullptr) mom.add_tile(out, a, tl, h);
      if (h == 0) {
        bulk_wait_read<0>();  // the store has read the tile
        if (res && t + (int)gridDim.x < a.total) load_res(t + gridDim.x);
      }
      mbar_arrive(out_empty);
      phase ^= 1;
    };
    int prev = -1;  // the tile whose epilogue is next
    for (int t = blockIdx.x; t < a.total; t += gridDim.x) {
      const Tile tl = tile_of<G, FOLD>(t, a);
      for (int cb = 0; cb < a.n_kc; ++cb) {
        if (ACT != NO_PROLOGUE) {
          mbar_wait(&in_full[si], pi);
          prologue_box<ACT>(box(si), side(si), a, tl, cb, h);
          fence_proxy_async();  // the writes, before TMA rewrites the stage
          mbar_arrive(&in_ready[si]);
          if (++si == IN_STAGES) {
            si = 0;
            pi ^= 1;
          }
        }
        if (cb == 0 && prev >= 0) epilogue(prev);
      }
      prev = t;
    }
    if (prev >= 0) epilogue(prev);
    if (a.part != nullptr) mom.flush(a, h);
    if (h == 0) bulk_wait<0>();  // the last stores are done before the exit
    return;
  }
  if (wg == 2) {  // the producer warp: one thread issues every load
    if (threadIdx.x != PRODUCER) return;
    int si = 0, sw = 0;
    uint32_t pi = 0, pw = 0;
    // channel block cb of tile t: the box, its side rows and columns and
    // corners (TMA counts a zero-filled byte as landed)
    auto issue_box = [&](int t, int cb) {
      const Tile tl = tile_of<G, FOLD>(t, a);
      const Edges e(tl, a);
      mbar_wait(&in_empty[si], pi ^ 1);
      mbar_arrive_expect_tx(&in_full[si], e.bytes());
      const int c0 = cb * KW, xs = box_x(tl, a), ys = box_y(tl, a);
      tma_load_4d(box(si), &xmap, &in_full[si], c0, xs, ys, tl.n);
      unsigned char* sd = side(si);
      for (int i = 0; i < 2; ++i) {
        const int hs = pad_source(i, a.H, a.h_mode), ws = pad_source(i, a.W, a.w_mode);
        if (e.row[i])
          tma_load_4d(sd + i * SROW_BYTES, &rowmap, &in_full[si], c0, xs, hs, tl.n);
        if (e.col[i])
          tma_load_4d(sd + 2 * SROW_BYTES + i * SCOL_BYTES, &colmap, &in_full[si], c0, ws,
                      ys, tl.n);
        for (int j = 0; j < 2; ++j)
          if (e.row[i] && e.col[j])
            tma_load_4d(sd + CORNERS + (2 * i + j) * 128, &cornermap, &in_full[si], c0,
                        pad_source(j, a.W, a.w_mode), hs, tl.n);
      }
      if (++si == IN_STAGES) {
        si = 0;
        pi ^= 1;
      }
    };
    issue_box(blockIdx.x, 0);
    for (int t = blockIdx.x; t < a.total; t += gridDim.x) {
      const Tile tl = tile_of<G, FOLD>(t, a);
      for (int cb = 0; cb < a.n_kc; ++cb) {
        for (int tap = 0; tap < 9; ++tap) {
          if (tap == NEXT_BOX_TAP) {
            if (cb + 1 < a.n_kc) issue_box(t, cb + 1);
            else if (t + gridDim.x < a.total) issue_box(t + gridDim.x, 0);
          }
          mbar_wait(&w_empty[sw], pw ^ 1);
          mbar_arrive_expect_tx(&w_full[sw], G::W_BYTES);
          tma_load_2d(wstage(sw), &wmap, &w_full[sw], 0,
                      (cb * 9 + (a.flip ? 8 - tap : tap)) * a.cout_pad + tl.co0);
          if (++sw == WS) {
            sw = 0;
            pw ^= 1;
          }
        }
      }
    }
    return;
  }

  // the two consumer warpgroups: a box is theirs once it has landed or,
  // with a prologue, once the helpers have passed over it
  uint64_t* in_have = ACT == NO_PROLOGUE ? in_full : in_ready;
  const int lane = tid % 32;
  float acc[NH][64];
  uint32_t f[G::NB][4];  // A fragments of the groups in flight and the next
  int si = 0, sw = 0, rel = 0;
  uint32_t pi = 0, pw = 0, out_phase = 0;
  // this lane's ldmatrix row: A row m, tile pixel (ty, tx); the rows past
  // the tile's pixels read pixel 0 (their sums are never stored)
  int m = 64 * wg + 16 * (tid / 32) + (tid & 15);
  m = m < TILE_H * TILE_W ? m : 0;
  const int ty = m / TILE_W, tx = m % TILE_W;
  for (int t = blockIdx.x; t < a.total; t += gridDim.x) {
    const Tile tl = tile_of<G, FOLD>(t, a);
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[h][j] = 0.f;

    // The k16 steps of the tile: per channel block, step j (tap j / 4, 16
    // channels from 16 (j % 4)). prepare(j) loads step j's fragment: at a
    // block's first step it waits for the box, at a tap's first it places
    // the lane (the side buffers only on an edge tile), and after the
    // block's last ldmatrix it releases the box's stage.
    const bool edge = Edges(tl, a).any();
    AFrag r;
    auto prepare = [&](uint32_t (&q)[4], int j) {
      if (j == 0) mbar_wait(&in_have[si], pi);
      if (j % 4 == 0) r = frag_setup(box(si), side(si), a, tl, edge, ty, tx, j / 4);
      load_frag(q, r, j % 4, lane);
      if (j == STEPS - 1) {
        if (lane == 0) mbar_arrive(&in_empty[si]);
        if (++si == IN_STAGES) {
          si = 0;
          pi ^= 1;
        }
      }
    };
    auto release_slab = [&]() {
      if (lane == 0) mbar_arrive(&w_empty[rel]);
      if (++rel == WS) rel = 0;
    };
    // Step j: B from its weight slab (couts 0 .. BN - 1 in one wgmma), A
    // from registers, one commit group; DEPTH steps stay in flight while the
    // next step's fragment loads. Unrolled over a channel block (36 steps,
    // a multiple of the NB fragment buffers), so the box, tap and slab
    // positions are constants. The wgmmas sit on no branch (ptxas
    // serializes wgmmas on divergent paths).
    constexpr int DEPTH = G::DEPTH, NB = G::NB;
    static_assert(STEPS % NB == 0, "a channel block's steps cycle the fragment buffers");
    prepare(f[0], 0);
    for (int cb = 0; cb < a.n_kc; ++cb) {
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        const int ks = j % 4;
        if (ks == 0) mbar_wait(&w_full[sw], pw);
        const uint64_t db = sw128_desc(wstage(sw)) + 2 * ks;
        wgmma_fence();
        if constexpr (NH == 2)
          wgmma_m64n256k16_rs(reinterpret_cast<float(&)[128]>(acc), f[j % NB], db);
        else
          wgmma_m64n128k16_rs(acc[0], f[j % NB], db);
        wgmma_commit();
        if (ks == 3 && ++sw == WS) {
          sw = 0;
          pw ^= 1;
        }
        // step j - DEPTH is done: its fragment and, at a tap's end, its slab
        wgmma_wait<DEPTH>();
        if ((j + 4 - DEPTH) % 4 == 3 && (cb > 0 || j >= DEPTH)) release_slab();
        if (j + 1 < STEPS) prepare(f[(j + 1) % NB], j + 1);
        else if (cb + 1 < a.n_kc) prepare(f[0], 0);
      }
    }
    wgmma_wait<0>();
    release_slab();

    // epilogue: once the helpers are done with the previous tile (and, in
    // K6, the tile's residual has landed in its place), into the staging
    // tile; the helpers store it (and take its moments) while the next
    // tile's k16 steps run
    mbar_wait(out_empty, out_phase ^ 1);
    if (res) mbar_wait(res_full, out_phase);
    if constexpr (FOLD) fold_tile<NH>(acc, red, a, tl, wg, tid);
    if constexpr (OUT >= DGRAD)
      stage_dgrad<NH, OUT - DGRAD>(acc, out, red, a, tl, wg, tid);
    else
      stage_out<NH, OUT>(acc, out, a, tl, wg, tid);
    fence_proxy_async();  // the writes, before the TMA store reads them
    mbar_arrive(out_full);
    out_phase ^= 1;
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// A launch of conv_tma_kernel: x (N, Hin, Win, C) bf16 with C % 8 == 0, y
// (N, H, W, Cout) bf16 with Cout % 8 == 0, the residual like y or null,
// all 16-byte aligned; wp the packed weight (9 n_kc, cout_pad, 64) bf16,
// cout_pad Cout rounded up to 128 NH; pa and pb (N, 64 n_kc) zero past C,
// 16-byte aligned, or both null; part (2, N, blocks, Cout) zeroed, or
// null. Output pixel (oy, ox)'s tap (dy, dx) reads input (oy + y_off + dy,
// ox + x_off + dx): zero outside the input, unless h_mode / w_mode reflect
// or wrap a pad of 1 (then Hin == H, Win == W, y_off / x_off -1).
struct ConvShape {
  const void* x;
  const void* wp;
  const void* res;
  void* y;
  const float* bias;
  const float* pa;
  const float* pb;
  float* part;
  int N, H, W, Hin, Win, C, Cout;
  int y_off, x_off, h_mode, w_mode, flip;
  int blocks;  // the persistent grid's blocks at most (the card's SMs)
  int fold_h = 0, fold_w = 0;  // K2's input gradient: the forward reflected H / W
  float* dpart = nullptr;      // DGRAD: the tiles' sums of dpre x and dpre
};

// The tensor maps (x; its side row, column and corner; w; y; the residual)
// and the arguments of a launch, and its grid.
template <int NH, class A>
cudaError_t prepare(const ConvShape& s, CUtensorMap (&maps)[N_MAPS], A* out, int* grid) {
  using G = Geom<NH>;
  A a;
  a.bias = s.bias;
  a.pa = s.pa;
  a.pb = s.pb;
  a.part = s.part;
  a.N = s.N;
  a.H = s.H;
  a.W = s.W;
  a.Hin = s.Hin;
  a.Win = s.Win;
  a.Cout = s.Cout;
  a.cout_pad = ceil_div(s.Cout, G::BN) * G::BN;
  a.y_off = s.y_off;
  a.x_off = s.x_off;
  int oy = 0, ox = 0, tiles_y = 0;
  tile_grid(s.H, TILE_H, s.fold_h, &oy, &tiles_y);
  tile_grid(s.W, TILE_W, s.fold_w, &ox, &a.tiles_x);
  a.n_sp = tiles_y * a.tiles_x;
  a.n_cb = a.cout_pad / G::BN;
  a.total = a.n_sp * s.N * a.n_cb;
  a.n_parts = s.blocks;
  a.n_kc = ceil_div(s.C, KW);
  a.cs = a.n_kc * KW;
  a.h_mode = s.h_mode;
  a.w_mode = s.w_mode;
  a.flip = s.flip;
  a.res = s.res != nullptr;
  if constexpr (std::is_same<A, DgradArgs>::value) {
    a.fold_h = s.fold_h;
    a.fold_w = s.fold_w;
    a.oy = oy;
    a.ox = ox;
    a.y = s.y;
    a.dpart = s.dpart;
  } else if (s.fold_h || s.fold_w || s.dpart != nullptr) {
    return cudaErrorInvalidValue;  // folds and DGRAD take DgradArgs
  }
  auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (s.C % 8 != 0 || s.Cout % 8 != 0 || s.blocks < 1 || s.H < 1 || s.W < 1 ||
      misaligned(s.x) || misaligned(s.wp) || misaligned(s.y) || misaligned(s.res) ||
      misaligned(s.pa) || misaligned(s.pb) || (s.pa == nullptr) != (s.pb == nullptr))
    return cudaErrorInvalidValue;

  // x (N, Hin, Win, C), the packed weight, y and the residual (N, H, W,
  // Cout), innermost first
  const cuuint64_t px = 2ull * s.C;  // bytes per input pixel
  const cuuint64_t xdims[4] = {(cuuint64_t)s.C, (cuuint64_t)s.Win, (cuuint64_t)s.Hin,
                               (cuuint64_t)s.N};
  const cuuint64_t xstrides[3] = {px, px * s.Win, px * s.Win * s.Hin};
  const cuuint32_t boxes[4][4] = {{KW, BOX_W, BOX_H, 1},  // the tile and its halo
                                  {KW, BOX_W, 1, 1},       // a pad row
                                  {KW, 1, BOX_H, 1},       // a pad column
                                  {KW, 1, 1, 1}};          // a corner
  const cuuint64_t wdims[2] = {KW, (cuuint64_t)9 * a.n_kc * a.cout_pad};
  const cuuint64_t wstrides[1] = {KW * 2};
  const cuuint32_t wbox[2] = {KW, G::BN};
  const cuuint64_t py = 2ull * s.Cout;  // bytes per output pixel
  const cuuint64_t ydims[4] = {(cuuint64_t)s.Cout, (cuuint64_t)s.W, (cuuint64_t)s.H,
                               (cuuint64_t)s.N};
  const cuuint64_t ystrides[3] = {py, py * s.W, py * s.W * s.H};
  const cuuint32_t ybox[4] = {KW, TILE_W, TILE_H, 1};
  // a side map only where that pad holds data, the residual's only with one:
  // the kernel reads no other (each encode is host time a launch)
  const bool hd = s.h_mode == PAD_REFLECT || s.h_mode == PAD_WRAP;
  const bool wd = s.w_mode == PAD_REFLECT || s.w_mode == PAD_WRAP;
  const bool need[N_MAPS] = {true, hd, wd, hd && wd, true, true, s.res != nullptr};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < N_MAPS && err == cudaSuccess; ++i) {
    if (!need[i]) {
      maps[i] = CUtensorMap{};
      continue;
    }
    if (i < 4) err = encode_bf16_map(&maps[i], s.x, 4, xdims, xstrides, boxes[i], i == 0);
    else if (i == 4) err = encode_bf16_map(&maps[4], s.wp, 2, wdims, wstrides, wbox, true);
    else err = encode_bf16_map(&maps[i], i == 5 ? s.y : s.res, 4, ydims, ystrides, ybox, true);
  }
  if (err != cudaSuccess) return err;
  *out = a;
  *grid = a.total < s.blocks ? a.total : s.blocks;
  return cudaSuccess;
}

template <int NH, int ACT, int OUT, bool FOLD = false>
cudaError_t launch_conv(const CUtensorMap (&maps)[N_MAPS], const ArgsOf<FOLD>& a, int grid,
                        cudaStream_t stream) {
  constexpr int SMEM = Geom<NH>::SMEM + red_bytes<OUT, FOLD>();
  cudaError_t err = cudaFuncSetAttribute(conv_tma_kernel<NH, ACT, OUT, FOLD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  conv_tma_kernel<NH, ACT, OUT, FOLD><<<grid, THREADS, SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], a);
  return cudaGetLastError();
}

}  // namespace conv_tma
}  // namespace port
