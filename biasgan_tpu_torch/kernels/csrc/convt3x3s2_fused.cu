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
// bf16 traffic (tensor cores, 0.039 ms at peak); up1 (1, 362, 720, 128) ->
// (1, 724, 1440, 64) is 38.4 GFLOP against 200 MB (memory, 0.060 ms). The
// f32 kernel (below), which exists for checking, is a direct CUDA-core loop.
//
// The transposed conv has four output phases, each a dense product of the
// undilated input (y[2i - 1 + ky, 2j - 1 + kx] += x[i, j] W[ky, kx]):
//   out(2m,   2j)   = W11 x(m, j)
//   out(2m,   2j+1) = W10 x(m, j+1) + W12 x(m, j)
//   out(2m+1, 2j)   = W01 x(m+1, j) + W21 x(m, j)
//   out(2m+1, 2j+1) = W00 x(m+1, j+1) + W02 x(m+1, j) + W20 x(m, j+1)
//                     + W22 x(m, j)
// The halo is one bottom row (zero, the H pad) and one right column (column
// 0 under wrap, else zero). The Pallas kernel merges the column phases onto
// the channel axis, multiplies their zero half-blocks, and emits even- and
// odd-row tensors for Mosaic's DMA rules; here each phase's pixels go
// straight to their (2m+py, 2j+px) places in the NHWC output.
//
// The bf16 kernel (up_tma_kernel) is an implicit GEMM on Hopper's machinery
// (TMA, mbarriers, wgmma, a persistent grid), built like K1's tile loop
// (conv3x3_tma.cuh), whose lessons it keeps:
//   * GEMM: M = the 7 x 18 input pixels of a tile (126 of 128 A rows, two
//     consumer warpgroups of 64), N = the four output phases x 64 couts =
//     256 (128 f32 accumulators a thread), K = 64-channel blocks. The
//     accumulator columns are the phases [ee | eo | oo | oe], so each of the
//     four shifted inputs feeds one contiguous N range and nothing is
//     multiplied by a zero block (9 x 64 columns a k16 step, not the 12 x 64
//     of the Pallas kernel's merged phases):
//       tap 0, x(m, j):         ee eo oo oe  W11 W12 W22 W21  n256, acc 0..127
//       tap 1, x(m, j + 1):        eo oo     W10 W20          n128, acc 32..95
//       tap 2, x(m + 1, j):           oo oe  W02 W01          n128, acc 64..127
//       tap 3, x(m + 1, j + 1):       oo     W00              n64,  acc 64..95
//     7 x 18 is chosen for the grid's rounds on 132 SMs, as K1's: up0 has
//     26 x 20 tiles x 2 cout blocks = 1040 units, 8 rounds (4 x 32 or 8 x
//     16: 1104 or 1058, 9 rounds); up1 52 x 40 = 2080, 16 (as the others).
//   * Loads, by one producer thread: per (unit, channel block) one TMA box
//     (8 x 19 pixels x 64 channels, 128-byte swizzle) of the tile, its
//     bottom row and its right column; the four A operands are ldmatrix
//     row offsets into it. TMA's zero fill gives the bottom H pad, the zero
//     W pad, the ragged tiles and the channels past C. Under wrap, the
//     right column of the last tile column is column 0: a side box of it
//     (8 x 1, unswizzled), where a lane whose row is column W points
//     ldmatrix instead. The weight, packed by the wrapper into K-major
//     slabs per (cout block, channel block) of 256, 128, 128 and 64 rows
//     (kernels/convt3x3s2_fused.py::pack_up_weight), comes as 64-row TMA
//     boxes into a buffer per slab: two for tap 0's 32 KB slab, one each
//     for the others (104 KB). So every slab has the time of the next
//     three taps to land (a ring of three 32 KB stages would give tap 0's
//     slab only that of taps 2 and 3, a third of it).
//   * The prologue (up1), by the three helper warps of the producer
//     warpgroup, once per staged element as each box lands, in place:
//     act(a x + b) in f32, one rounding, 0 where TMA zero-filled (never
//     act(b)); the consumers take a box once the helpers' ready barrier says
//     so (K1: in the consumers' registers it cost a third of the kernel).
//   * Products: per k16 step one wgmma from registers (A by ldmatrix, B
//     through its descriptor) on the tap's accumulator range, the loop
//     unrolled over a channel block's 16 steps (4 taps x 4) so every
//     position is a constant, the wgmmas on no branch. ptxas serializes the
//     wgmmas all the same (C7511: the taps' accumulator ranges overlap in
//     part; all on the full range it reports C7512, as for K1's loop, and
//     setmaxnreg is ignored, C7507, since the helpers need their
//     registers), so two steps in flight or one ran alike (throwaway chip
//     probes on an H100): the two consumer warpgroups keep the tensor
//     cores fed between each other's waits.
//   * Epilogue: the accumulators start at the f32 bias; one cast into a
//     128-byte-swizzled staging tile of the 14 x 36 output pixels x 64
//     couts, the phases interleaved there; a helper warp stores it by TMA
//     (one box, which clips the ragged edge), and the helpers read the
//     stored values back for the moments, 16 bytes (8 couts) of a pixel at
//     a time, summed by shuffles and across their three warps in a fixed
//     order, and kept as running sums that go to the block's slot of part
//     (zeroed by the launch) when the image or the cout block changes;
//     launch_reduce_moments sums the slots in a fixed order: deterministic,
//     no float atomics. The helpers take a unit's epilogue after the next
//     unit's first two boxes, which the consumers need first. A block's
//     walk may cross into the next image (batch > 1 with more units than
//     SMs): a and b and the moment slot are read per unit's image. The
//     epilogue and the helpers are kept short because the consumers wait
//     on them (throwaway chip probes on an H100; PERF.md): a bias added in
//     the epilogue, staging addresses that the compiler hoisted out of the
//     unit loop and spilled, and moments added into part in device memory
//     after every unit (every helper waiting on the read) each cost more
//     than the helpers' prologue.
//   * Shared memory: 104 KB of weight buffers + 63 KB staging + 2 x 19 KB
//     boxes + 2 x 1 KB side columns + barriers and sums + 1 KB alignment =
//     214,672 of 232,448 bytes.
// TMA needs 16-byte strides and addresses: C % 8 == 0, Cout % 8 == 0, x and
// y 16-byte aligned (the wrapper pads C and Cout, and raises for a
// misaligned x); a and b come as (N, C rounded up to 64), zero past C.
//
// Interface: plain C, loaded with ctypes; launches go on the caller's stream
// and the function returns the cudaError_t of the launches (0 = ok).

#include "conv3x3_tma.cuh"

namespace {

using namespace port;
using namespace port::sm90;
using port::conv_tma::AFrag;
using port::conv_tma::ceil_div;
using port::conv_tma::load_frag;

constexpr int KW = 64;  // input channels per channel block (128 bytes)
constexpr int TH = 7, TW = 18;  // a tile's input pixels: 126 of its A rows
constexpr int BOX_H = TH + 1, BOX_W = TW + 1;  // and its bottom row and right column
constexpr int BOX_BYTES = BOX_H * BOX_W * 128;
constexpr int BOX_STRIDE = (BOX_BYTES + 1023) / 1024 * 1024;  // the swizzle's alignment
constexpr int SIDE_BYTES = BOX_H * 128;  // the wrap column
constexpr int SIDE_STRIDE = 1024;
constexpr int OUT_H = 2 * TH, OUT_W = 2 * TW;  // a tile's output pixels
constexpr int OUT_BYTES = OUT_H * OUT_W * 128;  // by 64 couts
constexpr int BN = 64;  // couts of a unit, by the 4 phases: 256 accumulator columns
constexpr int SLAB_ROWS = 9 * BN;  // packed rows per (cout block, channel block)
constexpr int STEPS = 4 * KW / 16;  // k16 steps per channel block: 4 taps x 4
constexpr int DEPTH = 2;  // wgmma commit groups (k16 steps) let in flight
constexpr int NB = 4;  // A fragment buffers (a divisor of STEPS above DEPTH)
constexpr int IN_STAGES = 2;
constexpr int W_BUFS = 5;  // two for tap 0's slab, one for each other tap's
constexpr int W_BYTES = (2 * 256 + 128 + 128 + 64) * 128;
constexpr int CONSUMERS = 256;  // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and one producer warpgroup
constexpr int PRODUCER = CONSUMERS;  // the thread that issues the loads
constexpr int HELPERS = 96;  // warps 1-3 of the producer warpgroup: prologue, epilogues
constexpr int SUM_WARPS = HELPERS / 32;
constexpr int SUMS_BYTES = SUM_WARPS * 8 * 16 * 4;  // [warp][chunk][8 sums, 8 sums of squares]
constexpr int BARRIERS = 3 * IN_STAGES + 2 * W_BUFS + 2;
constexpr int SMEM = 1024 + W_BYTES + OUT_BYTES + IN_STAGES * (BOX_STRIDE + SIDE_STRIDE) +
                     SUMS_BYTES + BARRIERS * 8;
constexpr int NO_PROLOGUE = -1;  // the kernel's ACT without a prologue
constexpr int HELPER_BAR = 1;  // the helpers' named barrier
static_assert(SMEM <= 232448, "shared memory");
static_assert(STEPS % NB == 0 && DEPTH < NB && DEPTH < 4, "fragment buffers and releases");
static_assert(HELPERS % 8 == 0, "a helper takes one chunk column of the box");

// Tap t: the input shifted by (sy, sx); its slab's rows (N) and first row
// in the pack; the first accumulator register it adds into (the layout of
// wgmma_m64n256k16_rs: 4 registers per 8 columns).
__host__ __device__ constexpr int tap_sy(int t) { return t >= 2; }
__host__ __device__ constexpr int tap_sx(int t) { return t == 1 || t == 3; }
__host__ __device__ constexpr int tap_n(int t) { return t == 0 ? 256 : (t == 3 ? 64 : 128); }
__host__ __device__ constexpr int tap_row(int t) { return t == 0 ? 0 : 128 + 128 * t; }
__host__ __device__ constexpr int tap_acc(int t) { return t == 0 ? 0 : (t == 1 ? 32 : 64); }
// the weight buffer of tap t's slab at the g-th channel block of a block's
// walk, the parity of its barriers' phase, and its place in shared memory
__device__ __forceinline__ int w_buf(int t, int g) { return t == 0 ? (g & 1) : t + 1; }
__device__ __forceinline__ uint32_t w_parity(int t, int g) {
  return t == 0 ? (g >> 1) & 1 : g & 1;
}
__host__ __device__ constexpr int w_offset(int b) {
  return b < 2 ? b * 256 * 128 : 2 * 256 * 128 + (b - 2) * 128 * 128;
}

struct UpArgs {
  const float* bias;  // (Cout) or null
  const float* pa;    // (N, cs), zero past C, 16-byte aligned, or null
  const float* pb;
  float* part;        // (2, N, n_parts, Cout), zeroed, or null
  int N, H, W, Cout;  // the input's H, W; the output's Cout
  int tiles_x, n_sp, n_cob, total;  // tiles per tile row, per image; cout blocks
  int n_parts;                      // moment slots per image: at least the grid
  int n_kc, cs;                     // channel blocks; a and b per image
  int wrap;                         // W periodic: the right column is column 0
};

struct Tile {
  int n, y0, x0, co0;
};

// Unit t: its cout block first, so that the cout blocks of one pixel tile
// run together and read the same boxes while L2 still holds them.
__device__ __forceinline__ Tile tile_of(int t, const UpArgs& a) {
  Tile r;
  r.co0 = (t % a.n_cob) * BN;
  const int p = t / a.n_cob;
  const int sp = p % a.n_sp;
  r.n = p / a.n_sp;
  r.y0 = (sp / a.tiles_x) * TH;
  r.x0 = (sp % a.tiles_x) * TW;
  return r;
}

// The tile's box holds column W (the last tile column), which under wrap
// is column 0: its side load.
__device__ __forceinline__ bool wrap_tile(const Tile& tl, const UpArgs& a) {
  return a.wrap && tl.x0 + TW >= a.W;
}

// The prologue's a and b of channel block cb of unit tl for helper thread
// h, which takes chunk h % 8 (8 channels) of every twelfth row of the box:
// loaded before the box has landed, so their latency hides in the wait.
struct Scales {
  float4 a0, a1, b0, b1;
};
__device__ __forceinline__ Scales load_scales(const UpArgs& a, const Tile& tl, int cb, int h) {
  const size_t c0 = (size_t)tl.n * a.cs + cb * KW + 8 * (h % 8);
  const float4* pa = reinterpret_cast<const float4*>(a.pa + c0);
  const float4* pb = reinterpret_cast<const float4*>(a.pb + c0);
  return {__ldg(pa), __ldg(pa + 1), __ldg(pb), __ldg(pb + 1)};
}

// The prologue on a box as it landed, by helper thread h: the box
// (swizzled; a row holds data where its pixel lies in the input) and, on a
// wrap tile, the side column (column 0 of the box's rows); act(a x + b) on
// the 8 channels of chunk h % 8 in place where the row holds input data
// (one FMA, f32 a and b, one rounding), 0 where TMA zero-filled it.
template <int ACT>
__device__ __forceinline__ void prologue_box(unsigned char* box, unsigned char* side,
                                             const UpArgs& a, const Tile& tl, const Scales& sc,
                                             int h) {
  constexpr int ROWS = HELPERS / 8;  // rows in a pass
  const int cc = h % 8;
  auto chunk = [&](unsigned char* p, bool real) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (real) {
      v = *reinterpret_cast<const uint4*>(p);
      v.x = affine_act_bf16x2<ACT>(v.x, sc.a0.x, sc.b0.x, sc.a0.y, sc.b0.y);
      v.y = affine_act_bf16x2<ACT>(v.y, sc.a0.z, sc.b0.z, sc.a0.w, sc.b0.w);
      v.z = affine_act_bf16x2<ACT>(v.z, sc.a1.x, sc.b1.x, sc.a1.y, sc.b1.y);
      v.w = affine_act_bf16x2<ACT>(v.w, sc.a1.z, sc.b1.z, sc.a1.w, sc.b1.w);
    }
    *reinterpret_cast<uint4*>(p) = v;
  };
  for (int row = h / 8; row < BOX_H * BOX_W; row += ROWS)
    chunk(box + sw128_offset(row, cc),
          tl.y0 + row / BOX_W < a.H && tl.x0 + row % BOX_W < a.W);
  if (wrap_tile(tl, a))
    for (int row = h / 8; row < BOX_H; row += ROWS)
      chunk(side + row * 128 + cc * 16, tl.y0 + row < a.H);
}

// Where a lane's ldmatrix row lies at tap t: in the box, or in the side
// column where its shifted pixel is column W of a wrap tile.
__device__ __forceinline__ AFrag frag_setup(const unsigned char* box,
                                            const unsigned char* side, bool wrap,
                                            const UpArgs& a, const Tile& tl, int ty, int tx,
                                            int t) {
  const int br = ty + tap_sy(t), bc = tx + tap_sx(t);  // the box row and column
  AFrag r;
  if (wrap && tl.x0 + bc == a.W) {
    r.row_at = side + br * 128;
    r.sw = -1;
  } else {
    const int row = br * BOX_W + bc;
    r.row_at = box + row * 128;
    r.sw = row & 7;
  }
  return r;
}

// One cast into the output staging tile (the 14 x 36 output pixels of the
// tile by 64 couts, 128-byte swizzled, as the y tensor map stores them;
// the f32 bias is where the accumulators started): thread t of warpgroup g
// holds acc[4 q + 2 h + e] at A row 64 g + 16 (t / 32) + (t % 32) / 4 +
// 8 h, accumulator column 8 q + 2 (t % 4) + e (wgmma_m64n256k16_rs's
// layout): phase q / 8 of [ee | eo | oo | oe], cout 8 (q % 8) + 2 (t % 4)
// + e. A row is input pixel (ty, tx) of the tile; phase (py, px) puts it at
// output pixel (2 ty + py, 2 tx + px). The addresses are 32-bit ones in
// shared memory, from a base the caller launders each unit: the same for
// every unit, they were hoisted out of the unit loop and spilled.
__device__ __forceinline__ void stage_out(const float (&acc)[128], uint32_t out, int wg,
                                          int tid) {
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 64 * wg + 16 * warp + lane / 4 + 8 * h;
    if (m >= TH * TW) continue;  // rows past the tile's pixels
    const int base = 2 * (m / TW) * OUT_W + 2 * (m % TW);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int row = base + (p >= 2) * OUT_W + (p == 1 || p == 2);
      const uint32_t at = out + row * 128 + (lane % 4) * 4;
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        const int j = 4 * (8 * p + c8) + 2 * h;
        const __nv_bfloat162 v = __floats2bfloat162_rn(acc[j], acc[j + 1]);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + ((c8 ^ (row & 7)) << 4)),
                     "r"(*reinterpret_cast<const uint32_t*>(&v))
                     : "memory");
      }
    }
  }
}

// The moments of the stored values, read back from the staging tile by the
// helpers: helper h sums chunk h % 8 (8 couts) of every twelfth real output
// pixel from h / 8; the four helpers of a warp that share a chunk add by
// shuffles, the three warps in warp order through shared memory; lane l of
// helper warp 0 keeps the running sums of couts 2 l and 2 l + 1, which go to
// the block's slot part[n][blockIdx.x] (zeroed by the launch; only this
// block adds there, in its walk's order) when the image or the cout block
// changes, and at the end.
struct Moments {
  float sum[2] = {}, sq[2] = {};
  int n = -1, co0 = 0;

  __device__ __forceinline__ void flush(const UpArgs& a, int h) {
    if (n < 0 || h >= 32) return;
    const size_t plane = (size_t)a.N * a.n_parts * a.Cout;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = co0 + 2 * h + e;
      if (co >= a.Cout) continue;
      const size_t o = ((size_t)n * a.n_parts + blockIdx.x) * a.Cout + co;
      a.part[o] += sum[e];
      a.part[plane + o] += sq[e];
      sum[e] = sq[e] = 0.f;
    }
  }

  __device__ __forceinline__ void add_unit(const unsigned char* out, float* sums,
                                           const UpArgs& a, const Tile& tl, int h) {
    if (tl.n != n || tl.co0 != co0) {
      flush(a, h);
      n = tl.n;
      co0 = tl.co0;
    }
    constexpr int GROUPS = HELPERS / 8;  // pixels in a pass
    const int w = h / 32, lane = h % 32, cc = lane % 8;
    const int ny = 2 * min(TH, a.H - tl.y0), nx = 2 * min(TW, a.W - tl.x0);
    float s[8] = {}, q[8] = {};
    int oy = 0, ox = h / 8;  // the pixel's row and column among the real ones
    while (ox >= nx) {
      ox -= nx;
      ++oy;
    }
    while (oy < ny) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(out + sw128_offset(oy * OUT_W + ox, cc));
      const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
        s[2 * i] += f.x;
        s[2 * i + 1] += f.y;
        q[2 * i] += f.x * f.x;
        q[2 * i + 1] += f.y * f.y;
      }
      for (ox += GROUPS; ox >= nx;) {
        ox -= nx;
        ++oy;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int d = 8; d < 32; d <<= 1) {
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], d);
        q[i] += __shfl_xor_sync(0xffffffffu, q[i], d);
      }
    if (lane < 8)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sums[(w * 8 + cc) * 16 + i] = s[i];
        sums[(w * 8 + cc) * 16 + 8 + i] = q[i];
      }
    named_barrier(HELPER_BAR, HELPERS);
    if (w == 0)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 2 * lane + e;  // the cout in the unit
        for (int ww = 0; ww < SUM_WARPS; ++ww) {
          sum[e] += sums[(ww * 8 + k / 8) * 16 + k % 8];
          sq[e] += sums[(ww * 8 + k / 8) * 16 + 8 + k % 8];
        }
      }
    named_barrier(HELPER_BAR, HELPERS);  // the sums are read before the next unit's
  }
};

template <int ACT>
__global__ void __launch_bounds__(THREADS, 1)
    up_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap colmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap ymap, const UpArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* wst = smem;
  unsigned char* out = wst + W_BYTES;
  unsigned char* box0 = out + OUT_BYTES;
  unsigned char* side0 = box0 + IN_STAGES * BOX_STRIDE;
  float* sums = reinterpret_cast<float*>(side0 + IN_STAGES * SIDE_STRIDE);
  uint64_t* in_full = reinterpret_cast<uint64_t*>(sums + SUMS_BYTES / 4);
  uint64_t* in_ready = in_full + IN_STAGES;  // the helpers' prologue is done
  uint64_t* in_empty = in_ready + IN_STAGES;
  uint64_t* w_full = in_empty + IN_STAGES;
  uint64_t* w_empty = w_full + W_BUFS;
  uint64_t* out_full = w_empty + W_BUFS;  // the staging tile holds a unit
  uint64_t* out_empty = out_full + 1;     // the helpers are done with it
  auto box = [&](int s) { return box0 + s * BOX_STRIDE; };
  auto side = [&](int s) { return side0 + s * SIDE_STRIDE; };

  // the input stages with full (the producer's loads have landed), ready
  // (the helpers' prologue pass is done) and empty (every consumer warp's
  // last ldmatrix) barriers; the weight buffers with full and empty (the
  // wgmmas that read it have completed); and the staging tile between the
  // consumers and the helpers
  if (threadIdx.x == 0) {
    for (int s = 0; s < IN_STAGES; ++s) {
      mbar_init(&in_full[s], 1);
      mbar_init(&in_ready[s], HELPERS);
      mbar_init(&in_empty[s], CONSUMERS / 32);
    }
    for (int b = 0; b < W_BUFS; ++b) {
      mbar_init(&w_full[b], 1);
      mbar_init(&w_empty[b], CONSUMERS / 32);
    }
    mbar_init(out_full, CONSUMERS);
    mbar_init(out_empty, HELPERS);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (wg == 2 && tid >= 32) {
    // the helpers: the prologue pass on each box as it lands, and each
    // unit's store and moments
    const int h = tid - 32;
    Moments mom;
    uint32_t phase = 0, pi = 0;
    int si = 0;
    auto epilogue = [&](int t) {
      const Tile tl = tile_of(t, a);
      mbar_wait(out_full, phase);
      if (h == 0) {
        tma_store_4d(&ymap, out, tl.co0, 2 * tl.x0, 2 * tl.y0, tl.n);
        bulk_commit();
      }
      if (a.part != nullptr) mom.add_unit(out, sums, a, tl, h);
      if (h == 0) bulk_wait_read<0>();  // the store has read the tile
      mbar_arrive(out_empty);
      phase ^= 1;
    };
    // a unit's epilogue comes after the next unit's first two boxes, which
    // the consumers need before it
    int prev = -1;  // the unit whose epilogue is next
    for (int t = blockIdx.x; t < a.total; t += gridDim.x) {
      const Tile tl = tile_of(t, a);
      for (int cb = 0; cb < a.n_kc; ++cb) {
        if constexpr (ACT != NO_PROLOGUE) {
          const Scales sc = load_scales(a, tl, cb, h);
          mbar_wait(&in_full[si], pi);
          prologue_box<ACT>(box(si), side(si), a, tl, sc, h);
          fence_proxy_async();  // the writes, before TMA rewrites the stage
          mbar_arrive(&in_ready[si]);
          if (++si == IN_STAGES) {
            si = 0;
            pi ^= 1;
          }
        }
        if (cb == min(1, a.n_kc - 1) && prev >= 0) epilogue(prev);
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
    int si = 0;
    uint32_t pi = 0;
    // channel block cb of unit t: the box and, on a wrap tile, the side
    // column (TMA counts a zero-filled byte as landed)
    auto issue_box = [&](int t, int cb) {
      const Tile tl = tile_of(t, a);
      const bool wr = wrap_tile(tl, a);
      mbar_wait(&in_empty[si], pi ^ 1);
      mbar_arrive_expect_tx(&in_full[si], BOX_BYTES + (wr ? SIDE_BYTES : 0));
      tma_load_4d(box(si), &xmap, &in_full[si], cb * KW, tl.x0, tl.y0, tl.n);
      if (wr) tma_load_4d(side(si), &colmap, &in_full[si], cb * KW, 0, tl.y0, tl.n);
      if (++si == IN_STAGES) {
        si = 0;
        pi ^= 1;
      }
    };
    // tap t's slab of channel block cb of unit tl (the g-th of the walk),
    // as 64-row boxes
    auto issue_slab = [&](int t, const Tile& tl, int cb, int g) {
      const int b = w_buf(t, g);
      mbar_wait(&w_empty[b], w_parity(t, g) ^ 1);
      mbar_arrive_expect_tx(&w_full[b], tap_n(t) * 128);
      const int row = ((tl.co0 / BN) * a.n_kc + cb) * SLAB_ROWS + tap_row(t);
      for (int i = 0; i < tap_n(t) / 64; ++i)
        tma_load_2d(wst + w_offset(b) + i * 64 * 128, &wmap, &w_full[b], 0, row + 64 * i);
    };
    // in the consumers' order; the next box after tap 1's slab, so that
    // its stage's release (the previous block's last ldmatrix) holds up no
    // slab needed sooner
    issue_box(blockIdx.x, 0);
    int g = 0;
    for (int t = blockIdx.x; t < a.total; t += gridDim.x) {
      const Tile tl = tile_of(t, a);
      for (int cb = 0; cb < a.n_kc; ++cb, ++g) {
        issue_slab(0, tl, cb, g);
        issue_slab(1, tl, cb, g);
        if (cb + 1 < a.n_kc) issue_box(t, cb + 1);
        else if (t + (int)gridDim.x < a.total) issue_box(t + gridDim.x, 0);
        issue_slab(2, tl, cb, g);
        issue_slab(3, tl, cb, g);
      }
    }
    return;
  }

  // the two consumer warpgroups: a box is theirs once it has landed or,
  // with a prologue, once the helpers have passed over it
  uint64_t* in_have = ACT == NO_PROLOGUE ? in_full : in_ready;
  const int lane = tid % 32;
  float acc[128];
  uint32_t f[NB][4];  // A fragments of the steps in flight and the next
  int si = 0, g = 0;
  uint32_t pi = 0, out_phase = 0;
  // this lane's ldmatrix row: A row m, tile pixel (ty, tx); the rows past
  // the tile's pixels read pixel 0 (their sums are never stored)
  int m = 64 * wg + 16 * (tid / 32) + (tid & 15);
  m = m < TH * TW ? m : 0;
  const int ty = m / TW, tx = m % TW;
  auto release_slab = [&](int b) {
    if (lane == 0) mbar_arrive(&w_empty[b]);
  };
  for (int t = blockIdx.x; t < a.total; t += gridDim.x) {
    const Tile tl = tile_of(t, a);
    const bool wr = wrap_tile(tl, a);
    {  // the accumulators start at the f32 bias of their couts
      float bv[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int co = tl.co0 + 8 * (i / 2) + 2 * (lane % 4) + i % 2;
        bv[i] = a.bias != nullptr && co < a.Cout ? __ldg(a.bias + co) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 128; ++j) acc[j] = bv[2 * ((j / 4) % 8) + j % 2];
    }

    // The k16 steps of the unit: per channel block, step j (tap j / 4, 16
    // channels from 16 (j % 4)). prepare(j) loads step j's fragment: at a
    // block's first step it waits for the box, at a tap's first it places
    // the lane, and after the block's last ldmatrix it releases the box.
    AFrag r;
    auto prepare = [&](uint32_t (&q)[4], int j) {
      if (j == 0) mbar_wait(&in_have[si], pi);
      if (j % 4 == 0) r = frag_setup(box(si), side(si), wr, a, tl, ty, tx, j / 4);
      load_frag(q, r, j % 4, lane);
      if (j == STEPS - 1) {
        if (lane == 0) mbar_arrive(&in_empty[si]);
        if (++si == IN_STAGES) {
          si = 0;
          pi ^= 1;
        }
      }
    };
    // Step j: B from its tap's slab, A from registers, one wgmma on the
    // tap's accumulator range, one commit group; DEPTH steps stay in
    // flight while the next step's fragment loads. Unrolled over a channel
    // block (16 steps, a multiple of the NB fragment buffers), so the box,
    // tap and accumulator positions are constants. The wgmmas sit on no
    // branch (ptxas serializes wgmmas on divergent paths).
    prepare(f[0], 0);
    for (int cb = 0; cb < a.n_kc; ++cb, ++g) {
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        const int tap = j / 4, ks = j % 4;
        const int b = w_buf(tap, g);
        if (ks == 0) mbar_wait(&w_full[b], w_parity(tap, g));
        const uint64_t db = sw128_desc(wst + w_offset(b)) + 2 * ks;
        wgmma_fence();
        if (tap == 0)
          wgmma_m64n256k16_rs(acc, f[j % NB], db);
        else if (tap == 3)
          wgmma_m64n64k16_rs(*reinterpret_cast<float(*)[32]>(acc + tap_acc(3)), f[j % NB], db,
                             1);
        else
          wgmma_m64n128k16_rs(*reinterpret_cast<float(*)[64]>(acc + tap_acc(tap)), f[j % NB],
                              db);
        wgmma_commit();
        // step j - DEPTH is done: its fragment and, at a tap's last step,
        // its slab (the previous block's tap 3, where j < DEPTH)
        wgmma_wait<DEPTH>();
        const int jd = j - DEPTH;
        if (jd >= 0 && jd % 4 == 3) release_slab(w_buf(jd / 4, g));
        if (jd == -1 && cb > 0) release_slab(w_buf(3, g - 1));
        if (j + 1 < STEPS) prepare(f[(j + 1) % NB], j + 1);
        else if (cb + 1 < a.n_kc) prepare(f[0], 0);
      }
    }
    wgmma_wait<0>();
    release_slab(w_buf(3, g - 1));

    // epilogue: once the helpers are done with the previous unit, into the
    // staging tile; the helpers store it and take its moments while the
    // next unit's k16 steps run
    mbar_wait(out_empty, out_phase ^ 1);
    // the staging addresses are computed here, not held (and spilled)
    // across the loop
    uint32_t out_s = smem_addr(out);
    asm volatile("" : "+r"(out_s));
    stage_out(acc, out_s, wg, tid);
    fence_proxy_async();  // the writes, before the TMA store reads them
    mbar_arrive(out_full);
    out_phase ^= 1;
  }
}

template <int ACT>
cudaError_t launch_up(const CUtensorMap (&maps)[4], const UpArgs& a, int grid,
                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      up_tma_kernel<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  up_tma_kernel<ACT><<<grid, THREADS, SMEM, stream>>>(maps[0], maps[1], maps[2], maps[3], a);
  return cudaGetLastError();
}

// x (N, H, W, C) bf16 with C % 8 == 0, y (N, 2H, 2W, Cout) bf16 with
// Cout % 8 == 0, both 16-byte aligned; wp the packed weight
// (n_cob n_kc 576, 64) bf16 of pack_up_weight (n_cob = Cout / 64 and n_kc =
// C / 64, rounded up), 16-byte aligned; pa and pb (N, 64 n_kc) zero past C,
// 16-byte aligned, or both null; part (2, N, blocks, Cout) zeroed, or null.
cudaError_t launch_tma(const void* x, const void* wp, const float* bias, const float* pa,
                       const float* pb, void* y, float* part, int N, int H, int W, int C,
                       int Cout, int w_mode, int act, int blocks, cudaStream_t stream) {
  UpArgs a;
  a.bias = bias;
  a.pa = pa;
  a.pb = pb;
  a.part = part;
  a.N = N;
  a.H = H;
  a.W = W;
  a.Cout = Cout;
  a.tiles_x = ceil_div(W, TW);
  a.n_sp = ceil_div(H, TH) * a.tiles_x;
  a.n_cob = ceil_div(Cout, BN);
  a.total = a.n_sp * N * a.n_cob;
  a.n_parts = blocks;
  a.n_kc = ceil_div(C, KW);
  a.cs = a.n_kc * KW;
  a.wrap = w_mode == PAD_WRAP;
  auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (C % 8 != 0 || Cout % 8 != 0 || blocks < 1 || H < 1 || W < 1 || misaligned(x) ||
      misaligned(wp) || misaligned(y) || misaligned(pa) || misaligned(pb) ||
      (pa == nullptr) != (pb == nullptr))
    return cudaErrorInvalidValue;

  // x (N, H, W, C) with its box and its side column; the packed weight;
  // y (N, 2H, 2W, Cout); innermost first
  const cuuint64_t px = 2ull * C;  // bytes per input pixel
  const cuuint64_t xdims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t xstrides[3] = {px, px * W, px * W * H};
  const cuuint32_t xbox[4] = {KW, BOX_W, BOX_H, 1};
  const cuuint32_t colbox[4] = {KW, 1, BOX_H, 1};
  const cuuint64_t wdims[2] = {KW, (cuuint64_t)a.n_cob * a.n_kc * SLAB_ROWS};
  const cuuint64_t wstrides[1] = {KW * 2};
  const cuuint32_t wbox[2] = {KW, 64};
  const cuuint64_t py = 2ull * Cout;  // bytes per output pixel
  const cuuint64_t ydims[4] = {(cuuint64_t)Cout, (cuuint64_t)2 * W, (cuuint64_t)2 * H,
                               (cuuint64_t)N};
  const cuuint64_t ystrides[3] = {py, py * 2 * W, py * 4 * W * H};
  const cuuint32_t ybox[4] = {BN, OUT_W, OUT_H, 1};
  CUtensorMap maps[4];
  cudaError_t err = encode_bf16_map(&maps[0], x, 4, xdims, xstrides, xbox, true);
  if (err == cudaSuccess) err = encode_bf16_map(&maps[1], x, 4, xdims, xstrides, colbox, false);
  if (err == cudaSuccess) err = encode_bf16_map(&maps[2], wp, 2, wdims, wstrides, wbox, true);
  if (err == cudaSuccess) err = encode_bf16_map(&maps[3], y, 4, ydims, ystrides, ybox, true);
  if (err != cudaSuccess) return err;
  const int grid = a.total < blocks ? a.total : blocks;
  if (pa == nullptr) return launch_up<NO_PROLOGUE>(maps, a, grid, stream);
  if (act == ACT_RELU) return launch_up<ACT_RELU>(maps, a, grid, stream);
  if (act == ACT_LRELU) return launch_up<ACT_LRELU>(maps, a, grid, stream);
  return launch_up<ACT_NONE>(maps, a, grid, stream);
}

// f32 on the CUDA cores, for checking: warp cg of a block takes couts
// [64 blockIdx.y + 8 cg, +8) of 32 consecutive input pixels (one per lane)
// and writes the 4 output pixels each makes.
constexpr int F32_PIX = 32;
constexpr int F32_NT = 64;
constexpr int F32_NTH = 256;  // 8 warps

__global__ void __launch_bounds__(F32_NTH)
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

}  // namespace

extern "C" {

// The float32 kernel's pixel tiles of an image: the middle dimension of its
// moment partials.
int convt3x3s2_fused_num_tiles(int H, int W) { return (H * W + F32_PIX - 1) / F32_PIX; }

// dtype: 0 = float32, 1 = bfloat16. w_mode: 0 zero, 2 wrap. act: 0 none,
// 1 relu, 2 lrelu (only read with a prologue). x (N, H, W, C) NHWC, y
// (N, 2H, 2W, Cout); bias (Cout) f32 or null; pa, pb f32 or both null;
// part (2, N, n_parts, Cout) and moments (2, N, Cout) f32, or both null.
// float32: w the w9 (9, C, Cout) in x's dtype, tap ky * 3 + kx of the IOHW
// weight; pa, pb (N, C); n_parts convt3x3s2_fused_num_tiles(H, W).
// bfloat16: w the packed weight of pack_up_weight, C and Cout multiples of
// 8, pa and pb (N, 64 n_kc) zero past C, x, w, y, pa and pb 16-byte
// aligned; n_parts the blocks of the persistent grid at most (the card's SM
// count), a slot of part each (zeroed here).
int convt3x3s2_fused_launch(const void* x, const void* w, const void* bias,
                            const void* pa, const void* pb, void* y, void* part,
                            void* moments, int N, int H, int W, int C, int Cout,
                            int n_parts, int dtype, int w_mode, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* fa = static_cast<const float*>(pa);
  const float* fb = static_cast<const float*>(pb);
  float* pp = static_cast<float*>(part);
  if (n_parts < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 1) {
    // the blocks add their sums into their slots
    err = part == nullptr ? cudaSuccess
                          : cudaMemsetAsync(part, 0, sizeof(float) * 2 * N * n_parts * Cout, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_tma(x, w, b, fa, fb, y, pp, N, H, W, C, Cout, w_mode, act, n_parts, s);
  } else if (dtype == 0) {
    const int n_tiles = convt3x3s2_fused_num_tiles(H, W);
    if (n_parts != n_tiles) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid(n_tiles, (Cout + F32_NT - 1) / F32_NT, N);
    up_f32_kernel<<<grid, F32_NTH, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), b, fa, fb,
        static_cast<float*>(y), pp, N, H, W, C, Cout, n_tiles, w_mode, act);
    err = cudaGetLastError();
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  return static_cast<int>(port::launch_reduce_moments(
      pp, static_cast<float*>(moments), N, n_parts, Cout, s));
}

}  // extern "C"
