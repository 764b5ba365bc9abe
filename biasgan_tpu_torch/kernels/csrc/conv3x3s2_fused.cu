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
// 100 MB (~380 FLOP per byte: tensor cores). So the bf16 kernel is a
// Hopper implicit GEMM (TMA, mbarriers, wgmma) that reads the input once
// from device memory; what holds it back on the card is L2-to-SM traffic
// (every tile reloads its weight slabs and its shifted input boxes from L2)
// and the prologue's arithmetic, which the consumer warps run between the
// loads and the wgmmas (PERF.md, K4). The f32 kernel, which exists for
// checking, is a direct CUDA-core loop.
//
// The bf16 kernel (down_tma_kernel), read from the Pallas kernel for what it
// computes. x is taken through its free contiguous phase view
// (N, H/2, 2, W/2, 2C): pair row a, row phase p, pair column b, merged
// channel c' (c' < C the even input column 2b, c' >= C the odd one 2b+1).
// Output pixel (a, b) reads input rows 2a-1 (phase 1, pair row a-1),
// 2a (phase 0, row a) and 2a+1 (phase 1, row a), and input columns 2b-1
// (the odd half of pair column b-1), 2b and 2b+1 (both halves of pair
// column b). So the conv is a GEMM of M = output pixels, N = Cout and
// K = 9C, cut into k-blocks of 64 merged channels: for each row tap dy,
// the "M" blocks cover all 2C channels of pair column b (taps dx 1 and 2)
// and the "N" blocks the odd half of pair column b-1 (tap dx 0), with a
// zero weight on any even channel an N block holds (C % 64 != 0). The
// wrapper packs the weights in that order (kernels/conv3x3s2_fused.py::
// pack_phase_weight): k-block kb is a (Cout_pad, 64) K-major slab.
//   * Tiles: 128 output pixels of one pair row by 128 couts (Cout <= 128,
//     64 f32 accumulators a thread) or by 256 (above, 128 accumulators:
//     Cout 256 reads the input once); the cout blocks of a pixel tile run
//     next to each other. A persistent grid of one block per SM walks the
//     tiles.
//   * Warp roles: one producer thread issues the TMA loads; two consumer
//     warpgroups (64 pixel rows each) build A and run the wgmmas; the three
//     other warps of the producer warpgroup take each finished tile's store
//     and moments while the consumers go on to the next tile.
//   * Loads: per k-block a TMA box of the phase view (64 channels x 128
//     pair columns, 128-byte swizzle) and one of the packed weight (64 x
//     the tile's couts), into a ring of five (128 couts) or three (256)
//     shared-memory stages guarded by full / empty mbarriers. A box shifted
//     one pair column left is a box of its own (a shifted slice of a
//     swizzled box is no valid wgmma start); L2 serves the repeat. TMA's
//     zero fill of out-of-bounds boxes gives the top pad (pair row -1), the
//     zero W pad (pair column -1) and the ragged right tile; in wrap mode
//     the left pad of output column 0 is the odd half of pair column
//     W/2 - 1, loaded as its own unswizzled one-row box into a side buffer.
//   * Prologue, in registers: the consumers take A fragments by ldmatrix
//     from the swizzled stage (a lane whose row is the wrap column points
//     ldmatrix at the side buffer), apply a*x + b (one f32 fused
//     multiply-add, f32 a and b, from a table in shared memory) and the
//     activation, round once to bf16, mask by index every
//     position TMA zero-filled (a pad, a ragged column, a channel past 2C)
//     back to zero, never act(b), and feed wgmma with A from registers.
//     With 128 couts a k-block's four fragments are built while the
//     previous k-block's wgmmas run; with 256, one k16 step ahead. Chosen
//     over a pass in shared memory, which wrote every stage back, needed a
//     proxy fence and a barrier per stage and cost more on the card. A
//     k-block with no prologue takes the same path (ldmatrix only): ptxas
//     serializes wgmmas that sit on divergent branches.
//   * Products: wgmma m64n128k16 (one per 128 couts), bf16 in, f32
//     accumulation; a stage is released when the wgmmas that read it have
//     completed.
//   * Epilogue: f32 bias and one cast into a 128-byte-swizzled staging tile
//     in shared memory; a helper warp stores it by TMA (which clips the
//     ragged tile), and the helpers read the stored values back for the
//     moments, each column pair by one thread in row order, per tile into
//     part (pallas_conv.py:1621-1630); launch_reduce_moments then sums the
//     tiles in a fixed order: deterministic, no float atomics.
// TMA needs 16-byte strides, so C % 8 == 0 and Cout % 8 == 0: the wrapper
// zero-pads C up to it (zero weights and zero prologue a, b, so act(0) adds
// nothing) and Cout likewise (zero weights and bias, sliced off after).
//
// Interface: plain C, loaded with ctypes; launches go on the caller's stream
// and the function returns the cudaError_t of the launches (0 = ok).

#include "common.cuh"

namespace {

using namespace port;
using namespace port::sm90;

constexpr int KW = 64;          // merged channels per k-block (128 bytes)
constexpr int BW = 128;         // a tile: 128 pixels of one pair row
constexpr int BM = BW;          // (a consumer warpgroup takes 64 of them)
constexpr int CONSUMERS = 256;  // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and one producer warpgroup
constexpr int PRODUCER = CONSUMERS;  // the thread that issues the loads
constexpr int HELPERS = 96;  // warps 1-3 of the producer warpgroup: epilogues
constexpr int SCALE_MAX = 1024;  // input channels whose a, b sit in shared memory
constexpr int A_BYTES = BM * 128;
constexpr int SIDE_BYTES = 128;  // the wrap column of one pair row
constexpr int SCALE_BYTES = 2 * SCALE_MAX * 4;

// The tile's couts: NH halves of 128 (one wgmma n128 each). NH 1 (Cout <=
// 128): 64 accumulators a thread, five stages. NH 2: 128 accumulators,
// three stages; Cout 256 reads the input once.
template <int NH>
struct Geom {
  static constexpr int BN = 128 * NH;
  static constexpr int STAGES = NH == 1 ? 5 : 3;
  static constexpr int B_BYTES = BN * 128;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int OUT_BYTES = BM * BN * 2;  // BN / 64 swizzled boxes
  static constexpr int SMEM = 1024 + STAGES * (STAGE_BYTES + SIDE_BYTES) +
                              OUT_BYTES + SCALE_BYTES + (2 * STAGES + 2) * 8;
};

struct DownArgs {
  const float* bias;  // (Cout) or null
  const float* pa;    // (N, C), 16-byte aligned, or null (no prologue)
  const float* pb;
  float* part;        // (2, N, n_parts, Cout), zeroed, or null
  int N, Ho, Wo, C, Cout, cout_pad;
  int tiles_x, n_sp, n_cb, total;  // tiles per row, per image; cout blocks
  int n_parts;                     // moment slots per image: at least the grid
  int nb2, nb_lo, kbw;  // k-blocks: M blocks, first N block, per row tap
  int wrap, act;
};

struct Tile {
  int n, sp, oy0, ox0, co0;
};

// Tile t: its cout block first, so that the cout blocks of one pixel tile
// run together and read the same input while L2 still holds it.
template <class G>
__device__ __forceinline__ Tile tile_of(int t, const DownArgs& a) {
  Tile r;
  r.co0 = (t % a.n_cb) * G::BN;
  const int p = t / a.n_cb;
  r.sp = p % a.n_sp;
  r.n = p / a.n_sp;
  r.oy0 = r.sp / a.tiles_x;
  r.ox0 = (r.sp % a.tiles_x) * BW;
  return r;
}

// k-block kb: row tap dy = kb / kbw; the phase-view plane and pair-row
// offset of that tap; the channel block and the pair-column offset (0 for
// an M block, -1 for an N block). The order is pack_phase_weight's.
struct KBlock {
  int plane, row_off, col_off, cb;
};
__device__ __forceinline__ KBlock kblock_of(int kb, const DownArgs& a) {
  const int dy = kb / a.kbw, j = kb % a.kbw;
  KBlock k;
  k.plane = dy == 1 ? 0 : 1;
  k.row_off = dy == 0 ? -1 : 0;
  k.col_off = j < a.nb2 ? 0 : -1;
  k.cb = j < a.nb2 ? j : a.nb_lo + (j - a.nb2);
  return k;
}

// A fragments in registers for warpgroup wg (A rows 64 wg .. + 63): per
// k-block, where this lane's ldmatrix row lies (in the stage, or in the
// side buffer on the wrap column) and which of this thread's fragment rows
// and channels are real; per k16 step, the fragment itself.
struct AFrag {
  const unsigned char* row_at;  // chunk 0 of this lane's ldmatrix row
  int sw;                       // its swizzle, or -1 in the side buffer
  bool ok0, ok1;                // rows g and g + 8 of the fragment are real
  bool all_c;                   // every channel of the k-block is real
  int c0;                       // merged channel of this thread's registers 0, 1
};

__device__ __forceinline__ AFrag frag_setup(const unsigned char* stage,
                                            const unsigned char* side,
                                            const DownArgs& a, const Tile& tl,
                                            const KBlock& k, bool use_side,
                                            int wg, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  const int first = 64 * wg + 16 * warp;
  const int lrow = first + (lane & 15);
  const bool lside = use_side && tl.ox0 + k.col_off + lrow < 0;
  AFrag r;
  r.row_at = lside ? side : stage + lrow * 128;
  r.sw = lside ? -1 : lrow & 7;
  const int py = tl.oy0 + k.row_off, px = tl.ox0 + k.col_off + first + lane / 4;
  const bool row_in = py >= 0 && py < a.Ho;
  r.ok0 = row_in && px < a.Wo && (px >= 0 || use_side);
  r.ok1 = row_in && px + 8 < a.Wo;
  r.all_c = (k.cb + 1) * KW <= 2 * a.C;
  r.c0 = k.cb * KW + 2 * (lane % 4);
  return r;
}

// The fragment of k16 step ks, ACT the prologue's activation or -1 for
// none: ldmatrix from the stage, then act(a x + b) (sa, sb by input
// channel: merged channel c' takes c' or c' - C), and a position that TMA
// zero-filled (pad, ragged column, channel past 2C) masked back to zero,
// never act(b).
template <int ACT>
__device__ __forceinline__ void load_frag(uint32_t (&f)[4], const AFrag& r,
                                          int ks, const float* sa,
                                          const float* sb, const DownArgs& a,
                                          int lane) {
  const int chunk = 2 * ks + (lane >> 4);
  ldmatrix_x4(f, r.sw < 0 ? r.row_at + chunk * 16
                          : r.row_at + ((chunk ^ r.sw) << 4));
  if (ACT < 0) return;
#pragma unroll
  for (int e = 0; e < 2; ++e) {  // merged channels c, c + 1 then c + 8, c + 9
    const int c = r.c0 + 16 * ks + 8 * e;
    const bool c_ok = r.all_c || c < 2 * a.C;
    const int ci = c < a.C ? c : (c_ok ? c - a.C : 0);  // the input channel
    const float2 fa = *reinterpret_cast<const float2*>(sa + ci);
    const float2 fb = *reinterpret_cast<const float2*>(sb + ci);
    const uint32_t v0 = affine_act_bf16x2<ACT>(f[2 * e], fa.x, fb.x, fa.y, fb.y);
    const uint32_t v1 = affine_act_bf16x2<ACT>(f[2 * e + 1], fa.x, fb.x, fa.y, fb.y);
    f[2 * e] = r.ok0 && c_ok ? v0 : 0u;
    f[2 * e + 1] = r.ok1 && c_ok ? v1 : 0u;
  }
}

// Bias and one cast into the output staging tile (BN / 64 boxes of 64
// couts by BM rows, 128-byte swizzled, as the y tensor map stores them):
// thread t of warpgroup g holds acc[h][j] at A row 64 g + 16 (t / 32) +
// (t % 32) / 4 + 8 ((j / 2) % 2) and cout 128 h + 8 (j / 4) + 2 (t % 4) +
// j % 2 (the layout of wgmma_m64n128k16_rs).
template <int NH>
__device__ __forceinline__ void stage_out(const float (&acc)[NH][64],
                                          unsigned char* out, const DownArgs& a,
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
        const __nv_bfloat162 v = __floats2bfloat162_rn(acc[hh][4 * g + 2 * h] + b0,
                                                       acc[hh][4 * g + 2 * h + 1] + b1);
        *reinterpret_cast<__nv_bfloat162*>(box + sw128_offset(row, (col % 64) / 8)) = v;
      }
    }
  }
}

// The moments of the stored value, read back from the staging tile by
// helper thread h (0 .. 95) of the producer warpgroup, which owns the
// column pairs h and h + 96 of the tile: each tile's sums over its real
// rows in order (even and odd rows apart, then added), added in the block's
// tile order to running sums that go to part[n][block] (zeroed by the
// wrapper) whenever the image or the cout block changes, and at the end.
template <class G>
struct Moments {
  static constexpr int OWN = (G::BN / 2 + HELPERS - 1) / HELPERS;  // pairs a thread owns
  float sum[OWN][4] = {};  // [pair][sum0, sum1, sq0, sq1]
  int n = -1, co0 = 0;

  __device__ __forceinline__ void flush(const DownArgs& a, int h) {
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
                                           const DownArgs& a, const Tile& tl,
                                           int h) {
    if (tl.n != n || tl.co0 != co0) {
      flush(a, h);
      n = tl.n;
      co0 = tl.co0;
    }
    const int nx = min(BW, a.Wo - tl.ox0);  // the real rows: nx columns of one pair row
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
      const int cp = h + HELPERS * i;
      if (cp >= G::BN / 2) continue;
      const int col = 2 * cp;
      const unsigned char* box = out + (col / 64) * (BM * 128) + (col % 8) * 2;
      const int cc = (col % 64) / 8;
      float m[2][4] = {};  // [row parity][sum0, sum1, sq0, sq1]
      auto add = [&](float(&mm)[4], int r) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(box + sw128_offset(r, cc)));
        mm[0] += f.x;
        mm[1] += f.y;
        mm[2] += f.x * f.x;
        mm[3] += f.y * f.y;
      };
      int r = 0;
      for (; r + 1 < nx; r += 2) {
        add(m[0], r);
        add(m[1], r + 1);
      }
      if (r < nx) add(m[0], r);
#pragma unroll
      for (int q = 0; q < 4; ++q) sum[i][q] += m[0][q] + m[1][q];
    }
  }
};

template <int NH>
__global__ void __launch_bounds__(THREADS, 1)
    down_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wrapmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap ymap,
                    const DownArgs a) {
  using G = Geom<NH>;
  constexpr int STAGES = G::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* out = smem + STAGES * G::STAGE_BYTES;
  unsigned char* side0 = out + G::OUT_BYTES;
  float* scale = reinterpret_cast<float*>(side0 + STAGES * SIDE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(scale + 2 * SCALE_MAX);
  uint64_t* empty = full + STAGES;
  uint64_t* out_full = empty + STAGES;  // the staging tile holds a tile
  uint64_t* out_empty = out_full + 1;   // the helpers are done with it
  auto stage_a = [&](int s) { return smem + s * G::STAGE_BYTES; };
  auto stage_b = [&](int s) { return smem + s * G::STAGE_BYTES + A_BYTES; };
  auto side = [&](int s) { return side0 + s * SIDE_BYTES; };

  // the ring: full (the producer's loads have landed), empty (every
  // consumer warp's wgmmas that read the stage have completed); and the
  // staging tile between the consumers and the helpers
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    mbar_init(out_full, CONSUMERS);
    mbar_init(out_empty, HELPERS);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int n_kb = 3 * a.kbw;

  if (wg == 2 && tid >= 32) {  // the helpers: each tile's store and moments
    const int h = tid - 32;
    Moments<G> mom;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < a.total; t += gridDim.x) {
      const Tile tl = tile_of<G>(t, a);
      mbar_wait(out_full, phase);
      if (h == 0) {
        for (int j = 0; j < G::BN / 64 && tl.co0 + 64 * j < a.Cout; ++j)
          tma_store_4d(&ymap, out + j * (BM * 128), tl.co0 + 64 * j, tl.ox0, tl.oy0,
                       tl.n);
        bulk_commit();
      }
      if (a.part != nullptr) mom.add_tile(out, a, tl, h);
      if (h == 0) bulk_wait_read<0>();  // the store has read the tile
      mbar_arrive(out_empty);
      phase ^= 1;
    }
    if (a.part != nullptr) mom.flush(a, h);
    if (h == 0) bulk_wait<0>();  // the last stores are done before the exit
    return;
  }
  if (wg == 2) {  // the producer warp: one thread issues every load
    if (threadIdx.x != PRODUCER) return;
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < a.total; t += gridDim.x) {
      const Tile tl = tile_of<G>(t, a);
      const bool wrap_tile = a.wrap && tl.ox0 == 0;
      for (int kb = 0; kb < n_kb; ++kb) {
        const KBlock k = kblock_of(kb, a);
        const bool use_side = wrap_tile && k.col_off < 0;
        const int py = tl.oy0 + k.row_off;
        mbar_wait(&empty[s], phase ^ 1);
        mbar_arrive_expect_tx(&full[s], G::STAGE_BYTES + (use_side ? SIDE_BYTES : 0));
        tma_load_5d(stage_a(s), &xmap, &full[s], k.cb * KW, tl.ox0 + k.col_off,
                    k.plane, py, tl.n);
        tma_load_2d(stage_b(s), &wmap, &full[s], 0, kb * a.cout_pad + tl.co0);
        if (use_side)
          tma_load_5d(side(s), &wrapmap, &full[s], k.cb * KW, a.Wo - 1, k.plane, py,
                      tl.n);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the two consumer warpgroups
  const int t256 = threadIdx.x;
  const bool pro = a.pa != nullptr;
  const bool table = pro && a.C <= SCALE_MAX;
  float acc[NH][64];
  uint32_t f[2][KW / 16][4];  // A fragments: two k-blocks (NH 1), two steps (NH 2)
  int s = 0, prev = 0, table_n = -1;
  uint32_t phase = 0, out_phase = 0;
  for (int t = blockIdx.x; t < a.total; t += gridDim.x) {
    const Tile tl = tile_of<G>(t, a);
    const bool wrap_tile = a.wrap && tl.ox0 == 0;
    // this image's prologue a and b, in shared memory where they fit
    const float* sa = pro ? a.pa + (size_t)tl.n * a.C : nullptr;
    const float* sb = pro ? a.pb + (size_t)tl.n * a.C : nullptr;
    if (table) {
      if (tl.n != table_n) {
        // a new image: both warpgroups first leave the last tile's
        // fragments, which read the old image's a and b (a warpgroup may
        // run a tile ahead of the other), then rewrite the table, then
        // read it only after every write
        named_barrier(3, CONSUMERS);
        for (int c = t256; c < a.C; c += CONSUMERS) {
          scale[c] = sa[c];
          scale[SCALE_MAX + c] = sb[c];
        }
        table_n = tl.n;
        named_barrier(3, CONSUMERS);
      }
      sa = scale;
      sb = scale + SCALE_MAX;
    }
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[h][j] = 0.f;
    // One k-block: A from registers, B from the stage. The wgmmas sit on no
    // branch (ptxas serializes wgmmas on divergent paths), so a k-block
    // without a prologue takes A by ldmatrix too. NH 1: the k-block's four
    // fragments, built while the previous k-block's wgmmas run (the other
    // set of f), one commit group, at most two in flight. NH 2 (128 more
    // accumulators): a step at a time, the next built while this one's two
    // wgmmas run, the k-block complete at its end.
    auto step = [&](uint32_t (&fr)[KW / 16][4], int kb) {
      const KBlock k = kblock_of(kb, a);
      const bool use_side = wrap_tile && k.col_off < 0;
      mbar_wait(&full[s], phase);
      const AFrag r = frag_setup(stage_a(s), side(s), a, tl, k, use_side, wg, tid);
      const uint64_t db = sw128_desc(stage_b(s));
      auto load = [&](uint32_t (&q)[4], int ks) {
        const int lane = tid % 32;
        if (!pro) load_frag<-1>(q, r, ks, sa, sb, a, lane);
        else if (a.act == ACT_RELU) load_frag<ACT_RELU>(q, r, ks, sa, sb, a, lane);
        else if (a.act == ACT_LRELU) load_frag<ACT_LRELU>(q, r, ks, sa, sb, a, lane);
        else load_frag<ACT_NONE>(q, r, ks, sa, sb, a, lane);
      };
      if (NH == 1) {
#pragma unroll
        for (int ks = 0; ks < KW / 16; ++ks) load(fr[ks], ks);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KW / 16; ++ks) wgmma_m64n128k16_rs(acc[0], fr[ks], db + 2 * ks);
        wgmma_commit();
        wgmma_wait<1>();  // the previous k-block's wgmmas have completed
        if (kb > 0 && tid % 32 == 0) mbar_arrive(&empty[prev]);
      } else {
        load(fr[0], 0);
#pragma unroll
        for (int ks = 0; ks < KW / 16; ++ks) {
          wgmma_fence();
#pragma unroll
          for (int h = 0; h < NH; ++h)
            wgmma_m64n128k16_rs(acc[h], fr[ks & 1], db + h * 1024 + 2 * ks);
          wgmma_commit();
          if (ks + 1 < KW / 16) {
            wgmma_wait<1>();  // step ks - 1, which read fr[(ks + 1) & 1], is done
            load(fr[(ks + 1) & 1], ks + 1);
          }
        }
        wgmma_wait<0>();
        if (tid % 32 == 0) mbar_arrive(&empty[s]);
      }
      prev = s;
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    };
    for (int kb = 0; kb < n_kb; kb += 2) {
      step(f[0], kb);
      if (kb + 1 < n_kb) step(NH == 1 ? f[1] : f[0], kb + 1);
    }
    if (NH == 1) {
      wgmma_wait<0>();
      if (tid % 32 == 0) mbar_arrive(&empty[prev]);
    }

    // epilogue: once the helpers are done with the previous tile, bias and
    // cast into the staging tile; the helpers store it and take its moments
    // while the next tile's k-blocks run
    mbar_wait(out_empty, out_phase ^ 1);
    stage_out<NH>(acc, out, a, tl, wg, tid);
    fence_proxy_async();  // the writes, before the TMA store reads them
    mbar_arrive(out_full);
    out_phase ^= 1;
  }
}

// f32 on the CUDA cores, for checking: warp cg of a block takes couts
// [64 blockIdx.y + 8 cg, +8) of 32 consecutive output pixels (one per lane).
constexpr int F32_PIX = 32;
constexpr int F32_NT = 64;
constexpr int F32_NTH = 256;  // 8 warps

__global__ void __launch_bounds__(F32_NTH)
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


int ceil_div(int a, int b) { return (a + b - 1) / b; }

// x (N, H, W, C) bf16 with C % 8 == 0, y (N, H/2, W/2, Cout) bf16 with
// Cout % 8 == 0, both 16-byte aligned; wp the packed phase weight
// (3 kbw, cout_pad, 64) bf16, cout_pad Cout rounded up to 128 NH; pa and
// pb 16-byte aligned.
template <int NH>
cudaError_t launch_tma(const void* x, const void* wp, const float* bias,
                       const float* pa, const float* pb, void* y, float* part,
                       int N, int H, int W, int C, int Cout, int w_mode, int act,
                       int blocks, cudaStream_t stream) {
  using G = Geom<NH>;
  DownArgs a;
  a.bias = bias;
  a.pa = pa;
  a.pb = pb;
  a.part = part;
  a.N = N;
  a.Ho = H / 2;
  a.Wo = W / 2;
  a.C = C;
  a.Cout = Cout;
  a.cout_pad = ceil_div(Cout, G::BN) * G::BN;
  a.tiles_x = ceil_div(a.Wo, BW);
  a.n_sp = a.Ho * a.tiles_x;
  a.n_cb = a.cout_pad / G::BN;
  a.total = a.n_sp * N * a.n_cb;
  a.n_parts = blocks;
  a.nb2 = ceil_div(2 * C, KW);
  a.nb_lo = C / KW;
  a.kbw = 2 * a.nb2 - a.nb_lo;
  a.wrap = w_mode == PAD_WRAP;
  a.act = act;
  auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (C % 8 != 0 || Cout % 8 != 0 || misaligned(x) || misaligned(wp) ||
      misaligned(y) || misaligned(pa) || misaligned(pb))
    return cudaErrorInvalidValue;

  // the phase view (N, Ho, 2, Wo, 2C) and y (N, Ho, Wo, Cout), innermost first
  const cuuint64_t row = 4ull * C;  // bytes per pair column
  const cuuint64_t xdims[5] = {(cuuint64_t)2 * C, (cuuint64_t)a.Wo, 2,
                               (cuuint64_t)a.Ho, (cuuint64_t)N};
  const cuuint64_t xstrides[4] = {row, row * a.Wo, 2 * row * a.Wo,
                                  2 * row * a.Wo * a.Ho};
  const cuuint32_t abox[5] = {KW, BW, 1, 1, 1};
  const cuuint32_t sidebox[5] = {KW, 1, 1, 1, 1};
  const cuuint64_t wdims[2] = {KW, (cuuint64_t)3 * a.kbw * a.cout_pad};
  const cuuint64_t wstrides[1] = {KW * 2};
  const cuuint32_t bbox[2] = {KW, G::BN};
  const cuuint64_t ypix = 2ull * Cout;  // bytes per output pixel
  const cuuint64_t ydims[4] = {(cuuint64_t)Cout, (cuuint64_t)a.Wo,
                               (cuuint64_t)a.Ho, (cuuint64_t)N};
  const cuuint64_t ystrides[3] = {ypix, ypix * a.Wo, ypix * a.Wo * a.Ho};
  const cuuint32_t ybox[4] = {KW, BW, 1, 1};
  CUtensorMap xmap, wrapmap, wmap, ymap;
  cudaError_t err = encode_bf16_map(&xmap, x, 5, xdims, xstrides, abox, true);
  if (err == cudaSuccess)
    err = encode_bf16_map(&wrapmap, x, 5, xdims, xstrides, sidebox, false);
  if (err == cudaSuccess)
    err = encode_bf16_map(&wmap, wp, 2, wdims, wstrides, bbox, true);
  if (err == cudaSuccess)
    err = encode_bf16_map(&ymap, y, 4, ydims, ystrides, ybox, true);
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(down_tma_kernel<NH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  const int grid = a.total < blocks ? a.total : blocks;
  down_tma_kernel<NH><<<grid, THREADS, G::SMEM, stream>>>(xmap, wrapmap, wmap, ymap,
                                                         a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The float32 kernel's pixel tiles of an image: the middle dimension of
// its moment partials.
int conv3x3s2_fused_num_tiles(int H, int W) {
  return ((H / 2) * (W / 2) + F32_PIX - 1) / F32_PIX;
}

// dtype: 0 = float32, 1 = bfloat16. w_mode: 0 zero, 2 wrap. act: 0 none,
// 1 relu, 2 lrelu (only read with a prologue). x (N, H, W, C) NHWC with H and
// W even, y (N, H/2, W/2, Cout); bias (Cout) f32 or null; pa, pb (N, C) f32
// or both null; part (2, N, n_parts, Cout) and moments (2, N, Cout) f32,
// or both null. n_parts: for float32 conv3x3s2_fused_num_tiles; for
// bfloat16 the blocks of the persistent grid at most (the card's SM count),
// a zeroed slot of part each.
// w: for float32 w9 (9, C, Cout); for bfloat16 the packed phase
// weight (3 kbw, cout_pad, 64) of pack_phase_weight (cout_pad: Cout
// rounded up to 128, or to 256 above 128), with C and Cout multiples of 8
// and x, w, y, pa and pb 16-byte aligned.
int conv3x3s2_fused_launch(const void* x, const void* w, const void* bias,
                           const void* pa, const void* pb, void* y, void* part,
                           void* moments, int N, int H, int W, int C, int Cout,
                           int n_parts, int dtype, int w_mode, int act,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* fa = static_cast<const float*>(pa);
  const float* fb = static_cast<const float*>(pb);
  float* pp = static_cast<float*>(part);
  if (n_parts < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 1) {
    err = Cout <= 128 ? launch_tma<1>(x, w, b, fa, fb, y, pp, N, H, W, C, Cout,
                                      w_mode, act, n_parts, s)
                      : launch_tma<2>(x, w, b, fa, fb, y, pp, N, H, W, C, Cout,
                                      w_mode, act, n_parts, s);
  } else if (dtype == 0) {
    const int n_tiles = conv3x3s2_fused_num_tiles(H, W);
    if (n_parts != n_tiles) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid(n_tiles, (Cout + F32_NT - 1) / F32_NT, N);
    down_f32_kernel<<<grid, F32_NTH, 0, s>>>(
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
