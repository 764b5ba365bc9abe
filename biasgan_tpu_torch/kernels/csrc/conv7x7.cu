// conv7x7: VALID 7x7 stride-1 conv of an already padded NHWC input
// (N, H+6, W+6, Cin) -> (N, H, W, Cout) with one channel side of at most 8,
// f32 accumulation, an f32 bias added before the single cast.
//
// Replaces the Pallas TPU kernel biasgan_tpu/ops/pallas_conv7.py::
// conv7x7_valid (:197; bodies _k_smallcin :142 for the stem, _k_smallcout
// :169 for the head). It carries the resnet generator's 7x7 stem
// (3 -> 64) and head (64 -> 3) under --conv7_pallas; the caller pads first
// (reflect H, wrap W), as the JAX route does.
//
// What bounds it on an H100: at the full-globe shapes each is ~19.6 GFLOP
// of real products against ~140 MB of bf16 traffic (stem: a 6 MB input, a
// 133 MB output; head the reverse), so the bytes set the bound, ~0.042 ms
// each. A 3-wide channel side fills no tensor-core tile, so the padded
// products the tensor cores run (below) and the shared-memory reads that
// feed them come next: at the card's bf16 peak the stem's padded products
// take ~0.03 ms and the head's ~0.04.
//
// bf16: both variants are implicit GEMMs on the tensor cores (wgmma, A from
// registers by ldmatrix, B the packed weight resident in shared memory in
// the 128-byte swizzle, f32 accumulators), on a persistent grid of one
// block per SM that walks its tiles across images.
//   * The stem (Cin <= 8), stem_wgmma_kernel<P>: M = 64 output pixels of one
//     row, N = 64 couts (a launch per 64-cout block), K = 7 dy steps of the
//     7 dx taps times Cin_p channels. The input's pixel stride (6 bytes at
//     Cin 3) and row stride (1446 x 6) are no multiples of 16, so no TMA
//     tensor map describes it: the producer warpgroup loads each tile's
//     (8 + 6) x 71 pixels with 2-byte loads (coalesced along the row) and
//     stages them as 16-byte units of P pixels at Cin_p = 8 / P channels
//     (P = 2 for Cin <= 4, else 1), zero past Cin and past the input. At
//     one dy, an output pixel's A row is then P dx taps per unit and 7 taps
//     in 8 / P consecutive units, one run in shared memory (the TPU kernel's
//     dx-im2col, :142-166, for free), and every unit starts 16-byte aligned,
//     as ldmatrix needs. Cin_p 4 (P 2, the globe's Cin 3) takes 2 k16 steps
//     a dy, 14 a row, half of Cin_p 8's 28: each pixel is staged twice (as
//     the high half of one unit and the low half of the next), which costs
//     nothing next to the products; dx 7 has zero weights. Four consumer
//     warpgroups take two rows of each 8 x 64 tile; each row's 64 x 64 sum
//     gets the f32 bias, one cast, and goes by TMA store (a 64-pixel box)
//     from the warpgroup's two staging buffers, so one row's store overlaps
//     the next row's products.
//   * The head (Cout <= 8), head_wgmma_kernel<CPL>: the TPU kernel's form
//     (:169-194). Per staged input row, one product U = sum over dx of the
//     row's pixels x + dx (the A rows, from a TMA box of 70 pixels x 64
//     channels, 128-byte swizzle, per channel block) against a slab that
//     puts (dy, co) on N; then output row r - dy takes column (dy, co) of
//     staged row r's U, in f32. N is 32 for Cout <= 4 (CPL 1: column
//     8 (dy / 2) + 2 co + dy % 2, dy 7 zero) and 56 for Cout <= 8 (CPL 2:
//     column 8 dy + co), so each lane of the wgmma accumulator holds all
//     seven dy of its couts and its pixels: the dy collapse is a fixed
//     register add into a window of seven output-row partials that shifts
//     by one each staged row, with no shared-memory pass. A direct GEMM
//     (N = 8, K = 49 C) would read each staged pixel's channels once per
//     tap, 49 times; here each is read once per dx, 7 times. Each consumer
//     warpgroup walks its own units (a 64-pixel column strip of `th` output
//     rows, th chosen by the wrapper for the grid's rounds) through its own
//     ring of four TMA row boxes, fed by its own producer warp, so a staged
//     row is loaded once per unit, not once per tile row. The output (6 MB,
//     a 6-byte pixel stride that no TMA map takes) goes out by plain
//     stores; each output value is one lane's.
//   * Shared memory: the stem 57 KB of weights (7 dy slabs of 64 couts x
//     64 K), 2 x 15.5 KB input stages, 64 KB of output staging; the head
//     n_kc x 7 slabs (4 or 7 KB each) and 3 x 4 row boxes of 9 KB. The
//     head keeps its weight resident, which bounds C: C <= 256 at Cout <= 4,
//     C <= 128 at Cout <= 8 (the generator's head has C = ngf = 64).
//
// f32 (the checker): the CUDA-core kernel below. A block owns a 16-row by
// 16 PX-column output tile and COB output channels; thread (ty, tx) owns
// the PX pixels (ty, tx + 16 p) and COB accumulators for each. Per chunk of
// KCH input channels the block stages the (16+6) x (16 PX + 6) input halo
// as f32 channel planes and the chunk's weights [tap][ci][COB]; each thread
// then runs 49 taps x KCH channels. Two instantiations: smallcin (Cin in
// chunks of 4, COB 16) and smallcout (Cin in chunks of 8, COB 4).
//
// Interface: plain C, loaded with ctypes; launches go on the caller's stream
// and the function returns the cudaError_t of the launch (0 = ok).

#include "common.cuh"

namespace {

using namespace port;
using namespace port::sm90;

constexpr int K = 7;

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
inline bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// ---------------------------------------------------------------------------
// bf16 stem: Cin <= 8
// ---------------------------------------------------------------------------
namespace stem {

constexpr int TH = 8;   // output rows of a tile
constexpr int TW = 64;  // output columns of a tile: one wgmma's M
constexpr int NC = 4;   // consumer warpgroups, TH / NC rows each
constexpr int ROWS = TH + K - 1;  // staged input rows
constexpr int UNITS = TW + 7;     // 16-byte units a staged row: pixels 0 .. 70
constexpr int ROW_BYTES = UNITS * 16;
constexpr int STAGE_BYTES = ROWS * ROW_BYTES;
constexpr int STAGES = 2;
constexpr int NB = 64;             // couts a launch: one wgmma's N
constexpr int W_SLAB = NB * 128;   // one dy's weight: [cout][64 k], 128-byte swizzle
constexpr int OUT_BYTES = TW * 128;  // one output row: [pixel][64 couts], 128-byte swizzle
constexpr int PRODUCERS = 128;
constexpr int THREADS = 128 * NC + PRODUCERS;
constexpr int SMEM = 1024 + K * W_SLAB + 2 * NC * OUT_BYTES + STAGES * STAGE_BYTES +
                     2 * STAGES * 8;
static_assert(TH % NC == 0, "whole rows per consumer warpgroup");
static_assert(SMEM <= 232448, "shared memory");

struct Args {
  const unsigned short* x;  // (N, Hp, Wp, Cin) bf16
  const uint4* wp;          // this launch's block of the packed weight (7, 64, 64)
  const float* bias;        // this launch's 64 couts, or null
  int N, Hp, Wp, Cin, H, W;
  int co0;                         // the launch's first cout
  int tiles_x, tiles_y, total;     // tiles per row of tiles, per column; all
};

struct Tile {
  int n, y0, x0;
};

__device__ __forceinline__ Tile tile_of(int t, const Args& a) {
  const int tx = t % a.tiles_x, rest = t / a.tiles_x;
  return {rest / a.tiles_y, (rest % a.tiles_y) * TH, tx * TW};
}

// Tile (n, y0, x0)'s staged rows y0 .. y0 + 13, each UNITS units: unit u
// holds pixels x0 + u .. x0 + u + P - 1 at CP = 8 / P channels each, zero
// past Cin and past the input. By the producer warpgroup's thread `tid`:
// BATCH 2-byte loads in flight, then their stores (a pixel lands in P
// units).
template <int P>
__device__ __forceinline__ void stage_tile(unsigned char* st, const Args& a, const Tile& tl,
                                           int tid) {
  constexpr int CP = 8 / P;
  constexpr int NPX = UNITS + P - 1;
  constexpr int ITEMS = ROWS * NPX * CP;
  constexpr int BATCH = 16;
  for (int base = tid; base < ITEMS; base += PRODUCERS * BATCH) {
    unsigned short v[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int it = base + b * PRODUCERS;
      const int c = it % CP, p = (it / CP) % NPX, r = it / (CP * NPX);
      const int gy = tl.y0 + r, gx = tl.x0 + p;
      v[b] = 0;
      if (it < ITEMS && c < a.Cin && gy < a.Hp && gx < a.Wp)
        v[b] = __ldg(a.x + (((size_t)tl.n * a.Hp + gy) * a.Wp + gx) * a.Cin + c);
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int it = base + b * PRODUCERS;
      const int c = it % CP, p = (it / CP) % NPX, r = it / (CP * NPX);
      unsigned short* row = reinterpret_cast<unsigned short*>(st + r * ROW_BYTES);
#pragma unroll
      for (int d = 0; d < P; ++d) {
        const int u = p - d;
        if (it < ITEMS && u >= 0 && u < UNITS) row[u * 8 + d * CP + c] = v[b];
      }
    }
  }
}

template <int P>
__global__ void __launch_bounds__(THREADS, 1)
    stem_wgmma_kernel(const __grid_constant__ CUtensorMap ymap, const Args a) {
  constexpr int SPD = 4 / P;        // k16 steps per dy: K = 8 CP = 64 / P
  constexpr int STEPS = K * SPD;    // per output row
  constexpr int NBUF = 3;           // A fragments: two steps in flight, the next loading
  extern __shared__ unsigned char smem_raw[];
  unsigned char* wsl = align1024(smem_raw);
  unsigned char* out0 = wsl + K * W_SLAB;
  unsigned char* stage0 = out0 + 2 * NC * OUT_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(stage0 + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  // each input stage: full (the producers' stores are done), empty (every
  // consumer warp is done with it)
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], PRODUCERS);
      mbar_init(&empty[s], NC * 4);
    }
    fence_barrier_init();
  }
  for (int i = threadIdx.x; i < K * NB * 8; i += THREADS)
    *reinterpret_cast<uint4*>(wsl + (i / (NB * 8)) * W_SLAB + sw128_offset((i / 8) % NB, i % 8)) =
        __ldg(a.wp + i);
  fence_proxy_async();  // the slabs, before wgmma reads them
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (wg == NC) {  // the producers: stage each tile one ahead
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < a.total; t += gridDim.x) {
      mbar_wait(&empty[s], ph ^ 1);
      stage_tile<P>(stage0 + s * STAGE_BYTES, a, tile_of(t, a), tid);
      mbar_arrive(&full[s]);
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes rows wg TH / NC .. of each tile
  const int warp = tid / 32, lane = tid % 32;
  float bias[8][2];
#pragma unroll
  for (int g = 0; g < 8; ++g)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bias[g][e] = a.bias != nullptr ? __ldg(a.bias + 8 * g + 2 * (lane % 4) + e) : 0.f;
  // this lane's ldmatrix row: tile column m; lanes 16-31 the second 8 of a k16
  const int m = 16 * warp + (lane & 15), half = lane >> 4;
  float acc[32] = {};
  uint32_t f[NBUF][4];
  int s = 0, ob = 0;
  uint32_t ph = 0;
  for (int t = blockIdx.x; t < a.total; t += gridDim.x) {
    const Tile tl = tile_of(t, a);
    mbar_wait(&full[s], ph);
    for (int i = 0; i < TH / NC; ++i) {
      const int r = wg * (TH / NC) + i;
      // step j: dy j / SPD, k16 ks j % SPD: units m + P (2 ks + half) of
      // staged row r + dy
      const unsigned char* arow = stage0 + s * STAGE_BYTES + r * ROW_BYTES + m * 16;
      auto load = [&](uint32_t(&q)[4], int j) {
        ldmatrix_x4(q, arow + (j / SPD) * ROW_BYTES + P * (2 * (j % SPD) + half) * 16);
      };
      load(f[0], 0);
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        wgmma_fence();
        wgmma_m64n64k16_rs(acc, f[j % NBUF], sw128_desc(wsl + (j / SPD) * W_SLAB) + 2 * (j % SPD),
                           j > 0);
        wgmma_commit();
        wgmma_wait<NBUF - 1>();  // step j - 2 is done: its fragment buffer is free
        if (j + 1 < STEPS) load(f[(j + 1) % NBUF], j + 1);
      }
      wgmma_wait<0>();
      // the warpgroup's last row of the tile: its ldmatrix reads are done
      if (i == TH / NC - 1 && lane == 0) mbar_arrive(&empty[s]);

      // epilogue: f32 bias, one cast, into a staging buffer once its store
      // two rows ago has read it; one thread stores the row by TMA
      unsigned char* out = out0 + (2 * wg + ob) * OUT_BYTES;
      if (tid == 0) bulk_wait_read<1>();
      named_barrier(1 + wg, 128);
#pragma unroll
      for (int g = 0; g < 8; ++g)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = 16 * warp + lane / 4 + 8 * h;
          *reinterpret_cast<__nv_bfloat162*>(out + sw128_offset(px, g) + (lane % 4) * 4) =
              __floats2bfloat162_rn(acc[4 * g + 2 * h] + bias[g][0],
                                    acc[4 * g + 2 * h + 1] + bias[g][1]);
        }
      fence_proxy_async();  // the writes, before the TMA store reads them
      named_barrier(1 + wg, 128);
      if (tid == 0) {
        tma_store_4d(&ymap, out, a.co0, tl.x0, tl.y0 + r, tl.n);
        bulk_commit();
      }
      ob ^= 1;
    }
    if (++s == STAGES) {
      s = 0;
      ph ^= 1;
    }
  }
  if (tid == 0) bulk_wait<0>();  // the last stores are done before the exit
}

// x (N, Hp, Wp, Cin) bf16, Cin <= 8; wp the packed weight (n_cb, 7, 64, 64)
// of the wrapper's pack_stem_weight, 16-byte aligned; bias (64 n_cb) f32 or
// null; y (N, Hp - 6, Wp - 6, cout8) bf16, cout8 a multiple of 8 with
// n_cb = cout8 / 64 rounded up, 16-byte aligned. One launch per 64 couts.
template <int P>
cudaError_t launch_stem(const void* x, const void* wp, const float* bias, void* y, int N,
                        int Hp, int Wp, int Cin, int cout8, int blocks, cudaStream_t stream) {
  const int H = Hp - (K - 1), W = Wp - (K - 1);
  if (H < 1 || W < 1 || Cin < 1 || Cin > 8 / P || cout8 < 8 || cout8 % 8 != 0 ||
      blocks < 1 || misaligned(wp) || misaligned(y))
    return cudaErrorInvalidValue;
  const cuuint64_t py = 2ull * cout8;  // bytes per output pixel
  const cuuint64_t dims[4] = {(cuuint64_t)cout8, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {py, py * W, py * W * H};
  const cuuint32_t box[4] = {NB, TW, 1, 1};
  CUtensorMap ymap;
  cudaError_t err = encode_bf16_map(&ymap, y, 4, dims, strides, box, true);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(stem_wgmma_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (err != cudaSuccess) return err;
  Args a;
  a.x = static_cast<const unsigned short*>(x);
  a.N = N;
  a.Hp = Hp;
  a.Wp = Wp;
  a.Cin = Cin;
  a.H = H;
  a.W = W;
  a.tiles_x = ceil_div(W, TW);
  a.tiles_y = ceil_div(H, TH);
  a.total = N * a.tiles_x * a.tiles_y;
  const int grid = a.total < blocks ? a.total : blocks;
  for (int cb = 0; cb < ceil_div(cout8, NB); ++cb) {
    a.co0 = cb * NB;
    a.wp = static_cast<const uint4*>(wp) + (size_t)cb * K * NB * 8;
    a.bias = bias != nullptr ? bias + cb * NB : nullptr;
    stem_wgmma_kernel<P><<<grid, THREADS, SMEM, stream>>>(ymap, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace stem

// ---------------------------------------------------------------------------
// bf16 head: Cout <= 8
// ---------------------------------------------------------------------------
namespace head {

constexpr int TW = 64;  // output columns of a unit: one wgmma's M
constexpr int NC = 3;   // consumer warpgroups, each its own walk, ring and producer warp
constexpr int KW = 64;  // input channels per channel block (128 bytes)
constexpr int BOX_PX = TW + K - 1;  // a staged row's pixels
constexpr int BOX_BYTES = BOX_PX * 128;
constexpr int BOX_STRIDE = (BOX_BYTES + 1023) / 1024 * 1024;  // the swizzle's alignment
constexpr int NS = 4;  // row boxes in flight per consumer warpgroup
constexpr int STEPS = K * KW / 16;  // k16 steps per row box: dx, then 16 channels
constexpr int THREADS = 128 * (NC + 1);

template <int CPL>
struct Geom {
  static constexpr int N = CPL == 1 ? 32 : 56;  // (dy, co) columns of U
  static constexpr int SLAB = N * 128;          // one (channel block, dx) weight slab
  static constexpr int ACC = N / 2;             // U's registers a thread
};

inline int smem_bytes(int slab, int n_kc) {
  return 1024 + n_kc * K * slab + NC * NS * BOX_STRIDE + 2 * NC * NS * 8;
}

struct Args {
  const uint4* wp;   // the packed weight (7 n_kc, N, 64)
  const float* bias;  // (Cout) or null
  __nv_bfloat16* y;   // (N, H, W, Cout)
  int N, H, W, Cout, n_kc;
  int th, n_seg, n_strip, units;  // output rows a unit; units per strip, strips, all
};

struct Unit {
  int n, y0, x0;
};

// Unit u: the strips of a row segment next to each other.
__device__ __forceinline__ Unit unit_of(int u, const Args& a) {
  const int strip = u % a.n_strip, rest = u / a.n_strip;
  return {rest / a.n_seg, (rest % a.n_seg) * a.th, strip * TW};
}

template <int CPL>
__device__ __forceinline__ void mma(float (&d)[Geom<CPL>::ACC], const uint32_t (&f)[4],
                                    uint64_t db, int scale_d) {
  if constexpr (CPL == 1)
    wgmma_m64n32k16_rs(d, f, db, scale_d);
  else
    wgmma_m64n56k16_rs(d, f, db, scale_d);
}

template <int CPL>
__global__ void __launch_bounds__(THREADS, 1)
    head_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const Args a) {
  using G = Geom<CPL>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* wsl = align1024(smem_raw);
  unsigned char* box0 = wsl + a.n_kc * K * G::SLAB;  // SLAB is a multiple of 1024
  uint64_t* full = reinterpret_cast<uint64_t*>(box0 + NC * NS * BOX_STRIDE);
  uint64_t* empty = full + NC * NS;

  // ring w (stages w NS ..): full (its TMA box has landed), empty (every
  // warp of consumer warpgroup w is done with it)
  if (threadIdx.x == 0) {
    for (int i = 0; i < NC * NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);
    }
    fence_barrier_init();
  }
  for (int i = threadIdx.x; i < a.n_kc * K * G::N * 8; i += THREADS)
    *reinterpret_cast<uint4*>(wsl + (i / (G::N * 8)) * G::SLAB +
                              sw128_offset((i / 8) % G::N, i % 8)) = __ldg(a.wp + i);
  fence_proxy_async();  // the slabs, before wgmma reads them
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int slots = gridDim.x * NC;  // warpgroups walking units
  if (wg == NC) {  // producer warp w feeds consumer warpgroup w's ring
    const int w = tid / 32;
    if (w >= NC || tid % 32 != 0) return;
    int s = 0;
    uint32_t ph = 0;
    for (int u = blockIdx.x * NC + w; u < a.units; u += slots) {
      const Unit un = unit_of(u, a);
      for (int r = 0; r < a.th + K - 1; ++r)
        for (int cb = 0; cb < a.n_kc; ++cb) {
          const int i = w * NS + s;
          mbar_wait(&empty[i], ph ^ 1);
          mbar_arrive_expect_tx(&full[i], BOX_BYTES);  // zero fill counts as landed
          tma_load_4d(box0 + i * BOX_STRIDE, &xmap, &full[i], cb * KW, un.x0, un.y0 + r, un.n);
          if (++s == NS) {
            s = 0;
            ph ^= 1;
          }
        }
    }
    return;
  }

  // consumer warpgroup wg. Thread t holds U[j] at strip column 16 (t / 32)
  // + (t % 32) / 4 + 8 h and N column 8 g + 2 (t % 4) + e (j = 4 g + 2 h +
  // e), which is (dy 2 g + e, co t % 4) at CPL 1 and (dy g, co 2 (t % 4) +
  // e) at CPL 2. O[k][h][c]: the partial sums of output row r - k (after
  // staged row r) at those columns and couts.
  const int warp = tid / 32, lane = tid % 32;
  const int m = 16 * warp + (lane & 15), half = lane >> 4;  // this lane's ldmatrix row
  float bias[CPL];
  int co[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    co[c] = CPL == 1 ? lane % 4 : 2 * (lane % 4) + c;
    bias[c] = a.bias != nullptr && co[c] < a.Cout ? __ldg(a.bias + co[c]) : 0.f;
  }
  float U[G::ACC] = {};
  float O[K][2][CPL];
  uint32_t f[3][4];  // A fragments: two steps in flight, the next loading
  int s = 0;
  uint32_t ph = 0;
  for (int u = blockIdx.x * NC + wg; u < a.units; u += slots) {
    const Unit un = unit_of(u, a);
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < CPL; ++c) O[k][h][c] = 0.f;
    for (int r = 0; r < a.th + K - 1; ++r) {
      for (int cb = 0; cb < a.n_kc; ++cb) {
        const int i = wg * NS + s;
        mbar_wait(&full[i], ph);
        const unsigned char* bx = box0 + i * BOX_STRIDE;
        const uint64_t d0 = sw128_desc(wsl + cb * K * G::SLAB);
        // step j: dx j / 4, channels 16 (j % 4) ..: box pixel m + dx
        auto load = [&](uint32_t(&q)[4], int j) {
          const int p = m + j / 4, chunk = 2 * (j % 4) + half;
          ldmatrix_x4(q, bx + p * 128 + ((chunk ^ (p & 7)) << 4));
        };
        load(f[0], 0);
#pragma unroll
        for (int j = 0; j < STEPS; ++j) {
          wgmma_fence();
          mma<CPL>(U, f[j % 3], d0 + (j / 4) * (G::SLAB >> 4) + 2 * (j % 4), cb > 0 || j > 0);
          wgmma_commit();
          wgmma_wait<2>();  // step j - 2 is done: its fragment buffer is free
          if (j + 1 < STEPS) load(f[(j + 1) % 3], j + 1);
        }
        if (lane == 0) mbar_arrive(&empty[i]);  // the box's last ldmatrix is done
        if (++s == NS) {
          s = 0;
          ph ^= 1;
        }
        wgmma_wait<0>();  // U is complete, and f[0] free for the next box
      }
      // the dy collapse: output row r - dy takes column (dy, co) of U
#pragma unroll
      for (int j = 0; j < G::ACC; ++j) {
        const int g = j / 4, h = (j / 2) % 2, e = j % 2;
        const int dy = CPL == 1 ? 2 * g + e : g;
        if (dy < K) O[dy][h][CPL == 1 ? 0 : e] += U[j];
      }
      // output row r - 6 is complete: f32 bias, one cast, plain stores
      const int oy = un.y0 + r - (K - 1);
      if (r >= K - 1 && oy < a.H) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = un.x0 + 16 * warp + lane / 4 + 8 * h;
          if (px >= a.W) continue;
          __nv_bfloat16* dst = a.y + (((size_t)un.n * a.H + oy) * a.W + px) * a.Cout;
#pragma unroll
          for (int c = 0; c < CPL; ++c)
            if (co[c] < a.Cout) dst[co[c]] = __float2bfloat16_rn(O[K - 1][h][c] + bias[c]);
        }
      }
#pragma unroll
      for (int k = K - 1; k > 0; --k)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < CPL; ++c) O[k][h][c] = O[k - 1][h][c];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < CPL; ++c) O[0][h][c] = 0.f;
    }
  }
}

// x (N, Hp, Wp, C) bf16, C a multiple of 8, 16-byte aligned; wp the packed
// weight (7 n_kc, N, 64) of the wrapper's pack_head_weight, n_kc = C / 64
// rounded up, 16-byte aligned; bias (Cout) f32 or null; y (N, Hp - 6,
// Wp - 6, Cout) bf16, Cout <= 4 CPL; th output rows a unit.
template <int CPL>
cudaError_t launch_head(const void* x, const void* wp, const float* bias, void* y, int N,
                        int Hp, int Wp, int C, int Cout, int th, int blocks,
                        cudaStream_t stream) {
  using G = Geom<CPL>;
  const int H = Hp - (K - 1), W = Wp - (K - 1);
  const int n_kc = ceil_div(C, KW), smem = smem_bytes(G::SLAB, n_kc);
  if (H < 1 || W < 1 || C < 8 || C % 8 != 0 || Cout < 1 || Cout > 4 * CPL || th < 1 ||
      blocks < 1 || smem > 232448 || misaligned(x) || misaligned(wp))
    return cudaErrorInvalidValue;
  const cuuint64_t px = 2ull * C;  // bytes per input pixel
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)Wp, (cuuint64_t)Hp, (cuuint64_t)N};
  const cuuint64_t strides[3] = {px, px * Wp, px * Wp * Hp};
  const cuuint32_t box[4] = {KW, BOX_PX, 1, 1};
  CUtensorMap xmap;
  cudaError_t err = encode_bf16_map(&xmap, x, 4, dims, strides, box, true);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(head_wgmma_kernel<CPL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  Args a;
  a.wp = static_cast<const uint4*>(wp);
  a.bias = bias;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.N = N;
  a.H = H;
  a.W = W;
  a.Cout = Cout;
  a.n_kc = n_kc;
  a.th = th;
  a.n_seg = ceil_div(H, th);
  a.n_strip = ceil_div(W, TW);
  a.units = N * a.n_seg * a.n_strip;
  const int need = ceil_div(a.units, NC);
  head_wgmma_kernel<CPL><<<need < blocks ? need : blocks, THREADS, smem, stream>>>(xmap, a);
  return cudaGetLastError();
}

}  // namespace head

// ---------------------------------------------------------------------------
// f32: the CUDA-core checker
// ---------------------------------------------------------------------------
constexpr int T = 16;  // output rows per block, and threads along x
constexpr int NTH = T * T;

template <int COB, int KCH, int PX>
__global__ void __launch_bounds__(NTH)
    conv7x7_f32_kernel(const float* __restrict__ xp, const float* __restrict__ w49,
                       const float* __restrict__ bias, float* __restrict__ y, int Hp,
                       int Wp, int Cin, int Cout, int tiles_x) {
  constexpr int HALO_H = T + K - 1, HALO_W = T * PX + K - 1;
  __shared__ float s_x[KCH][HALO_H * HALO_W];
  __shared__ __align__(16) float s_w[K * K][KCH][COB];

  const int H = Hp - (K - 1), W = Wp - (K - 1);
  const int n = blockIdx.z, co0 = blockIdx.y * COB;
  const int oy0 = (blockIdx.x / tiles_x) * T, ox0 = (blockIdx.x % tiles_x) * T * PX;
  const int ty = threadIdx.x / T, tx = threadIdx.x % T;

  float acc[PX][COB];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int j = 0; j < COB; ++j) acc[p][j] = 0.f;

  for (int k0 = 0; k0 < Cin; k0 += KCH) {
    const int kc = min(KCH, Cin - k0);
    // the halo, channel fastest on the read side (coalesced), planes in smem
    for (int i = threadIdx.x; i < HALO_H * HALO_W * KCH; i += NTH) {
      const int ci = i % KCH, pix = i / KCH;
      const int gy = oy0 + pix / HALO_W, gx = ox0 + pix % HALO_W;
      float v = 0.f;
      if (ci < kc && gy < Hp && gx < Wp)
        v = xp[(((size_t)n * Hp + gy) * Wp + gx) * Cin + k0 + ci];
      s_x[ci][pix] = v;
    }
    for (int i = threadIdx.x; i < K * K * KCH * COB; i += NTH) {
      const int j = i % COB, ci = (i / COB) % KCH, tap = i / (COB * KCH);
      float v = 0.f;
      if (ci < kc && co0 + j < Cout) v = w49[((size_t)tap * Cin + k0 + ci) * Cout + co0 + j];
      s_w[tap][ci][j] = v;
    }
    __syncthreads();
    for (int ci = 0; ci < kc; ++ci) {
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          float v[PX];
#pragma unroll
          for (int p = 0; p < PX; ++p)
            v[p] = s_x[ci][(ty + dy) * HALO_W + tx + T * p + dx];
          const float4* wv = reinterpret_cast<const float4*>(s_w[dy * K + dx][ci]);
#pragma unroll
          for (int j4 = 0; j4 < COB / 4; ++j4) {
            const float4 w = wv[j4];
#pragma unroll
            for (int p = 0; p < PX; ++p) {
              acc[p][4 * j4] = fmaf(v[p], w.x, acc[p][4 * j4]);
              acc[p][4 * j4 + 1] = fmaf(v[p], w.y, acc[p][4 * j4 + 1]);
              acc[p][4 * j4 + 2] = fmaf(v[p], w.z, acc[p][4 * j4 + 2]);
              acc[p][4 * j4 + 3] = fmaf(v[p], w.w, acc[p][4 * j4 + 3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  const int oy = oy0 + ty;
  if (oy >= H) return;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int ox = ox0 + tx + T * p;
    if (ox >= W) continue;
    float* dst = y + (((size_t)n * H + oy) * W + ox) * Cout + co0;
#pragma unroll
    for (int j = 0; j < COB; ++j)
      if (co0 + j < Cout) dst[j] = acc[p][j] + (bias != nullptr ? bias[co0 + j] : 0.f);
  }
}

constexpr int PX = 2;  // output pixels per thread

template <int COB, int KCH>
cudaError_t launch_f32(const void* xp, const void* w49, const float* bias, void* y, int N,
                       int Hp, int Wp, int Cin, int Cout, cudaStream_t s) {
  const int H = Hp - (K - 1), W = Wp - (K - 1);
  const int tiles_x = (W + T * PX - 1) / (T * PX);
  dim3 grid(((H + T - 1) / T) * tiles_x, (Cout + COB - 1) / COB, N);
  conv7x7_f32_kernel<COB, KCH, PX><<<grid, NTH, 0, s>>>(
      static_cast<const float*>(xp), static_cast<const float*>(w49), bias,
      static_cast<float*>(y), Hp, Wp, Cin, Cout, tiles_x);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. smallcin: 1 for Cin <= 8 (the stem),
// 0 for Cout <= 8 (the head). xp (N, Hp, Wp, Cin) NHWC, y
// (N, Hp-6, Wp-6, Cout); bias (Cout) f32 or null. float32: w the w49
// (49, Cin, Cout), tap dy * 7 + dx of the OIHW weight; pack, rows and
// blocks unread. bfloat16 (blocks: the persistent grid's blocks at most,
// the card's SM count): the stem takes w = pack_stem_weight's (n_cb, 7,
// 64, 64) with pack = P (pixels per staged unit: 2 for Cin <= 4, else 1),
// Cout a multiple of 8 (y's TMA stores), bias 64 n_cb long or null; the
// head takes w = pack_head_weight's (7 n_kc, N, 64) with pack = CPL (couts
// per lane: 1 for Cout <= 4, else 2), Cin a multiple of 8 and a 16-byte
// aligned xp (its TMA loads), rows the output rows of a unit.
int conv7x7_launch(const void* xp, const void* w, const void* bias, void* y, int N, int Hp,
                   int Wp, int Cin, int Cout, int dtype, int smallcin, int pack, int rows,
                   int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1 && smallcin && (pack == 1 || pack == 2))
    err = pack == 1 ? stem::launch_stem<1>(xp, w, b, y, N, Hp, Wp, Cin, Cout, blocks, s)
                    : stem::launch_stem<2>(xp, w, b, y, N, Hp, Wp, Cin, Cout, blocks, s);
  else if (dtype == 1 && !smallcin && (pack == 1 || pack == 2))
    err = pack == 1
              ? head::launch_head<1>(xp, w, b, y, N, Hp, Wp, Cin, Cout, rows, blocks, s)
              : head::launch_head<2>(xp, w, b, y, N, Hp, Wp, Cin, Cout, rows, blocks, s);
  else if (dtype == 0)
    err = smallcin ? launch_f32<16, 4>(xp, w, b, y, N, Hp, Wp, Cin, Cout, s)
                   : launch_f32<4, 8>(xp, w, b, y, N, Hp, Wp, Cin, Cout, s);
  return static_cast<int>(err);
}

}  // extern "C"
