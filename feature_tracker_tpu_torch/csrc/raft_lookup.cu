// RAFT's windowed correlation lookup over a pooled feature pyramid, one
// launch for all batch items, queries and levels, for Hopper.
//
// Replaces: feature_tracker_tpu/ops/pallas_raft_lookup.py::
// lookup_correlation_pallas_batched (l.158, body _kernel l.46). Plain
// version: feature_tracker_tpu_torch/models/raft.py::lookup_correlation_otf;
// Python wrapper: feature_tracker_tpu_torch/ops/cuda_raft_lookup.py::
// lookup_correlation_cuda.
//
// What it computes, for every query pixel n of fmap0 [B, H, W, C] and every
// level l of the second image's pooled features f1_l [B, h_l, w_l, C]: the
// correlation <f0[n] / sqrt(C), f1_l> sampled bilinearly at the (2r+1)^2
// integer offsets around (x, y) = locations[n] / 2^l, each of the four taps
// contributing 0 where it leaves the map. Output [B, H, W, L (2r+1)^2],
// level-major, then dy-major, dx-minor. In border mode (padding 1,
// CoTracker's grid_sample(padding_mode="border", align_corners=True)) each
// sample position is first clamped into [0, w_l - 1] x [0, h_l - 1], so that
// no tap with weight leaves the map.
//
// The offsets are integers, so all samples of one query at one level share
// one fractional part (fx, fy): they are four-tap blends, with four constant
// weights, of the (2r+2)^2 dot products on the integer grid whose corner is
// floor(x, y) - r. A grid pixel outside the map has dot product 0, which is
// the per-tap zero padding. A query whose location is NaN, infinite or
// beyond +-2^30 has no valid tap and writes zeros.
//
// Border mode keeps the one grid a query and level: the location / 2^l is
// clamped into [-r, w_l - 1 + r] x [-r, h_l - 1 + r] first (every window
// sample beyond that range clamps to the map's edge either way), so the grid
// always meets the map, and a sample's clamped position lies on the grid:
// its local coordinate fx + dx is clamped into [-x0, w_l - 1 - x0] (x0 the
// grid corner), and the blend takes the four grid pixels around it. Only a
// NaN or infinite location writes zeros there. Zeros mode is compiled
// apart (a template argument), as it was.
//
// Bound on an H100 at the serving shape (B=4, 55x128 queries, C=128, three
// levels, r=3), counting only the grid pixels that lie inside their maps:
// about 4.6 M dot products of 128 channels, 1.20 GFLOP, 0.0179 ms at
// 67 TFLOP/s of float32 outside the tensor cores; fmap0, the pyramid and the
// locations read once and the output written once are 50 MB, 0.0149 ms at
// 3.35 TB/s. Operations bind.
//
// What decides the time is where the feature rows are read from. A warp per
// query that reads each of its grid pixels from global memory moves 2.8 GB
// of 512-byte rows per launch at the serving shape, 150 times the maps,
// because neighbouring queries' windows overlap by 7/8 and are fetched
// again per query: such a kernel runs at L2's rate (0.67 ms on an H100).
//
// Design: one block per tile of 8x8 neighbouring queries of one batch item
// and level.
//  - The block reduces its queries' grid corners to a bounding box and
//    copies that box of the level's map into shared memory once, with
//    cp.async (16 bytes a piece), in chunks of 32, 16, 8 or 4 channels: the
//    largest chunk whose stage (52 KB) holds the box. A smooth flow gives a
//    box of about 16x16 pixels at level 0 (chunks of 32); a flow that
//    scatters the windows over 35x35 pixels still fits at 8 or 4 channels a
//    chunk, and a 57x57 box is the limit. One stage, not a ring: four
//    blocks share an SM (64 registers a thread at radius 3), and while one
//    waits for its copy the others compute; a second stage with two blocks
//    to an SM measured a little slower. Box pixels outside the map are
//    zero-filled by the copy, so the arithmetic needs no mask. The tile's
//    64 rows of fmap0 are staged with each chunk too.
//  - Dot products are float32 fused multiply-adds outside the tensor cores.
//    (A plain TF32 product keeps three decimal digits, too few for the
//    1e-4 agreement with the plain version. A split 3xTF32 product by
//    mma.sync on pairs of tile columns, 16 queries against their own dense
//    box, agreed as well as this one but measured no faster: the dense box
//    doubles and the split triples the products.) Only the (2r+2)^2
//    dot products a query needs are formed. A thread owns one query and two
//    or three rows of its grid, (2r+2) running sums a row; it reads a pixel's
//    channels as float4 at addresses that are a compile-time offset from one
//    base per row. A warp holds the eight y-neighbours of one tile column
//    times four grid rows. A pixel's stride is the chunk plus four floats
//    and a box row's pitch is odd, which spreads a warp's pixels over the
//    banks.
//  - The dot products go to shared memory, and all threads blend and write
//    the (2r+1)^2 outputs.
//  - What the tile cannot take stays in the same launch: when the box does
//    not fit even at 4 channels a chunk (windows more than ~50 pixels
//    apart), when C is not a multiple of 4 or a pointer is not 16-byte
//    aligned, or for a radius other than 3 or 4, the block's warps take the
//    queries one by one through lookup_query below, which reads the grid
//    pixels from global memory (one warp per query, lanes split the
//    channels, a transposing butterfly leaves pixel p's sum in lane p).
//    Any C, any radius whose grid fits shared memory, up to 8 levels.
// feature_tracker_tpu_torch/ops/cuda_raft_lookup.py::staged_share mirrors
// the staging rule on the host.
//
// What bounds this design: every multiply-add takes one operand from shared
// memory, and a float4 read by a warp costs four 128-byte wavefronts
// whether or not lanes read the same address (mapping the lanes so that a
// quarter-warp reads one address made it slower, not faster). 0.69 G
// multiply-adds x 4 bytes at 128 B/clk/SM are 0.10 ms; the phase clocks
// (FTK_MARK below) show the multiply-add phase at that rate and at two
// thirds of a block's time, starting the copies and waiting for them at a
// fifth. Going below takes a register tile that uses a loaded value for
// several queries, which needs neighbouring queries' windows aligned (they
// are data), or wgmma on operands split into TF32 halves beforehand.
//
// This library alone is built with fused multiply-adds (--fmad=true): no
// status or threshold depends on a rounding here, and only the order of the
// sum over channels and the fusing separate it from the plain version (max
// |difference| ~2e-5 on values of order 4). The plain version floors
// location + offset per offset, this kernel floors the location once; in
// float32 the two fractions differ in the last bits of the larger number.

#include <limits.h>

#include "klt_common.cuh"

namespace {

using namespace ftk;

constexpr int kTile = 8;                       // queries per tile side
constexpr int kTileQueries = kTile * kTile;
constexpr int kThreads = 256;                  // one warp per tile column
constexpr int kStageFloats = 13312;            // 52 KB: a staged chunk
constexpr float kMaxCorner = 1073741824.0f;    // 2^30

struct FeaturePyramid {
  const float* f1[FTK_MAX_LEVELS];  // [B, h, w, C] per level
  int h[FTK_MAX_LEVELS];
  int w[FTK_MAX_LEVELS];
  int levels;
};

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  float v[1];
  __device__ __forceinline__ void load(const float* p) { v[0] = *p; }
};
template <>
struct Vec<4> {
  float v[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
};

// Floats between two staged pixels for a chunk of `ch` channels: an odd
// number of 16-byte units, so that neighbouring pixels fall in other banks.
__host__ __device__ constexpr int pixel_stride(int ch) {
  return ch > 4 ? ch + 4 : 4;
}

// Box pixels (rows times odd pitch) that fit a stage at `ch` channels,
// beside the tile's rows of fmap0.
__host__ __device__ constexpr int box_capacity(int ch) {
  return kStageFloats / pixel_stride(ch) - kTileQueries;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool read) {
  // With a source size of 0 nothing is read and 16 zero bytes are written.
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = read ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit_and_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The four-tap blend of one query's grid of dot products into its window.
__device__ __forceinline__ float blend(const float* dots, int gw, int k, int o,
                                       float fx, float fy) {
  const int dy = o / k;
  const float* d = dots + dy * gw + (o - dy * k);
  const float w00 = (1.0f - fy) * (1.0f - fx), w01 = (1.0f - fy) * fx;
  const float w10 = fy * (1.0f - fx), w11 = fy * fx;
  return w00 * d[0] + w01 * d[1] + w10 * d[gw] + w11 * d[gw + 1];
}

// Border mode's blend: sample o's position, clamped into the map, on the
// grid of corner (x0, y0); the map's first and last pixels lie at local
// -x0 and w - 1 - x0 (and likewise in y).
__device__ __forceinline__ float blend_border(const float* dots, int gw, int k,
                                              int o, float fx, float fy,
                                              int x0, int y0, int h, int w) {
  const int dy = o / k;
  const float sx = fminf(fmaxf(fx + (float)(o - dy * k), (float)(-x0)),
                         (float)(w - 1 - x0));
  const float sy = fminf(fmaxf(fy + (float)dy, (float)(-y0)),
                         (float)(h - 1 - y0));
  const float ixf = floorf(sx), iyf = floorf(sy);
  const float tx = sx - ixf, ty = sy - iyf;
  const float* d = dots + (int)iyf * gw + (int)ixf;
  const float w00 = (1.0f - ty) * (1.0f - tx), w01 = (1.0f - ty) * tx;
  const float w10 = ty * (1.0f - tx), w11 = ty * tx;
  return w00 * d[0] + w01 * d[1] + w10 * d[gw] + w11 * d[gw + 1];
}

// Border mode's centre: the location at this level clamped into
// [-r, w - 1 + r] x [-r, h - 1 + r]; NaN stays NaN (and so has no grid).
__device__ __forceinline__ void clamp_centre(float& cx, float& cy, int radius,
                                             int h, int w) {
  if (isfinite(cx) && isfinite(cy)) {
    cx = fminf(fmaxf(cx, (float)-radius), (float)(w - 1 + radius));
    cy = fminf(fmaxf(cy, (float)-radius), (float)(h - 1 + radius));
  } else {
    cx = cy = __int_as_float(0x7fffffff);
  }
}

// One query at one level by one warp, reading the grid pixels from global
// memory; `dots` is the warp's (2r+2)^2 floats of shared memory.
template <int VEC, bool BORDER>
__device__ void lookup_query(const float* __restrict__ f1, int h, int w,
                             const float* __restrict__ f0, float lx, float ly,
                             float inv, float* __restrict__ out_l,
                             float* dots, int channels, int radius,
                             float scale, int lane) {
  const int k = 2 * radius + 1;   // window side
  const int gw = k + 1;           // grid side
  const int grid = gw * gw;
  float cx = lx * inv, cy = ly * inv;
  if (BORDER) clamp_centre(cx, cy, radius, h, w);
  const float x0f = floorf(cx), y0f = floorf(cy);
  // Decided on the floats: NaN and infinities compare false.
  if (!(fabsf(x0f) <= kMaxCorner && fabsf(y0f) <= kMaxCorner)) {
    for (int o = lane; o < k * k; o += 32) out_l[o] = 0.0f;
    return;
  }
  const float fx = cx - x0f, fy = cy - y0f;
  const int x0 = (int)x0f - radius, y0 = (int)y0f - radius;

  for (int p0 = 0; p0 < grid; p0 += 32) {
    // This lane's pixel of the chunk: its offset in the map, or -1.
    int offset = -1;
    const int p = p0 + lane;
    if (p < grid) {
      const int gy = p / gw;
      const int y = y0 + gy, x = x0 + (p - gy * gw);
      if (y >= 0 && y < h && x >= 0 && x < w) offset = y * w + x;
    }
    float acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.0f;
    // Every lane takes every trip (the shuffles need the whole warp). The
    // reads are unconditional, so that the 32 of a trip are in flight
    // together: a pixel outside the map reads pixel 0 and a lane whose
    // channels lie beyond C reads channel 0, and both add nothing.
    for (int c0 = 0; c0 < channels; c0 += 32 * VEC) {
      const bool mine = c0 + lane * VEC < channels;
      const int c = mine ? c0 + lane * VEC : 0;
      Vec<VEC> q;
      q.load(f0 + c);
#pragma unroll
      for (int i = 0; i < VEC; ++i) q.v[i] = q.v[i] * scale;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int o = __shfl_sync(0xffffffffu, offset, j);
        Vec<VEC> t;
        t.load(f1 + (size_t)(o < 0 ? 0 : o) * channels + c);
        float part = q.v[0] * t.v[0];
#pragma unroll
        for (int i = 1; i < VEC; ++i) part = part + q.v[i] * t.v[i];
        acc[j] = acc[j] + (o >= 0 && mine ? part : 0.0f);
      }
    }
    const float dot = transpose_sum(acc, lane);
    if (p < grid) dots[p] = dot;
  }
  __syncwarp();
  for (int o = lane; o < k * k; o += 32)
    out_l[o] = BORDER ? blend_border(dots, gw, k, o, fx, fy, x0, y0, h, w)
                      : blend(dots, gw, k, o, fx, fy);
  __syncwarp();
}

// A tile's queries, shared by the block.
struct TileQueries {
  int n[kTileQueries];      // index of the query in [B H W], -1: beyond H, W
  int x0[kTileQueries];     // grid corner
  int y0[kTileQueries];
  float fx[kTileQueries];   // fractional part of the location
  float fy[kTileQueries];
  int live[kTileQueries];   // the grid meets the map: there is work
  int box[4];               // min x0, min y0, max x0, max y0 over live
};

// Blocks that share an SM: four of the staged kernel at radius 3 (64
// registers a thread), three at radius 4, whose threads hold 30 sums.
__host__ __device__ constexpr int blocks_per_sm(int gw) {
  return gw == 0 ? 1 : (gw <= 8 ? 4 : 3);
}

// Chunk `c0` of the box and of the tile's fmap0 rows into `stage`.
__device__ __forceinline__ void stage_chunk(
    float* stage, const TileQueries& q, const float* __restrict__ fmap0,
    const float* __restrict__ f1, int h, int w, int channels, int c0, int ch,
    int bx0, int by0, int bw, int pitch, int npix) {
  const int shift = 31 - __clz(ch >> 2);           // log2 of pieces a pixel
  const int groups = min(ch, channels - c0) >> 2;  // pieces this chunk has
  const int ps = pixel_stride(ch);
  const int total = (npix + kTileQueries) << shift;
  // p / pitch as a multiplication: exact for p, pitch < 2^16.
  const unsigned magic = 0xffffffffu / (unsigned)pitch + 1;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int g = i & ((1 << shift) - 1);
    int p = i >> shift;
    if (g >= groups) continue;
    const float* src;
    bool read;
    if (p < kTileQueries) {
      read = q.n[p] >= 0;
      src = fmap0 + (size_t)(read ? q.n[p] : 0) * channels;
    } else {
      const int py = (int)__umulhi((unsigned)(p - kTileQueries), magic);
      const int px = (p - kTileQueries) - py * pitch;
      const int y = by0 + py, x = bx0 + px;
      read = px < bw && y >= 0 && y < h && x >= 0 && x < w;
      src = f1 + (read ? (size_t)y * w + x : 0) * channels;
    }
    cp_async16(stage + (size_t)p * ps + 4 * g, src + c0 + 4 * g, read);
  }
}

// One staged chunk into the thread's running sums: ROWS grid rows of GW
// pixels each, `groups` float4 of channels.
template <int GW, int ROWS, int PS>
__device__ __forceinline__ void accumulate_chunk(const float* stage, int slot,
                                                 const int (&row)[ROWS],
                                                 int groups, float scale,
                                                 float (&acc)[ROWS][GW]) {
  const float* f0 = stage + slot * PS;
  const float* box = stage + kTileQueries * PS;
  for (int g = 0; g < groups; ++g) {
    float4 a = *reinterpret_cast<const float4*>(f0 + 4 * g);
    a.x = a.x * scale, a.y = a.y * scale, a.z = a.z * scale,
    a.w = a.w * scale;
#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      const float* r = box + row[s] + 4 * g;
#pragma unroll
      for (int j = 0; j < GW; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(r + j * PS);
        acc[s][j] = acc[s][j] + a.x * v.x;
        acc[s][j] = acc[s][j] + a.y * v.y;
        acc[s][j] = acc[s][j] + a.z * v.z;
        acc[s][j] = acc[s][j] + a.w * v.w;
      }
    }
  }
}

// The grid row that lane `lane` takes in its row slot `s`, or GW for none:
// a quarter of a warp, the eight y-neighbours of a tile column, shares one
// grid row.
template <int GW>
__device__ __forceinline__ int grid_row(int lane, int s) {
  const int gy = (lane >> 3) + 4 * s;
  return gy < GW ? gy : GW;
}

// A tile whose box is staged at `ch` channels a chunk: the dot products of
// all its queries from shared memory, then the blend. Whole block.
template <int GW, bool BORDER>
__device__ __forceinline__ void lookup_tile_staged(
    float* smem, const TileQueries& q, const float* __restrict__ fmap0,
    const float* __restrict__ f1, int h, int w, int channels, int radius,
    float scale, int ch, bool any_live, int npix, float* __restrict__ out,
    int levels, int lvl, PhaseClock& phases) {
  constexpr int ROWS = (GW + 3) / 4;
  const bool first = threadIdx.x == 0;  // its clocks are the block's
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bx0 = q.box[0], by0 = q.box[1];
  const int bw = any_live ? q.box[2] - bx0 + GW : 0;
  const int pitch = bw | 1;
  // This thread: the query of slot warp * 8 + lane % 8, grid rows
  // grid_row(lane, s).
  const int slot = warp * kTile + (lane & 7);
  const bool live = q.live[slot] != 0;
  const int ps = pixel_stride(ch);
  int row[ROWS];
  float acc[ROWS][GW];
#pragma unroll
  for (int s = 0; s < ROWS; ++s) {
    const int gy = grid_row<GW>(lane, s);
    // A thread without work reads the first pixels of the box.
    row[s] = live && gy < GW
                 ? ((q.y0[slot] - by0 + gy) * pitch + (q.x0[slot] - bx0)) * ps
                 : 0;
#pragma unroll
    for (int j = 0; j < GW; ++j) acc[s][j] = 0.0f;
  }
  if (any_live) {
    const int chunks = (channels + ch - 1) / ch;
    for (int c = 0; c < chunks; ++c) {
      stage_chunk(smem, q, fmap0, f1, h, w, channels, c * ch, ch, bx0, by0,
                  bw, pitch, npix);
      FTK_MARK(phases, 2, first);
      cp_async_commit_and_wait();
      __syncthreads();  // the chunk has landed
      FTK_MARK(phases, 1, first);
      const int groups = min(ch, channels - c * ch) >> 2;
      if (ch == 32)
        accumulate_chunk<GW, ROWS, pixel_stride(32)>(smem, slot, row, groups,
                                                     scale, acc);
      else if (ch == 16)
        accumulate_chunk<GW, ROWS, pixel_stride(16)>(smem, slot, row, groups,
                                                     scale, acc);
      else if (ch == 8)
        accumulate_chunk<GW, ROWS, pixel_stride(8)>(smem, slot, row, groups,
                                                    scale, acc);
      else
        accumulate_chunk<GW, ROWS, pixel_stride(4)>(smem, slot, row, groups,
                                                    scale, acc);
      FTK_MARK(phases, 3, first);
      __syncthreads();  // read out: the next chunk, or the dots, take its place
      FTK_MARK(phases, 1, first);
    }
  }
  float* dots = smem;  // [slot][GW][GW]
#pragma unroll
  for (int s = 0; s < ROWS; ++s) {
    const int gy = grid_row<GW>(lane, s);
    if (gy < GW) {
#pragma unroll
      for (int j = 0; j < GW; ++j)
        dots[(slot * GW + gy) * GW + j] = live ? acc[s][j] : 0.0f;
    }
  }
  __syncthreads();
  constexpr int k = GW - 1, kk = k * k;  // the window side 2r+1
  for (int i = threadIdx.x; i < kTileQueries * kk; i += kThreads) {
    const int s = i / kk, o = i - s * kk;
    if (q.n[s] < 0) continue;
    float* out_l = out + ((size_t)q.n[s] * levels + lvl) * kk;
    // A query without work: zeros (its fx, fy may be unset).
    if (BORDER)
      out_l[o] = q.live[s] ? blend_border(dots + s * GW * GW, GW, k, o,
                                          q.fx[s], q.fy[s], q.x0[s], q.y0[s],
                                          h, w)
                           : 0.0f;
    else
      out_l[o] = q.live[s] ? blend(dots + s * GW * GW, GW, k, o, q.fx[s],
                                   q.fy[s])
                           : 0.0f;
  }
  FTK_MARK(phases, 4, first);
}

// GW: the grid side 2r+2 when the staged path is compiled for this radius
// (and VEC is 4), else 0: every tile then takes the per-query path. BORDER:
// border mode.
template <int GW, int VEC, bool BORDER>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(GW))
    raft_lookup_kernel(FeaturePyramid pyr, const float* __restrict__ fmap0,
                       const float* __restrict__ locations,
                       float* __restrict__ out, int height, int width,
                       int channels, int radius, float scale, int tiles_x,
                       int tiles_y) {
  extern __shared__ __align__(16) float smem[];
  __shared__ TileQueries q;
  __shared__ int chunk;  // channels a staged chunk; 0: per-query path

  int bid = blockIdx.x;
  const int lvl = bid % pyr.levels;
  bid /= pyr.levels;
  const int tile_x = bid % tiles_x;
  bid /= tiles_x;
  const int tile_y = bid % tiles_y;
  const int item = bid / tiles_y;

  const int h = pyr.h[lvl], w = pyr.w[lvl];
  const float* f1 = pyr.f1[lvl] + (size_t)item * h * w * channels;
  const float inv = 1.0f / (float)(1 << lvl);  // 2^-level, exact
  const int k = 2 * radius + 1, gw = k + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // Phases (FTK_PHASE_CLOCKS builds only), by the block's first thread:
  // 0 the tile's queries and box, 1 waiting for a chunk and the block,
  // 2 starting a chunk's copies, 3 multiply-adds, 4 dots and blend, 5 the
  // per-query path.
  PhaseClock phases;

  // The tile's queries; slot = column * 8 + row, so that the y-neighbours
  // of a column are one warp's.
  if (threadIdx.x < 4) q.box[threadIdx.x] = threadIdx.x < 2 ? INT_MAX : INT_MIN;
  if (threadIdx.x == 0) chunk = 0;
  __syncthreads();
  for (int slot = threadIdx.x; slot < kTileQueries; slot += blockDim.x) {
    const int x = tile_x * kTile + slot / kTile;
    const int y = tile_y * kTile + slot % kTile;
    const bool exists = x < width && y < height;
    const int n = exists ? (item * height + y) * width + x : -1;
    q.n[slot] = n;
    int live = 0;
    if (GW > 0 && exists) {
      float cx = locations[2 * (size_t)n] * inv;
      float cy = locations[2 * (size_t)n + 1] * inv;
      if (BORDER) clamp_centre(cx, cy, radius, h, w);
      const float x0f = floorf(cx), y0f = floorf(cy);
      // Decided on the floats: NaN and infinities compare false.
      if (fabsf(x0f) <= kMaxCorner && fabsf(y0f) <= kMaxCorner) {
        const int x0 = (int)x0f - radius, y0 = (int)y0f - radius;
        q.x0[slot] = x0, q.y0[slot] = y0;
        q.fx[slot] = cx - x0f, q.fy[slot] = cy - y0f;
        live = x0 > -GW && x0 < w && y0 > -GW && y0 < h;
        if (live) {
          atomicMin(&q.box[0], x0), atomicMin(&q.box[1], y0);
          atomicMax(&q.box[2], x0), atomicMax(&q.box[3], y0);
        }
      }
    }
    q.live[slot] = live;
  }
  __syncthreads();

  if constexpr (GW > 0) {
    // The box of the live queries' grids (not clipped to the map: what
    // lies outside is zero-filled), and the chunk it allows.
    const bool any_live = q.box[0] <= q.box[2];
    const int bw = any_live ? q.box[2] - q.box[0] + GW : 0;
    const int bh = any_live ? q.box[3] - q.box[1] + GW : 0;
    const long long area = (long long)bh * (bw | 1);
    const int npix = area <= box_capacity(4) ? (int)area : 0;
    if (threadIdx.x == 0) {
      int ch = 4;  // a tile without any work counts as staged
      if (any_live && area > box_capacity(4)) ch = 0;
      while (ch >= 4 && ch < 32 && npix <= box_capacity(2 * ch)) ch *= 2;
      chunk = ch;
    }
    __syncthreads();
    const int ch = chunk;
    FTK_MARK(phases, 0, threadIdx.x == 0);
    if (ch > 0) {
      lookup_tile_staged<GW, BORDER>(smem, q, fmap0, f1, h, w, channels,
                                     radius, scale, ch, any_live, npix, out,
                                     pyr.levels, lvl, phases);
      return;
    }
  }

  // The per-query path: the block's warps take the tile's queries in turn.
  const int warps = blockDim.x >> 5;
  float* dots = smem + (size_t)warp * gw * gw;
  for (int slot = warp; slot < kTileQueries; slot += warps) {
    const int n = q.n[slot];
    if (n < 0) continue;
    lookup_query<VEC, BORDER>(
        f1, h, w, fmap0 + (size_t)n * channels, locations[2 * (size_t)n],
        locations[2 * (size_t)n + 1], inv,
        out + ((size_t)n * pyr.levels + lvl) * k * k, dots, channels, radius,
        scale, lane);
  }
  FTK_MARK(phases, 5, threadIdx.x == 0);
}

template <int GW, int VEC, bool BORDER>
cudaError_t launch(const FeaturePyramid& pyr, const float* fmap0,
                   const float* locations, float* out, int batch, int height,
                   int width, int channels, int radius, float scale,
                   cudaStream_t stream, int* blocks_per_sm) {
  auto kernel = raft_lookup_kernel<GW, VEC, BORDER>;
  const size_t per_warp =
      sizeof(float) * (size_t)(2 * radius + 2) * (2 * radius + 2);
  int warps;
  size_t smem;
  cudaError_t e;
  if (GW > 0) {
    warps = kThreads / 32;
    smem = sizeof(float) * kStageFloats;  // holds the dots too
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  } else {
    e = plan_block(kernel, per_warp, &warps, &smem);
  }
  if (e != cudaSuccess) return e;
  if (blocks_per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                         32 * warps, smem);
  const int tiles_x = (width + kTile - 1) / kTile;
  const int tiles_y = (height + kTile - 1) / kTile;
  const long long blocks = (long long)tiles_x * tiles_y * batch * pyr.levels;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(int)blocks, 32 * warps, smem, stream>>>(
      pyr, fmap0, locations, out, height, width, channels, radius, scale,
      tiles_x, tiles_y);
  return cudaGetLastError();
}

// The kernel for this radius and alignment: staged at radius 3 and 4.
template <bool BORDER>
cudaError_t dispatch(const FeaturePyramid& pyr, const float* f0,
                     const float* loc, float* out, int batch, int height,
                     int width, int channels, int radius, bool vec4,
                     float scale, cudaStream_t s, int* blocks_per_sm) {
  if (vec4 && radius == 3)
    return launch<8, 4, BORDER>(pyr, f0, loc, out, batch, height, width,
                                channels, radius, scale, s, blocks_per_sm);
  if (vec4 && radius == 4)
    return launch<10, 4, BORDER>(pyr, f0, loc, out, batch, height, width,
                                 channels, radius, scale, s, blocks_per_sm);
  if (vec4)
    return launch<0, 4, BORDER>(pyr, f0, loc, out, batch, height, width,
                                channels, radius, scale, s, blocks_per_sm);
  return launch<0, 1, BORDER>(pyr, f0, loc, out, batch, height, width,
                              channels, radius, scale, s, blocks_per_sm);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success); `padding` is 0 (zeros) or 1 (border). The level pointer and size
// arrays live on the host; fmap0 [B, H, W, C], the levels [B, h_l, w_l, C],
// locations [B, H, W, 2] and out [B, H, W, L (2r+1)^2] are contiguous
// float32 on the device. With
// `blocks_per_sm` not null nothing is launched: it receives the number of
// blocks of this configuration's kernel that one SM holds at once.
int ftk_raft_lookup(const void* const* level_ptrs, const int* heights,
                    const int* widths, int levels, const void* fmap0,
                    const void* locations, void* out, int batch, int height,
                    int width, int channels, int radius, int padding,
                    float scale, void* stream, int* blocks_per_sm) {
  if (levels < 1 || levels > FTK_MAX_LEVELS || batch < 0 || height < 0 ||
      width < 0 || channels < 1 || radius < 0 || radius > 1024 ||
      (padding != 0 && padding != 1))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)batch * height * width;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n == 0 && !blocks_per_sm) return (int)cudaSuccess;
  FeaturePyramid pyr;
  for (int l = 0; l < FTK_MAX_LEVELS; ++l) {
    const bool on = l < levels;
    pyr.f1[l] = on ? (const float*)level_ptrs[l] : nullptr;
    pyr.h[l] = on ? heights[l] : 0;
    pyr.w[l] = on ? widths[l] : 0;
    // Offsets inside one item's map are ints.
    if (on && (heights[l] < 1 || widths[l] < 1 ||
               (long long)heights[l] * widths[l] > 0x7fffffffLL))
      return (int)cudaErrorInvalidValue;
  }
  pyr.levels = levels;

  // 16-byte reads and copies need every row's start aligned: C a multiple
  // of 4 and aligned base pointers.
  bool vec4 = channels % 4 == 0 && ((uintptr_t)fmap0 & 15) == 0;
  for (int l = 0; l < levels; ++l)
    vec4 = vec4 && ((uintptr_t)level_ptrs[l] & 15) == 0;
  const float* f0 = (const float*)fmap0;
  const float* loc = (const float*)locations;
  cudaStream_t s = (cudaStream_t)stream;
  return padding ? (int)dispatch<true>(pyr, f0, loc, (float*)out, batch,
                                       height, width, channels, radius, vec4,
                                       scale, s, blocks_per_sm)
                 : (int)dispatch<false>(pyr, f0, loc, (float*)out, batch,
                                        height, width, channels, radius, vec4,
                                        scale, s, blocks_per_sm);
}

}  // extern "C"

FTK_DEFINE_ERROR_STRING
