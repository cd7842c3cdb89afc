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
// level-major, then dy-major, dx-minor.
//
// The offsets are integers, so all samples of one query at one level share
// one fractional part (fx, fy): they are four-tap blends, with four constant
// weights, of the (2r+2)^2 dot products on the integer grid whose corner is
// floor(x, y) - r. A grid pixel outside the map has dot product 0, which is
// the per-tap zero padding. A query whose location is NaN, infinite or
// beyond +-2^30 has no valid tap and writes zeros.
//
// Bound on an H100 at the serving shape (B=4, 55x128 queries, C=128, three
// levels, r=3): 28,160 x 3 x 64 dot products of 128 channels are 1.38 GFLOP,
// 0.021 ms at 67 TFLOP/s of float32 outside the tensor cores; fmap0, the
// pyramid and the locations read once and the output written once are 50 MB,
// 0.015 ms at 3.35 TB/s. Operations bind.
//
// Design: one warp per query, several warps per block, neighbouring queries
// in neighbouring warps so that their overlapping windows meet in L1. Lanes
// split the channels: a grid pixel's C floats are one coalesced read (16
// bytes a lane when C is a multiple of 4), multiplied into the lane's share
// of f0[n] / sqrt(C). The reads of a chunk of pixels are unconditional and
// independent, so many are in flight at once (with a branch round each one
// the kernel waited out every read's latency in turn and took 0.83 ms at the
// serving shape). The grid is taken 32 pixels at a time: each lane
// first works out one pixel's offset in the map (or that it lies outside)
// and the warp reads the offsets back by shuffle, so the address arithmetic
// is done once per pixel, not once per lane and pixel; each lane keeps 32
// partial sums, and a transposing butterfly (31 shuffles for 32 sums
// instead of 5 each) leaves pixel p's dot product in lane p. The dot
// products go to per-warp shared memory, (2r+2)^2 floats, and the lanes
// blend and write the (2r+1)^2 outputs, coalesced. Any C, any radius whose
// grid fits shared memory, up to 8 levels. The feature maps are read
// through L1/L2: each grid pixel is read once per query that covers it.
// Staging window rows for several queries at once (cp.async or TMA) and
// the tensor cores on a tile of neighbouring queries are later work.
//
// Built with --fmad=false like the other kernels: products and sums round
// on their own as in the plain version, and only the order of the sum over
// channels differs from it. (The plain version floors location + offset per
// offset, this kernel floors the location once; in float32 the two
// fractions differ in the last bits of the larger of the two numbers.)

#include "klt_common.cuh"

namespace {

using namespace ftk;

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

// acc[j] of every lane summed over the lanes; lane p returns the total of
// acc[p]. Each step halves the values a lane holds: a lane keeps the half
// its bit selects and receives the partner's sums for that half.
__device__ __forceinline__ float transpose_sum(float (&acc)[32], int lane) {
#pragma unroll
  for (int half = 16; half >= 1; half >>= 1) {
    const bool upper = (lane & half) != 0;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float keep = upper ? acc[j + half] : acc[j];
      const float send = upper ? acc[j] : acc[j + half];
      acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, half);
    }
  }
  return acc[0];
}

template <int VEC>
__global__ void raft_lookup_kernel(FeaturePyramid pyr,
                                   const float* __restrict__ fmap0,
                                   const float* __restrict__ locations,
                                   float* __restrict__ out, int n_queries,
                                   int queries_per_item, int channels,
                                   int radius, float scale) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= n_queries) return;  // whole warp

  const int k = 2 * radius + 1;   // window side
  const int gw = k + 1;           // grid side
  const int grid = gw * gw;
  float* dots = smem + (size_t)warp * grid;
  const int item = n / queries_per_item;
  const float* f0 = fmap0 + (size_t)n * channels;
  const float lx = locations[2 * (size_t)n];
  const float ly = locations[2 * (size_t)n + 1];
  float* out_n = out + (size_t)n * pyr.levels * k * k;

  float inv = 1.0f;  // 2^-level, exact
  for (int lvl = 0; lvl < pyr.levels; ++lvl, inv *= 0.5f) {
    const int h = pyr.h[lvl], w = pyr.w[lvl];
    const float* f1 = pyr.f1[lvl] + (size_t)item * h * w * channels;
    const float cx = lx * inv, cy = ly * inv;
    const float x0f = floorf(cx), y0f = floorf(cy);
    float* out_l = out_n + lvl * k * k;
    // Decided on the floats: NaN and infinities compare false.
    if (!(fabsf(x0f) <= 1073741824.0f && fabsf(y0f) <= 1073741824.0f)) {
      for (int o = lane; o < k * k; o += 32) out_l[o] = 0.0f;
      continue;
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

    const float w00 = (1.0f - fy) * (1.0f - fx), w01 = (1.0f - fy) * fx;
    const float w10 = fy * (1.0f - fx), w11 = fy * fx;
    for (int o = lane; o < k * k; o += 32) {
      const int dy = o / k;
      const float* d = dots + dy * gw + (o - dy * k);
      out_l[o] = w00 * d[0] + w01 * d[1] + w10 * d[gw] + w11 * d[gw + 1];
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). The level pointer and size arrays live on the host; fmap0
// [B, H, W, C], the levels [B, h_l, w_l, C], locations [B, H, W, 2] and out
// [B, H, W, L (2r+1)^2] are contiguous float32 on the device.
int ftk_raft_lookup(const void* const* level_ptrs, const int* heights,
                    const int* widths, int levels, const void* fmap0,
                    const void* locations, void* out, int batch,
                    int queries_per_item, int channels, int radius,
                    float scale, void* stream) {
  if (levels < 1 || levels > FTK_MAX_LEVELS || batch < 0 ||
      queries_per_item < 0 || channels < 1 || radius < 0 || radius > 1024)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)batch * queries_per_item;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
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

  const size_t per_warp =
      sizeof(float) * (size_t)(2 * radius + 2) * (2 * radius + 2);
  // 16-byte reads need every row's start aligned: C a multiple of 4 and
  // aligned base pointers.
  bool vec4 = channels % 4 == 0 && ((uintptr_t)fmap0 & 15) == 0;
  for (int l = 0; l < levels; ++l)
    vec4 = vec4 && ((uintptr_t)level_ptrs[l] & 15) == 0;
  auto kernel = vec4 ? raft_lookup_kernel<4> : raft_lookup_kernel<1>;
  int warps;
  size_t smem;
  cudaError_t e = plan_block(kernel, per_warp, &warps, &smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (int)((n + warps - 1) / warps);
  kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
      pyr, (const float*)fmap0, (const float*)locations, (float*)out, (int)n,
      queries_per_item, channels, radius, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"

FTK_DEFINE_ERROR_STRING
