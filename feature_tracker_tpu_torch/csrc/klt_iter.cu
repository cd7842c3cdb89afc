// Basic-KLT DIRECT / INVERSE mode over a whole image pyramid, one launch,
// for Hopper.
//
// Replaces: feature_tracker_tpu/ops/pallas_klt.py::track_pyramid_iter_pallas
// (l.1327, body _iter_kernel l.1127). Plain version: feature_tracker_tpu_torch/
// trackers/klt/basic.py::track_pyramid_iter_reference; Python wrapper:
// feature_tracker_tpu_torch/ops/cuda_klt.py::track_pyramid_iter_cuda.
//
// What it computes, per non-skipped feature, coarse to fine over L levels
// (positions scaled by 2^-(L-1) first, doubled between levels):
//  - level setup: the extended (pr+2)x(pc+2) reference patch sampled with
//    one anchor and four constant bilinear weights (an invalid tap reads
//    0). Its centre is the reference value; for INVERSE its +-1 neighbours
//    are the gradients, fixed for the level.
//  - up to max_iterations Gauss-Newton steps. Each samples the current
//    image with the current position's constant weights: INVERSE the
//    pr x pc patch, DIRECT the extended patch, whose centre is the current
//    value and whose +-1 neighbours are the gradients (the shifts share the
//    anchor's fraction, so one sample yields all five). H and b are rebuilt
//    over the pixels where all four gradient taps, the reference tap and
//    the current tap are valid. v = H^-1 b in closed form. Break rules, in
//    order: no valid pixel (state and status unchanged); NaN step
//    (NUMERIC_ERROR, uv unchanged); update; the updated position left this
//    level's image (OUTSIDE); the squared step < max_converge_step
//    (TRACKED). No divergence counter.
// The incoming status is kept, also from level to level: a feature that
// never meets a break rule leaves with the status it came in with, and each
// level starts its chain anew. Skipped lanes return their cur_uv and
// incoming status at once. The final outside check is the caller's.
//
// Bound on an H100: as klt_fast.cu, the pyramids are read from HBM once
// (752x480, 4 levels, both frames: 3.8 MB, 1.1 us at 3.35 TB/s) and every
// window read hits L2 or L1. Per step and patch pixel the work is the
// bilinear sample (7 FLOP; DIRECT (pr+2)(pc+2) of them), the residual and
// five products and sums: ~18 FLOP, all f32 outside the tensor cores
// (67 TFLOP/s). Bound by operations, not bytes; in practice by latency:
// each step is a dependent chain of loads, a reduction and a 2x2 solve,
// one feature per warp.
//
// Design: one warp per feature and several warps per block, each lane a
// strided share of the patch pixels, butterfly sums so that every lane
// holds the same scalar state. One source serves both modes: the mode is a
// template argument.
//  - The pixels that count in a step are the intersection of six
//    rectangles (four gradient taps, the reference tap, the current tap),
//    which is one rectangle in (i, j): it is computed once per step from
//    the two anchors, its area is the step's pixel count (no reduction),
//    and a lane tests its pixels against it with four compares. A step
//    with no pixel stops before it loads anything.
//  - A lane's pixel coordinates are computed once per launch and, where
//    the patch has at most 32 * kRegPix pixels (13x13: 6 a lane), its
//    reference values and (INVERSE) the reference gradients once per level,
//    all in registers: an INVERSE step reads nothing but its current taps.
//    Larger patches keep the gradients in shared memory.
//  - Loads go out together and without a branch before them: the reference
//    patch and DIRECT's per-step current patch four samples at a time
//    (klt_common.cuh::load_extended_patch_batched), INVERSE's current taps
//    for all of a lane's pixels at once; a tap outside the rectangle reads
//    pixel (0, 0) and is discarded.
//  - The five float32 sums of a step are reduced by one transposing
//    butterfly (klt_common.cuh::transpose_sum): 7 + 2 shuffles and five
//    broadcasts in place of 25.
//  - __launch_bounds__(256, 3) on the register path: three blocks of eight
//    warps = 24 warps to an SM at 80 registers a thread (two blocks, 104
//    registers, measured slower); the shared-memory path keeps two.
// Tried on the card and dropped, as no faster: staging the image pixels
// under each patch in shared memory (one load per pixel in place of four
// per tap), loading a patch column by column, prefetching the next level's
// windows into L1, eight samples' loads at once, four blocks to an SM
// (spills), and packing a lane's pixel coordinates into one register each.
// The phase clocks (FTK_MARK below) put, on an H100 at 752x480 with 10240
// features, INVERSE: 58 % of the warps' time in the level setups, 34 % in
// the steps' pixels, 3 % in their reductions and 1 % in the solves;
// DIRECT: 44 % level setups, 42 % the steps' current patches, 11 % their
// pixels. Both wait on loads of image pixels, not on arithmetic.
// The float32 sums run in another order than in the plain version, so a
// borderline feature may flip at the convergence threshold (compared by
// count). Built with --fmad=false so that the per-pixel arithmetic rounds
// as in the plain version.

#include "klt_common.cuh"

namespace {

using namespace ftk;

constexpr int kMaxWarps = 8;     // per block
constexpr int kRegPix = 6;       // pixels a lane keeps in registers
constexpr int kBatch = 4;        // shared-memory path: loads sent together
constexpr int kNoRow = 1 << 20;  // row of a lane's pixel beyond the patch

__host__ __device__ inline bool pixels_in_registers(int pr, int pc) {
  return pr * pc <= 32 * kRegPix;
}

// Per-warp shared memory (floats): the reference extended patch, then the
// current extended patch (DIRECT) or, on the shared-memory path, the two
// reference gradient planes (INVERSE).
__host__ __device__ inline size_t warp_floats(int pr, int pc, bool inverse) {
  const size_t ex_n = (size_t)(pr + 2) * (pc + 2), p_n = (size_t)pr * pc;
  if (!inverse) return 2 * ex_n;
  return ex_n + (pixels_in_registers(pr, pc) ? 0 : 2 * p_n);
}

// A rectangle of patch pixels (i, j), bounds included.
struct Rect {
  int i_lo, i_hi, j_lo, j_hi;
  __device__ __forceinline__ bool holds(int i, int j) const {
    return i >= i_lo && i <= i_hi && j >= j_lo && j <= j_hi;
  }
  __device__ __forceinline__ int area() const {
    return i_hi < i_lo || j_hi < j_lo ? 0
                                      : (i_hi - i_lo + 1) * (j_hi - j_lo + 1);
  }
};

// kInverse: INVERSE (else DIRECT). kPix: pixels a lane keeps in registers
// (kRegPix), or 0 for the shared-memory path.
template <bool kInverse, int kPix>
__global__ void __launch_bounds__(32 * kMaxWarps, kPix > 0 ? 3 : 2)
    klt_iter_pyramid_kernel(Pyramids pyr, Options opt,
                            const float* __restrict__ ref_uv,
                            const float* __restrict__ cur_uv,
                            const int8_t* __restrict__ status_in,
                            const uint8_t* __restrict__ skip,
                            float* __restrict__ out_uv,
                            int8_t* __restrict__ out_status, int n) {
  constexpr int K = kPix > 0 ? kPix : 1;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f = blockIdx.x * (blockDim.x >> 5) + warp;
  if (f >= n) return;  // whole warp

  const int pr = opt.pr, pc = opt.pc;
  const int epr = pr + 2, epc = pc + 2;
  const int ex_n = epr * epc, p_n = pr * pc;
  float* ex = smem + (size_t)warp * warp_floats(pr, pc, kInverse);
  float* cex = ex + ex_n;  // DIRECT: the current extended patch
  float* gxs = ex + ex_n;  // INVERSE, shared-memory path: the gradients
  float* gys = gxs + p_n;

  float cx = cur_uv[2 * f], cy = cur_uv[2 * f + 1];
  int status = status_in[f];
  if (skip[f]) {
    if (lane == 0) {
      out_uv[2 * f] = cx;
      out_uv[2 * f + 1] = cy;
      out_status[f] = (int8_t)status;
    }
    return;
  }
  // Phases (FTK_PHASE_CLOCKS builds only): 0 level setup, 1 a step's
  // current patch (DIRECT), 2 its pixels, 3 its reduction, 4 its solve and
  // update.
  PhaseClock phases;
  // Register path: this lane's pixels p = lane + 32 k as (row, column).
  int pi[K], pj[K];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = lane + 32 * k;
    pi[k] = p < p_n ? p / pc : kNoRow;
    pj[k] = p < p_n ? p - pi[k] * pc : 0;
  }
  const float scale = 1.0f / (float)(1 << (pyr.levels - 1));
  float rx = ref_uv[2 * f] * scale, ry = ref_uv[2 * f + 1] * scale;
  cx *= scale;
  cy *= scale;

  for (int lvl = pyr.levels - 1; lvl >= 0; --lvl) {
    const float* __restrict__ R = pyr.ref[lvl];
    const float* __restrict__ C = pyr.cur[lvl];
    const int h = pyr.h[lvl], w = pyr.w[lvl];

    // Level setup: the reference extended patch; (r_min_r, r_min_c) is the
    // tap of inner pixel (0, 0). The pixels whose reference taps count:
    // INVERSE those of the gradients (tap in [1, dim-3], inside the centre
    // tap's [0, dim-2]), DIRECT the centre tap.
    const Anchor ra = make_anchor(rx, ry);
    const int r_min_r = ra.r - pr / 2, r_min_c = ra.c - pc / 2;
    load_extended_patch_batched<4>(R, h, w, ra, epr, epc, lane, ex);
    __syncwarp();
    constexpr int lo = kInverse ? 1 : 0, hi = kInverse ? 3 : 2;
    const Rect ref_rect = {lo - r_min_r, h - hi - r_min_r, lo - r_min_c,
                           w - hi - r_min_c};
    float refc[K], rgx[K], rgy[K];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int e = pi[k] == kNoRow ? epc + 1
                                    : (pi[k] + 1) * epc + (pj[k] + 1);
      refc[k] = ex[e];
      if constexpr (kInverse) {
        rgx[k] = ex[e + 1] - ex[e - 1];
        rgy[k] = ex[e + epc] - ex[e - epc];
      }
    }
    if constexpr (kInverse && kPix == 0) {
      for (int p = lane; p < p_n; p += 32) {
        const int i = p / pc, j = p - i * pc;
        const int e = (i + 1) * epc + (j + 1);
        gxs[p] = ex[e + 1] - ex[e - 1];
        gys[p] = ex[e + epc] - ex[e - epc];
      }
    }
    FTK_MARK(phases, 0, lane == 0);

    for (int it = 0; it < opt.max_iterations; ++it) {
      const Anchor ca = make_anchor(cx, cy);
      const int c_min_r = ca.r - pr / 2, c_min_c = ca.c - pc / 2;
      // The current taps that count: INVERSE the centre tap (in
      // [0, dim-2]), DIRECT the gradients' (in [1, dim-3]).
      constexpr int clo = kInverse ? 0 : 1, chi = kInverse ? 2 : 3;
      const Rect rect = {max(max(ref_rect.i_lo, clo - c_min_r), 0),
                         min(min(ref_rect.i_hi, h - chi - c_min_r), pr - 1),
                         max(max(ref_rect.j_lo, clo - c_min_c), 0),
                         min(min(ref_rect.j_hi, w - chi - c_min_c), pc - 1)};
      if (rect.area() == 0) break;
      if constexpr (!kInverse) {
        load_extended_patch_batched<4>(C, h, w, ca, epr, epc, lane, cex);
        __syncwarp();
      }
      FTK_MARK(phases, 1, lane == 0);
      float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      auto add_pixel = [&](float fx, float fy, float ft) {
        acc[0] += fx * fx;
        acc[1] += fx * fy;
        acc[2] += fy * fy;
        acc[3] += fx * ft;
        acc[4] += fy * ft;
      };
      if constexpr (kPix > 0) {
        if constexpr (kInverse) {
          float t[K][4];
#pragma unroll
          for (int k = 0; k < kPix; ++k) {
            const float* q =
                C + (rect.holds(pi[k], pj[k])
                         ? (size_t)(c_min_r + pi[k]) * w + (c_min_c + pj[k])
                         : 0);
            t[k][0] = q[0], t[k][1] = q[1], t[k][2] = q[w], t[k][3] = q[w + 1];
          }
#pragma unroll
          for (int k = 0; k < kPix; ++k)
            if (rect.holds(pi[k], pj[k])) {
              const float curv = ca.wtl * t[k][0] + ca.wtr * t[k][1] +
                                 ca.wbl * t[k][2] + ca.wbr * t[k][3];
              add_pixel(rgx[k], rgy[k], curv - refc[k]);
            }
        } else {
#pragma unroll
          for (int k = 0; k < kPix; ++k)
            if (rect.holds(pi[k], pj[k])) {
              const int e = (pi[k] + 1) * epc + (pj[k] + 1);
              add_pixel(cex[e + 1] - cex[e - 1], cex[e + epc] - cex[e - epc],
                        cex[e] - refc[k]);
            }
        }
      } else {
        for (int p0 = lane; p0 < p_n; p0 += 32 * kBatch) {
          float t[kBatch][4];
          bool use[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int p = p0 + 32 * u;
            const int i = p / pc, j = p - i * pc;
            use[u] = p < p_n && rect.holds(i, j);
            if constexpr (kInverse) {
              const float* q =
                  C + (use[u] ? (size_t)(c_min_r + i) * w + (c_min_c + j) : 0);
              t[u][0] = q[0], t[u][1] = q[1], t[u][2] = q[w],
              t[u][3] = q[w + 1];
            }
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            if (use[u]) {
              const int p = p0 + 32 * u;
              const int i = p / pc, j = p - i * pc;
              const int e = (i + 1) * epc + (j + 1);
              if constexpr (kInverse) {
                const float curv = ca.wtl * t[u][0] + ca.wtr * t[u][1] +
                                   ca.wbl * t[u][2] + ca.wbr * t[u][3];
                add_pixel(gxs[p], gys[p], curv - ex[e]);
              } else {
                add_pixel(cex[e + 1] - cex[e - 1],
                          cex[e + epc] - cex[e - epc], cex[e] - ex[e]);
              }
            }
        }
      }
      FTK_MARK(phases, 2, lane == 0);
      const float total = transpose_sum(acc, lane);  // lane k: sum k
      const float h00 = __shfl_sync(0xffffffffu, total, 0);
      const float h01 = __shfl_sync(0xffffffffu, total, 1);
      const float h11 = __shfl_sync(0xffffffffu, total, 2);
      const float b0 = -__shfl_sync(0xffffffffu, total, 3);
      const float b1 = -__shfl_sync(0xffffffffu, total, 4);
      // All lanes have read cex[] before the next step overwrites it.
      if constexpr (!kInverse) __syncwarp();
      FTK_MARK(phases, 3, lane == 0);
      const float det = h00 * h11 - h01 * h01;
      const float v0 = (h11 * b0 - h01 * b1) / det;
      const float v1 = (h00 * b1 - h01 * b0) / det;
      FTK_MARK(phases, 4, lane == 0);
      if (isnan(v0) || isnan(v1)) {
        status = kNumericError;
        break;
      }
      cx = cx + v0;
      cy = cy + v1;
      if (cx < 0.0f || cx > (float)(w - 1) || cy < 0.0f ||
          cy > (float)(h - 1)) {
        status = kOutside;
        break;
      }
      if (v0 * v0 + v1 * v1 < opt.max_converge_step) {
        status = kTracked;
        break;
      }
    }
    if (lvl > 0) {
      rx *= 2.0f;
      ry *= 2.0f;
      cx *= 2.0f;
      cy *= 2.0f;
    }
    __syncwarp();  // the next level overwrites the reference patch
  }
  if (lane == 0) {
    out_uv[2 * f] = cx;
    out_uv[2 * f + 1] = cy;
    out_status[f] = (int8_t)status;
  }
}

template <bool kInverse>
void* pick_kernel(const Options& opt) {
  return pixels_in_registers(opt.pr, opt.pc)
             ? (void*)klt_iter_pyramid_kernel<kInverse, kRegPix>
             : (void*)klt_iter_pyramid_kernel<kInverse, 0>;
}

// Kernel, warps per block and dynamic shared memory: as many warps as fit
// half an SM's shared memory, at most kMaxWarps.
cudaError_t plan(const Options& opt, bool inverse, void** kernel, int* warps,
                 size_t* smem) {
  *kernel = inverse ? pick_kernel<true>(opt) : pick_kernel<false>(opt);
  const size_t per_warp =
      sizeof(float) * warp_floats(opt.pr, opt.pc, inverse);
  const size_t half_sm = 113 * 1024, max_smem = 227 * 1024;
  if (per_warp > max_smem) return cudaErrorInvalidValue;
  int nw = (int)(half_sm / per_warp);
  nw = nw < 1 ? 1 : (nw > kMaxWarps ? kMaxWarps : nw);
  *warps = nw;
  *smem = per_warp * nw;
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(*kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Level pointer and size arrays live on the host; image, uv,
// status, skip and output pointers on the device. `inverse` selects the
// INVERSE mode (gradients of the reference image), else DIRECT.
int ftk_klt_iter_pyramid(const void* const* ref_levels,
                         const void* const* cur_levels, const int* heights,
                         const int* widths, int levels, const void* ref_uv,
                         const void* cur_uv, const void* status_in,
                         const void* skip, void* out_uv, void* out_status,
                         int n, int inverse, int patch_row_half_size,
                         int patch_col_half_size, int max_iterations,
                         float max_converge_step, void* stream) {
  Pyramids pyr;
  Options opt;
  if (n < 0 ||
      !fill_pyramids(&pyr, ref_levels, cur_levels, heights, widths, levels) ||
      !fill_options(&opt, patch_row_half_size, patch_col_half_size,
                    max_iterations, 0, max_converge_step))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;

  void* kernel;
  int warps;
  size_t smem;
  cudaError_t e = plan(opt, inverse != 0, &kernel, &warps, &smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + warps - 1) / warps;
  const float *ref_p = (const float*)ref_uv, *cur_p = (const float*)cur_uv;
  const int8_t* st_p = (const int8_t*)status_in;
  const uint8_t* skip_p = (const uint8_t*)skip;
  float* ouv_p = (float*)out_uv;
  int8_t* ost_p = (int8_t*)out_status;
  void* args[] = {&pyr,   &opt,  &ref_p, &cur_p, &st_p,
                  &skip_p, &ouv_p, &ost_p, &n};
  e = cudaLaunchKernel(kernel, dim3(blocks), dim3(32 * warps), args, smem,
                       (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// What the card holds of the kernel these options launch: registers a
// thread, warps a block, and the blocks one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a cudaError.
int ftk_klt_iter_occupancy(int patch_row_half_size, int patch_col_half_size,
                           int inverse, int* registers, int* warps_per_block,
                           int* blocks_per_sm) {
  Options opt;
  if (!fill_options(&opt, patch_row_half_size, patch_col_half_size, 1, 0,
                    0.0f))
    return (int)cudaErrorInvalidValue;
  void* kernel;
  size_t smem;
  cudaError_t e = plan(opt, inverse != 0, &kernel, warps_per_block, &smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  *registers = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, 32 * *warps_per_block, smem);
}

}  // extern "C"

FTK_DEFINE_ERROR_STRING
