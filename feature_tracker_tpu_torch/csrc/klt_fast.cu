// Basic-KLT FAST mode over a whole image pyramid, one launch, for Hopper.
//
// Replaces: feature_tracker_tpu/ops/pallas_klt.py::track_pyramid_fast_pallas
// (l.1016, body _kernel l.454). Plain version: feature_tracker_tpu_torch/
// trackers/klt/basic.py::track_pyramid_fast_reference; Python wrapper:
// feature_tracker_tpu_torch/ops/cuda_klt.py::track_pyramid_fast_cuda.
//
// What it computes, per non-skipped feature, coarse to fine over L levels
// (positions scaled by 2^-(L-1) first, doubled between levels):
//  - reference setup: the extended (pr+2)x(pc+2) patch sampled with one
//    anchor and four constant bilinear weights; a tap is valid when its
//    anchor lies in [0, dim-2], an invalid tap reads 0. Central-difference
//    gradients over the inner patch, masked by the AND of the four
//    neighbours' validity (a closed-form rectangle), and the 2x2 H.
//  - initial status: OUTSIDE when the extended patch has no valid tap,
//    else LARGE_RESIDUAL.
//  - up to max_iterations Gauss-Newton steps, each resampling the pr x pc
//    current patch, b = -sum(grad * (cur - inner)) over the jointly valid
//    pixels, v = H^-1 b in closed form. Break rules, in order:
//    no valid pixel (state and status unchanged); NaN step
//    (NUMERIC_ERROR, uv unchanged); update; the squared step failed to
//    shrink max_tolerance_large_step times in a row (status stays);
//    squared step < max_converge_step (TRACKED).
// The status is rewritten at every level, so a feature that fails at a
// coarse level is still tracked at the finer ones. Skipped lanes return
// their cur_uv and NOT_TRACKED at once. The final outside check and the
// skip pass-through of the input status are the caller's.
//
// Bound on an H100: the pyramids are read from HBM once (752x480, 4
// levels, both frames: 3.8 MB, 1.1 us at 3.35 TB/s); every later window
// read hits L2 (50 MB) or L1. The work is about 12 FLOP per patch pixel
// per Gauss-Newton step (bilinear sample, residual, two products):
// ~2 kFLOP per feature-iteration for a 13x13 patch, plus ~3 kFLOP of
// reference setup per feature and level, all f32 outside the tensor
// cores (67 TFLOP/s). Bound by operations, not bytes; in practice by
// latency: each step is a dependent chain of loads, a reduction and a 2x2
// solve, one feature per warp.
//
// Design: one warp per feature and several warps per block, each lane a
// strided share of the patch pixels, butterfly sums so that every lane
// holds the same scalar state and the warp branches uniformly (the
// divergence counter, FastBreaks, too runs on the same bits in every
// lane).
//  - Pixel sets are rectangles, not reductions. The extended patch's valid
//    taps form one rectangle, whose area is the level's count of valid
//    taps. A step's counted pixels are the intersection of the current
//    centre taps' rectangle and the reference centre taps': one rectangle
//    in (i, j), computed from the two anchors, whose area is the step's
//    pixel count, so a step with no pixel stops before it loads anything.
//    Cut with the gradient mask's rectangle (tap in [1, dim-3]) it gives
//    the pixels that are loaded and summed: the others add grad * dt = 0.
//  - A lane's pixel coordinates are computed once per launch and, where
//    the patch has at most 32 * kRegPix pixels (13x13: 6 a lane), its
//    reference centre values and gradients once per level, all in
//    registers: a step reads nothing but its current taps, issued for all
//    of a lane's pixels at once without a branch (a tap outside the
//    rectangle reads pixel (0, 0) and is discarded). Larger patches keep
//    the gradients in shared memory and load four pixels at a time.
//  - The reference extended patch is loaded four samples at a time with no
//    branch before the loads (klt_common.cuh::load_extended_patch_batched).
//  - H's three sums are reduced once per level and b's two once per step,
//    each by one transposing butterfly (klt_common.cuh::transpose_sum),
//    then broadcast: 3 + 3 shuffles and three broadcasts for H, 1 + 4 and
//    two for b, in place of 20 and 15.
//  - __launch_bounds__(256, 2): two blocks of eight warps = 16 warps to an
//    SM, and the register path's 118 registers a thread without a spill
//    (three blocks cap a thread at 80 registers, and the register path then
//    spilled 44 bytes). Few features are spread over every SM in blocks of
//    fewer warps: at the front end's 300 features each feature's chain of
//    steps sets the time, and 38 full blocks left 94 SMs idle.
// The phase clocks (FTK_MARK below) put the first design's warps, on an
// H100 at 752x480 with 10240 features, 59 % of their time in the level
// setups (the reference patch one sample at a time behind a branch) and
// 38 % in the steps' pixels; its sums and solves took 3 %. This design
// takes half the SM clocks per feature with the same shares (60 % level
// setups, 35 % steps' pixels, 4 % reductions, 2 % solves): every phase
// shrank, and the loads of image pixels still set the pace.
// Counting (tracing on: a non-null `counters`): lane 0 of each warp adds
// its feature's steps and a 1 with two atomics after its last store; the
// test of the pointer is the same in every warp, and null costs nothing.
// The float32 sums run in another order than in the plain version, so a
// borderline feature may flip at the convergence threshold (compared by
// count). Built with --fmad=false: the plain version rounds every multiply
// and add on its own, and so does the JAX reference, so the per-pixel
// arithmetic (bilinear weights and taps, det, the solve) rounds the same
// way here and only the order of the sums differs.

#include "klt_common.cuh"

namespace {

using namespace ftk;

constexpr int kMaxWarps = 8;     // per block
constexpr int kRegPix = 6;       // pixels a lane keeps in registers
constexpr int kBatch = 4;        // loads sent together
constexpr int kNoRow = 1 << 20;  // row of a lane's pixel beyond the patch

__host__ __device__ inline bool pixels_in_registers(int pr, int pc) {
  return pr * pc <= 32 * kRegPix;
}

// Per-warp shared memory (floats): the reference extended patch and, on
// the shared-memory path, the two gradient planes.
__host__ __device__ inline size_t warp_floats(int pr, int pc) {
  const size_t ex_n = (size_t)(pr + 2) * (pc + 2), p_n = (size_t)pr * pc;
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
  __device__ __forceinline__ Rect cut(const Rect& o) const {
    return {max(i_lo, o.i_lo), min(i_hi, o.i_hi), max(j_lo, o.j_lo),
            min(j_hi, o.j_hi)};
  }
};

// The pixels (i, j) of a rows x cols block whose tap (min_r + i, min_c + j)
// lies in [lo, h - 1 - hi] x [lo, w - 1 - hi].
__device__ __forceinline__ Rect tap_rect(int min_r, int min_c, int rows,
                                         int cols, int h, int w, int lo,
                                         int hi) {
  return {max(lo - min_r, 0), min(h - 1 - hi - min_r, rows - 1),
          max(lo - min_c, 0), min(w - 1 - hi - min_c, cols - 1)};
}

// kPix: pixels a lane keeps in registers (kRegPix), or 0 for the
// shared-memory path.
template <int kPix>
__global__ void __launch_bounds__(32 * kMaxWarps, 2)
    klt_fast_pyramid_kernel(Pyramids pyr, Options opt,
                            const float* __restrict__ ref_uv,
                            const float* __restrict__ cur_uv,
                            const uint8_t* __restrict__ skip,
                            float* __restrict__ out_uv,
                            int8_t* __restrict__ out_status, int n,
                            unsigned long long* __restrict__ counters) {
  constexpr int K = kPix > 0 ? kPix : 1;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f = blockIdx.x * (blockDim.x >> 5) + warp;
  if (f >= n) return;  // whole warp

  const int pr = opt.pr, pc = opt.pc;
  const int epr = pr + 2, epc = pc + 2;
  const int ex_n = epr * epc, p_n = pr * pc;
  float* ex = smem + (size_t)warp * warp_floats(pr, pc);  // extended patch
  float* gxs = ex + ex_n;  // shared-memory path: inner d/dx
  float* gys = gxs + p_n;  //                     inner d/dy

  float cx = cur_uv[2 * f], cy = cur_uv[2 * f + 1];
  if (skip[f]) {
    if (lane == 0) {
      out_uv[2 * f] = cx;
      out_uv[2 * f + 1] = cy;
      out_status[f] = kNotTracked;
    }
    return;
  }
  // Phases (FTK_PHASE_CLOCKS builds only): 0 level setup, 1 a step's
  // pixels, 2 its reduction, 3 its solve and update.
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
  int status = kNotTracked;
  int steps = 0;  // Gauss-Newton steps begun, over the levels

  for (int lvl = pyr.levels - 1; lvl >= 0; --lvl) {
    const float* __restrict__ R = pyr.ref[lvl];
    const float* __restrict__ C = pyr.cur[lvl];
    const int h = pyr.h[lvl], w = pyr.w[lvl];

    // Reference setup. (r_min_r, r_min_c) is the tap of inner pixel
    // (0, 0); the extended patch starts one tap before it. The inner
    // pixels whose reference centre tap is valid, and those whose four
    // gradient taps are (the centre tap in [1, dim-3]).
    const Anchor ra = make_anchor(rx, ry);
    const int r_min_r = ra.r - pr / 2, r_min_c = ra.c - pc / 2;
    const int n_ref =
        tap_rect(r_min_r - 1, r_min_c - 1, epr, epc, h, w, 0, 1).area();
    const Rect ref_rect = tap_rect(r_min_r, r_min_c, pr, pc, h, w, 0, 1);
    const Rect grad_rect = tap_rect(r_min_r, r_min_c, pr, pc, h, w, 1, 2);
    status = n_ref == 0 ? kOutside : kLargeResidual;
    if (n_ref > 0) {
      load_extended_patch_batched<kBatch>(R, h, w, ra, epr, epc, lane, ex);
      __syncwarp();
    }
    // Without a valid tap the gradient rectangle is empty: nothing below
    // reads what was not loaded but refc[], which no step then uses.
    float acc_h[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float refc[K], gx[K], gy[K];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int e = pi[k] == kNoRow ? epc + 1
                                    : (pi[k] + 1) * epc + (pj[k] + 1);
      const bool g = grad_rect.holds(pi[k], pj[k]);
      refc[k] = ex[e];
      gx[k] = g ? ex[e + 1] - ex[e - 1] : 0.0f;
      gy[k] = g ? ex[e + epc] - ex[e - epc] : 0.0f;
      acc_h[0] += gx[k] * gx[k];
      acc_h[1] += gx[k] * gy[k];
      acc_h[2] += gy[k] * gy[k];
    }
    if constexpr (kPix == 0) {
      PatchWalk at(lane, pc);
      for (int p = lane; p < p_n; p += 32, at.next()) {
        const int e = (at.i + 1) * epc + (at.j + 1);
        const bool g = grad_rect.holds(at.i, at.j);
        const float dx = g ? ex[e + 1] - ex[e - 1] : 0.0f;
        const float dy = g ? ex[e + epc] - ex[e - epc] : 0.0f;
        gxs[p] = dx;
        gys[p] = dy;
        acc_h[0] += dx * dx;
        acc_h[1] += dx * dy;
        acc_h[2] += dy * dy;
      }
    }
    const float h_total = transpose_sum(acc_h, lane);  // lane k: sum k
    const float h00 = __shfl_sync(0xffffffffu, h_total, 0);
    const float h01 = __shfl_sync(0xffffffffu, h_total, 1);
    const float h11 = __shfl_sync(0xffffffffu, h_total, 2);
    FTK_MARK(phases, 0, lane == 0);

    if (n_ref > 0) {
      FastBreaks breaks;
      for (int it = 0; it < opt.max_iterations; ++it) {
        ++steps;
        const Anchor ca = make_anchor(cx, cy);
        const int c_min_r = ca.r - pr / 2, c_min_c = ca.c - pc / 2;
        // Counted: the current and the reference centre taps are valid.
        // Summed: of those, the pixels with a gradient.
        const Rect counted =
            tap_rect(c_min_r, c_min_c, pr, pc, h, w, 0, 1).cut(ref_rect);
        if (counted.area() == 0) break;
        const Rect summed = counted.cut(grad_rect);
        float acc_b[2] = {0.0f, 0.0f};
        if constexpr (kPix > 0) {
          float t[K][4];
          bool use[K];
#pragma unroll
          for (int k = 0; k < kPix; ++k) {
            use[k] = summed.holds(pi[k], pj[k]);
            const float* q =
                C + (use[k] ? (size_t)(c_min_r + pi[k]) * w + (c_min_c + pj[k])
                            : 0);
            t[k][0] = q[0], t[k][1] = q[1], t[k][2] = q[w], t[k][3] = q[w + 1];
          }
#pragma unroll
          for (int k = 0; k < kPix; ++k)
            if (use[k]) {
              const float cur = ca.wtl * t[k][0] + ca.wtr * t[k][1] +
                                ca.wbl * t[k][2] + ca.wbr * t[k][3];
              const float dt = cur - refc[k];
              acc_b[0] += gx[k] * dt;
              acc_b[1] += gy[k] * dt;
            }
        } else {
          PatchWalk at(lane, pc);
          for (int p0 = lane; p0 < p_n; p0 += 32 * kBatch) {
            float t[kBatch][4];
            bool use[kBatch];
            int e[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              use[u] = p0 + 32 * u < p_n && summed.holds(at.i, at.j);
              e[u] = (at.i + 1) * epc + (at.j + 1);
              const float* q =
                  C + (use[u] ? (size_t)(c_min_r + at.i) * w + (c_min_c + at.j)
                              : 0);
              t[u][0] = q[0], t[u][1] = q[1], t[u][2] = q[w],
              t[u][3] = q[w + 1];
              at.next();
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u)
              if (use[u]) {
                const int p = p0 + 32 * u;
                const float cur = ca.wtl * t[u][0] + ca.wtr * t[u][1] +
                                  ca.wbl * t[u][2] + ca.wbr * t[u][3];
                const float dt = cur - ex[e[u]];
                acc_b[0] += gxs[p] * dt;
                acc_b[1] += gys[p] * dt;
              }
          }
        }
        FTK_MARK(phases, 1, lane == 0);
        const float b_total = transpose_sum(acc_b, lane);  // lane k: sum k
        const float b0 = -__shfl_sync(0xffffffffu, b_total, 0);
        const float b1 = -__shfl_sync(0xffffffffu, b_total, 1);
        FTK_MARK(phases, 2, lane == 0);
        const float det = h00 * h11 - h01 * h01;
        const float v0 = (h11 * b0 - h01 * b1) / det;
        const float v1 = (h00 * b1 - h01 * b0) / det;
        FTK_MARK(phases, 3, lane == 0);
        if (isnan(v0) || isnan(v1)) {
          status = kNumericError;
          break;
        }
        cx = cx + v0;
        cy = cy + v1;
        if (breaks.after_update(v0 * v0 + v1 * v1,
                                opt.max_tolerance_large_step,
                                opt.max_converge_step, &status))
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
    if (counters != nullptr) {  // the same for every warp of the launch
      atomicAdd(&counters[0], (unsigned long long)steps);
      atomicAdd(&counters[1], 1ull);
    }
  }
}

// Kernel, warps per block and dynamic shared memory: as many warps as fit
// half an SM's shared memory, at most kMaxWarps (the launch may take fewer).
cudaError_t plan(const Options& opt, void** kernel, int* warps,
                 size_t* smem) {
  *kernel = pixels_in_registers(opt.pr, opt.pc)
                ? (void*)klt_fast_pyramid_kernel<kRegPix>
                : (void*)klt_fast_pyramid_kernel<0>;
  const size_t per_warp = sizeof(float) * warp_floats(opt.pr, opt.pc);
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
// skip and output pointers on the device. `counters`: null, or two int64
// on the device; the kernel adds its Gauss-Newton steps (summed over the
// levels and the non-skipped lanes) to the first and its non-skipped
// lanes to the second.
int ftk_klt_fast_pyramid(const void* const* ref_levels,
                         const void* const* cur_levels, const int* heights,
                         const int* widths, int levels, const void* ref_uv,
                         const void* cur_uv, const void* skip, void* out_uv,
                         void* out_status, int n, int patch_row_half_size,
                         int patch_col_half_size, int max_iterations,
                         int max_tolerance_large_step,
                         float max_converge_step, void* stream,
                         long long* counters) {
  Pyramids pyr;
  Options opt;
  if (n < 0 ||
      !fill_pyramids(&pyr, ref_levels, cur_levels, heights, widths, levels) ||
      !fill_options(&opt, patch_row_half_size, patch_col_half_size,
                    max_iterations, max_tolerance_large_step,
                    max_converge_step))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;

  void* kernel;
  int warps;
  size_t smem;
  cudaError_t e = plan(opt, &kernel, &warps, &smem);
  if (e != cudaSuccess) return (int)e;
  // Few features: fewer warps a block, so that the blocks reach every SM.
  int device = 0, sms = 1;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int spread = (n + sms - 1) / sms;
  if (spread < warps) warps = spread;
  const int blocks = (n + warps - 1) / warps;
  const float *ref_p = (const float*)ref_uv, *cur_p = (const float*)cur_uv;
  const uint8_t* skip_p = (const uint8_t*)skip;
  float* ouv_p = (float*)out_uv;
  int8_t* ost_p = (int8_t*)out_status;
  unsigned long long* cnt_p = (unsigned long long*)counters;
  void* args[] = {&pyr,   &opt,  &ref_p, &cur_p, &skip_p,
                  &ouv_p, &ost_p, &n,    &cnt_p};
  e = cudaLaunchKernel(kernel, dim3(blocks), dim3(32 * warps), args, smem,
                       (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// What the card holds of the kernel these options launch: registers a
// thread, warps a block, and the blocks one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a cudaError.
int ftk_klt_fast_occupancy(int patch_row_half_size, int patch_col_half_size,
                           int* registers, int* warps_per_block,
                           int* blocks_per_sm) {
  Options opt;
  if (!fill_options(&opt, patch_row_half_size, patch_col_half_size, 1, 0,
                    0.0f))
    return (int)cudaErrorInvalidValue;
  void* kernel;
  size_t smem;
  cudaError_t e = plan(opt, &kernel, warps_per_block, &smem);
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
