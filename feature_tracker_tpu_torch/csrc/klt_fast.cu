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
// cores (67 TFLOP/s). So the kernel is bound by operations, not bytes.
//
// Design: one warp per feature, several warps per block. Each lane takes a
// strided share of the patch pixels; the extended reference patch and the
// two gradient planes sit in per-warp shared memory sized from the
// options at launch, so any patch size that fits shared memory works.
// The sums (H, b, valid counts) are reduced with __shfl_xor_sync: the
// butterfly leaves the same bits in every lane, so every lane carries the
// scalar Gauss-Newton state redundantly and branches uniformly. The
// images stay in global memory and are read through L1/L2. Getting close
// to the bound (cp.async staging of the windows, several features per
// warp) is later work.
//
// Build with --fmad=false: the plain version rounds every multiply and add
// on its own, and so does the JAX reference. Without contraction the
// per-pixel arithmetic (bilinear weights and taps, det, the solve) rounds
// the same way here, and only the order of the sums differs.

#include "klt_common.cuh"

namespace {

using namespace ftk;

__global__ void klt_fast_pyramid_kernel(Pyramids pyr, Options opt,
                                        const float* __restrict__ ref_uv,
                                        const float* __restrict__ cur_uv,
                                        const uint8_t* __restrict__ skip,
                                        float* __restrict__ out_uv,
                                        int8_t* __restrict__ out_status,
                                        int n) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f = blockIdx.x * (blockDim.x >> 5) + warp;
  if (f >= n) return;  // whole warp

  const int pr = opt.pr, pc = opt.pc;
  const int epr = pr + 2, epc = pc + 2;
  const int ex_n = epr * epc, p_n = pr * pc;
  float* ex = smem + (size_t)warp * (ex_n + 2 * p_n);  // extended patch
  float* gx = ex + ex_n;                                // inner d/dx
  float* gy = gx + p_n;                                 // inner d/dy

  float cx = cur_uv[2 * f], cy = cur_uv[2 * f + 1];
  if (skip[f]) {
    if (lane == 0) {
      out_uv[2 * f] = cx;
      out_uv[2 * f + 1] = cy;
      out_status[f] = kNotTracked;
    }
    return;
  }
  const float scale = 1.0f / (float)(1 << (pyr.levels - 1));
  float rx = ref_uv[2 * f] * scale, ry = ref_uv[2 * f + 1] * scale;
  cx *= scale;
  cy *= scale;
  int status = kNotTracked;

  for (int lvl = pyr.levels - 1; lvl >= 0; --lvl) {
    const float* __restrict__ R = pyr.ref[lvl];
    const float* __restrict__ C = pyr.cur[lvl];
    const int h = pyr.h[lvl], w = pyr.w[lvl];

    // Reference setup: extended patch, gradients, H.
    const Anchor ra = make_anchor(rx, ry);
    const int min_r = ra.r - epr / 2, min_c = ra.c - epc / 2;
    int n_ref = load_extended_patch(R, h, w, ra, epr, epc, lane, ex);
    __syncwarp();
    float h00 = 0.0f, h01 = 0.0f, h11 = 0.0f;
    for (int p = lane; p < p_n; p += 32) {
      const int i = p / pc, j = p - i * pc;
      float dx, dy;
      inner_gradient(ex, epc, min_r, min_c, i, j, h, w, &dx, &dy);
      gx[p] = dx;
      gy[p] = dy;
      h00 += dx * dx;
      h01 += dx * dy;
      h11 += dy * dy;
    }
    h00 = warp_sum(h00);
    h01 = warp_sum(h01);
    h11 = warp_sum(h11);
    n_ref = warp_sum(n_ref);
    __syncwarp();

    status = n_ref == 0 ? kOutside : kLargeResidual;
    if (n_ref > 0) {
      FastBreaks breaks;
      for (int it = 0; it < opt.max_iterations; ++it) {
        const Anchor ca = make_anchor(cx, cy);
        const int cmin_r = ca.r - pr / 2, cmin_c = ca.c - pc / 2;
        float b0 = 0.0f, b1 = 0.0f;
        int n_valid = 0;
        for (int p = lane; p < p_n; p += 32) {
          const int i = p / pc, j = p - i * pc;
          const int r = cmin_r + i, c = cmin_c + j;
          if (tap_valid(r, c, h, w) &&
              tap_valid(min_r + i + 1, min_c + j + 1, h, w)) {
            const float cur =
                sample(C, w, r, c, ca.wtl, ca.wtr, ca.wbl, ca.wbr);
            const float dt = cur - ex[(i + 1) * epc + (j + 1)];
            b0 += gx[p] * dt;
            b1 += gy[p] * dt;
            ++n_valid;
          }
        }
        b0 = -warp_sum(b0);
        b1 = -warp_sum(b1);
        n_valid = warp_sum(n_valid);
        if (n_valid == 0) break;
        const float det = h00 * h11 - h01 * h01;
        const float v0 = (h11 * b0 - h01 * b1) / det;
        const float v1 = (h00 * b1 - h01 * b0) / det;
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
  }
  if (lane == 0) {
    out_uv[2 * f] = cx;
    out_uv[2 * f + 1] = cy;
    out_status[f] = (int8_t)status;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Level pointer and size arrays live on the host; image, uv,
// skip and output pointers on the device.
int ftk_klt_fast_pyramid(const void* const* ref_levels,
                         const void* const* cur_levels, const int* heights,
                         const int* widths, int levels, const void* ref_uv,
                         const void* cur_uv, const void* skip, void* out_uv,
                         void* out_status, int n, int patch_row_half_size,
                         int patch_col_half_size, int max_iterations,
                         int max_tolerance_large_step,
                         float max_converge_step, void* stream) {
  Pyramids pyr;
  Options opt;
  if (n < 0 ||
      !fill_pyramids(&pyr, ref_levels, cur_levels, heights, widths, levels) ||
      !fill_options(&opt, patch_row_half_size, patch_col_half_size,
                    max_iterations, max_tolerance_large_step,
                    max_converge_step))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;

  const size_t per_warp =
      sizeof(float) * ((size_t)(opt.pr + 2) * (opt.pc + 2) +
                       2 * (size_t)opt.pr * opt.pc);
  int warps;
  size_t smem;
  cudaError_t e = plan_block(klt_fast_pyramid_kernel, per_warp, &warps, &smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + warps - 1) / warps;
  klt_fast_pyramid_kernel<<<blocks, 32 * warps, smem,
                            (cudaStream_t)stream>>>(
      pyr, opt, (const float*)ref_uv, (const float*)cur_uv,
      (const uint8_t*)skip, (float*)out_uv, (int8_t*)out_status, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

FTK_DEFINE_ERROR_STRING
