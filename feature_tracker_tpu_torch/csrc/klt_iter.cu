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
//    the current tap are valid: an intersection of rectangles, tested per
//    pixel in closed form. v = H^-1 b in closed form. Break rules, in
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
// (67 TFLOP/s). Bound by operations, not bytes.
//
// Design: klt_fast.cu's, one warp per feature and several warps per block,
// each lane a strided share of the patch pixels, the extended patches in
// per-warp shared memory, butterfly sums so that every lane holds the same
// scalar state. One source serves both modes: `inverse` is a kernel
// argument, uniform over the grid. Built with --fmad=false so that the
// per-pixel arithmetic rounds as in the plain version.

#include "klt_common.cuh"

namespace {

using namespace ftk;

__global__ void klt_iter_pyramid_kernel(Pyramids pyr, Options opt,
                                        int inverse,
                                        const float* __restrict__ ref_uv,
                                        const float* __restrict__ cur_uv,
                                        const int8_t* __restrict__ status_in,
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
  float* ex = smem + (size_t)warp * (2 * ex_n);  // reference extended patch
  float* cex = ex + ex_n;                         // current one (DIRECT)

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
  const float scale = 1.0f / (float)(1 << (pyr.levels - 1));
  float rx = ref_uv[2 * f] * scale, ry = ref_uv[2 * f + 1] * scale;
  cx *= scale;
  cy *= scale;

  for (int lvl = pyr.levels - 1; lvl >= 0; --lvl) {
    const float* __restrict__ R = pyr.ref[lvl];
    const float* __restrict__ C = pyr.cur[lvl];
    const int h = pyr.h[lvl], w = pyr.w[lvl];

    // Level setup: the reference extended patch. (r_min_r, r_min_c) is the
    // tap of inner pixel (0, 0).
    const Anchor ra = make_anchor(rx, ry);
    const int r_min_r = ra.r - pr / 2, r_min_c = ra.c - pc / 2;
    load_extended_patch(R, h, w, ra, epr, epc, lane, ex);
    __syncwarp();

    for (int it = 0; it < opt.max_iterations; ++it) {
      const Anchor ca = make_anchor(cx, cy);
      const int c_min_r = ca.r - pr / 2, c_min_c = ca.c - pc / 2;
      const float* g = ex;  // the patch the gradients are read from
      int g_min_r = r_min_r, g_min_c = r_min_c;
      if (!inverse) {
        load_extended_patch(C, h, w, ca, epr, epc, lane, cex);
        __syncwarp();
        g = cex;
        g_min_r = c_min_r;
        g_min_c = c_min_c;
      }
      float h00 = 0.0f, h01 = 0.0f, h11 = 0.0f, b0 = 0.0f, b1 = 0.0f;
      int n_valid = 0;
      for (int p = lane; p < p_n; p += 32) {
        const int i = p / pc, j = p - i * pc;
        const int gr = g_min_r + i, gc = g_min_c + j;
        const int cr = c_min_r + i, cc = c_min_c + j;
        // The four gradient taps are valid iff the pixel's own tap in the
        // gradient image lies in [1, dim-3] both ways.
        if (gr >= 1 && gr <= h - 3 && gc >= 1 && gc <= w - 3 &&
            tap_valid(r_min_r + i, r_min_c + j, h, w) &&
            tap_valid(cr, cc, h, w)) {
          const int e = (i + 1) * epc + (j + 1);
          const float fx = g[e + 1] - g[e - 1];
          const float fy = g[e + epc] - g[e - epc];
          const float curv =
              inverse ? sample(C, w, cr, cc, ca.wtl, ca.wtr, ca.wbl, ca.wbr)
                      : cex[e];
          const float ft = curv - ex[e];
          h00 += fx * fx;
          h01 += fx * fy;
          h11 += fy * fy;
          b0 += fx * ft;
          b1 += fy * ft;
          ++n_valid;
        }
      }
      h00 = warp_sum(h00);
      h01 = warp_sum(h01);
      h11 = warp_sum(h11);
      b0 = -warp_sum(b0);
      b1 = -warp_sum(b1);
      n_valid = warp_sum(n_valid);
      // All lanes have read cex[] before the next step overwrites it.
      __syncwarp();
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

  const size_t per_warp =
      sizeof(float) * 2 * (size_t)(opt.pr + 2) * (opt.pc + 2);
  int warps;
  size_t smem;
  cudaError_t e = plan_block(klt_iter_pyramid_kernel, per_warp, &warps, &smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + warps - 1) / warps;
  klt_iter_pyramid_kernel<<<blocks, 32 * warps, smem,
                            (cudaStream_t)stream>>>(
      pyr, opt, inverse, (const float*)ref_uv, (const float*)cur_uv,
      (const int8_t*)status_in, (const uint8_t*)skip, (float*)out_uv,
      (int8_t*)out_status, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

FTK_DEFINE_ERROR_STRING
