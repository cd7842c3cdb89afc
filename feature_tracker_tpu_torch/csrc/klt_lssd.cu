// SE(2) (rotation + translation) KLT with optional luminance normalisation
// ("LSSD"), FAST mode, one pyramid level per launch, for Hopper.
//
// Replaces: feature_tracker_tpu/ops/pallas_warp_klt.py::
// lssd_track_level_pallas (l.761, body _lssd_kernel l.524). Plain version:
// feature_tracker_tpu_torch/trackers/klt/lssd.py::
// lssd_track_level_reference; Python wrapper: feature_tracker_tpu_torch/
// ops/cuda_warp_klt.py::lssd_track_level_cuda.
//
// What it computes, per non-skipped feature, at one level, with the warp
// pos_cur = R pos_ref + t over the absolute reference coordinates
// pos_ref = ref_uv + patch offset:
//  - reference setup as in basic FAST KLT (extended patch with constant
//    weights, masked central-difference gradients, OUTSIDE when the
//    extended patch has no valid tap, else LARGE_RESIDUAL). With
//    `luminance`, the gradients and the inner patch are divided by
//    ref_mean = (sum over the inner patch) / (valid taps of the whole
//    extended patch).
//  - up to max_iterations steps. Each samples the current image at
//    R pos_ref + t for every patch pixel (four loads, own weights). With
//    `luminance` the sampled patch is divided by cur_mean = (sum over its
//    rows and columns 1..n-2) / (count of valid samples): a first pass
//    over the patch keeps the samples in shared memory, a second one
//    builds the system. J = [grad . (R (-y_ref, x_ref)), dx, dy]; the 3x3
//    H = J^T J and b = -J^T residual are rebuilt over the jointly valid
//    pixels (R changes every step), solved, and
//    R <- R [[1, -v0], [v0, 1]] divided as a whole by the norm of its
//    first column, t += v[1:3]. Break rules of the FAST modes
//    (klt_fast.cu) on the 3-vector v.
// Neither mean is guarded against an empty patch, as in the plain version.
// Skipped lanes return R, t and NOT_TRACKED at once.
//
// The system in float64. jtheta holds absolute coordinates, and over a
// small patch far from the origin the rotation column is nearly a
// combination of the two translation columns: cond(H) reaches 1e7 and more
// at 752x480, and in float32 the order of the patch sums alone moves the
// solution (see klt_affine.cu). The per-pixel terms stay float32 (the same
// roundings as the plain version); H, b and the sums behind the two means
// are accumulated in float64, so the products are exact and the sums agree
// with the plain version's to 1e-16 in any order. The 3x3 is solved in float64 by Gaussian elimination
// with partial pivoting (klt_common.cuh::solve_pivoted); a singular H comes
// out as NaN -> NUMERIC_ERROR.
//
// Bound on an H100: two images read from HBM once (2.9 MB at 752x480,
// 0.9 us at 3.35 TB/s); the patch reads hit L1/L2. Per step and patch
// pixel ~55 FLOP (warp 10, sample 15, normalisation and residual 2, jtheta
// 9, nine products and sums 18), outside the tensor cores (67 TFLOP/s in
// f32). Bound by operations.
//
// Design: one warp per feature, several warps per block; each lane a
// strided share of the patch pixels; the reference patch, gradients and the
// step's samples in per-warp shared memory; butterfly sums. Built with
// --fmad=false.

#include "klt_common.cuh"

namespace {

using namespace ftk;

__global__ void klt_lssd_level_kernel(
    const float* __restrict__ R, const float* __restrict__ C, int h, int w,
    Options opt, int luminance, const float* __restrict__ ref_uv,
    const float* __restrict__ rot, const float* __restrict__ trans,
    const uint8_t* __restrict__ skip, float* __restrict__ out_rot,
    float* __restrict__ out_trans, int8_t* __restrict__ out_status, int n) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f = blockIdx.x * (blockDim.x >> 5) + warp;
  if (f >= n) return;  // whole warp

  const int pr = opt.pr, pc = opt.pc;
  const int epr = pr + 2, epc = pc + 2;
  const int ex_n = epr * epc, p_n = pr * pc;
  float* ex = smem + (size_t)warp * (ex_n + 4 * p_n);  // extended patch
  float* gx = ex + ex_n;                                // inner d/dx
  float* gy = gx + p_n;                                 // inner d/dy
  float* inner = gy + p_n;  // inner patch (normalised with luminance)
  float* cv = inner + p_n;  // this step's samples (0 where invalid)

  float r00 = rot[4 * f], r01 = rot[4 * f + 1];
  float r10 = rot[4 * f + 2], r11 = rot[4 * f + 3];
  float tx = trans[2 * f], ty = trans[2 * f + 1];
  int status = kNotTracked;

  if (!skip[f]) {
    const float rx = ref_uv[2 * f], ry = ref_uv[2 * f + 1];
    const Anchor ra = make_anchor(rx, ry);
    const int min_r = ra.r - epr / 2, min_c = ra.c - epc / 2;
    int n_ref = load_extended_patch(R, h, w, ra, epr, epc, lane, ex);
    __syncwarp();
    n_ref = warp_sum(n_ref);
    float ref_mean = 1.0f;
    if (luminance) {
      double s = 0.0;
      for (int p = lane; p < p_n; p += 32) {
        const int i = p / pc, j = p - i * pc;
        s += (double)ex[(i + 1) * epc + (j + 1)];
      }
      ref_mean = (float)warp_sum(s) / (float)n_ref;
    }
    for (int p = lane; p < p_n; p += 32) {
      const int i = p / pc, j = p - i * pc;
      float dx, dy;
      inner_gradient(ex, epc, min_r, min_c, i, j, h, w, &dx, &dy);
      float v = ex[(i + 1) * epc + (j + 1)];
      if (luminance) {
        dx = dx / ref_mean;
        dy = dy / ref_mean;
        v = v / ref_mean;
      }
      gx[p] = dx;
      gy[p] = dy;
      inner[p] = v;
    }
    __syncwarp();

    status = n_ref == 0 ? kOutside : kLargeResidual;
    if (n_ref > 0) {
      FastBreaks breaks;
      for (int it = 0; it < opt.max_iterations; ++it) {
        // Pass 1: sample the warped patch.
        double s_in = 0.0;
        int n_cur = 0;
        for (int p = lane; p < p_n; p += 32) {
          const int i = p / pc, j = p - i * pc;
          const float px = rx + (float)(j - pc / 2);
          const float py = ry + (float)(i - pr / 2);
          const float x = px * r00 + py * r01 + tx;
          const float y = px * r10 + py * r11 + ty;
          float v;
          if (sample_at(C, h, w, x, y, &v)) {
            ++n_cur;
            if (i >= 1 && i <= pr - 2 && j >= 1 && j <= pc - 2)
              s_in += (double)v;
          }
          cv[p] = v;
        }
        float cur_mean = 1.0f;
        if (luminance) {
          n_cur = warp_sum(n_cur);
          cur_mean = (float)warp_sum(s_in) / (float)n_cur;
        }
        // Pass 2: the system over the jointly valid pixels. Each lane
        // reads back only the samples it wrote.
        double hs[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
        double bs[3] = {0.0, 0.0, 0.0};
        int n_valid = 0;
        for (int p = lane; p < p_n; p += 32) {
          const int i = p / pc, j = p - i * pc;
          const float px = rx + (float)(j - pc / 2);
          const float py = ry + (float)(i - pr / 2);
          if (position_valid(h, w, px * r00 + py * r01 + tx,
                             px * r10 + py * r11 + ty) &&
              tap_valid(min_r + i + 1, min_c + j + 1, h, w)) {
            float curv = cv[p];
            if (luminance) curv = curv / cur_mean;
            const float res = curv - inner[p];
            const float jrx = (-py) * r00 + px * r01;
            const float jry = (-py) * r10 + px * r11;
            const float dx = gx[p], dy = gy[p];
            const float jt = dx * jrx + dy * jry;
            const double jtd = jt, dxd = dx, dyd = dy, resd = res;
            hs[0] += jtd * jtd;
            hs[1] += jtd * dxd;
            hs[2] += jtd * dyd;
            hs[3] += dxd * dxd;
            hs[4] += dxd * dyd;
            hs[5] += dyd * dyd;
            bs[0] += jtd * resd;
            bs[1] += dxd * resd;
            bs[2] += dyd * resd;
            ++n_valid;
          }
        }
#pragma unroll
        for (int k = 0; k < 6; ++k) hs[k] = warp_sum(hs[k]);
#pragma unroll
        for (int k = 0; k < 3; ++k) bs[k] = -warp_sum(bs[k]);
        n_valid = warp_sum(n_valid);
        if (n_valid == 0) break;

        double m[3][3] = {{hs[0], hs[1], hs[2]},
                          {hs[1], hs[3], hs[4]},
                          {hs[2], hs[4], hs[5]}};
        double z[3] = {bs[0], bs[1], bs[2]};
        solve_pivoted<3>(m, z);
        const float v0 = (float)z[0], v1 = (float)z[1], v2 = (float)z[2];
        if (isnan(v0) || isnan(v1) || isnan(v2)) {
          status = kNumericError;
          break;
        }
        // delta = I + [[0, -1], [1, 0]] * v0, entry by entry as the plain
        // version forms it (0 * v0 is NaN for an infinite v0).
        const float d00 = 1.0f + 0.0f * v0, d01 = 0.0f + (-1.0f) * v0;
        const float d10 = 0.0f + 1.0f * v0, d11 = 1.0f + 0.0f * v0;
        const float n00 = r00 * d00 + r01 * d10, n01 = r00 * d01 + r01 * d11;
        const float n10 = r10 * d00 + r11 * d10, n11 = r10 * d01 + r11 * d11;
        const float norm = sqrtf(n00 * n00 + n10 * n10);
        r00 = n00 / norm;
        r01 = n01 / norm;
        r10 = n10 / norm;
        r11 = n11 / norm;
        tx = tx + v1;
        ty = ty + v2;
        if (breaks.after_update(v0 * v0 + v1 * v1 + v2 * v2,
                                opt.max_tolerance_large_step,
                                opt.max_converge_step, &status))
          break;
      }
    }
  }
  if (lane == 0) {
    out_rot[4 * f] = r00;
    out_rot[4 * f + 1] = r01;
    out_rot[4 * f + 2] = r10;
    out_rot[4 * f + 3] = r11;
    out_trans[2 * f] = tx;
    out_trans[2 * f + 1] = ty;
    out_status[f] = (int8_t)status;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). All pointers are device pointers: images float32 [h, w],
// ref_uv float32 [n, 2], rot float32 [n, 2, 2], trans float32 [n, 2],
// skip uint8 [n].
int ftk_klt_lssd_level(const void* ref_img, const void* cur_img, int h, int w,
                       const void* ref_uv, const void* rot, const void* trans,
                       const void* skip, void* out_rot, void* out_trans,
                       void* out_status, int n, int luminance,
                       int patch_row_half_size, int patch_col_half_size,
                       int max_iterations, int max_tolerance_large_step,
                       float max_converge_step, void* stream) {
  Options opt;
  if (n < 0 || h < 2 || w < 2 ||
      !fill_options(&opt, patch_row_half_size, patch_col_half_size,
                    max_iterations, max_tolerance_large_step,
                    max_converge_step))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;

  const size_t per_warp =
      sizeof(float) * ((size_t)(opt.pr + 2) * (opt.pc + 2) +
                       4 * (size_t)opt.pr * opt.pc);
  int warps;
  size_t smem;
  cudaError_t e = plan_block(klt_lssd_level_kernel, per_warp, &warps, &smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + warps - 1) / warps;
  klt_lssd_level_kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const float*)ref_img, (const float*)cur_img, h, w, opt, luminance,
      (const float*)ref_uv, (const float*)rot, (const float*)trans,
      (const uint8_t*)skip, (float*)out_rot, (float*)out_trans,
      (int8_t*)out_status, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

FTK_DEFINE_ERROR_STRING
