// Affine-warp KLT, FAST mode, one pyramid level per launch, for Hopper.
//
// Replaces: feature_tracker_tpu/ops/pallas_warp_klt.py::
// affine_track_level_pallas (l.728, body _affine_kernel l.376). Plain
// version: feature_tracker_tpu_torch/trackers/klt/affine.py::
// affine_track_level_reference; Python wrapper: feature_tracker_tpu_torch/
// ops/cuda_warp_klt.py::affine_track_level_cuda.
//
// What it computes, per non-skipped feature, at one level, with the warp
// pos_cur = A (dcol, drow) + cur_uv:
//  - reference setup as in basic FAST KLT: the extended (pr+2)x(pc+2)
//    patch with constant weights, masked central-difference gradients,
//    OUTSIDE when the extended patch has no valid tap, else LARGE_RESIDUAL.
//  - H = sum J J^T once per level, J = [x0 dx, x0 dy, y0 dx, y0 dy, dx, dy]
//    with (x0, y0) = patch offset + the level-entry cur_uv (absolute pixel
//    coordinates): 21 distinct sums.
//  - up to max_iterations steps. Each samples the current image at the
//    warped position of every patch pixel (four loads and own weights per
//    pixel, wherever the warp leads: no window limit), sums the six bias
//    terms with the warped absolute coordinates over the jointly valid
//    pixels, solves the 6x6, and updates v = z[0:2] x + z[2:4] y + z[4:6],
//    uv += v, the columns of A += z[0:2], z[2:4]. Break rules of the FAST
//    modes (klt_fast.cu), with NaN and convergence tested on v, not z.
// Skipped lanes return cur_uv, A and NOT_TRACKED at once.
//
// The system in float64. It holds absolute pixel coordinates, so cond(H)
// grows like coordinate^4 (1e8 and more at 752x480). In float32 the mere
// order of the patch sums then moves the solution: on the CPU, two float32
// implementations of this tracker that differ only in that order end up to
// 0.2 px apart on a single level, while exchanging a float32 for a float64
// solve moves it by 3e-3 px. So the per-pixel terms stay float32 (the same
// roundings as the plain version, --fmad=false), but they are accumulated
// in float64: the products of H are then exact and the sums agree with the
// plain version's to 1e-16, in any order. The 6x6 is solved in float64 by
// Gaussian elimination with partial pivoting (klt_common.cuh::
// solve_pivoted): no equilibration, and no assumption that H is positive
// definite (a flat or one-directional patch gives a singular H, which must
// come out as NaN -> NUMERIC_ERROR, not trap). Every lane runs the same
// solve on the same bits, so the warp stays uniform; its ~200 float64
// operations are small beside the ~40 operations for each of the pr*pc
// pixels of a step.
//
// Bound on an H100: two images read from HBM once (752x480: 2.9 MB,
// 0.9 us at 3.35 TB/s at level 0); the patch reads hit L1/L2. Per step and
// patch pixel ~40 FLOP (warp 8, sample 15, residual, 6 bias terms 14), per
// level and pixel ~60 (setup and the 21 H terms), outside the tensor cores
// (67 TFLOP/s in f32). Bound by operations.
//
// Design: one warp per feature, several warps per block; each lane a
// strided share of the patch pixels; the reference patch and gradients in
// per-warp shared memory; butterfly sums. Built with --fmad=false.

#include "klt_common.cuh"

namespace {

using namespace ftk;

// Index of entry (a, b), a <= b, in the packed upper triangle of a 6x6.
__host__ __device__ constexpr int tri(int a, int b) {
  return a * 6 - a * (a - 1) / 2 + (b - a);
}

__global__ void klt_affine_level_kernel(
    const float* __restrict__ R, const float* __restrict__ C, int h, int w,
    Options opt, const float* __restrict__ ref_uv,
    const float* __restrict__ cur_uv, const float* __restrict__ affine,
    const uint8_t* __restrict__ skip, float* __restrict__ out_uv,
    float* __restrict__ out_affine, int8_t* __restrict__ out_status, int n) {
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
  float a00 = affine[4 * f], a01 = affine[4 * f + 1];
  float a10 = affine[4 * f + 2], a11 = affine[4 * f + 3];
  int status = kNotTracked;

  if (!skip[f]) {
    // Reference setup: extended patch, gradients, the 6x6 H.
    const Anchor ra = make_anchor(ref_uv[2 * f], ref_uv[2 * f + 1]);
    const int min_r = ra.r - epr / 2, min_c = ra.c - epc / 2;
    int n_ref = load_extended_patch(R, h, w, ra, epr, epc, lane, ex);
    __syncwarp();
    double hs[21];
#pragma unroll
    for (int k = 0; k < 21; ++k) hs[k] = 0.0;
    for (int p = lane; p < p_n; p += 32) {
      const int i = p / pc, j = p - i * pc;
      float dx, dy;
      inner_gradient(ex, epc, min_r, min_c, i, j, h, w, &dx, &dy);
      gx[p] = dx;
      gy[p] = dy;
      const float x0 = (float)(j - pc / 2) + cx;
      const float y0 = (float)(i - pr / 2) + cy;
      const float jv[6] = {x0 * dx, x0 * dy, y0 * dx, y0 * dy, dx, dy};
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = a; b < 6; ++b)
          hs[tri(a, b)] += (double)jv[a] * (double)jv[b];
    }
#pragma unroll
    for (int k = 0; k < 21; ++k) hs[k] = warp_sum(hs[k]);
    n_ref = warp_sum(n_ref);
    __syncwarp();

    status = n_ref == 0 ? kOutside : kLargeResidual;
    if (n_ref > 0) {
      FastBreaks breaks;
      for (int it = 0; it < opt.max_iterations; ++it) {
        double bs[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
        int n_valid = 0;
        for (int p = lane; p < p_n; p += 32) {
          const int i = p / pc, j = p - i * pc;
          const float ox = (float)(j - pc / 2), oy = (float)(i - pr / 2);
          const float wx = ox * a00 + oy * a01 + cx;
          const float wy = ox * a10 + oy * a11 + cy;
          float curv;
          if (sample_at(C, h, w, wx, wy, &curv) &&
              tap_valid(min_r + i + 1, min_c + j + 1, h, w)) {
            const float dt = curv - ex[(i + 1) * epc + (j + 1)];
            const float dx = gx[p], dy = gy[p];
            bs[0] += (double)(dt * wx * dx);
            bs[1] += (double)(dt * wx * dy);
            bs[2] += (double)(dt * wy * dx);
            bs[3] += (double)(dt * wy * dy);
            bs[4] += (double)(dt * dx);
            bs[5] += (double)(dt * dy);
            ++n_valid;
          }
        }
#pragma unroll
        for (int k = 0; k < 6; ++k) bs[k] = -warp_sum(bs[k]);
        n_valid = warp_sum(n_valid);
        if (n_valid == 0) break;

        double m[6][6], z[6];
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          z[a] = bs[a];
#pragma unroll
          for (int b = a; b < 6; ++b) {
            m[a][b] = hs[tri(a, b)];
            m[b][a] = hs[tri(a, b)];
          }
        }
        solve_pivoted<6>(m, z);
        const float z0 = (float)z[0], z1 = (float)z[1], z2 = (float)z[2];
        const float z3 = (float)z[3], z4 = (float)z[4], z5 = (float)z[5];
        const float v0 = z0 * cx + z2 * cy + z4;
        const float v1 = z1 * cx + z3 * cy + z5;
        if (isnan(v0) || isnan(v1)) {
          status = kNumericError;
          break;
        }
        cx = cx + v0;
        cy = cy + v1;
        a00 += z0;
        a10 += z1;
        a01 += z2;
        a11 += z3;
        if (breaks.after_update(v0 * v0 + v1 * v1,
                                opt.max_tolerance_large_step,
                                opt.max_converge_step, &status))
          break;
      }
    }
  }
  if (lane == 0) {
    out_uv[2 * f] = cx;
    out_uv[2 * f + 1] = cy;
    out_affine[4 * f] = a00;
    out_affine[4 * f + 1] = a01;
    out_affine[4 * f + 2] = a10;
    out_affine[4 * f + 3] = a11;
    out_status[f] = (int8_t)status;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). All pointers are device pointers: images float32 [h, w],
// ref_uv / cur_uv float32 [n, 2], affine float32 [n, 2, 2], skip uint8 [n].
int ftk_klt_affine_level(const void* ref_img, const void* cur_img, int h,
                         int w, const void* ref_uv, const void* cur_uv,
                         const void* affine, const void* skip, void* out_uv,
                         void* out_affine, void* out_status, int n,
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
                       2 * (size_t)opt.pr * opt.pc);
  int warps;
  size_t smem;
  cudaError_t e = plan_block(klt_affine_level_kernel, per_warp, &warps, &smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + warps - 1) / warps;
  klt_affine_level_kernel<<<blocks, 32 * warps, smem,
                            (cudaStream_t)stream>>>(
      (const float*)ref_img, (const float*)cur_img, h, w, opt,
      (const float*)ref_uv, (const float*)cur_uv, (const float*)affine,
      (const uint8_t*)skip, (float*)out_uv, (float*)out_affine,
      (int8_t*)out_status, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

FTK_DEFINE_ERROR_STRING
