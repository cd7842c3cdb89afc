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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FTK_MAX_LEVELS 8

namespace {

enum : int {
  kNotTracked = 0,
  kTracked = 1,
  kLargeResidual = 2,
  kOutside = 3,
  kNumericError = 4,
};

struct Pyramids {
  const float* ref[FTK_MAX_LEVELS];
  const float* cur[FTK_MAX_LEVELS];
  int h[FTK_MAX_LEVELS];
  int w[FTK_MAX_LEVELS];
  int levels;
};

struct Options {
  int pr, pc;  // patch rows / cols (odd)
  int max_iterations;
  int max_tolerance_large_step;
  float max_converge_step;  // compared against the squared step
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Integer anchor of a floored coordinate. Clamped far beyond any image, so
// every tap of a far-off feature is invalid and no index overflows.
__device__ __forceinline__ int anchor(float floored) {
  return (int)fminf(fmaxf(floored, -1073741824.0f), 1073741824.0f);
}

__device__ __forceinline__ bool tap_valid(int r, int c, int h, int w) {
  return r >= 0 && r <= h - 2 && c >= 0 && c <= w - 2;
}

__device__ __forceinline__ float sample(const float* img, int w, int r,
                                        int c, float wtl, float wtr,
                                        float wbl, float wbr) {
  const float* q = img + (size_t)r * w + c;
  return wtl * q[0] + wtr * q[1] + wbl * q[w] + wbr * q[w + 1];
}

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
    const float ry0 = floorf(ry), rx0 = floorf(rx);
    const float fr = ry - ry0, fc = rx - rx0;
    const float wtl = (1.0f - fr) * (1.0f - fc), wtr = (1.0f - fr) * fc;
    const float wbl = fr * (1.0f - fc), wbr = fr * fc;
    const int min_r = anchor(ry0) - epr / 2, min_c = anchor(rx0) - epc / 2;
    int n_ref = 0;
    for (int p = lane; p < ex_n; p += 32) {
      const int i = p / epc, j = p - i * epc;
      const int r = min_r + i, c = min_c + j;
      float v = 0.0f;
      if (tap_valid(r, c, h, w)) {
        v = sample(R, w, r, c, wtl, wtr, wbl, wbr);
        ++n_ref;
      }
      ex[p] = v;
    }
    __syncwarp();
    float h00 = 0.0f, h01 = 0.0f, h11 = 0.0f;
    for (int p = lane; p < p_n; p += 32) {
      const int i = p / pc, j = p - i * pc;
      // Tap of inner pixel (i, j): its four neighbours are all valid iff
      // it lies in [1, dim-3] in both directions.
      const int r = min_r + i + 1, c = min_c + j + 1;
      float dx = 0.0f, dy = 0.0f;
      if (r >= 1 && r <= h - 3 && c >= 1 && c <= w - 3) {
        const float* e = ex + (i + 1) * epc + (j + 1);
        dx = e[1] - e[-1];
        dy = e[epc] - e[-epc];
      }
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
      float last_sq = INFINITY;
      int cnt = 0;
      for (int it = 0; it < opt.max_iterations; ++it) {
        const float cy0 = floorf(cy), cx0 = floorf(cx);
        const float cfr = cy - cy0, cfc = cx - cx0;
        const float ctl = (1.0f - cfr) * (1.0f - cfc);
        const float ctr = (1.0f - cfr) * cfc;
        const float cbl = cfr * (1.0f - cfc), cbr = cfr * cfc;
        const int cmin_r = anchor(cy0) - pr / 2;
        const int cmin_c = anchor(cx0) - pc / 2;
        float b0 = 0.0f, b1 = 0.0f;
        int n_valid = 0;
        for (int p = lane; p < p_n; p += 32) {
          const int i = p / pc, j = p - i * pc;
          const int r = cmin_r + i, c = cmin_c + j;
          if (tap_valid(r, c, h, w) &&
              tap_valid(min_r + i + 1, min_c + j + 1, h, w)) {
            const float cur = sample(C, w, r, c, ctl, ctr, cbl, cbr);
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
        const float sq = v0 * v0 + v1 * v1;
        if (sq < last_sq) {
          last_sq = sq;
          cnt = 0;
        } else {
          ++cnt;
        }
        if (cnt >= opt.max_tolerance_large_step) break;
        if (sq < opt.max_converge_step) {
          status = kTracked;
          break;
        }
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
  if (levels < 1 || levels > FTK_MAX_LEVELS || n < 0 ||
      patch_row_half_size < 0 || patch_col_half_size < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Pyramids pyr;
  for (int l = 0; l < FTK_MAX_LEVELS; ++l) {
    const bool on = l < levels;
    pyr.ref[l] = on ? (const float*)ref_levels[l] : nullptr;
    pyr.cur[l] = on ? (const float*)cur_levels[l] : nullptr;
    pyr.h[l] = on ? heights[l] : 0;
    pyr.w[l] = on ? widths[l] : 0;
  }
  pyr.levels = levels;
  Options opt;
  opt.pr = 2 * patch_row_half_size + 1;
  opt.pc = 2 * patch_col_half_size + 1;
  opt.max_iterations = max_iterations;
  opt.max_tolerance_large_step = max_tolerance_large_step;
  opt.max_converge_step = max_converge_step;

  const size_t per_warp =
      sizeof(float) * ((size_t)(opt.pr + 2) * (opt.pc + 2) +
                       2 * (size_t)opt.pr * opt.pc);
  const size_t default_smem = 48 * 1024, max_smem = 227 * 1024;
  if (per_warp > max_smem) return (int)cudaErrorInvalidValue;
  int warps = (int)(default_smem / per_warp);
  warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
  const size_t smem = per_warp * warps;
  if (smem > default_smem) {
    cudaError_t e = cudaFuncSetAttribute(
        klt_fast_pyramid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n + warps - 1) / warps;
  klt_fast_pyramid_kernel<<<blocks, 32 * warps, smem,
                            (cudaStream_t)stream>>>(
      pyr, opt, (const float*)ref_uv, (const float*)cur_uv,
      (const uint8_t*)skip, (float*)out_uv, (int8_t*)out_status, n);
  return (int)cudaGetLastError();
}

const char* ftk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
