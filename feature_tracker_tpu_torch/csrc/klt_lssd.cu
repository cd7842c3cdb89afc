// SE(2) (rotation + translation) KLT with optional luminance normalisation
// ("LSSD"), FAST mode, the whole image pyramid in one launch, for Hopper.
//
// Replaces: feature_tracker_tpu/ops/pallas_warp_klt.py::
// lssd_track_level_pallas (l.761, body _lssd_kernel l.524), which runs one
// level per call inside the tracker's level loop; this kernel runs that loop
// too. Plain versions: feature_tracker_tpu_torch/trackers/klt/lssd.py::
// lssd_track_level_reference (one level) and lssd_track_pyramid_reference
// (the level loop over it); Python wrappers: feature_tracker_tpu_torch/ops/
// cuda_warp_klt.py::lssd_track_pyramid_cuda and lssd_track_level_cuda (the
// one-level case of the same kernel).
//
// What it computes, per feature, coarse to fine over L levels, with the warp
// pos_cur = R pos_ref + t over the absolute reference coordinates
// pos_ref = s_ref + patch offset:
//  - at the coarsest level s_ref = ref_uv / 2^(L-1) and t = s_cur - R s_ref
//    with s_cur = cur_uv / 2^(L-1) (or t as given, for the one-level case);
//    R is carried from level to level unscaled, and only s_ref and t double
//    between levels; the result is R ref_uv + t at full resolution.
//  - reference setup at each level as in basic FAST KLT (extended patch with
//    constant weights, masked central-difference gradients, OUTSIDE when
//    the extended patch has no valid tap, else LARGE_RESIDUAL). With
//    `luminance`, the gradients and the inner patch are divided by
//    ref_mean = (sum over the inner patch) / (valid taps of the whole
//    extended patch).
//  - up to max_iterations steps. Pass 1 samples the current image at
//    R pos_ref + t for every patch pixel (four loads, own weights); with
//    `luminance` the samples are divided by cur_mean = (sum over rows and
//    columns 1..n-2 of the sampled patch) / (count of valid samples).
//    Pass 2 builds J = [grad . (R (-y_ref, x_ref)), dx, dy] and the 3x3
//    H = J^T J, b = -J^T residual over the jointly valid pixels (H changes
//    with R, so it is rebuilt every step), solves, and sets
//    R <- R [[1, -v0], [v0, 1]] divided as a whole by the norm of its first
//    column, t += v[1:3]. Break rules of the FAST modes (klt_fast.cu) on the
//    3-vector v.
// The status is rewritten at every level. Neither mean is guarded against an
// empty patch, as in the plain version. Skipped lanes keep R and t, move
// through the scalings like the others, and return NOT_TRACKED.
//
// The system in float64. jtheta holds absolute coordinates, and over a
// small patch far from the origin the rotation column is nearly a
// combination of the two translation columns: cond(H) reaches 1e7 and more
// at 752x480, and in float32 the order of the patch sums alone moves the
// solution (see klt_affine.cu). The per-pixel terms stay float32 (the same
// roundings as the plain version, --fmad=false); H, b and the sums behind
// the two means are accumulated in float64, so the products are exact and
// the sums agree with the plain version's to 1e-16 in any order. The 3x3 is
// solved in float64 by Gaussian elimination with partial pivoting
// (klt_common.cuh::solve_pivoted); a singular H comes out as NaN ->
// NUMERIC_ERROR.
//
// Bound on an H100: the two pyramids read from HBM once (752x480, 4 levels:
// 3.8 MB, 1.1 us at 3.35 TB/s); the patch reads hit L1/L2. Per step and
// patch pixel ~55 FLOP (warp 10, sample 15, normalisation and residual 2,
// jtheta 9, nine products and sums 18), outside the tensor cores
// (67 TFLOP/s in f32). Bound by operations; in practice by latency: each
// step is a dependent chain of loads, a reduction and a solve, one feature
// per warp, so what counts is how many warps an SM holds and how short the
// chain is.
//
// Design: one warp per feature, several warps per block; each lane a
// strided share of the patch pixels; the reference patch and gradients in
// per-warp shared memory.
//  - One launch per track() call: the level loop, the scalings and the
//    carried R live in the kernel (as in klt_affine.cu).
//  - A lane's step samples stay in registers where the patch has at most
//    32 * kRegPix pixels (13x13: 6 a lane), with a validity bit per sample:
//    pass 2 neither reloads them nor recomputes the warp and its validity.
//    Larger patches keep the samples and their validity in shared memory.
//    Luminance is a template argument: without it the two passes are one
//    stream of independent work per pixel for the compiler to schedule.
//  - Pass 1's loads go out together and without a branch before them (an
//    invalid position reads pixel (0, 0) and is discarded); so do the
//    reference patch's.
//  - The nine float64 sums of a step are reduced by one transposing
//    butterfly (klt_common.cuh::transpose_sum, its step a template argument
//    so that the array stays in registers), 15 + 1 shuffles and nine
//    broadcasts in place of 45; counts by the hardware's integer reduction
//    (__reduce_add_sync), so pass 1's means take one butterfly.
//  - __launch_bounds__(256, 2): at most 128 registers a thread, two blocks
//    of eight warps = 16 warps to an SM. (Three blocks at 80 registers
//    spilled and measured slower; so did staging the image pixels under the
//    reference patch in shared memory, loading the patch column by column,
//    and, without luminance, keeping the pixels' rows and columns across
//    levels.)
// The phase clocks (FTK_MARK below) put, on an H100 at 752x480 with 10240
// features, 50 % of the warps' time in the reference patches, 25 % in
// pass 1, 8 % in pass 2, 5 % in the step reductions and 11 % in the solves;
// with luminance 33 / 31 / 13 / 6 / 13 %, and 4 % in the means. The
// reference setup, once per level and feature, costs as much as the ~2
// steps a level takes. Built with --fmad=false.

#include "klt_common.cuh"

namespace {

using namespace ftk;

constexpr int kMaxWarps = 8;  // per block; two blocks to an SM
constexpr int kRegPix = 6;    // samples a lane keeps in registers
constexpr int kBatch = 3;     // shared-memory path: loads sent out together

// Per-warp shared memory: the extended patch, the two gradient planes and
// the inner patch as floats; on the shared-memory path also the step's
// samples (floats) and their validity (bytes).
__host__ __device__ inline size_t warp_bytes(int pr, int pc,
                                             bool samples_in_smem) {
  const size_t p_n = (size_t)pr * pc;
  size_t floats = (size_t)(pr + 2) * (pc + 2) + 3 * p_n;
  size_t bytes = 0;
  if (samples_in_smem) {
    floats += p_n;
    bytes = (p_n + 3) & ~(size_t)3;
  }
  return sizeof(float) * floats + bytes;
}

__host__ __device__ inline bool samples_in_registers(int pr, int pc) {
  return pr * pc <= 32 * kRegPix;
}

// kLum: luminance normalisation. kPix: samples a lane keeps in registers
// (kRegPix), or 0 for the shared-memory path.
template <bool kLum, int kPix>
__global__ void __launch_bounds__(32 * kMaxWarps, 2)
    klt_lssd_pyramid_kernel(Pyramids pyr, Options opt,
                            const float* __restrict__ ref_uv,
                            const float* __restrict__ cur_uv,
                            const float* __restrict__ trans,
                            const float* __restrict__ rot,
                            const uint8_t* __restrict__ skip,
                            float* __restrict__ out_uv,
                            float* __restrict__ out_rot,
                            float* __restrict__ out_trans,
                            int8_t* __restrict__ out_status, int n) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f = blockIdx.x * (blockDim.x >> 5) + warp;
  if (f >= n) return;  // whole warp

  const int pr = opt.pr, pc = opt.pc;
  const int epr = pr + 2, epc = pc + 2;
  const int ex_n = epr * epc, p_n = pr * pc;
  float* ex = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) +
                                       warp * warp_bytes(pr, pc, kPix == 0));
  float* gx = ex + ex_n;     // inner d/dx
  float* gy = gx + p_n;      // inner d/dy
  float* inner = gy + p_n;   // inner patch (normalised with luminance)
  float* cv = inner + p_n;   // shared-memory path: the step's samples
  uint8_t* cok = reinterpret_cast<uint8_t*>(cv + p_n);  // and validity

  float r00 = rot[4 * f], r01 = rot[4 * f + 1];
  float r10 = rot[4 * f + 2], r11 = rot[4 * f + 3];
  const float ux = ref_uv[2 * f], uy = ref_uv[2 * f + 1];
  const float scale = 1.0f / (float)(1 << (pyr.levels - 1));
  float rx = ux * scale, ry = uy * scale;
  float tx, ty;
  if (trans != nullptr) {
    tx = trans[2 * f];
    ty = trans[2 * f + 1];
  } else {
    const float sx = cur_uv[2 * f] * scale, sy = cur_uv[2 * f + 1] * scale;
    tx = sx - (r00 * rx + r01 * ry);
    ty = sy - (r10 * rx + r11 * ry);
  }
  int status = kNotTracked;
  const bool tracked = !skip[f];
  constexpr int K = kPix > 0 ? kPix : 1;
  // Phases (FTK_PHASE_CLOCKS builds only): 0 reference patch, 1 pass 1 (the
  // samples), 2 the means' reductions, 3 pass 2 (the system), 4 the step's
  // reduction, 5 its solve and update.
  PhaseClock phases;

  for (int lvl = pyr.levels - 1; lvl >= 0; --lvl) {
    if (tracked) {
      const float* __restrict__ R = pyr.ref[lvl];
      const float* __restrict__ C = pyr.cur[lvl];
      const int h = pyr.h[lvl], w = pyr.w[lvl];

      // Reference setup.
      const Anchor ra = make_anchor(rx, ry);
      const int min_r = ra.r - epr / 2, min_c = ra.c - epc / 2;
      int n_ref =
          load_extended_patch_batched<4>(R, h, w, ra, epr, epc, lane, ex);
      __syncwarp();
      n_ref = __reduce_add_sync(0xffffffffu, n_ref);
      float ref_mean = 1.0f;
      if constexpr (kLum) {
        double s = 0.0;
        PatchWalk at(lane, pc);
        for (int p = lane; p < p_n; p += 32, at.next())
          s += (double)ex[(at.i + 1) * epc + (at.j + 1)];
        ref_mean = (float)warp_sum(s) / (float)n_ref;
      }
      PatchWalk at(lane, pc);
      for (int p = lane; p < p_n; p += 32, at.next()) {
        float dx, dy;
        inner_gradient(ex, epc, min_r, min_c, at.i, at.j, h, w, &dx, &dy);
        float v = ex[(at.i + 1) * epc + (at.j + 1)];
        if constexpr (kLum) {
          dx = dx / ref_mean;
          dy = dy / ref_mean;
          v = v / ref_mean;
        }
        gx[p] = dx;
        gy[p] = dy;
        inner[p] = v;
      }
      // Register path: this lane's pixels p = lane + 32 k, their absolute
      // reference coordinates, the validity of their reference taps and
      // (luminance) whether they count in the current patch's mean. (Kept
      // across levels, the pixels' rows and columns cost registers that the
      // divisions here do not.)
      float px[K], py[K];
      unsigned ref_ok = 0u, core = 0u;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const int p = lane + 32 * k;
        const int i = p < p_n ? p / pc : 0, j = p < p_n ? p - i * pc : 0;
        px[k] = rx + (float)(j - pc / 2);
        py[k] = ry + (float)(i - pr / 2);
        if (p < p_n && tap_valid(min_r + i + 1, min_c + j + 1, h, w))
          ref_ok |= 1u << k;
        if (p < p_n && i >= 1 && i <= pr - 2 && j >= 1 && j <= pc - 2)
          core |= 1u << k;
      }
      __syncwarp();
      FTK_MARK(phases, 0, lane == 0);

      status = n_ref == 0 ? kOutside : kLargeResidual;
      if (n_ref > 0) {
        FastBreaks breaks;
        for (int it = 0; it < opt.max_iterations; ++it) {
          // Pass 1: sample the warped patch.
          float smp[K];
          unsigned cur_ok = 0u;
          double s_in = 0.0;
          int n_cur = 0;
          if constexpr (kPix > 0) {
            Taps taps[K];
#pragma unroll
            for (int k = 0; k < kPix; ++k) {
              const float x = px[k] * r00 + py[k] * r01 + tx;
              const float y = px[k] * r10 + py[k] * r11 + ty;
              taps[k].load(C, h, w, x, y);
            }
#pragma unroll
            for (int k = 0; k < kPix; ++k) {
              const bool ok = taps[k].ok && lane + 32 * k < p_n;
              smp[k] = ok ? taps[k].value() : 0.0f;
              cur_ok |= (unsigned)ok << k;
              if (kLum && ((core >> k) & 1u)) s_in += (double)smp[k];
            }
            n_cur = __popc(cur_ok);
          } else {
            for (int p0 = lane; p0 < p_n; p0 += 32 * kBatch) {
              Taps taps[kBatch];
#pragma unroll
              for (int u = 0; u < kBatch; ++u) {
                const int p = p0 + 32 * u;
                const int i = p / pc, j = p - i * pc;
                const float qx = rx + (float)(j - pc / 2);
                const float qy = ry + (float)(i - pr / 2);
                taps[u].load(C, h, w, qx * r00 + qy * r01 + tx,
                             qx * r10 + qy * r11 + ty);
              }
#pragma unroll
              for (int u = 0; u < kBatch; ++u) {
                const int p = p0 + 32 * u;
                if (p < p_n) {
                  const int i = p / pc, j = p - i * pc;
                  const float v = taps[u].ok ? taps[u].value() : 0.0f;
                  cv[p] = v;
                  cok[p] = taps[u].ok;
                  n_cur += taps[u].ok;
                  if (kLum && i >= 1 && i <= pr - 2 && j >= 1 && j <= pc - 2)
                    s_in += (double)v;
                }
              }
            }
          }
          FTK_MARK(phases, 1, lane == 0);
          float cur_mean = 1.0f;
          if constexpr (kLum) {
            n_cur = __reduce_add_sync(0xffffffffu, n_cur);
            cur_mean = (float)warp_sum(s_in) / (float)n_cur;
          }
          FTK_MARK(phases, 2, lane == 0);
          // Pass 2: the system over the jointly valid pixels.
          double acc[16];
#pragma unroll
          for (int k = 0; k < 16; ++k) acc[k] = 0.0;
          int n_valid = 0;
          auto add_pixel = [&](int p, float qx, float qy, float curv) {
            if constexpr (kLum) curv = curv / cur_mean;
            const float res = curv - inner[p];
            const float jrx = (-qy) * r00 + qx * r01;
            const float jry = (-qy) * r10 + qx * r11;
            const float dx = gx[p], dy = gy[p];
            const float jt = dx * jrx + dy * jry;
            const double jtd = jt, dxd = dx, dyd = dy, resd = res;
            acc[0] += jtd * jtd;
            acc[1] += jtd * dxd;
            acc[2] += jtd * dyd;
            acc[3] += dxd * dxd;
            acc[4] += dxd * dyd;
            acc[5] += dyd * dyd;
            acc[6] += jtd * resd;
            acc[7] += dxd * resd;
            acc[8] += dyd * resd;
          };
          if constexpr (kPix > 0) {
            const unsigned valid = cur_ok & ref_ok;
#pragma unroll
            for (int k = 0; k < kPix; ++k)
              if ((valid >> k) & 1u)
                add_pixel(lane + 32 * k, px[k], py[k], smp[k]);
            n_valid = __popc(valid);
          } else {
            for (int p = lane; p < p_n; p += 32) {
              const int i = p / pc, j = p - i * pc;
              if (cok[p] && tap_valid(min_r + i + 1, min_c + j + 1, h, w)) {
                add_pixel(p, rx + (float)(j - pc / 2),
                          ry + (float)(i - pr / 2), cv[p]);
                ++n_valid;
              }
            }
          }
          FTK_MARK(phases, 3, lane == 0);
          n_valid = __reduce_add_sync(0xffffffffu, n_valid);
          if (n_valid == 0) break;
          const double total = transpose_sum(acc, lane);  // lane k: sum k
          double m[3][3], z[3];
          m[0][0] = __shfl_sync(0xffffffffu, total, 0);
          m[0][1] = m[1][0] = __shfl_sync(0xffffffffu, total, 1);
          m[0][2] = m[2][0] = __shfl_sync(0xffffffffu, total, 2);
          m[1][1] = __shfl_sync(0xffffffffu, total, 3);
          m[1][2] = m[2][1] = __shfl_sync(0xffffffffu, total, 4);
          m[2][2] = __shfl_sync(0xffffffffu, total, 5);
#pragma unroll
          for (int k = 0; k < 3; ++k)
            z[k] = -__shfl_sync(0xffffffffu, total, 6 + k);
          FTK_MARK(phases, 4, lane == 0);
          solve_pivoted<3>(m, z);
          const float v0 = (float)z[0], v1 = (float)z[1], v2 = (float)z[2];
          if (isnan(v0) || isnan(v1) || isnan(v2)) {
            status = kNumericError;
            FTK_MARK(phases, 5, lane == 0);
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
          FTK_MARK(phases, 5, lane == 0);
          if (breaks.after_update(v0 * v0 + v1 * v1 + v2 * v2,
                                  opt.max_tolerance_large_step,
                                  opt.max_converge_step, &status))
            break;
        }
      }
      __syncwarp();  // the next level overwrites the patch
    }
    if (lvl > 0) {
      rx *= 2.0f;
      ry *= 2.0f;
      tx *= 2.0f;
      ty *= 2.0f;
    }
  }
  if (lane == 0) {
    out_rot[4 * f] = r00;
    out_rot[4 * f + 1] = r01;
    out_rot[4 * f + 2] = r10;
    out_rot[4 * f + 3] = r11;
    if (out_trans != nullptr) {
      out_trans[2 * f] = tx;
      out_trans[2 * f + 1] = ty;
    }
    if (out_uv != nullptr) {
      out_uv[2 * f] = (r00 * ux + r01 * uy) + tx;
      out_uv[2 * f + 1] = (r10 * ux + r11 * uy) + ty;
    }
    out_status[f] = (int8_t)status;
  }
}

// The instantiation for these options.
template <bool kLum>
void* pick_kernel(const Options& opt) {
  return samples_in_registers(opt.pr, opt.pc)
             ? (void*)klt_lssd_pyramid_kernel<kLum, kRegPix>
             : (void*)klt_lssd_pyramid_kernel<kLum, 0>;
}

// Kernel, warps per block and dynamic shared memory: as many warps as fit
// half an SM's shared memory, at most kMaxWarps (the register bound lets two
// such blocks share an SM).
cudaError_t plan(const Options& opt, bool luminance, void** kernel,
                 int* warps, size_t* smem) {
  *kernel = luminance ? pick_kernel<true>(opt) : pick_kernel<false>(opt);
  const size_t per_warp =
      warp_bytes(opt.pr, opt.pc, !samples_in_registers(opt.pr, opt.pc));
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
// success). Level pointer and size arrays live on the host (one level is a
// pyramid of one); all other pointers are device pointers: images float32
// [h, w], ref_uv / cur_uv float32 [n, 2] at full resolution, trans float32
// [n, 2] at the coarsest level, rot float32 [n, 2, 2], skip uint8 [n].
// Exactly one of cur_uv and trans is given (the other is null); out_uv
// (R ref_uv + t) and out_trans (t at level 0) may each be null.
int ftk_klt_lssd_pyramid(const void* const* ref_levels,
                         const void* const* cur_levels, const int* heights,
                         const int* widths, int levels, const void* ref_uv,
                         const void* cur_uv, const void* trans,
                         const void* rot, const void* skip, void* out_uv,
                         void* out_rot, void* out_trans, void* out_status,
                         int n, int luminance, int patch_row_half_size,
                         int patch_col_half_size, int max_iterations,
                         int max_tolerance_large_step,
                         float max_converge_step, void* stream) {
  Pyramids pyr;
  Options opt;
  if (n < 0 || (cur_uv == nullptr) == (trans == nullptr) ||
      !fill_pyramids(&pyr, ref_levels, cur_levels, heights, widths, levels) ||
      !fill_options(&opt, patch_row_half_size, patch_col_half_size,
                    max_iterations, max_tolerance_large_step,
                    max_converge_step))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < levels; ++l)
    if (heights[l] < 2 || widths[l] < 2) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;

  void* kernel;
  int warps;
  size_t smem;
  cudaError_t e = plan(opt, luminance != 0, &kernel, &warps, &smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + warps - 1) / warps;
  const float *ref_p = (const float*)ref_uv, *cur_p = (const float*)cur_uv;
  const float *trans_p = (const float*)trans, *rot_p = (const float*)rot;
  const uint8_t* skip_p = (const uint8_t*)skip;
  float *ouv_p = (float*)out_uv, *orot_p = (float*)out_rot;
  float* otrans_p = (float*)out_trans;
  int8_t* ost_p = (int8_t*)out_status;
  void* args[] = {&pyr,    &opt,    &ref_p,    &cur_p, &trans_p, &rot_p,
                  &skip_p, &ouv_p,  &orot_p,   &otrans_p, &ost_p, &n};
  e = cudaLaunchKernel(kernel, dim3(blocks), dim3(32 * warps), args, smem,
                       (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// What the card holds of the kernel these options launch: registers a
// thread, warps a block, and the blocks one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a cudaError.
int ftk_klt_lssd_occupancy(int patch_row_half_size, int patch_col_half_size,
                           int luminance, int* registers,
                           int* warps_per_block, int* blocks_per_sm) {
  Options opt;
  if (!fill_options(&opt, patch_row_half_size, patch_col_half_size, 1, 1,
                    0.0f))
    return (int)cudaErrorInvalidValue;
  void* kernel;
  size_t smem;
  cudaError_t e = plan(opt, luminance != 0, &kernel, warps_per_block, &smem);
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
