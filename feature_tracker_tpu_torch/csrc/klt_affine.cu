// Affine-warp KLT, FAST mode, the whole image pyramid in one launch, for
// Hopper.
//
// Replaces: feature_tracker_tpu/ops/pallas_warp_klt.py::
// affine_track_level_pallas (l.728, body _affine_kernel l.376), which runs
// one level per call inside the tracker's level loop; this kernel runs that
// loop too. Plain versions: feature_tracker_tpu_torch/trackers/klt/
// affine.py::affine_track_level_reference (one level) and
// affine_track_pyramid_reference (the level loop over it); Python wrappers:
// feature_tracker_tpu_torch/ops/cuda_warp_klt.py::affine_track_pyramid_cuda
// and affine_track_level_cuda (the one-level case of the same kernel).
//
// What it computes, per non-skipped feature, coarse to fine over L levels
// (both positions scaled by 2^-(L-1) first and doubled between levels; the
// 2x2 affine A is carried from level to level unscaled), at each level with
// the warp pos_cur = A (dcol, drow) + cur_uv:
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
// The status is rewritten at every level. Skipped lanes return cur_uv, A
// and NOT_TRACKED at once.
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
// Gaussian elimination with partial pivoting: no equilibration, and no
// assumption that H is positive definite (a flat or one-directional patch
// gives a singular H, which must come out as NaN -> NUMERIC_ERROR, not
// trap: a zero pivot divides).
//
// Bound on an H100: the two pyramids read from HBM once (752x480, 4
// levels: 3.8 MB, 1.1 us at 3.35 TB/s); the patch reads hit L1/L2. Per step
// and patch pixel ~40 FLOP (warp 8, sample 15, residual, 6 bias terms 14),
// per level and pixel ~60 (setup and the 21 H terms), outside the tensor
// cores (67 TFLOP/s in f32). Bound by operations; in practice by latency:
// each step is a dependent chain of loads, a reduction and a solve, so what
// counts is how many warps an SM holds and how short the chain is.
//
// Design: one warp per feature, several warps per block; each lane a
// strided share of the patch pixels; the reference patch and gradients in
// per-warp shared memory.
//  - One launch per track() call: the level loop, the doubling of the
//    positions and the carried A live in the kernel.
//  - H is constant over a level, so it is factored once per level
//    (klt_common.cuh::lu_factor, every lane on the same bits) and the
//    factors go to per-warp shared memory; a step only replays the row
//    swaps and multipliers on its b and substitutes back (lu_solve).
//    Multipliers and solutions are products with the pivots' reciprocals,
//    as in LAPACK's getf2: six double divisions a level where eliminating
//    afresh took 21 a step. That changes a last bit of float64; the float32
//    results agree with the plain version as before.
//  - The 21 float64 sums of H and the 36 factors are dead before the step
//    loop, which keeps the kernel at 128 registers a thread without spills
//    (__launch_bounds__(256, 2)): 16 warps to an SM, where 180 registers
//    allowed 8.
//  - Sums over the warp by a transposing butterfly (klt_common.cuh::
//    transpose_sum): 7 + 2 shuffles and 6 broadcasts for the six sums of b
//    in place of 30, 31 for the 21 of H in place of 105; the pixel count by
//    the hardware's integer reduction.
//  - The loads of the reference patch and of a step's pixels go out several
//    pixels at a time and without a branch before them (an invalid tap
//    reads pixel (0, 0) and is discarded), so that they wait together.
// The phase clocks (FTK_MARK below) put 37 % of the warps' time in the
// steps' pixel loops, 21 % in the patch, 20 % in the sums of H and their
// reduction, 11 % in the factorisation and 6 % in the solves.
// Built with --fmad=false.

#include "klt_common.cuh"

namespace {

using namespace ftk;

constexpr int kMaxWarps = 8;  // per block; two blocks to an SM
constexpr int kBatch = 3;     // pixels of a step whose loads go out together

// Index of entry (a, b), a <= b, in the packed upper triangle of a 6x6.
__host__ __device__ constexpr int tri(int a, int b) {
  return a * 6 - a * (a - 1) / 2 + (b - a);
}

// Per-warp shared memory: 36 factors and 21 sums of H as doubles (padded to
// 58), then the extended patch and the two gradient planes as floats.
constexpr int kWarpDoubles = 58;

__host__ __device__ inline size_t warp_bytes(int pr, int pc) {
  const size_t floats = (size_t)(pr + 2) * (pc + 2) + 2 * (size_t)pr * pc;
  return sizeof(double) * kWarpDoubles + sizeof(float) * ((floats + 1) & ~1);
}

__global__ void __launch_bounds__(32 * kMaxWarps, 2)
    klt_affine_pyramid_kernel(Pyramids pyr, Options opt,
                              const float* __restrict__ ref_uv,
                              const float* __restrict__ cur_uv,
                              const float* __restrict__ affine,
                              const uint8_t* __restrict__ skip,
                              float* __restrict__ out_uv,
                              float* __restrict__ out_affine,
                              int8_t* __restrict__ out_status, int n) {
  extern __shared__ double smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f = blockIdx.x * (blockDim.x >> 5) + warp;
  if (f >= n) return;  // whole warp

  const int pr = opt.pr, pc = opt.pc;
  const int epr = pr + 2, epc = pc + 2;
  const int ex_n = epr * epc, p_n = pr * pc;
  double* lu = reinterpret_cast<double*>(reinterpret_cast<char*>(smem) +
                                         warp * warp_bytes(pr, pc));
  double* hsum = lu + 36;
  float* ex = reinterpret_cast<float*>(lu + kWarpDoubles);  // extended patch
  float* gx = ex + ex_n;                                     // inner d/dx
  float* gy = gx + p_n;                                      // inner d/dy

  float cx = cur_uv[2 * f], cy = cur_uv[2 * f + 1];
  float a00 = affine[4 * f], a01 = affine[4 * f + 1];
  float a10 = affine[4 * f + 2], a11 = affine[4 * f + 3];
  int status = kNotTracked;
  // Phases (FTK_PHASE_CLOCKS builds only): 0 patch, 1 sums of H, 2 their
  // reduction, 3 factorisation, 4 a step's pixels, 5 its reduction, 6 its
  // solve and update.
  PhaseClock phases;

  if (!skip[f]) {
    const float scale = 1.0f / (float)(1 << (pyr.levels - 1));
    float rx = ref_uv[2 * f] * scale, ry = ref_uv[2 * f + 1] * scale;
    cx *= scale;
    cy *= scale;

    for (int lvl = pyr.levels - 1; lvl >= 0; --lvl) {
      const float* __restrict__ R = pyr.ref[lvl];
      const float* __restrict__ C = pyr.cur[lvl];
      const int h = pyr.h[lvl], w = pyr.w[lvl];

      // Reference setup: extended patch, gradients, the 21 sums of H.
      const Anchor ra = make_anchor(rx, ry);
      const int min_r = ra.r - epr / 2, min_c = ra.c - epc / 2;
      int n_ref =
          load_extended_patch_batched<4>(R, h, w, ra, epr, epc, lane, ex);
      __syncwarp();
      FTK_MARK(phases, 0, lane == 0);
      int piv[6];
      {
        double hs[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) hs[k] = 0.0;
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
        FTK_MARK(phases, 1, lane == 0);
        const double total = transpose_sum(hs, lane);  // lane k: sum k
        if (lane < 21) hsum[lane] = total;
      }
      n_ref = __reduce_add_sync(0xffffffffu, n_ref);
      __syncwarp();
      FTK_MARK(phases, 2, lane == 0);
      // Factor H once for the level: every lane on the same bits, the
      // factors to shared memory, the row swaps in registers.
      {
        double m[6][6];
#pragma unroll
        for (int a = 0; a < 6; ++a)
#pragma unroll
          for (int b = a; b < 6; ++b) {
            m[a][b] = hsum[tri(a, b)];
            m[b][a] = m[a][b];
          }
        lu_factor<6>(m, piv);
        if (lane == 0) {
#pragma unroll
          for (int a = 0; a < 6; ++a)
#pragma unroll
            for (int b = 0; b < 6; ++b) lu[a * 6 + b] = m[a][b];
        }
      }
      __syncwarp();
      FTK_MARK(phases, 3, lane == 0);

      status = n_ref == 0 ? kOutside : kLargeResidual;
      if (n_ref > 0) {
        FastBreaks breaks;
        for (int it = 0; it < opt.max_iterations; ++it) {
          double bs[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
          int n_valid = 0;
          // kBatch pixels at a time, their loads sent out together.
          for (int p0 = lane; p0 < p_n; p0 += 32 * kBatch) {
            Taps taps[kBatch];
            float wxs[kBatch], wys[kBatch];
            bool use[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              const int p = p0 + 32 * u;
              const int i = p / pc, j = p - i * pc;
              const float ox = (float)(j - pc / 2), oy = (float)(i - pr / 2);
              wxs[u] = ox * a00 + oy * a01 + cx;
              wys[u] = ox * a10 + oy * a11 + cy;
              taps[u].load(C, h, w, wxs[u], wys[u]);
              use[u] = p < p_n && taps[u].ok &&
                       tap_valid(min_r + i + 1, min_c + j + 1, h, w);
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              if (use[u]) {
                const int p = p0 + 32 * u;
                const int i = p / pc, j = p - i * pc;
                const float wx = wxs[u], wy = wys[u];
                const float dt =
                    taps[u].value() - ex[(i + 1) * epc + (j + 1)];
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
          }
          FTK_MARK(phases, 4, lane == 0);
          n_valid = __reduce_add_sync(0xffffffffu, n_valid);
          if (n_valid == 0) break;
          const double total = transpose_sum(bs, lane);  // lane k: sum k
          double z[6];
#pragma unroll
          for (int k = 0; k < 6; ++k)
            z[k] = -__shfl_sync(0xffffffffu, total, k);
          FTK_MARK(phases, 5, lane == 0);
          lu_solve<6>(lu, piv, z);
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
          FTK_MARK(phases, 6, lane == 0);
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
      __syncwarp();  // the next level overwrites the patch and the factors
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

// Warps per block and its dynamic shared memory for this patch: as many
// warps as fit half an SM's shared memory, at most kMaxWarps (the register
// bound lets two such blocks share an SM).
cudaError_t plan(const Options& opt, int* warps, size_t* smem) {
  const size_t per_warp = warp_bytes(opt.pr, opt.pc);
  const size_t half_sm = 113 * 1024, max_smem = 227 * 1024;
  if (per_warp > max_smem) return cudaErrorInvalidValue;
  int nw = (int)(half_sm / per_warp);
  nw = nw < 1 ? 1 : (nw > kMaxWarps ? kMaxWarps : nw);
  *warps = nw;
  *smem = per_warp * nw;
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(klt_affine_pyramid_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Level pointer and size arrays live on the host (one level is a
// pyramid of one); all other pointers are device pointers: images float32
// [h, w], ref_uv / cur_uv float32 [n, 2] at full resolution, affine float32
// [n, 2, 2], skip uint8 [n].
int ftk_klt_affine_pyramid(const void* const* ref_levels,
                           const void* const* cur_levels, const int* heights,
                           const int* widths, int levels, const void* ref_uv,
                           const void* cur_uv, const void* affine,
                           const void* skip, void* out_uv, void* out_affine,
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
  for (int l = 0; l < levels; ++l)
    if (heights[l] < 2 || widths[l] < 2) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;

  int warps;
  size_t smem;
  cudaError_t e = plan(opt, &warps, &smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + warps - 1) / warps;
  klt_affine_pyramid_kernel<<<blocks, 32 * warps, smem,
                              (cudaStream_t)stream>>>(
      pyr, opt, (const float*)ref_uv, (const float*)cur_uv,
      (const float*)affine, (const uint8_t*)skip, (float*)out_uv,
      (float*)out_affine, (int8_t*)out_status, n);
  return (int)cudaGetLastError();
}

// What the card holds of this kernel at this patch size: registers a
// thread, warps a block, and the blocks one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a cudaError.
int ftk_klt_affine_occupancy(int patch_row_half_size, int patch_col_half_size,
                             int* registers, int* warps_per_block,
                             int* blocks_per_sm) {
  Options opt;
  if (!fill_options(&opt, patch_row_half_size, patch_col_half_size, 1, 1,
                    0.0f))
    return (int)cudaErrorInvalidValue;
  size_t smem;
  cudaError_t e = plan(opt, warps_per_block, &smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, klt_affine_pyramid_kernel);
  if (e != cudaSuccess) return (int)e;
  *registers = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, klt_affine_pyramid_kernel, 32 * *warps_per_block, smem);
}

}  // extern "C"

FTK_DEFINE_ERROR_STRING
