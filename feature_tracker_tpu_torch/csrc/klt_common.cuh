// Device helpers shared by the sparse-KLT kernels (klt_fast.cu, klt_iter.cu,
// klt_affine.cu, klt_lssd.cu): the status codes, the warp butterfly sums,
// the bilinear taps with their validity rule, the reference-patch setup of
// the FAST modes, and a small dense solver.
//
// All kernels run one warp per feature. Sums over the patch are reduced
// with __shfl_xor_sync: the butterfly leaves the same bits in every lane,
// so every lane carries the scalar Gauss-Newton state redundantly and the
// warp branches uniformly.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FTK_MAX_LEVELS 8

namespace ftk {

// Both frames' pyramids, finest level first; passed to a kernel by value.
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

inline bool fill_pyramids(Pyramids* pyr, const void* const* ref_levels,
                          const void* const* cur_levels, const int* heights,
                          const int* widths, int levels) {
  if (levels < 1 || levels > FTK_MAX_LEVELS) return false;
  for (int l = 0; l < FTK_MAX_LEVELS; ++l) {
    const bool on = l < levels;
    pyr->ref[l] = on ? (const float*)ref_levels[l] : nullptr;
    pyr->cur[l] = on ? (const float*)cur_levels[l] : nullptr;
    pyr->h[l] = on ? heights[l] : 0;
    pyr->w[l] = on ? widths[l] : 0;
  }
  pyr->levels = levels;
  return true;
}

inline bool fill_options(Options* opt, int patch_row_half_size,
                         int patch_col_half_size, int max_iterations,
                         int max_tolerance_large_step,
                         float max_converge_step) {
  if (patch_row_half_size < 0 || patch_col_half_size < 0) return false;
  opt->pr = 2 * patch_row_half_size + 1;
  opt->pc = 2 * patch_col_half_size + 1;
  opt->max_iterations = max_iterations;
  opt->max_tolerance_large_step = max_tolerance_large_step;
  opt->max_converge_step = max_converge_step;
  return true;
}

enum : int {
  kNotTracked = 0,
  kTracked = 1,
  kLargeResidual = 2,
  kOutside = 3,
  kNumericError = 4,
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
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

// A bilinear tap is valid when its anchor lies in [0, dim-2]: the +1
// neighbours must exist.
__device__ __forceinline__ bool tap_valid(int r, int c, int h, int w) {
  return r >= 0 && r <= h - 2 && c >= 0 && c <= w - 2;
}

__device__ __forceinline__ float sample(const float* img, int w, int r,
                                        int c, float wtl, float wtr,
                                        float wbl, float wbr) {
  const float* q = img + (size_t)r * w + c;
  return wtl * q[0] + wtr * q[1] + wbl * q[w] + wbr * q[w + 1];
}

// The four constant bilinear weights of a position and its integer anchor.
struct Anchor {
  int r, c;  // floor(y), floor(x), clamped
  float wtl, wtr, wbl, wbr;
};

__device__ __forceinline__ Anchor make_anchor(float x, float y) {
  const float y0 = floorf(y), x0 = floorf(x);
  const float fr = y - y0, fc = x - x0;
  Anchor a;
  a.r = anchor(y0);
  a.c = anchor(x0);
  a.wtl = (1.0f - fr) * (1.0f - fc);
  a.wtr = (1.0f - fr) * fc;
  a.wbl = fr * (1.0f - fc);
  a.wbr = fr * fc;
  return a;
}

// Validity of a free sampling position, decided on the floored float: a
// position beyond the int range, infinite or NaN is invalid (NaN compares
// false) before any cast.
__device__ __forceinline__ bool position_valid(int h, int w, float x,
                                               float y) {
  const float y0 = floorf(y), x0 = floorf(x);
  return y0 >= 0.0f && y0 <= (float)(h - 2) && x0 >= 0.0f &&
         x0 <= (float)(w - 2);
}

// Bounds-checked bilinear sample at a free position (own weights per call).
__device__ __forceinline__ bool sample_at(const float* img, int h, int w,
                                          float x, float y, float* out) {
  if (!position_valid(h, w, x, y)) {
    *out = 0.0f;
    return false;
  }
  const float y0 = floorf(y), x0 = floorf(x);
  const float fr = y - y0, fc = x - x0;
  const float* q = img + (size_t)(int)y0 * w + (int)x0;
  *out = (1.0f - fr) * (1.0f - fc) * q[0] + (1.0f - fr) * fc * q[1] +
         fr * (1.0f - fc) * q[w] + fr * fc * q[w + 1];
  return true;
}

// Extended (pr+2)x(pc+2) patch around `a` with constant weights, written to
// ex[] (0 where the tap is invalid). Returns this lane's count of valid
// taps; the caller sums it over the warp and syncs before reading ex[].
__device__ __forceinline__ int load_extended_patch(const float* img, int h,
                                                   int w, const Anchor& a,
                                                   int epr, int epc,
                                                   int lane, float* ex) {
  const int min_r = a.r - epr / 2, min_c = a.c - epc / 2;
  int n_valid = 0;
  for (int p = lane; p < epr * epc; p += 32) {
    const int i = p / epc, j = p - i * epc;
    const int r = min_r + i, c = min_c + j;
    float v = 0.0f;
    if (tap_valid(r, c, h, w)) {
      v = sample(img, w, r, c, a.wtl, a.wtr, a.wbl, a.wbr);
      ++n_valid;
    }
    ex[p] = v;
  }
  return n_valid;
}

// Central differences of inner pixel (i, j) of the extended patch ex[]
// whose top-left tap is (min_r, min_c): zero unless all four neighbour
// taps are valid, i.e. the pixel's own tap lies in [1, dim-3] both ways.
__device__ __forceinline__ void inner_gradient(const float* ex, int epc,
                                               int min_r, int min_c, int i,
                                               int j, int h, int w,
                                               float* dx, float* dy) {
  const int r = min_r + i + 1, c = min_c + j + 1;
  *dx = 0.0f;
  *dy = 0.0f;
  if (r >= 1 && r <= h - 3 && c >= 1 && c <= w - 3) {
    const float* e = ex + (i + 1) * epc + (j + 1);
    *dx = e[1] - e[-1];
    *dy = e[epc] - e[-epc];
  }
}

// Solve the dense NxN system a x = b in place (x returned in b) by Gaussian
// elimination with partial pivoting, in float64. Fully unrolled with
// predicated row swaps, so a[][] and b[] stay in registers, and every lane
// of a warp that holds the same bits takes the same path. A singular
// system leaves NaN or inf in b and traps nothing: a zero pivot divides.
template <int N>
__device__ __forceinline__ void solve_pivoted(double (&a)[N][N],
                                              double (&b)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int piv = k;
    double best = fabs(a[k][k]);
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      const double cand = fabs(a[r][k]);
      if (cand > best) {
        best = cand;
        piv = r;
      }
    }
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      if (r == piv) {
#pragma unroll
        for (int c = k; c < N; ++c) {
          const double tmp = a[k][c];
          a[k][c] = a[r][c];
          a[r][c] = tmp;
        }
        const double tmp = b[k];
        b[k] = b[r];
        b[r] = tmp;
      }
    }
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      const double m = a[r][k] / a[k][k];
#pragma unroll
      for (int c = k + 1; c < N; ++c) a[r][c] -= m * a[k][c];
      b[r] -= m * b[k];
    }
  }
#pragma unroll
  for (int k = N - 1; k >= 0; --k) {
    double s = b[k];
#pragma unroll
    for (int c = k + 1; c < N; ++c) s -= a[k][c] * b[c];
    b[k] = s / a[k][k];
  }
}

// FAST-mode break rules after a step has been applied (the divergence
// counter, then convergence): returns true when the chain ends and sets
// *status to TRACKED on convergence.
struct FastBreaks {
  float last_sq;
  int cnt;
  __device__ __forceinline__ FastBreaks() : last_sq(INFINITY), cnt(0) {}
  __device__ __forceinline__ bool after_update(float sq, int tolerance,
                                               float converge, int* status) {
    if (sq < last_sq) {
      last_sq = sq;
      cnt = 0;
    } else {
      ++cnt;
    }
    if (cnt >= tolerance) return true;
    if (sq < converge) {
      *status = kTracked;
      return true;
    }
    return false;
  }
};

// Warps per block and dynamic shared memory for `per_warp` bytes a warp:
// as many warps as fit the default 48 KB (at most 8); a single warp may
// take up to the 227 KB a block can opt into.
template <typename Kernel>
inline cudaError_t plan_block(Kernel kernel, size_t per_warp, int* warps,
                              size_t* smem) {
  const size_t default_smem = 48 * 1024, max_smem = 227 * 1024;
  if (per_warp > max_smem) return cudaErrorInvalidValue;
  int n = (int)(default_smem / per_warp);
  n = n < 1 ? 1 : (n > 8 ? 8 : n);
  *warps = n;
  *smem = per_warp * n;
  if (*smem > default_smem)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return cudaSuccess;
}

}  // namespace ftk

// Every library built from these sources exports the error-string lookup.
#define FTK_DEFINE_ERROR_STRING                           \
  extern "C" const char* ftk_cuda_error_string(int code) { \
    return cudaGetErrorString((cudaError_t)code);          \
  }
