// Device helpers shared by the sparse-KLT kernels (klt_fast.cu, klt_iter.cu,
// klt_affine.cu, klt_lssd.cu) and by raft_lookup.cu: the status codes, the
// warp butterfly sums, the bilinear taps with their validity rule, the
// reference-patch setup of the FAST modes, and a small dense solver.
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

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One halving step of transpose_sum; HALF is a template argument so that
// the indices are compile-time constants and acc[] stays in registers (with
// the step size in a loop variable the compiler left the loop rolled and
// put acc[] in local memory).
template <typename T, int HALF>
__device__ __forceinline__ void transpose_step(T* acc, int lane) {
  const bool upper = (lane & HALF) != 0;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const T keep = upper ? acc[j + HALF] : acc[j];
    const T send = upper ? acc[j] : acc[j + HALF];
    acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
  }
  if constexpr (HALF > 1) transpose_step<T, HALF / 2>(acc, lane);
}

// acc[j] of every lane summed over the lanes, for N = 2, 4, ... 32 sums:
// the lanes whose index is p modulo N return the total of acc[p]. Each of
// the first log2(N) steps halves the values a lane holds (a lane keeps the
// half its bit selects and receives the partner's sums for that half):
// N - 1 shuffles in place of 5 N; the remaining steps are plain butterflies
// of the one value left. The total's bits are the same in every lane that
// holds it.
template <typename T, int N>
__device__ __forceinline__ T transpose_sum(T (&acc)[N], int lane) {
  static_assert(N >= 2 && N <= 32 && (N & (N - 1)) == 0, "N: a power of 2");
  transpose_step<T, N / 2>(acc, lane);
  T total = acc[0];
#pragma unroll
  for (int o = N; o < 32; o <<= 1)
    total += __shfl_xor_sync(0xffffffffu, total, o);
  return total;
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

// Row and column of the entries p = lane, lane + 32, lane + 64, ... of a
// row-major block with `cols` columns, stepped without a division: an
// integer division by a value known only at run time is some twenty
// instructions, and the loops over a patch took one for every entry.
struct PatchWalk {
  int i, j, di, dj, cols;
  __device__ __forceinline__ PatchWalk(int lane, int cols_) : cols(cols_) {
    i = lane / cols;
    j = lane - i * cols;
    di = 32 / cols;
    dj = 32 - di * cols;
  }
  __device__ __forceinline__ void next() {
    j += dj;
    i += di;
    const bool wrap = j >= cols;
    j -= wrap ? cols : 0;
    i += wrap;
  }
};

// Extended (pr+2)x(pc+2) patch around `a` with constant weights, written to
// ex[] (0 where the tap is invalid), with the loads of U taps sent out
// together: a tap outside the image reads pixel (0, 0) and is discarded,
// so no load waits behind a branch (with a branch around each tap's loads,
// a lane waits out their latency one tap after the other). Returns this
// lane's count of valid taps; the caller syncs the warp before reading
// ex[].
template <int U>
__device__ __forceinline__ int load_extended_patch_batched(
    const float* img, int h, int w, const Anchor& a, int epr, int epc,
    int lane, float* ex) {
  const int min_r = a.r - epr / 2, min_c = a.c - epc / 2;
  const int ex_n = epr * epc;
  int n_valid = 0;
  PatchWalk at(lane, epc);
  for (int p0 = lane; p0 < ex_n; p0 += 32 * U) {
    float t[U][4];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + 32 * u;
      const int r = min_r + at.i, c = min_c + at.j;
      at.next();
      ok[u] = p < ex_n && tap_valid(r, c, h, w);
      const float* q = img + (ok[u] ? (size_t)r * w + c : 0);
      t[u][0] = q[0], t[u][1] = q[1], t[u][2] = q[w], t[u][3] = q[w + 1];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + 32 * u;
      if (p < ex_n) {
        ex[p] = ok[u] ? a.wtl * t[u][0] + a.wtr * t[u][1] + a.wbl * t[u][2] +
                            a.wbr * t[u][3]
                      : 0.0f;
        n_valid += ok[u];
      }
    }
  }
  return n_valid;
}

// The four taps of a free sampling position (own weights per call), loaded
// without a branch: an invalid position (position_valid) reads pixel
// (0, 0), and value() is then not used.
struct Taps {
  float t[4];
  float fr, fc;
  bool ok;
  __device__ __forceinline__ void load(const float* img, int h, int w, float x,
                                       float y) {
    const float y0 = floorf(y), x0 = floorf(x);
    ok = position_valid(h, w, x, y);
    fr = y - y0;
    fc = x - x0;
    const float* q = img + (ok ? (size_t)(int)y0 * w + (int)x0 : 0);
    t[0] = q[0], t[1] = q[1], t[2] = q[w], t[3] = q[w + 1];
  }
  __device__ __forceinline__ float value() const {
    return (1.0f - fr) * (1.0f - fc) * t[0] + (1.0f - fr) * fc * t[1] +
           fr * (1.0f - fc) * t[2] + fr * fc * t[3];
  }
};

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

// The same elimination split in two, for a matrix that serves many right
// sides. lu_factor leaves in a[][] the upper triangle with the RECIPROCALS
// of the pivots on the diagonal and, below it, the multiplier each step
// applied to the row then in that place, and in piv[k] the row that step k
// swapped with row k. lu_solve replays the swaps and multipliers on b and
// substitutes back. Multipliers and solutions are products with the
// pivot's reciprocal (as in LAPACK's getf2), one division per pivot in
// place of 15 + 6 per solve for N = 6: a double division is a long
// sequence, and every lane runs it. A zero pivot gives an infinite
// reciprocal and a NaN or infinite solution, and traps nothing. `lu` is
// row-major N x N (registers or shared memory).
template <int N>
__device__ __forceinline__ void lu_factor(double (&a)[N][N], int (&piv)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int p = k;
    double best = fabs(a[k][k]);
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      const double cand = fabs(a[r][k]);
      if (cand > best) {
        best = cand;
        p = r;
      }
    }
    piv[k] = p;
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      if (r == p) {
#pragma unroll
        for (int c = k; c < N; ++c) {
          const double tmp = a[k][c];
          a[k][c] = a[r][c];
          a[r][c] = tmp;
        }
      }
    }
    const double inv = 1.0 / a[k][k];
    a[k][k] = inv;
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      const double m = a[r][k] * inv;
#pragma unroll
      for (int c = k + 1; c < N; ++c) a[r][c] -= m * a[k][c];
      a[r][k] = m;
    }
  }
}

template <int N>
__device__ __forceinline__ void lu_solve(const double* lu,
                                         const int (&piv)[N],
                                         double (&b)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int p = piv[k];
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      if (r == p) {
        const double tmp = b[k];
        b[k] = b[r];
        b[r] = tmp;
      }
    }
#pragma unroll
    for (int r = k + 1; r < N; ++r) b[r] -= lu[r * N + k] * b[k];
  }
#pragma unroll
  for (int k = N - 1; k >= 0; --k) {
    double s = b[k];
#pragma unroll
    for (int c = k + 1; c < N; ++c) s -= lu[k * N + c] * b[c];
    b[k] = s * lu[k * N + k];
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

// Phase clocks, for a profile where the card offers no profiler of
// kernels' insides. A source compiled with FTK_PHASE_CLOCKS defined (see
// ops/_build.py::phase_clock_library) adds, at every FTK_MARK, the SM
// clocks since the thread's last mark to a counter of that phase in device
// memory, and exports ftk_phase_clocks_read. Without the definition the
// marks compile to nothing.
#ifdef FTK_PHASE_CLOCKS
#define FTK_PHASES 8
__device__ unsigned long long phase_clocks[FTK_PHASES];
struct PhaseClock {
  long long last;
  __device__ __forceinline__ PhaseClock() : last(0) { mark(-1); }
  __device__ __forceinline__ void mark(int phase) {
#ifdef __CUDA_ARCH__  // the host pass knows no clock64
    const long long now = clock64();
    if (phase >= 0)
      atomicAdd(&phase_clocks[phase], (unsigned long long)(now - last));
    last = now;
#endif
  }
};
// `who`: the one thread of a warp or block whose clocks are kept.
#define FTK_MARK(clock, phase, who) \
  do {                              \
    if (who) (clock).mark(phase);   \
  } while (0)
#else
struct PhaseClock {};
#define FTK_MARK(clock, phase, who) \
  do {                              \
    (void)(clock), (void)(who);     \
  } while (0)
#endif

}  // namespace ftk

#ifdef FTK_PHASE_CLOCKS
// Copies the FTK_PHASES counters to `out` (host) and sets them to zero.
extern "C" int ftk_phase_clocks_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(
      out, ftk::phase_clocks, sizeof(unsigned long long) * FTK_PHASES);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[FTK_PHASES] = {};
  return (int)cudaMemcpyToSymbol(ftk::phase_clocks, zero, sizeof(zero));
}
#endif

// Every library built from these sources exports the error-string lookup.
#define FTK_DEFINE_ERROR_STRING                           \
  extern "C" const char* ftk_cuda_error_string(int code) { \
    return cudaGetErrorString((cudaError_t)code);          \
  }
