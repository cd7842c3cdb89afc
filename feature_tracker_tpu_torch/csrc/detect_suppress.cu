// Detection's exact greedy radius suppression in one launch, for Hopper
// (kernel 6).
//
// Replaces no pallas_call: the JAX package's detection is plain XLA
// (feature_tracker_tpu/ops/detect.py::greedy_suppression, chunks resolved
// by chaotic rounds). Plain version: feature_tracker_tpu_torch/ops/
// detect.py::suppress_candidates, whose rounds each end in a read of the
// device; Python wrapper: feature_tracker_tpu_torch/ops/cuda_detect.py::
// suppress_candidates_cuda.
//
// What it computes. The k candidates come in rank order (a stable
// descending sort of the corner scores); a score of -inf marks no
// candidate and sorts last, so the valid ones are a prefix. Candidate i at
// pixel (x, y) = (idx % W, idx / W) is kept exactly when no kept j < i has
// dx^2 + dy^2 < T, in integer arithmetic; T is the least integer squared
// distance that is no conflict (ops/cuda_detect.py::conflict_threshold: the
// plain version's float32 test on integer distances). The first max_num
// kept points are written to uv [max_num, 2] float32 (x, y), the other
// rows -1, and their count to num (int32). A later candidate never changes
// an earlier one's fate, so the scan stops once max_num are kept.
//
// Design: one block of one warp walks the candidates 32 at a time, a lane
// each, all in registers but the kept points:
//  1. each lane tests its candidate against the points kept before the
//     batch;
//  2. each lane gathers, by shuffles, the mask of the earlier lanes of the
//     batch it conflicts with;
//  3. the warp resolves the batch in rank order: lane j is kept when it
//     survived step 1 and no kept lane before it is in its mask, 32 steps
//     on a bit mask that every lane computes alike (skipped when no
//     surviving lane has such a conflict, the common case);
//  4. the kept lanes write their points in rank order, up to max_num, and
//     the next batch's scores and indices were loaded during this one.
// Step 1 reads a grid of cells in shared memory whose side s is the least
// integer with s^2 >= T: a conflicting point lies in the 3x3 cells around
// the candidate, and as kept points are at least sqrt(T) apart and a
// cell's pixels span s - 1 < sqrt(T), a cell holds at most 4 of them (one
// in each quarter of the cell). At 752x480 and 25 px the grid is 31x20
// cells, 12.4 KB. Where it would have more than kMaxGridCells cells (a
// small distance on a large image) step 1 tests against the list of kept
// points instead, which is uv itself and at most max_num long: correct
// for any size, slower where many points are kept. The launch picks the
// path from the image size and T alone: the host computes the grid
// (ops/cuda_detect.py::grid_layout) and passes it in, and the entry only
// checks it; both paths give the same bits.
//
// What bounds it: it is a sequential scan, so one warp's latency: each
// batch is a chain of dependent shared-memory reads, shuffles and ballots,
// a few thousand clocks with nothing to hide them. On an H100 at 752x480,
// 25 px and max_num 300 a launch takes ~0.11 ms of device time (~0.27 ms
// for all 4096 candidates, without the early stop), against the plain
// version's ~25 rounds that each wait for the host (~11 ms a detection).
// The bytes (12 a candidate) do not count. The list path costs a pass over
// the kept points a batch: ~3.5 ms where 3752 of 4096 are kept (3 px).

#include <math.h>

#include "klt_common.cuh"

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kSlots = 4;              // kept points a cell holds
constexpr int kMaxGridCells = 11264;   // 220 KB of shared memory
constexpr int kMaxSide = 32767;        // so dx^2 + dy^2 fits an int

// Ranks the candidates; see above. `count` and `slot` (the grid path's
// kept points, (y << 16) | x) live in the dynamic shared memory.
template <bool GRID>
__global__ void __launch_bounds__(32)
    detect_suppress_kernel(const float* __restrict__ scores,
                           const long long* __restrict__ idx, int k,
                           int width, int threshold, int cell, int cols,
                           int rows, int max_num, float* uv, int* num_out) {
  extern __shared__ int grid[];
  int* count = grid;
  int* slot = grid + cols * rows;
  const int lane = threadIdx.x;
  if (GRID)
    for (int c = lane; c < cols * rows; c += 32) count[c] = 0;
  __syncwarp();

  int num = 0;
  float next_score = lane < k ? scores[lane] : -INFINITY;
  int next_idx = lane < k ? (int)idx[lane] : 0;
  for (int base = 0; base < k && num < max_num; base += 32) {
    const float score = next_score;
    const int f = next_idx;
    const int ahead = base + 32 + lane;
    next_score = ahead < k ? scores[ahead] : -INFINITY;
    next_idx = ahead < k ? (int)idx[ahead] : 0;
    const bool valid = base + lane < k && score > -INFINITY;
    const int x = valid ? f % width : 0;
    const int y = valid ? f / width : 0;

    // 1. Against the points kept before this batch.
    bool blocked = false;
    if (valid && GRID) {
      const int cx = x / cell, cy = y / cell;
      for (int gy = max(cy - 1, 0); gy <= min(cy + 1, rows - 1); ++gy)
        for (int gx = max(cx - 1, 0); gx <= min(cx + 1, cols - 1); ++gx) {
          const int c = gy * cols + gx;
          const int n = count[c];
          for (int s = 0; s < n; ++s) {
            const int p = slot[c * kSlots + s];
            const int dx = (p & 0xffff) - x, dy = (p >> 16) - y;
            blocked |= dx * dx + dy * dy < threshold;
          }
        }
    } else if (valid) {
      const float2* kept_uv = reinterpret_cast<const float2*>(uv);
      for (int j = 0; j < num; ++j) {
        const float2 p = kept_uv[j];
        const int dx = (int)p.x - x, dy = (int)p.y - y;
        blocked |= dx * dx + dy * dy < threshold;
      }
    }

    // 2. The earlier lanes of the batch this one conflicts with.
    unsigned earlier = 0;
    for (int j = 0; j < 31; ++j) {
      const int dx = __shfl_sync(kAll, x, j) - x;
      const int dy = __shfl_sync(kAll, y, j) - y;
      if (j < lane && dx * dx + dy * dy < threshold) earlier |= 1u << j;
    }

    // 3. The batch in rank order.
    const unsigned alive = __ballot_sync(kAll, valid && !blocked);
    unsigned kept = alive;
    if (__any_sync(kAll, (earlier & alive) != 0)) {
      kept = 0;
      for (int j = 0; j < 32; ++j) {
        const unsigned mask = __shfl_sync(kAll, earlier, j);
        if ((alive >> j & 1u) && !(mask & kept)) kept |= 1u << j;
      }
    }

    // 4. The kept points, in rank order, up to max_num.
    const int take = min(__popc(kept), max_num - num);
    const int rank = __popc(kept & ((1u << lane) - 1u));
    if ((kept >> lane & 1u) && rank < take) {
      uv[2 * (num + rank)] = (float)x;
      uv[2 * (num + rank) + 1] = (float)y;
      if (GRID) {
        const int c = (y / cell) * cols + x / cell;
        const int s = atomicAdd(&count[c], 1);
        if (s < kSlots) slot[c * kSlots + s] = (y << 16) | x;  // always
      }
    }
    num += take;
    __syncwarp();
    if (__ballot_sync(kAll, valid) != kAll) break;  // the valid prefix ended
  }
  for (int j = num + lane; j < max_num; j += 32) {
    uv[2 * j] = -1.0f;
    uv[2 * j + 1] = -1.0f;
  }
  if (lane == 0) *num_out = num;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). scores [k] float32, idx [k] int64, uv [max_num, 2] float32 and
// num (one int32) live on the device; height x width is the image's size
// and `threshold` the least squared distance that is no conflict. The grid
// is `cols` x `rows` cells of side `cell` (ops/cuda_detect.py::
// grid_layout), or cols = rows = 0 for the list of kept points; a grid
// that does not cover the image, leaves a conflict outside the 3x3 cells
// or lets a cell hold more than kSlots points is refused.
int ftk_detect_suppress(const void* scores, const void* idx, int k,
                        int height, int width, int threshold, int cell,
                        int cols, int rows, int max_num, void* uv, void* num,
                        void* stream) {
  if (k < 1 || max_num < 1 || height < 1 || width < 1 ||
      height > kMaxSide || width > kMaxSide)
    return (int)cudaErrorInvalidValue;
  const long long cells = (long long)cols * rows;
  const bool grid = cols > 0 || rows > 0;
  if (grid && (cell < 1 || cells > kMaxGridCells ||
               (long long)cols * cell < width ||
               (long long)rows * cell < height ||
               (long long)cell * cell < threshold ||
               (cell > 1 && (long long)(cell - 1) * (cell - 1) >= threshold)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (grid) {
    const size_t smem = sizeof(int) * (size_t)cells * (1 + kSlots);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          detect_suppress_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    detect_suppress_kernel<true><<<1, 32, smem, s>>>(
        (const float*)scores, (const long long*)idx, k, width, threshold,
        cell, cols, rows, max_num, (float*)uv, (int*)num);
  } else {
    detect_suppress_kernel<false><<<1, 32, 0, s>>>(
        (const float*)scores, (const long long*)idx, k, width, threshold,
        1, 0, 0, max_num, (float*)uv, (int*)num);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

FTK_DEFINE_ERROR_STRING
