// Selection-cut compensation mask with per-block popcounts, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/filter_compact.py::filter_mask_pallas.  For (N, W) int32
// rows and a static conjunction of (col, value) equalities:
//     mask[i]   = rows[i, 0] >= 0  and  rows[i, col] == value for every pair
//     counts[b] = sum of mask over rows [512 b, 512 b + 512)
// Rows past N count 0, as the TPU kernel's -1 padding does.
//
// Design.  One block of 512 threads per 512-row block, as the TPU grid has
// one step per 512-row tile; thread t tests row 512 b + t.  The pairs come
// as a small int32 device array (n_conds, 2), read through the read-only
// cache (every thread of the card reads the same few words).  The block's
// count is __syncthreads_count, one barrier per block; no atomics, so the
// counts are exact and deterministic.
//
// Bound.  Memory-bound: read N*W row words, write N mask words and
// ceil(N / 512) counts, N*W*4 + N*4 + ceil(N/512)*4 bytes at the H100's
// 3.35 TB/s.  A thread reads its row's columns with stride W words, so a
// warp touches 32*W contiguous words per column pass: every sector it
// loads is used across the column passes through L1.
//
// The kernel allocates nothing and does not synchronise: the caller passes
// the outputs and the stream.  The launcher returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 512;

__global__ void __launch_bounds__(kRowsPerBlock)
filter_mask_kernel(const int32_t* __restrict__ rows,
                   const int32_t* __restrict__ conds, int n_conds,
                   int32_t* __restrict__ mask, int32_t* __restrict__ counts,
                   int64_t N, int W) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x;
  int keep = 0;
  if (i < N) {
    const int32_t* row = rows + i * W;
    keep = __ldg(row) >= 0;
    for (int c = 0; c < n_conds; ++c) {
      const int32_t col = __ldg(conds + 2 * c);
      const int32_t value = __ldg(conds + 2 * c + 1);
      keep &= __ldg(row + col) == value;
    }
    mask[i] = keep;
  }
  const int total = __syncthreads_count(keep);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

}  // namespace

extern "C" int filter_mask_launch(const void* rows, const void* conds,
                                  int n_conds, void* mask, void* counts,
                                  int64_t N, int W, void* stream) {
  const dim3 grid(
      static_cast<unsigned>((N + kRowsPerBlock - 1) / kRowsPerBlock));
  filter_mask_kernel<<<grid, kRowsPerBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(conds),
      n_conds, static_cast<int32_t*>(mask), static_cast<int32_t*>(counts), N,
      W);
  return static_cast<int>(cudaGetLastError());
}
