// Sorted-join probe (lower bound + match count) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/join_count.py::join_count_pallas.
// For each probe key l of member b:
//     lo[b, i]    = #{s in build[b] : s <  l}
//     count[b, i] = #{s in build[b] : s == l}
// against the member's ascending build row.  Probes of invalid rows are -1
// and give lo = 0, count = 0 (build keys are >= 0); the build row is padded
// with SENTINEL_HI = 2^31 - 1, which is never less than a valid key.
//
// Design.  The TPU kernel streams an O(L*S) compare matrix because branchy
// search is hostile to the TPU's vector unit.  On Hopper a thread does the
// search: one thread per probe, two branchless binary searches (lower and
// upper bound) over its member's build row.  The trip count depends only on
// S, so a warp never diverges.  A leading member axis lets one launch serve a
// whole join bucket: grid (ceil(L / 256), B).
//
// Bound.  The kernel is memory-bound: it must read B*L probes and B*S build
// keys and write B*L lo and B*L counts, B*(12*L + 4*S) bytes, at the H100's
// 3.35 TB/s.  The log2(S) dependent loads of each search hit the 50 MB L2
// (the upper levels of the search tree are shared by every thread).  Staging
// those levels in shared memory, or a merge-path design, is left for later.
//
// The kernel allocates nothing and does not synchronise: the caller passes
// the outputs and the stream.  The launcher returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// First index i in [0, n] with s[i] >= key (kUpper: s[i] > key).
template <bool kUpper>
__device__ __forceinline__ int search(const int32_t* __restrict__ s, int n,
                                      int32_t key) {
  if (n == 0) return 0;
  int base = 0;
  int len = n;
  while (len > 1) {
    const int half = len >> 1;
    const int32_t v = __ldg(s + base + half);
    const bool right = kUpper ? (v <= key) : (v < key);
    base = right ? base + half : base;
    len -= half;
  }
  const int32_t v = __ldg(s + base);
  return base + (kUpper ? (v <= key) : (v < key));
}

__global__ void __launch_bounds__(kThreads)
join_count_kernel(const int32_t* __restrict__ probe,
                  const int32_t* __restrict__ build,
                  int32_t* __restrict__ lo, int32_t* __restrict__ count,
                  int L, int S) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= L) return;
  const int64_t row = blockIdx.y;
  const int32_t* s = build + row * S;
  const int64_t at = row * L + i;
  const int32_t key = __ldg(probe + at);
  const int l = search<false>(s, S, key);
  const int h = search<true>(s, S, key);
  lo[at] = l;
  count[at] = h - l;
}

}  // namespace

extern "C" int join_count_launch(const void* probe, const void* build,
                                 void* lo, void* count, int B, int L, int S,
                                 void* stream) {
  const dim3 grid((L + kThreads - 1) / kThreads, B);
  join_count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(probe), static_cast<const int32_t*>(build),
      static_cast<int32_t*>(lo), static_cast<int32_t*>(count), L, S);
  return static_cast<int>(cudaGetLastError());
}
