// Scatter-append of delta rows into a padded relation buffer, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/scatter_append.py::scatter_append_pallas.  Streaming view
// maintenance appends k delta rows at the valid-row count n of a (cap, W)
// capacity-class buffer without changing its shape:
//     out[r, c] = rows[r - n, c]   if n <= r < n + k
//                 buf[r, c]        otherwise
// As in the TPU kernel, a slot r - n >= dcap inside [n, n + k) (only
// possible for k > dcap, which the wrapper refuses for host counts) reads 0.
// Two entry points:
//   - scatter_append_launch reads n and k on the device from nk = [[n, k]]
//     (int32), as the TPU kernel does: the launch needs no host value of
//     them and can be captured in a CUDA graph;
//   - scatter_append_counts_launch takes n and k by value, for a caller that
//     holds them on the host (the maintainer does, in its host mirror), so
//     no device tensor has to be built for them: building one from host ints
//     is a host-to-device copy, which synchronises the stream.
//
// Design.  The TPU kernel builds a one-hot (BR, DCAP) selection matrix
// because a TPU block cannot index its delta tile dynamically.  On Hopper a
// thread indexes directly.  The buffer is a flat run of cap*W words; the
// appended window is the words [n*W, (n+k)*W).  Each thread walks 16-byte
// vectors of the output (a grid-stride loop): a vector wholly outside the
// window is one 16-byte load of buf and one 16-byte store, a vector that
// touches the window is a plain loop over its four words, each from rows
// inside the window and from buf outside it.  The words past the last whole
// vector go one a thread.  The grid is the card's resident capacity (8
// blocks of 256 threads on each SM) or less: enough to fill 132 SMs, no
// more.  A buffer whose base is not 16-byte aligned takes the same loop one
// word at a time.  The output is a new buffer, as JAX's is: the
// maintainer's rollback snapshots share the old buffer by reference.
//
// Bound.  Memory-bound: each output word comes from one input word, of
// buf outside [n, n + k) and of rows inside it, so the function reads
// cap*W words and writes cap*W: 2*cap*W*4 bytes at the H100's 3.35 TB/s.
// An in-place append would move only k*W*8 bytes, but the rollback
// snapshots share the old buffer, so it needs copy-on-write snapshots
// first; the copy it would save is a fraction of a millisecond over a
// maintenance stream that takes seconds on the H100 (PERF.md).
//
// The kernel allocates nothing and does not synchronise: the caller passes
// the output and the stream.  The launchers return cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;   // 8 x 256 threads: a full SM

__device__ __forceinline__ int32_t word_at(const int32_t* __restrict__ buf,
                                           const int32_t* __restrict__ rows,
                                           int64_t i, int64_t lo, int64_t hi,
                                           int64_t delta_words) {
  if (i < lo || i >= hi) return __ldg(buf + i);
  return i - lo < delta_words ? __ldg(rows + (i - lo)) : 0;
}

// kVec words a step: 4 (16-byte vectors) or 1 (an unaligned buffer).
template <int kVec>
__global__ void __launch_bounds__(kThreads)
scatter_append_kernel(const int32_t* __restrict__ buf,
                      const int32_t* __restrict__ rows,
                      const int32_t* __restrict__ nk,
                      int32_t* __restrict__ out, int64_t total, int W,
                      int dcap, int64_t n, int64_t k) {
  if (nk != nullptr) {
    n = __ldg(nk);
    k = __ldg(nk + 1);
  }
  const int64_t lo = n * W;
  const int64_t hi = (n + k) * W;
  const int64_t delta_words = static_cast<int64_t>(dcap) * W;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t vectors = total / kVec;
  for (int64_t v = first; v < vectors; v += step) {
    const int64_t i = v * kVec;
    if (kVec == 4 && (i + 4 <= lo || i >= hi)) {
      reinterpret_cast<int4*>(out)[v] =
          __ldg(reinterpret_cast<const int4*>(buf) + v);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        out[i + j] = word_at(buf, rows, i + j, lo, hi, delta_words);
    }
  }
  const int64_t tail = vectors * kVec + first;
  if (tail < total) out[tail] = word_at(buf, rows, tail, lo, hi, delta_words);
}

// Streaming multiprocessors of `device`, asked once.
int sm_count(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) device = 0;
  if (cached[device] == 0)
    cudaDeviceGetAttribute(&cached[device], cudaDevAttrMultiProcessorCount,
                           device);
  return cached[device] > 0 ? cached[device] : 1;
}

int launch(const void* buf, const void* rows, const void* nk, void* out,
           int64_t cap, int W, int dcap, int64_t n, int64_t k, int device,
           void* stream) {
  const int64_t total = cap * W;
  const bool vec = ((reinterpret_cast<uintptr_t>(buf) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int64_t steps = vec ? total / 4 : total;
  const int64_t needed = (steps > 0 ? steps : 1) + kThreads - 1;
  const int64_t resident = static_cast<int64_t>(sm_count(device)) * kBlocksPerSM;
  const dim3 grid(static_cast<unsigned>(
      needed / kThreads < resident ? needed / kThreads : resident));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const int32_t*>(buf);
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* c = static_cast<const int32_t*>(nk);
  auto* o = static_cast<int32_t*>(out);
  if (vec)
    scatter_append_kernel<4><<<grid, kThreads, 0, st>>>(b, r, c, o, total, W,
                                                        dcap, n, k);
  else
    scatter_append_kernel<1><<<grid, kThreads, 0, st>>>(b, r, c, o, total, W,
                                                        dcap, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// buf and out (cap, W), rows (dcap, W), all int32 and contiguous on
// `device`; nk: the device counts [[n, k]] (int32).
extern "C" int scatter_append_launch(const void* buf, const void* rows,
                                     const void* nk, void* out, int64_t cap,
                                     int W, int dcap, int device,
                                     void* stream) {
  return launch(buf, rows, nk, out, cap, W, dcap, 0, 0, device, stream);
}

// The same, with n and k by value.
extern "C" int scatter_append_counts_launch(const void* buf, const void* rows,
                                            void* out, int64_t cap, int W,
                                            int dcap, int64_t n, int64_t k,
                                            int device, void* stream) {
  return launch(buf, rows, nullptr, out, cap, W, dcap, n, k, device, stream);
}
