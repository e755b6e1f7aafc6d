// Scatter-append of delta rows into a padded relation buffer, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/scatter_append.py::scatter_append_pallas.  Streaming view
// maintenance appends k delta rows at the valid-row count n of a (cap, W)
// capacity-class buffer without changing its shape:
//     out[r, c] = rows[r - n, c]   if n <= r < n + k
//                 buf[r, c]        otherwise
// n and k are device data, nk = [[n, k]] (int32), read inside the kernel:
// the launch needs no host read and stays capturable in a CUDA graph.  As
// in the TPU kernel, a slot r - n >= dcap inside [n, n + k) (only possible
// for k > dcap, which the wrapper refuses for host counts) reads 0.
//
// Design.  The TPU kernel builds a one-hot (BR, DCAP) selection matrix
// because a TPU block cannot index its delta tile dynamically.  On Hopper a
// thread indexes directly: one thread per output element (r, c), a
// coalesced read of buf (or of rows inside the appended window) and a
// coalesced write of out.  The output is a new buffer, as JAX's is: the
// maintainer's rollback snapshots share the old buffer by reference.
//
// Bound.  Memory-bound: each output word comes from one input word, of
// buf outside [n, n + k) and of rows inside it, so the function reads
// cap*W words and writes cap*W: 2*cap*W*4 bytes at the H100's 3.35 TB/s.
// An in-place append would move only k*W*8 bytes; it needs copy-on-write
// snapshots first and is left for later.
//
// The kernel allocates nothing and does not synchronise: the caller passes
// the output and the stream.  The launcher returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
scatter_append_kernel(const int32_t* __restrict__ buf,
                      const int32_t* __restrict__ rows,
                      const int32_t* __restrict__ nk,
                      int32_t* __restrict__ out, int64_t total, int W,
                      int dcap) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int64_t n = __ldg(nk);
  const int64_t k = __ldg(nk + 1);
  const int64_t r = i / W;
  const int64_t slot = r - n;
  int32_t v;
  if (slot >= 0 && slot < k) {
    v = slot < dcap ? __ldg(rows + slot * W + (i - r * W)) : 0;
  } else {
    v = __ldg(buf + i);
  }
  out[i] = v;
}

}  // namespace

extern "C" int scatter_append_launch(const void* buf, const void* rows,
                                     const void* nk, void* out, int64_t cap,
                                     int W, int dcap, void* stream) {
  const int64_t total = cap * W;
  const dim3 grid(static_cast<unsigned>((total + kThreads - 1) / kThreads));
  scatter_append_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(buf), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(nk), static_cast<int32_t*>(out), total, W,
      dcap);
  return static_cast<int>(cudaGetLastError());
}
