// Sorted-join probe (lower bound + match count) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/join_count.py::join_count_pallas.
// For each probe key l of member b:
//     lo[b, i]    = #{s in build[b] : s <  l}
//     count[b, i] = #{s in build[b] : s == l}
// against the member's ascending build row.  Probes of invalid rows are -1
// and give lo = 0, count = 0 (build keys are >= 0); the build row is padded
// with SENTINEL_HI = 2^31 - 1, which is never less than a valid key.  The
// result is exactly that of two binary searches for any key and any
// ascending row.
//
// Design.  The TPU kernel streams an O(L*S) compare matrix because branchy
// search is hostile to the TPU's vector unit.  On Hopper a thread searches,
// and what costs is its global loads: a plain binary search over S = 2^19
// keys makes 19 dependent loads per bound, and a warp's load of 32
// scattered keys costs the L1 32 sector lookups.  So the top of the search
// tree goes to shared memory and the global part shrinks to one window:
//   - Sample.  Every D-th key of the row, ranks r = 1 .. T-1 at positions
//     r*D, T = ceil(S / D) <= 32768 (`kernels/join_count.py::plan` picks D
//     from the work a block has: at most 8 staged keys a probe, or 1 where
//     a lone block gathers them).  With several blocks a member, a pre-pass
//     writes the sample contiguously once (B*T words of the caller's
//     scratch) and each block copies it as 16-byte loads; a lone block
//     reads every D-th key of the row itself.  Shared memory holds it in
//     Eytzinger order (the perfect search tree stored level by level,
//     padded with INT32_MAX): at most 32767 keys, 128 KB, one 1024-thread
//     block an SM.
//   - Search.  Each thread descends the tree for its probe in log2(T)
//     steps: c = #samples < key, so the lower bound lies in the window
//     [c*D, c*D + D) of the row.  One pass over the window counts its keys
//     < key and <= key: a window of 4 to 16 keys as 16-byte loads all in
//     flight (one to four sector lookups), a wider one by two binary
//     searches in step, so their loads are independent.  lo = c*D +
//     #(< key); the upper bound is c*D + #(<= key) unless sample c+1
//     equals the key, i.e. the run of equal keys reaches the next window;
//     only then a second descent (samples <= key) and a second window.
//   - Launch.  The grid fills the card once, or covers L, and each thread
//     loops over probes, so a block's staging serves all of its probes.
//
// Bound.  Memory: the kernel must read B*L probes and B*S build keys and
// write B*L lo and B*L counts, B*(12*L + 4*S) bytes, at the H100's
// 3.35 TB/s.  What it moves beyond that: the pre-pass reads B*T sectors
// and writes B*T words, each block reads its T-key sample, and each probe
// reads one window of D keys (64 bytes at S = 2^19, where D = 16) in place
// of 38 dependent 4-byte loads.  Left on the table: the descent, whose
// shared-memory loads collide in banks when a warp's probes visit the
// nodes of a level at random.
//
// The kernel allocates nothing and does not synchronise: the caller passes
// the outputs, the scratch and the stream.  The launcher returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape it refuses.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kBlocksPerSM = 1;       // 1024 threads and 128 KB: one SM
constexpr int kMaxSamples = 32768;    // T: ranks 1 .. T-1 fill 32767 nodes
constexpr int kPrepassThreads = 256;

// How many keys of the window s[0 .. n) are < key (lt) and <= key (le).
// kVec: s is 16-byte aligned, and the window is read as 16-byte vectors,
// all in flight at once; else two binary searches in step (ceil(log2 n)
// rounds of two independent loads).
template <bool kVec>
__device__ __forceinline__ void window_counts(const int32_t* __restrict__ s,
                                              int n, int32_t key, int& lt,
                                              int& le) {
  lt = 0;
  le = 0;
  if (kVec) {
    const int4* v = reinterpret_cast<const int4*>(s);
#pragma unroll 4
    for (int q = 0; q < (n >> 2); ++q) {
      const int4 x = __ldg(v + q);
      lt += (x.x < key) + (x.y < key) + (x.z < key) + (x.w < key);
      le += (x.x <= key) + (x.y <= key) + (x.z <= key) + (x.w <= key);
    }
    for (int e = n & ~3; e < n; ++e) {
      const int32_t x = __ldg(s + e);
      lt += x < key;
      le += x <= key;
    }
  } else if (n > 0) {
    int len = n;
    while (len > 1) {
      const int half = len >> 1;
      lt = __ldg(s + lt + half) < key ? lt + half : lt;
      le = __ldg(s + le + half) <= key ? le + half : le;
      len -= half;
    }
    lt += __ldg(s + lt) < key;
    le += __ldg(s + le) <= key;
  }
}

// Where the perfect search tree of `depth` levels, stored level by level,
// keeps its node of in-order rank r (1-based): level depth-1-ctz(r),
// position r >> (ctz(r) + 1) of that level.
__device__ __forceinline__ int node(int r, int depth) {
  const int z = __ffs(r) - 1;
  return (1 << (depth - 1 - z)) + (r >> (z + 1)) - 1;
}

// sample[b, r] = build[b, r * stride] for r in [0, T).
__global__ void __launch_bounds__(kPrepassThreads)
sample_kernel(const int32_t* __restrict__ build, int32_t* __restrict__ sample,
              int S, int log_stride, int T) {
  const int r = blockIdx.x * kPrepassThreads + threadIdx.x;
  if (r >= T) return;
  const int64_t b = blockIdx.y;
  sample[b * T + r] =
      __ldg(build + b * S + (static_cast<int64_t>(r) << log_stride));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
join_count_kernel(const int32_t* __restrict__ probe,
                  const int32_t* __restrict__ build,
                  const int32_t* __restrict__ sample,
                  int32_t* __restrict__ lo, int32_t* __restrict__ count,
                  int L, int S, int log_stride, int T, int depth) {
  extern __shared__ int32_t tree[];   // (1 << depth) - 1 nodes, Eytzinger
  const int64_t b = blockIdx.y;
  const int32_t* s = build + b * S;
  // sample rank r: the pre-pass's sample[b, r], or the row's key r*D read
  // here when there is no pre-pass
  const int32_t* src = sample != nullptr ? sample + b * T : s;
  const int src_log = sample != nullptr ? 0 : log_stride;
  const int nodes = (1 << depth) - 1;
  // ranks 4q .. 4q+3 as one 16-byte load where they are contiguous,
  // aligned and all below T; rank 0 is not a node
  const bool stage_vec =
      src_log == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
#pragma unroll 4
  for (int q = threadIdx.x; 4 * q <= nodes; q += kThreads) {
    int32_t x[4];
    if (stage_vec && 4 * q + 3 < T) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(src) + q);
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[j] = 4 * q + j < T
                   ? __ldg(src + (static_cast<int64_t>(4 * q + j) << src_log))
                   : INT_MAX;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * q + j;
      if (r >= 1 && r <= nodes) tree[node(r, depth)] = x[j];
    }
  }
  __syncthreads();

  const int D = 1 << log_stride;
  const int32_t* p = probe + b * L;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < L;
       i += gridDim.x * kThreads) {
    const int32_t key = __ldg(p + i);
    // c = #samples < key
    int k = 1;
    for (int d = 0; d < depth; ++d) k = 2 * k + (tree[k - 1] < key);
    const int c = k - (1 << depth);
    const int w0 = c << log_stride;
    int lt, le;
    window_counts<kVec>(s + w0, min(D, S - w0), key, lt, le);
    const int l = w0 + lt;
    int h = w0 + le;
    if (c + 1 < T && tree[node(c + 1, depth)] == key) {
      // the run of equal keys reaches the next sample: the upper bound lies
      // in the window of the last sample <= key
      k = 1;
      for (int d = 0; d < depth; ++d) k = 2 * k + (tree[k - 1] <= key);
      const int w1 = min(k - (1 << depth), T - 1) << log_stride;
      window_counts<kVec>(s + w1, min(D, S - w1), key, lt, le);
      h = w1 + le;
    }
    lo[b * L + i] = l;
    count[b * L + i] = h - l;
  }
}

// Raise the kernel's shared-memory limit on `device`, once.
void prepare_device(int device) {
  static bool done[64] = {false};
  if (device < 0 || device >= 64 || done[device]) return;
  const int smem = static_cast<int>(sizeof(int32_t)) * (kMaxSamples - 1);
  cudaFuncSetAttribute(join_count_kernel<true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(join_count_kernel<false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  done[device] = true;
}

}  // namespace

// A launch's shape, as `kernels/join_count.py::plan` chose it: stride is D,
// a power of two with ceil(S / D) <= 32768; blocks, the blocks a member.
// Passed by pointer, so the launch call carries one argument for all six.
struct JoinShape {
  int B, L, S, stride, blocks, device;
};

// probe (B, L), build (B, S), lo and count (B, L), all int32 and
// contiguous on the shape's device; scratch: B * ceil(S / D) int32 for the
// pre-pass, or null to have each block read every D-th key of its row
// itself.
extern "C" int join_count_launch(const void* probe, const void* build,
                                 void* scratch, void* lo, void* count,
                                 const JoinShape* shape, void* stream) {
  const int B = shape->B, L = shape->L, S = shape->S;
  const int stride = shape->stride, blocks = shape->blocks;
  const int device = shape->device;
  if (stride < 1 || (stride & (stride - 1)) != 0 || blocks < 1)
    return cudaErrorInvalidValue;
  const int log_stride = __builtin_ctz(static_cast<unsigned>(stride));
  const int T = static_cast<int>((static_cast<int64_t>(S) + stride - 1) / stride);
  if (T > kMaxSamples) return cudaErrorInvalidValue;
  prepare_device(device);
  int depth = 0;
  while ((1 << depth) - 1 < T - 1) ++depth;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* sample = nullptr;
  if (stride > 1 && scratch != nullptr) {
    const dim3 grid((T + kPrepassThreads - 1) / kPrepassThreads, B);
    sample_kernel<<<grid, kPrepassThreads, 0, st>>>(
        static_cast<const int32_t*>(build), static_cast<int32_t*>(scratch), S,
        log_stride, T);
    sample = static_cast<const int32_t*>(scratch);
  }
  const dim3 grid(blocks, B);
  const size_t smem = sizeof(int32_t) * ((1u << depth) - 1);
  // windows of 4 to 16 keys are read as 16-byte vectors when every row
  // starts 16-byte aligned; others by binary search
  const bool vec = stride >= 4 && stride <= 16 && S % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(build) % 16 == 0;
  const auto* pr = static_cast<const int32_t*>(probe);
  const auto* bu = static_cast<const int32_t*>(build);
  auto* l = static_cast<int32_t*>(lo);
  auto* c = static_cast<int32_t*>(count);
  if (vec)
    join_count_kernel<true><<<grid, kThreads, smem, st>>>(
        pr, bu, sample, l, c, L, S, log_stride, T, depth);
  else
    join_count_kernel<false><<<grid, kThreads, smem, st>>>(
        pr, bu, sample, l, c, L, S, log_stride, T, depth);
  return static_cast<int>(cudaGetLastError());
}
