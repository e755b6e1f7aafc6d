// Causal flash-attention forward (GQA, optional sliding window) for Hopper
// (sm_90a), in two designs chosen by the caller from (dtype, hd):
//   tensor_core  bf16 at hd 64, 128 and 256: TMA-fed bf16 tiles and wgmma,
//                in flash_attn_wgmma.cuh (the LM prefill's path);
//   cuda_core    every instantiation below: fp32 at hd 16..256 and bf16 at
//                hd 16 and 32 (and bf16 at 64..256, launched only to time
//                the earlier design beside the new one).
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attn.py::flash_attention_pallas.  For q (B,S,H,hd) and
// k, v (B,S,Hkv,hd), all contiguous and of one type (fp32 or bf16):
//     o[b,s,h] = sum_t softmax_t(q[b,s,h] . k[b,t,h/G] * scale) v[b,t,h/G]
// with G = H / Hkv, scale = 1/sqrt(hd), over the keys t <= s and, when
// window > 0, t > s - window.  The output has q's type.  Scores, the running
// max m, the running sum l and the output accumulator are fp32; the scale is
// applied to each fp32 score after the product, as the Pallas kernel does
// (the XLA chunked path scales q first; both agree within the tolerances).
// The result is acc / max(l, 1e-30), as there.
//
// The CUDA-core design.  The TPU kernel walks a sequential (query block, key
// block) grid and carries (o, m, l) in VMEM across it.  Here one thread
// block owns one 64-row query tile of one (batch, head) and walks the key
// tiles itself, so nothing carries across blocks.  It reads (B,S,H,hd)
// through strides, with no transpose copy.  Q is staged once in shared
// memory as fp32; each K and V tile is staged per step.  256 threads form a
// 16 x 16 grid: thread (ty, tx) owns query rows 4ty..4ty+3, keys tx + 16j of
// the tile and output dims tx + 16j, so its scores and its accumulator
// (4 x hd/16 fp32) stay in registers, and the row max and sum are reduced
// over the 16 lanes of a half-warp by shuffles.  Key tiles wholly outside
// (s - window, s] for every row of the query tile are skipped, so a
// sliding-window layer costs its window, not the sequence; inside a visited
// tile a masked key gets p = 0 (not exp(-1e30 - m)), so a row whose first
// tiles are all masked carries nothing from them.  The tail tile is masked,
// so any S >= 1 works.  Query tiles are issued longest first (the last tile
// sees the most keys).
//
// Bound.  The forward must read q, k, v and write o once, and do 4*hd flops
// per unmasked (query, key) pair per head (the two products).  At the
// serving path's shape (B=4, S=2048, H=16, Hkv=8, hd=256, bf16) that is
// 201 MB (0.060 ms at 3.35 TB/s) against 1.375e11 flops for a global layer
// (0.139 ms at the 989.4 TFLOP/s dense bf16 tensor-core peak), so the
// kernel is compute-bound.  The CUDA-core design does its products in fp32
// from shared memory and sits far from that bound; the tensor-core design
// runs them on wgmma (with P split into two bf16 halves, 1.5x the flops).
//
// Neither design allocates or synchronises: the caller passes the output
// and the stream.  The launcher returns cudaGetLastError().
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_attn_wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per block
constexpr int kRows = kBQ / 16;  // query rows per thread
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Key tile rows: 64, or 32 at hd = 256 so that Q, K, V and P fit the 227 KB
// a block may hold.
template <int HD> struct Tile {
  static constexpr int kBK = HD >= 256 ? 32 : 64;
  static constexpr int kKeys = kBK / 16;  // keys per thread
  static constexpr int kDims = HD / 16;   // output dims per thread
  static constexpr int kQ = HD + 1;       // padded row strides (floats)
  static constexpr int kK = HD + 1;
  static constexpr int kV = HD;
  static constexpr int kP = kBK + 1;
  static constexpr int kSmemFloats = kBQ * kQ + kBK * kK + kBK * kV + kBQ * kP;
  static constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;
};

// Max over the 16 lanes of a half-warp that share one query row group.
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int S, int H,
                  int Hkv, int window, float scale_log2) {
  using TL = Tile<HD>;
  constexpr int BK = TL::kBK;
  extern __shared__ float smem[];
  float* qs = smem;                    // [kBQ][kQ]
  float* ks = qs + kBQ * TL::kQ;       // [BK][kK]
  float* vs = ks + BK * TL::kK;        // [BK][kV]
  float* ps = vs + BK * TL::kV;        // [kBQ][kP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest tiles first
  const int64_t q_row = static_cast<int64_t>(H) * HD;      // stride of s in q
  const int64_t kv_row = static_cast<int64_t>(Hkv) * HD;   // ... in k and v
  const T* qb = q + static_cast<int64_t>(b) * S * q_row + h * HD;
  const T* kb = k + static_cast<int64_t>(b) * S * kv_row + hk * HD;
  const T* vb = v + static_cast<int64_t>(b) * S * kv_row + hk * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int s = q0 + r;
    qs[r * TL::kQ + d] = s < S ? to_float(qb[s * q_row + d]) : 0.f;
  }

  float acc[kRows][TL::kDims];
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < TL::kDims; ++c) acc[r][c] = 0.f;
  }

  // Keys any row of this tile can see: [k_lo, k_hi).
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_hi = q_last + 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < BK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int t = k0 + r;
      const bool in = t < S;
      ks[r * TL::kK + d] = in ? to_float(kb[t * kv_row + d]) : 0.f;
      vs[r * TL::kV + d] = in ? to_float(vb[t * kv_row + d]) : 0.f;
    }
    __syncthreads();

    float sc[kRows][TL::kKeys];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < TL::kKeys; ++j) sc[r][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[TL::kKeys];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = qs[(ty * kRows + r) * TL::kQ + d];
#pragma unroll
      for (int j = 0; j < TL::kKeys; ++j) kv[j] = ks[(tx + 16 * j) * TL::kK + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < TL::kKeys; ++j) sc[r][j] = fmaf(qv[r], kv[j], sc[r][j]);
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int s = q0 + ty * kRows + r;
      bool valid[TL::kKeys];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < TL::kKeys; ++j) {
        const int t = k0 + tx + 16 * j;
        valid[j] = t <= s && t < S && (window <= 0 || t > s - window);
        sc[r][j] = valid[j] ? sc[r][j] * scale_log2 : kNegInf;  // log2 units
        row_max = fmaxf(row_max, sc[r][j]);
      }
      const float m_new = fmaxf(m[r], half_warp_max(row_max));
      const float alpha = exp2f(m[r] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < TL::kKeys; ++j) {
        const float p = valid[j] ? exp2f(sc[r][j] - m_new) : 0.f;
        row_sum += p;
        ps[(ty * kRows + r) * TL::kP + tx + 16 * j] = p;
      }
      l[r] = l[r] * alpha + half_warp_sum(row_sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < TL::kDims; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < BK; ++t) {
      float pv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pv[r] = ps[(ty * kRows + r) * TL::kP + t];
#pragma unroll
      for (int c = 0; c < TL::kDims; ++c) {
        const float vv = vs[t * TL::kV + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(pv[r], vv, acc[r][c]);
      }
    }
  }

  T* ob = o + static_cast<int64_t>(b) * S * q_row + h * HD;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = q0 + ty * kRows + r;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < TL::kDims; ++c)
      ob[s * q_row + tx + 16 * c] = from_float<T>(acc[r][c] * inv);
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int Hkv, int window, cudaStream_t stream) {
  constexpr size_t smem = Tile<HD>::kSmemBytes;
  auto kernel = flash_attn_kernel<HD, T>;
  // Once per instantiation, on the first launch (before any graph capture);
  // the port drives one card per process.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(HD));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, Hkv, window,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int Hkv, int hd, int window, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16, T>(q, k, v, o, B, S, H, Hkv, window, stream);
    case 32: return launch<32, T>(q, k, v, o, B, S, H, Hkv, window, stream);
    case 64: return launch<64, T>(q, k, v, o, B, S, H, Hkv, window, stream);
    case 128: return launch<128, T>(q, k, v, o, B, S, H, Hkv, window, stream);
    case 256: return launch<256, T>(q, k, v, o, B, S, H, Hkv, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool SPLIT>
int dispatch_tc(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int Hkv, int hd, int window, cudaStream_t st) {
  switch (hd) {
    case 64: return fa_tc::launch<64, SPLIT>(q, k, v, o, B, S, H, Hkv, window, st);
    case 128: return fa_tc::launch<128, SPLIT>(q, k, v, o, B, S, H, Hkv, window, st);
    case 256: return fa_tc::launch<256, SPLIT>(q, k, v, o, B, S, H, Hkv, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  design: 0 =
// cuda_core, 1 = tensor_core (bf16 only; split_p != 0 issues P V as the two
// bf16 halves of P, 0 as one bf16 product).  The caller picks the design;
// a pair this source has no instantiation for is refused, never redirected.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, int B, int S, int H, int Hkv, int hd,
                                 int window, int dtype, int design,
                                 int split_p, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == 1) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    return split_p ? dispatch_tc<true>(q, k, v, o, B, S, H, Hkv, hd, window, st)
                   : dispatch_tc<false>(q, k, v, o, B, S, H, Hkv, hd, window, st);
  }
  if (design != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, S, H, Hkv, hd, window, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, hd, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
