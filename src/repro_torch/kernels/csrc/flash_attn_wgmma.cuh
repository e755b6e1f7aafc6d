// Causal flash-attention forward on Hopper's tensor cores: bf16 tiles fed by
// TMA, products by wgmma.  Included by flash_attn.cu, which launches it for
// bf16 at hd 64, 128 and 256 (the "tensor_core" design); fp32 and the small
// head widths keep the CUDA-core kernel there.
//
// It computes exactly what that kernel computes: o[b,s,h] = softmax over the
// keys t <= s (and t > s - window when window > 0) of q.k * scale, times v,
// with GQA through h / (H / Hkv), (B,S,H,hd) read through 2-D tensor maps
// with no transpose copy, any S >= 1 (tail tiles masked), masked keys p = 0,
// the result acc / max(l, 1e-30) rounded once to bf16.
//
// Design.  One block of three warpgroups owns a 128-row query tile of one
// (batch, head).  Warpgroup 2 is the producer: one thread loads Q once and
// then K and V tiles of 64 keys into a two-stage ring of shared memory with
// cp.async.bulk.tensor, each stage completed by an mbarrier ("full") and
// released by the consumers through another ("empty").  It gives up its
// registers (setmaxnreg 40) to warpgroups 0 and 1 (232 each), the
// consumers, each of which owns 64 query rows:
//   S  = Q K^T     wgmma m64n64k16, A and B from shared memory (K-major)
//   softmax        fp32 in registers on the accumulator's fragment layout;
//                  the mask is evaluated only on the diagonal, window-edge
//                  and tail tiles, and tiles outside a warpgroup's keys are
//                  skipped (the window layers cost their window)
//   O += P V       wgmma m64n64k16 per 64 output dims, P from registers (the
//                  accumulator layout of S is wgmma's A-register layout), V
//                  from shared memory (MN-major)
// O stays in registers (hd/2 fp32 a thread) until the end.
//
// Precision.  Q K^T multiplies bf16 exactly into fp32, as the plain version
// does.  P is in [0, 1] and would lose 8 bits as one bf16 operand, more
// than the one-bf16-ulp check allows; with SPLIT the P V product is issued
// twice, on hi = bf16(p) and lo = bf16(p - hi), into the same accumulator,
// which carries 16 bits of p at 1.5x the flops of the two products.
//
// Tiles are 64 rows by 128 bytes (64 bf16 of hd), written by TMA with the
// 128-byte swizzle that the wgmma descriptors name; hd is split into hd/64
// such boxes.  Shared memory at hd 256: Q 64 KB + 2 stages x (K 32 KB +
// V 32 KB) = 192 KB, one block an SM.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fa_tc {

constexpr int kBQ = 128;          // query rows per block
constexpr int kRowsWG = 64;       // query rows per consumer warpgroup
constexpr int kBK = 64;           // keys per tile
constexpr int kStages = 2;        // K/V ring
constexpr int kConsumers = 2;     // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBox = 64;          // hd columns per TMA box: 128 bytes
constexpr int kBoxBytes = 64 * 128;  // a 64-row box
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD> struct Layout {
  static constexpr int kSub = HD / kBox;  // boxes across hd
  static constexpr int kTile = kSub * kBoxBytes;  // 64 rows of hd
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kConsumers * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;  // full[], empty[], q
  // + 1024: the base is rounded up to the swizzle's 1024-byte period
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 1) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One box of a 2-D tensor map, at (column, row), into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
      "r"(row) : "memory");
}

// wgmma shared-memory descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units).  K-major (Q, K): rows of
// 128 bytes, 8-row groups 1024 bytes apart (the stride offset); the leading
// offset is unused.  MN-major (V): 8 key rows of 128 bytes, key groups 1024
// bytes apart; a 64-dim operand is one swizzle atom wide, so the leading
// offset is unused too.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1024 >> 4) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of wgmma's registers across the
// asynchronous product.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FA_D32                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define FA_R32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64, fp32) = (scale_d ? d : 0) + A B^T, A and B K-major bf16 in
// shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_D32 : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, fp32) += A B, A (64 x 16 bf16) in registers, B (16 x 64)
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_D32 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef FA_D32
#undef FA_R32

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator fragment of m64nNk16 (fp32): thread `lane` of warp w holds
// rows 16w + lane/4 + 8i (i = 0, 1) and, in each 8-column chunk c, columns
// 8c + 2 (lane % 4) + j (j = 0, 1), in register 4c + 2i + j.  The A-register
// fragment of a 64 x 16 bf16 operand is the same map over two chunks, two
// values a register, so keys 16kk..16kk+15 of P are registers 8kk..8kk+7.
template <int HD, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     __nv_bfloat16* __restrict__ o, int S, int H, int Hkv,
                     int window, float scale_log2) {
  using L = Layout<HD>;
  constexpr int kSub = L::kSub;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base + L::kQ, k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t full = base + L::kBar;        // full[st] at full + 8 st
  const uint32_t empty = full + 8 * kStages;   // empty[st]
  const uint32_t qbar = empty + 8 * kStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest tiles first
  // key tiles any row of the block sees: [t_begin, t_end)
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_lo / kBK;
  const int t_end = (min(q0 + kBQ, S) + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 4 * kConsumers);  // one arrival a warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * kConsumers) {
      const int row0 = b * S;  // row of (b, 0) in the (B*S, heads*hd) views
      mbar_expect_tx(qbar, kBQ * HD * 2);
      for (int w = 0; w < kConsumers; ++w)
        for (int j = 0; j < kSub; ++j)
          tma_load(q_s + w * L::kTile + j * kBoxBytes, &qmap, qbar,
                   h * HD + j * kBox, row0 + q0 + w * kRowsWG);
      for (int i = 0; i < t_end - t_begin; ++i) {
        const int st = i % kStages;
        mbar_wait(empty + 8 * st, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, 2 * kBK * HD * 2);
        const int row = row0 + (t_begin + i) * kBK;
        for (int j = 0; j < kSub; ++j) {
          tma_load(k_s + st * L::kTile + j * kBoxBytes, &kmap, full + 8 * st,
                   hk * HD + j * kBox, row);
          tma_load(v_s + st * L::kTile + j * kBoxBytes, &vmap, full + 8 * st,
                   hk * HD + j * kBox, row);
        }
      }
    }
  } else {
    // ---- consumer warpgroup `wg`: query rows qw .. qw + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int qw = q0 + wg * kRowsWG;
    const int r0 = qw + 16 * warp + lane / 4;  // rows r0 and r0 + 8
    const int c0 = 2 * (lane % 4);             // columns c0, c0 + 1 of a chunk
    const int kw_lo = window > 0 ? max(0, qw - window + 1) : 0;
    const int kw_hi = min(qw + kRowsWG, S);
    const uint32_t q_wg = q_s + wg * L::kTile;

    float acc[kSub][32];
#pragma unroll
    for (int j = 0; j < kSub; ++j)
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[j][x] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's part of the row sums

    mbar_wait(qbar, 0);
    for (int i = 0; i < t_end - t_begin; ++i) {
      const int st = i % kStages;
      const int k0 = (t_begin + i) * kBK;
      mbar_wait(full + 8 * st, (i / kStages) & 1);
      if (qw < S && k0 < kw_hi && k0 + kBK > kw_lo) {
        // S = Q K^T over hd in steps of 16
        float sc[32];
#pragma unroll
        for (int x = 0; x < 32; ++x) sc[x] = 0.f;
        const uint32_t k_t = k_s + st * L::kTile;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
          wgmma_ss(sc, desc_sw128(q_wg + off), desc_sw128(k_t + off), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // scores in log2 units; the mask only where a tile crosses the
        // diagonal, the window's edge or S (uniform over the warpgroup)
#pragma unroll
        for (int x = 0; x < 32; ++x) sc[x] *= scale_log2;
        const bool edge = k0 + kBK - 1 > qw
                          || (window > 0 && k0 <= qw + kRowsWG - 1 - window);
        if (edge) {
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            const int t = k0 + 8 * (x / 4) + c0 + (x % 2);
            const int s = r0 + 8 * ((x / 2) % 2);
            if (t > s || (window > 0 && t <= s - window)) sc[x] = kNegInf;
          }
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = kNegInf;
#pragma unroll
          for (int c = 0; c < 8; ++c)
            mx = fmaxf(mx, fmaxf(sc[4 * c + 2 * r], sc[4 * c + 2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[r], mx);
          alpha[r] = exp2f(m[r] - m_new);
          m[r] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int x = 4 * c + 2 * r + j;
              sc[x] = sc[x] > kNegInf ? exp2f(sc[x] - m_new) : 0.f;  // masked: 0
              sum += sc[x];
            }
          l[r] = l[r] * alpha[r] + sum;
        }
#pragma unroll
        for (int j = 0; j < kSub; ++j)
#pragma unroll
          for (int x = 0; x < 32; ++x) acc[j][x] *= alpha[(x / 2) % 2];

        // P as A fragments: hi = bf16(p), lo = bf16(p - hi)
        uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float a = sc[8 * kk + 2 * r], c = sc[8 * kk + 2 * r + 1];
            p_hi[kk][r] = pack_bf16(a, c);
            if (SPLIT) {
              const __nv_bfloat162 hv =
                  *reinterpret_cast<const __nv_bfloat162*>(&p_hi[kk][r]);
              p_lo[kk][r] = pack_bf16(a - __low2float(hv),
                                      c - __high2float(hv));
            }
          }

        // O += P V, 64 output dims at a time
        const uint32_t v_t = v_s + st * L::kTile;
#pragma unroll
        for (int j = 0; j < kSub; ++j) fence_regs(acc[j]);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kSub; ++j)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t dv = desc_sw128(v_t + j * kBoxBytes + kk * 16 * 128);
            wgmma_rs(acc[j], p_hi[kk], dv);
            if (SPLIT) wgmma_rs(acc[j], p_lo[kk], dv);
          }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int j = 0; j < kSub; ++j) fence_regs(acc[j]);
      }
      if (lane == 0) mbar_arrive(empty + 8 * st);  // this warp is done with it
    }

    if (qw < S) {
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sum = l[r];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        inv[r] = 1.f / fmaxf(sum, 1e-30f);
      }
      const int64_t row_stride = static_cast<int64_t>(H) * HD;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = r0 + 8 * r;
        if (s >= S) continue;
        __nv_bfloat16* orow = o + (static_cast<int64_t>(b) * S + s) * row_stride
                              + h * HD + c0;
#pragma unroll
        for (int j = 0; j < kSub; ++j)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            *reinterpret_cast<__nv_bfloat162*>(orow + j * 64 + 8 * c) =
                __floats2bfloat162_rn(acc[j][4 * c + 2 * r] * inv[r],
                                      acc[j][4 * c + 2 * r + 1] * inv[r]);
      }
    }
  }
}

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// cuTensorMapEncodeTiled of the CUDA driver API, found once through the
// runtime (no link against libcuda).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (rows, cols) row-major bf16 view, read in 64 x 64 boxes with the
// 128-byte swizzle; rows past the end read as zeros.
inline bool encode_map(CUtensorMap* map, const void* ptr, int64_t rows,
                       int64_t cols) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  cuuint32_t box[2] = {kBox, 64};
  cuuint32_t elem_strides[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor maps are encoded on every call: the pointers change.
template <int HD, bool SPLIT>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int Hkv, int window, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  const int64_t rows = static_cast<int64_t>(B) * S;
  if (!encode_map(&qm, q, rows, static_cast<int64_t>(H) * HD)
      || !encode_map(&km, k, rows, static_cast<int64_t>(Hkv) * HD)
      || !encode_map(&vm, v, rows, static_cast<int64_t>(Hkv) * HD))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Layout<HD>::kBytes;
  auto kernel = flash_attn_tc_kernel<HD, SPLIT>;
  // once per instantiation, on its first launch (before any graph capture)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(HD));
  kernel<<<grid, kThreads, smem, stream>>>(qm, km, vm,
                                           static_cast<__nv_bfloat16*>(o), S,
                                           H, Hkv, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fa_tc
