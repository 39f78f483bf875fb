// Warp-level tensor-core helpers for the bf16 kernels (sm_90a): the
// forward body of flash_fwd_mma.cuh (#3 and mha_block's #1), the backward
// bodies of flash_bwd_mma.cuh (#4, #5 and mha_block's #2) and
// bn_relu_conv1x1.cu (#8).  Each is one PTX instruction, so a fragment
// layout can be checked one product at a time.
//
// mma.m16n8k16 (bf16 in, float32 accumulate), per lane with g = lane / 4
// and t = lane % 4:
//   A (16 x 16, row-major), four 32-bit registers of two bf16 each:
//     a0 = (row g,     cols 2t, 2t+1)   a1 = (row g + 8, cols 2t, 2t+1)
//     a2 = (row g,     cols 2t+8, +9)   a3 = (row g + 8, cols 2t+8, +9)
//   B (16 x 8), two registers:  b0 = (k 2t, 2t+1; n g)  b1 = (k 2t+8, +9; n g)
//   C (16 x 8 float32):  c0, c1 = (row g, cols 2t, 2t+1)
//                        c2, c3 = (row g + 8, cols 2t, 2t+1)
// So the accumulators of two adjacent n-tiles, rounded to bf16 and packed
// in pairs, are the A fragment of the next product with k = those 16
// columns: (c0, c1) of tile 0 -> a0, (c2, c3) -> a1, tile 1's -> a2, a3.
//
// ldmatrix.x4 loads four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i of a lane receives matrix i's
// (row g, cols 2t, 2t+1), or with .trans its (rows 2t, 2t+1; col g).
//
// Shared tiles are [rows][D + 8] bf16: the 16 bytes of padding put the 8
// row addresses of one ldmatrix (and a warp's 16-byte cp.async writes) on
// 8 distinct bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_mma {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until cp_async_wait; with
// in_bounds false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in_bounds) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in_bounds ? 16 : 0)
               : "memory");
}

// 8 bytes global -> shared, zero-filled when in_bounds is false
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool in_bounds) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in_bounds ? 8 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when in_bounds is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in_bounds) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in_bounds ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c (16 x 8) += a (16 x 16) b (16 x 8)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k-step kk from accumulators c[2 kk], c[2 kk + 1]
// (16 x 8 each), rounded to bf16
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[N][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Shared-tile addresses of one lane for an ldmatrix.x4 on a [rows][stride]
// bf16 tile, at (row0, col0):
//   a_frag: the A fragment of rows row0..+15, cols col0..+15;
//   b_pair: the B fragments of n-tiles row0..+7 and row0+8..+15 (rows of
//     the tile are n, cols are k = col0..+15): registers (b0, b1) of the
//     first n-tile, then of the second;
//   bt_pair (with .trans): the B fragments of n-tiles col0..+7 and
//     col0+8..+15 (rows of the tile are k = row0..+15, cols are n).
__device__ __forceinline__ const bf16* a_frag(const bf16* tile, int stride,
                                              int row0, int col0, int lane) {
  return tile + (row0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * stride + col0 +
         8 * (lane >> 4);
}

__device__ __forceinline__ const bf16* b_pair(const bf16* tile, int stride,
                                              int row0, int col0, int lane) {
  return tile + (row0 + (lane & 7) + 8 * (lane >> 4)) * stride + col0 +
         8 * ((lane >> 3) & 1);
}

__device__ __forceinline__ const bf16* bt_pair(const bf16* tile, int stride,
                                               int row0, int col0, int lane) {
  return a_frag(tile, stride, row0, col0, lane);
}

// x (8 bf16) scaled by s in float32 and rounded back to bf16 in place
__device__ __forceinline__ void scale8(uint4& x, float s) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    h[i] = __floats2bfloat162_rn(f.x * s, f.y * s);
  }
}

// The keys image b's rows see in the attention bodies: [0, kl), and under
// causal only those at or left of the (Sk - Sq)-offset diagonal; kv_len
// arrives as float32 and compares as int32, clamped to [0, Sk].  uniform
// (mha_block mode, key_len <= 0): every score is mha_block's finite -1e30,
// so every key is live with equal scores, those right of the causal
// diagonal too; it is visited with every score taken as 0, causal off.
struct Live {
  int kl;
  bool causal;
  bool uniform;
};

template <bool kMha>
__device__ __forceinline__ Live live_keys(const float* kv_len, int Sk,
                                          int causal, int b) {
  Live r{Sk, causal != 0, false};
  if (kv_len != nullptr) {
    const int n = (int)kv_len[b];  // f32 -> int32, as astype
    if (kMha && n <= 0) {
      r.causal = false;
      r.uniform = true;
    } else {
      r.kl = max(0, min(Sk, n));
    }
  }
  return r;
}

__host__ __device__ inline bool aligned16(const void* p, long long stride0,
                                          long long stride1) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && stride0 % 8 == 0 &&
         stride1 % 8 == 0;
}

}  // namespace flash_mma
