// Exact multi-head attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/mha_block.py:_mha_fwd_kernel (the Pallas
// single-block MHA kernel, called from _mha_core).  Same function:
//   S = (q * scale) K^T in float32, q scaled in its own dtype first;
//   causal mask with the (Sk - Sq) diagonal offset and a key_len mask
//   (lengths arrive as float32 and compare as int32), both by setting the
//   score to the finite -1e30;
//   a full-row softmax, then O = P V.
// So a row whose keys are ALL masked softmaxes to the uniform mean of V,
// exactly as the Pallas kernel does; -inf is never used as a mask value.
//
// What bounds it on this card: at the serving slice's prefill shapes
// (transformer-base, D = 64, f32) the work is ~4 Sq Sk D FLOP per head
// against ~2 (Sq + Sk) D * 4 bytes, so it is bound by float32 arithmetic
// (67 TFLOP/s without tensor cores), not by memory.  The Pallas kernel
// kept the whole [hc, Sq, Sk] score tile in VMEM; a Hopper block has at
// most 227 KB of shared memory, and a 64 x 1024 f32 score tile alone is
// 256 KB.  So the design follows the function, not the Pallas blocks:
//   * q, k, v are read in place in the [B, S, H*D] layout through their
//     batch and row strides (no head transposes through device memory),
//     and the output is written as [B, Sq, H*D];
//   * grid = (q-row tiles of 64, heads, batch); each block keeps its 64
//     pre-scaled query rows in shared memory and streams 64-key tiles of
//     K and V through shared memory with an online softmax (running max,
//     running sum, rescaled accumulator), which equals the exact softmax
//     up to float rounding;
//   * 256 threads each hold a 4 x 4 score micro-tile and a 4 x (D/16)
//     output micro-tile in registers, on strided rows/columns so that the
//     shared-memory reads are conflict-free;
//   * key tiles wholly past the causal diagonal or past key_len are never
//     loaded when every row of the block still has a live key (their
//     -1e30 scores would add exactly 0); a block whose key_len is 0 visits
//     every key, so its rows come out as the uniform mean of V.
// Simple and right first: no tensor cores, no TMA, no pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per streamed tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kBQ * (D + 1) + kBK * (D + 1) + kBK * D +
                                  kBQ * (kBK + 1) + 2 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out,
               const float* __restrict__ key_len, int Sq, int Sk, int H,
               long long q_bs, long long q_rs, long long k_bs, long long k_rs,
               long long v_bs, long long v_rs, float scale, int causal) {
  constexpr int DP = D + 1;     // padded row stride of the Q and K tiles
  constexpr int BKP = kBK + 1;  // padded row stride of the score tile
  constexpr int DC = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                // [kBQ][DP]  pre-scaled queries
  float* Ks = Qs + kBQ * DP;       // [kBK][DP]
  float* Vs = Ks + kBK * DP;       // [kBK][D]
  float* Ps = Vs + kBK * D;        // [kBQ][BKP] scores, then probabilities
  float* row_alpha = Ps + kBQ * BKP;  // [kBQ] rescale factor of this tile
  float* row_l = row_alpha + kBQ;     // [kBQ] final softmax denominators

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Sk - Sq;
  const bool masked = key_len != nullptr;
  const int kl = masked ? (int)key_len[b] : Sk;  // f32 -> int32, as astype

  // Keys this block must visit.  With a live key in every row (always true
  // under causal, since Sq <= Sk keeps key 0 on every row's diagonal side),
  // masked keys contribute exp(-1e30 - m) == 0 and can be skipped.  With
  // key_len <= 0 every key is masked and all of them enter the softmax.
  int kend = Sk;
  if (!masked || kl > 0) {
    if (masked) kend = min(kend, kl);
    if (causal) kend = min(kend, min(q0 + kBQ, Sq) + off);
  }

  const T* qp = q + b * q_bs + (long long)h * D;
  const T* kp = k + b * k_bs + (long long)h * D;
  const T* vp = v + b * v_bs + (long long)h * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, row = q0 + r;
    float x = 0.f;
    if (row < Sq) x = to_f(from_f<T>(to_f(qp[row * q_rs + c]) * scale));
    Qs[r * DP + c] = x;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  // running softmax state of row tid / 4, held by its 4 threads
  float m_run = -INFINITY, l_run = 0.f;
  const int srow = tid / 4, spart = tid % 4;

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D, key = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (key < kend) {
        kx = to_f(kp[key * k_rs + c]);
        vx = to_f(vp[key * v_rs + c]);
      }
      Ks[r * DP + c] = kx;
      Vs[r * D + c] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float x = s[i][j];
        if (key >= kend) {
          x = -INFINITY;  // not visited: outside this softmax entirely
        } else {
          if (causal && key > row + off) x = kMasked;
          if (masked && key >= kl) x = kMasked;
        }
        Ps[(ty + 16 * i) * BKP + tx + 16 * j] = x;
      }
    }
    __syncthreads();

    {
      float* prow = Ps + srow * BKP + spart * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // finite: the first tile holds key 0 < kend, later tiles keep m_run
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(prow[c] - m_new);
        prow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (spart == 0) row_alpha[srow] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * BKP + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (spart == 0) row_l[srow] = l_run;
  __syncthreads();
  const long long hd = (long long)H * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float inv = 1.f / row_l[ty + 16 * i];
    T* op = out + ((long long)b * Sq + row) * hd + (long long)h * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) op[tx + 16 * j] = from_f<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const float* key_len, int B, int Sq, int Sk, int H,
                   long long q_bs, long long q_rs, long long k_bs,
                   long long k_rs, long long v_bs, long long v_rs,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      mha_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  mha_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), key_len, Sq, Sk, H,
      q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* out, const float* key_len, int B, int Sq, int Sk,
                       int H, long long q_bs, long long q_rs, long long k_bs,
                       long long k_rs, long long v_bs, long long v_rs,
                       float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, out, key_len, B, Sq, Sk, H, q_bs, q_rs,
                           k_bs, k_rs, v_bs, v_rs, scale, causal, s);
    case 128:
      return launch<T, 128>(q, k, v, out, key_len, B, Sq, Sk, H, q_bs, q_rs,
                            k_bs, k_rs, v_bs, v_rs, scale, causal, s);
    case 192:
      return launch<T, 192>(q, k, v, out, key_len, B, Sq, Sk, H, q_bs, q_rs,
                            k_bs, k_rs, v_bs, v_rs, scale, causal, s);
    case 256:
      return launch<T, 256>(q, k, v, out, key_len, B, Sq, Sk, H, q_bs, q_rs,
                            k_bs, k_rs, v_bs, v_rs, scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, Sq, H*D], k/v [B, Sk, H*D] (last dim contiguous, batch and row
// strides in elements), out [B, Sq, H*D] contiguous, key_len [B] float32
// or NULL.  dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int mha_block_fwd(const void* q, const void* k, const void* v,
                             void* out, const float* key_len, int B, int Sq,
                             int Sk, int H, int D, long long q_bs,
                             long long q_rs, long long k_bs, long long k_rs,
                             long long v_bs, long long v_rs, float scale,
                             int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(D, q, k, v, out, key_len, B, Sq, Sk, H,
                                  q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale,
                                  causal, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(D, q, k, v, out, key_len, B, Sq,
                                          Sk, H, q_bs, q_rs, k_bs, k_rs,
                                          v_bs, v_rs, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
