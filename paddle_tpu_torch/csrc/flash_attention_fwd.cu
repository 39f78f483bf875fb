// Streaming (flash) attention forward with the row logsumexp, for Hopper
// (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:_fwd_kernel (called
// from _flash_fwd; entries flash_attention and flash_attention_lse).  Same
// function:
//   S = (q * scale) K^T in float32, q scaled in its own dtype first;
//   causal mask with the (Sk - Sq) diagonal offset, keys at or past
//   kv_len[b] masked (float32 lengths compared as int32, clamped to Sk),
//   both with the finite -1e30;
//   an online softmax over key tiles, P rounded to V's dtype before P V;
//   O = acc / l and lse = m + log(l) per row;
//   a row with no live key (kv_len 0) gives O = 0 and lse = -1e30, the
//   identity of the (O, lse) merge, not the mean of V that mha_block's
//   full-row softmax gives.
// The Pallas kernel pads Sk to its block grid and, with kv_len past Sk,
// counts the zero padding keys as live; here kv_len is clamped to Sk, as
// the composite masks it.
//
// What bounds it on this card: at BERT-base pretraining at 2048 tokens
// (batch 16, 12 heads of 64, bf16, ragged kv_len, chip_smoke.py's L2 shape)
// it does 4 D H FLOP a live (row, key) pair, 0.15 TFLOP, against ~0.2 GB
// of reads and writes: bound by bf16 tensor-core operations (989 TFLOP/s),
// not by memory.  Two kernels, chosen by dtype in the entry:
//
// bf16, flash_fwd_mma_kernel<D> (tensor cores, mma.sync m16n8k16): the
//   flash mode of the body in flash_fwd_mma.cuh, shared with mha_block's
//   bf16 forward (#1): 64 query rows a block, Q as register fragments, K
//   and V through a two-stage cp.async ring, S and P in registers, an
//   online softmax with P rounded to bf16 unnormalised, O / l and
//   lse = m + log l in the epilogue;
// float32, flash_fwd_kernel<float, D> (SIMT FMAs, kept on purpose: tensor
// cores in float32 are TF32, which would round the inputs to 10 mantissa
// bits): 256 threads each hold a 4 x 4 score micro-tile and a 4 x (D/16)
// output micro-tile (mha_block.cu's tile loop), 64 x 64 tiles through
// shared memory.  Both read q, k, v in place in the [B, S, H*D] layout
// through their batch and row strides (the bf16 kernel needs 16-byte
// aligned rows: the entry returns cudaErrorMisalignedAddress otherwise),
// write O as [B, Sq, H*D], treat ragged Sq and Sk as bounds checks, and
// end their key loop at the block's last live key.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_fwd_mma.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per streamed tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr float kMasked = -1e30f;

// flash_fwd_kernel runs float32 only (bf16 takes flash_fwd_mma_kernel)
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kBQ * (D + 1) + kBK * (D + 1) + kBK * D +
                                  kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, const float* __restrict__ kv_len,
                 int Sq, int Sk, int H, long long q_bs, long long q_rs,
                 long long k_bs, long long k_rs, long long v_bs,
                 long long v_rs, float scale, int causal) {
  constexpr int DP = D + 1;     // padded row stride of the Q and K tiles
  constexpr int BKP = kBK + 1;  // padded row stride of the score tile
  constexpr int DC = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                   // [kBQ][DP]  pre-scaled queries
  float* Ks = Qs + kBQ * DP;          // [kBK][DP]
  float* Vs = Ks + kBK * DP;          // [kBK][D]
  float* Ps = Vs + kBK * D;           // [kBQ][BKP] scores, then P in T
  float* row_alpha = Ps + kBQ * BKP;  // [kBQ] rescale factor of this tile
  float* row_l = row_alpha + kBQ;     // [kBQ] final softmax denominators
  float* row_m = row_l + kBQ;         // [kBQ] final running maxima

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Sk - Sq;
  // live keys: [0, kl); kv_len is clamped to Sk
  const int kl = kv_len != nullptr ? max(0, min(Sk, (int)kv_len[b])) : Sk;
  // keys this block visits: with kl > 0 key 0 is live on every row (Sq <=
  // Sk under causal keeps it on the diagonal's side), so a row's running
  // max is finite from the first tile on; with kl == 0 nothing is visited
  int kend = kl;
  if (causal) kend = min(kend, min(q0 + kBQ, Sq) + off);

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
        } else if (causal && key > row + off) {
          x = kMasked;
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
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(prow[c] - m_new);
        sum += p;
        prow[c] = to_f(from_f<T>(p));  // P in V's dtype before P V
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

  if (spart == 0) {
    row_l[srow] = l_run;
    row_m[srow] = m_run;
  }
  __syncthreads();
  if (tid < kBQ && q0 + tid < Sq) {
    const float l = row_l[tid];
    lse[((long long)b * H + h) * Sq + q0 + tid] =
        l == 0.f ? kMasked : row_m[tid] + logf(l);
  }
  const long long hd = (long long)H * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float l = row_l[ty + 16 * i];
    const float inv = l == 0.f ? 0.f : 1.f / l;  // no live key -> O = 0
    T* op = out + ((long long)b * Sq + row) * hd + (long long)h * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) op[tx + 16 * j] = from_f<T>(acc[i][j] * inv);
  }
}

// ------------------------------------------- bf16: tensor-core kernel

namespace ff = flash_fwd;
using Args = ff::Args;

template <int D>
__global__ void __launch_bounds__(ff::kMmaThreads, ff::MmaTile<D>::kMinBlocks)
flash_fwd_mma_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ff::fwd_mma_body<D, false>(a, smem_raw);
}

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.lse, a.kv_len,
      a.Sq, a.Sk, a.H, a.q_bs, a.q_rs, a.k_bs, a.k_rs, a.v_bs, a.v_rs,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 64:
      return launch<T, 64>(a, s);
    case 128:
      return launch<T, 128>(a, s);
    case 192:
      return launch<T, 192>(a, s);
    case 256:
      return launch<T, 256>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_mma(int D, const Args& a, cudaStream_t s) {
  if (!ff::rows_aligned(a)) return cudaErrorMisalignedAddress;
  switch (D) {
    case 64:
      return ff::launch_mma<64>(flash_fwd_mma_kernel<64>, a, s);
    case 128:
      return ff::launch_mma<128>(flash_fwd_mma_kernel<128>, a, s);
    case 192:
      return ff::launch_mma<192>(flash_fwd_mma_kernel<192>, a, s);
    case 256:
      return ff::launch_mma<256>(flash_fwd_mma_kernel<256>, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, Sq, H*D], k/v [B, Sk, H*D] (last dim contiguous, batch and row
// strides in elements), out [B, Sq, H*D] contiguous, lse [B, H, Sq]
// float32 contiguous, kv_len [B] float32 or NULL (every key live).
// dtype: 0 = float32 (SIMT kernel), 1 = bfloat16 (tensor-core kernel; q,
// k, v rows 16-byte aligned).  Returns cudaGetLastError().
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const float* kv_len, int B, int Sq, int Sk, int H, int D, long long q_bs,
    long long q_rs, long long k_bs, long long k_rs, long long v_bs,
    long long v_rs, float scale, int causal, int dtype, void* stream) {
  const Args a{q, k, v, out, lse, kv_len, B, Sq, Sk, H, q_bs, q_rs, k_bs,
               k_rs, v_bs, v_rs, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(D, a, s);
  if (dtype == 1) return (int)dispatch_mma(D, a, s);
  return (int)cudaErrorInvalidValue;
}
