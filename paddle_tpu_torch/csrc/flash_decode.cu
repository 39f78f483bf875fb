// Single-query decode attention over a dense KV cache for Hopper (sm_90a),
// plain C interface.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:_decode_kernel (called
// from _decode_core).  Same function: one query row per (batch, head)
// attends the cached keys below kv_len[b] (float32 lengths compared as
// int32), q scaled in its own dtype first, softmax in float32, O = P V.
// Keys at or past kv_len are NEVER read, and a row with kv_len == 0 gives
// O = 0 (the Pallas kernel skips every block and its finalize maps l == 0
// to 0) — unlike mha_block, where an all-masked row is the mean of V.
//
// What bounds it on this card: each live key is read once (its K and V
// rows, 2 * D * itemsize bytes) and costs 4 D FLOP, so the kernel is bound
// by memory bandwidth (3.35 TB/s) on the live cache bytes.  The Pallas
// kernel walked the keys sequentially for each (batch, head-group) and
// padded the single query to 16 sublanes; neither carries over.  With
// transformer-base (B * H = 64) one block per (batch, head) would leave
// most of the 132 SMs idle, so:
//   * the key axis is split into chunks of `chunk` keys; grid = (chunks,
//     heads, batch).  A chunk starting at or past kv_len[b] exits before
//     reading anything;
//   * inside a block, 4 warps stride over the chunk 8 keys at a time (4
//     for D > 128), loading those keys' K and V rows together; each lane
//     owns D / 32 columns, a key's score is a warp-shuffle reduction, and
//     each warp keeps an online softmax (max m, sum l, accumulator);
//   * the block merges its warps' (m, l, acc) in shared memory and writes
//     one float32 partial per chunk; a second small kernel merges the
//     chunks of each (batch, head) and normalises (l == 0 -> O = 0).
// No padding of q, no shared-memory staging of K/V: each K/V row is one
// coalesced read by one warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ kv_len,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int Sk, int H, int chunk,
                    int splits, long long q_bs, long long k_bs,
                    long long k_rs, long long v_bs, long long v_rs,
                    float scale) {
  constexpr int DL = D / 32;           // columns per lane
  constexpr int U = D <= 128 ? 8 : 4;  // keys per warp per iteration
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kl = kv_len != nullptr ? min(Sk, (int)kv_len[b]) : Sk;
  const int start = split * chunk;
  const int stop = min(start + chunk, kl);
  const long long pidx = ((long long)b * H + h) * splits + split;
  if (start >= stop) {  // nothing live in this chunk: the merge identity
    if (threadIdx.x == 0) {
      part_m[pidx] = -INFINITY;
      part_l[pidx] = 0.f;
    }
    for (int c = threadIdx.x; c < D; c += kWarps * 32)
      part_acc[pidx * D + c] = 0.f;
    return;
  }

  const T* qp = q + b * q_bs + (long long)h * D;
  const T* kp = k + b * k_bs + (long long)h * D;
  const T* vp = v + b * v_bs + (long long)h * D;
  float qv[DL], acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    qv[i] = to_f(from_f<T>(to_f(qp[lane + 32 * i]) * scale));
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int j0 = start + warp * U; j0 < stop; j0 += kWarps * U) {
    // the K and V rows of U keys are loaded together, so one memory latency
    // is exposed per iteration, not one for K and another for V
    float kr[U][DL], vr[U][DL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u;
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        kr[u][i] = j < stop ? to_f(kp[j * k_rs + lane + 32 * i]) : 0.f;
        vr[u][i] = j < stop ? to_f(vp[j * v_rs + lane + 32 * i]) : 0.f;
      }
    }
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DL; ++i) part = fmaf(qv[i], kr[u][i], part);
      s[u] = j0 + u < stop ? warp_sum(part) : -INFINITY;
    }
    float mx = s[0];
#pragma unroll
    for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[u]);
    const float m_new = fmaxf(m, mx);  // finite: key j0 < stop is live
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 + u >= stop) continue;
      const float p = expf(s[u] - m_new);
      l += p;
      // P is cast to V's dtype before P V, as in the Pallas kernel
      const float pv = to_f(from_f<T>(p));
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[i] = fmaf(pv, vr[u][i], acc[i]);
    }
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DL; ++i) sm_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();
  if (warp != 0) return;
  float M = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w]);
  float L = 0.f, A[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) A[i] = 0.f;
  // M is finite: this chunk holds at least one live key
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float sc = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - M);
    L += sm_l[w] * sc;
#pragma unroll
    for (int i = 0; i < DL; ++i) A[i] += sm_acc[w][lane + 32 * i] * sc;
  }
  if (lane == 0) {
    part_m[pidx] = M;
    part_l[pidx] = L;
  }
#pragma unroll
  for (int i = 0; i < DL; ++i) part_acc[pidx * D + lane + 32 * i] = A[i];
}

template <typename T, int D>
__global__ void __launch_bounds__(32)
decode_merge_kernel(const float* __restrict__ part_m,
                    const float* __restrict__ part_l,
                    const float* __restrict__ part_acc, T* __restrict__ out,
                    int H, int splits) {
  constexpr int DL = D / 32;
  const int h = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  const long long base = ((long long)b * H + h) * splits;
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, part_m[base + s]);
  float L = 0.f, A[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) A[i] = 0.f;
  if (M != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const float ms = part_m[base + s];
      if (ms == -INFINITY) continue;
      const float sc = expf(ms - M);
      L += part_l[base + s] * sc;
#pragma unroll
      for (int i = 0; i < DL; ++i)
        A[i] += part_acc[(base + s) * D + lane + 32 * i] * sc;
    }
  }
  const float inv = L == 0.f ? 0.f : 1.f / L;  // kv_len == 0 -> O = 0
  T* op = out + ((long long)b * H + h) * D;
#pragma unroll
  for (int i = 0; i < DL; ++i) op[lane + 32 * i] = from_f<T>(A[i] * inv);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const float* kv_len, float* part_m, float* part_l,
                   float* part_acc, int B, int Sk, int H, int splits,
                   int chunk, long long q_bs, long long k_bs, long long k_rs,
                   long long v_bs, long long v_rs, float scale,
                   cudaStream_t stream) {
  dim3 grid(splits, H, B);
  decode_split_kernel<T, D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, part_m, part_l, part_acc, Sk, H,
      chunk, splits, q_bs, k_bs, k_rs, v_bs, v_rs, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T, D><<<dim3(H, B), 32, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), H, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* out, const float* kv_len, float* part_m,
                       float* part_l, float* part_acc, int B, int Sk, int H,
                       int splits, int chunk, long long q_bs, long long k_bs,
                       long long k_rs, long long v_bs, long long v_rs,
                       float scale, cudaStream_t s) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, out, kv_len, part_m, part_l, part_acc, B,
                           Sk, H, splits, chunk, q_bs, k_bs, k_rs, v_bs,
                           v_rs, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, kv_len, part_m, part_l, part_acc,
                            B, Sk, H, splits, chunk, q_bs, k_bs, k_rs, v_bs,
                            v_rs, scale, s);
    case 192:
      return launch<T, 192>(q, k, v, out, kv_len, part_m, part_l, part_acc,
                            B, Sk, H, splits, chunk, q_bs, k_bs, k_rs, v_bs,
                            v_rs, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, out, kv_len, part_m, part_l, part_acc,
                            B, Sk, H, splits, chunk, q_bs, k_bs, k_rs, v_bs,
                            v_rs, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, 1, H*D], k/v [B, Sk, H*D] (last dim contiguous, batch and row
// strides in elements), out [B, 1, H*D] contiguous, kv_len [B] float32 or
// NULL (every key live).  part_m/part_l [B*H*splits] and part_acc
// [B*H*splits*D] are float32 scratch.  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError().
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                void* out, const float* kv_len, float* part_m,
                                float* part_l, float* part_acc, int B, int Sk,
                                int H, int D, int splits, int chunk,
                                long long q_bs, long long k_bs, long long k_rs,
                                long long v_bs, long long v_rs, float scale,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(D, q, k, v, out, kv_len, part_m, part_l,
                                  part_acc, B, Sk, H, splits, chunk, q_bs,
                                  k_bs, k_rs, v_bs, v_rs, scale, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(D, q, k, v, out, kv_len, part_m,
                                          part_l, part_acc, B, Sk, H, splits,
                                          chunk, q_bs, k_bs, k_rs, v_bs, v_rs,
                                          scale, s);
  return (int)cudaErrorInvalidValue;
}
