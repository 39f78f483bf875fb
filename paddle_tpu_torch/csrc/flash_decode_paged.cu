// Single-query decode attention over a paged KV pool for Hopper (sm_90a),
// plain C interface.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:_paged_decode_kernel
// (called from flash_decode_paged).  Same function: one query row per
// (batch, head) attends the keys of its block chain: logical key position
// p of row b lives in pool block table[b, p / bs], row p % bs.  Table
// entries are clipped into [0, N); positions at or past lengths[b]
// (float32 lengths compared as int32, capped at M * bs, the table's reach)
// are NEVER read, so stale or junk entries past ceil(len / bs) cannot
// change the output, and a row with lengths[b] == 0 gives O = 0.  q is
// scaled in its own dtype first, scores and softmax are float32, P is
// rounded to V's dtype before P V, as in the Pallas kernel.
//
// What bounds it on this card: every live key costs one read of its K and
// V rows (2 * D * itemsize bytes) and 4 D FLOP, so the kernel is bound by
// memory bandwidth (3.35 TB/s) on the live pool bytes, plus the table.
// The Pallas kernel streamed one pool block per grid step, its DMA index
// map reading the table from scalar prefetch, sequentially per (batch,
// head group).  Here, as in csrc/flash_decode.cu:
//   * the logical key axis [0, M * bs) is split into chunks of `chunk`
//     keys; grid = (chunks, heads, batch).  A chunk starting at or past
//     the row's length exits before reading anything;
//   * inside a block, 4 warps stride over the chunk 8 keys at a time (4
//     for D > 128); each key's lane loads resolve its pool row through the
//     table (one cached int read per key), then the K and V rows of the 8
//     keys are loaded together; each lane owns D / 32 columns, a score is
//     a warp-shuffle reduction, and each warp keeps an online softmax;
//   * the block merges its warps' (m, l, acc) in shared memory and writes
//     one float32 partial per chunk; a second small kernel merges the
//     chunks of each (batch, head) and normalises (l == 0 -> O = 0).
// No dense [B, M * bs, H * D] view is ever built.  Simple and right first:
// no tensor cores, no TMA, no pipelining.

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
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                   const T* __restrict__ vpool, const int* __restrict__ table,
                   const float* __restrict__ lengths,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int N, int bs, int M, int H,
                   int chunk, int splits, long long q_bs, long long k_blk,
                   long long k_rs, long long v_blk, long long v_rs,
                   float scale) {
  constexpr int DL = D / 32;           // columns per lane
  constexpr int U = D <= 128 ? 8 : 4;  // keys per warp per iteration
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int reach = M * bs;
  const int kl = min(reach, max(0, (int)lengths[b]));
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

  const int* tab = table + (long long)b * M;
  const T* qp = q + b * q_bs + (long long)h * D;
  const T* kp = kpool + (long long)h * D;
  const T* vp = vpool + (long long)h * D;
  float qv[DL], acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    qv[i] = to_f(from_f<T>(to_f(qp[lane + 32 * i]) * scale));
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int j0 = start + warp * U; j0 < stop; j0 += kWarps * U) {
    float kr[U][DL], vr[U][DL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u;
      long long ko = 0, vo = 0;
      if (j < stop) {
        const int blk = min(max(tab[j / bs], 0), N - 1);
        const int row = j % bs;
        ko = blk * k_blk + row * k_rs;
        vo = blk * v_blk + row * v_rs;
      }
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        kr[u][i] = j < stop ? to_f(kp[ko + lane + 32 * i]) : 0.f;
        vr[u][i] = j < stop ? to_f(vp[vo + lane + 32 * i]) : 0.f;
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
      const float pv = to_f(from_f<T>(p));  // P in V's dtype before P V
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
  float Mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) Mx = fmaxf(Mx, sm_m[w]);
  float L = 0.f, A[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) A[i] = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float sc = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - Mx);
    L += sm_l[w] * sc;
#pragma unroll
    for (int i = 0; i < DL; ++i) A[i] += sm_acc[w][lane + 32 * i] * sc;
  }
  if (lane == 0) {
    part_m[pidx] = Mx;
    part_l[pidx] = L;
  }
#pragma unroll
  for (int i = 0; i < DL; ++i) part_acc[pidx * D + lane + 32 * i] = A[i];
}

template <typename T, int D>
__global__ void __launch_bounds__(32)
paged_merge_kernel(const float* __restrict__ part_m,
                   const float* __restrict__ part_l,
                   const float* __restrict__ part_acc, T* __restrict__ out,
                   int H, int splits) {
  constexpr int DL = D / 32;
  const int h = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  const long long base = ((long long)b * H + h) * splits;
  float Mx = -INFINITY;
  for (int s = 0; s < splits; ++s) Mx = fmaxf(Mx, part_m[base + s]);
  float L = 0.f, A[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) A[i] = 0.f;
  if (Mx != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const float ms = part_m[base + s];
      if (ms == -INFINITY) continue;
      const float sc = expf(ms - Mx);
      L += part_l[base + s] * sc;
#pragma unroll
      for (int i = 0; i < DL; ++i)
        A[i] += part_acc[(base + s) * D + lane + 32 * i] * sc;
    }
  }
  const float inv = L == 0.f ? 0.f : 1.f / L;  // length 0 -> O = 0
  T* op = out + ((long long)b * H + h) * D;
#pragma unroll
  for (int i = 0; i < DL; ++i) op[lane + 32 * i] = from_f<T>(A[i] * inv);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* table;
  const float* lengths;
  void* out;
  float* part_m;
  float* part_l;
  float* part_acc;
  int B, N, bs, M, H, splits, chunk;
  long long q_bs, k_blk, k_rs, v_blk, v_rs;
  float scale;
};

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  dim3 grid(a.splits, a.H, a.B);
  paged_split_kernel<T, D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.table, a.lengths, a.part_m, a.part_l,
      a.part_acc, a.N, a.bs, a.M, a.H, a.chunk, a.splits, a.q_bs, a.k_blk,
      a.k_rs, a.v_blk, a.v_rs, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_merge_kernel<T, D><<<dim3(a.H, a.B), 32, 0, stream>>>(
      a.part_m, a.part_l, a.part_acc, static_cast<T*>(a.out), a.H, a.splits);
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

}  // namespace

// q [B, 1, H*D] (batch stride in elements), pools k/v [N, bs, H*D] (block
// and row strides in elements, last dim contiguous), table [B, M] int32
// contiguous, lengths [B] float32, out [B, 1, H*D] contiguous.
// part_m/part_l [B*H*splits] and part_acc [B*H*splits*D] are float32
// scratch.  dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int flash_decode_paged_fwd(
    const void* q, const void* k, const void* v, const int* table,
    const float* lengths, void* out, float* part_m, float* part_l,
    float* part_acc, int B, int N, int bs, int M, int H, int D, int splits,
    int chunk, long long q_bs, long long k_blk, long long k_rs,
    long long v_blk, long long v_rs, float scale, int dtype, void* stream) {
  const Args a{q, k, v, table, lengths, out, part_m, part_l, part_acc,
               B, N, bs, M, H, splits, chunk, q_bs, k_blk, k_rs, v_blk,
               v_rs, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(D, a, s);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(D, a, s);
  return (int)cudaErrorInvalidValue;
}
