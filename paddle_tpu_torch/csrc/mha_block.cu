// Exact multi-head attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/mha_block.py:_mha_fwd_kernel (the Pallas
// single-block MHA kernel, called from _mha_core).  Same function:
//   S = (q * scale) K^T in float32, q scaled in its own dtype first;
//   causal mask with the (Sk - Sq) diagonal offset and a key_len mask
//   (lengths arrive as float32 and compare as int32, not clamped), both
//   by setting the score to the finite -1e30;
//   a full-row softmax, the normalised P rounded to V's dtype, O = P V.
// So a row whose keys are ALL masked (key_len <= 0) softmaxes to the
// uniform mean of V over every key, those right of the causal diagonal
// too, exactly as the Pallas kernel does; -inf is never used as a mask
// value, and no lse is returned.
//
// What bounds it on this card: at the training slice's shapes
// (transformer-base, 8 heads of 64, Sq = Sk = 256) the work is ~4 Sq Sk D
// FLOP a head against ~2 (Sq + Sk) D itemsize bytes, so the bf16 path is
// near the line between the two (989 TFLOP/s against 3.35 TB/s) and the
// float32 one is bound by arithmetic (67 TFLOP/s without tensor cores); a
// single query (mha_decode, Sq = 1) reads K and V once for 4 Sk D FLOP and
// is bound by memory.  The Pallas kernel kept the whole [hc, Sq, Sk] score
// tile in VMEM; a Hopper block has at most 227 KB of shared memory.  So
// the design follows the function, not the Pallas blocks, with three
// kernels chosen in the entry by dtype and shape:
//   * mha_fwd_mma_kernel<D> (bf16, Sq > 1): the mha_block mode of the
//     tensor-core body in flash_fwd_mma.cuh, shared with the flash forward
//     (#3): mma.sync m16n8k16, K and V through a cp.async ring, and two
//     sweeps over the live key tiles, the row lse first and then
//     P = exp(S - lse) rounded to bf16 as the A fragment of P V, so that P
//     is rounded normalised where the Pallas kernel rounds it.  Rows must
//     start on 16 bytes (cudaErrorMisalignedAddress otherwise);
//   * mha_fwd_kernel<float, D> (float32, Sq > 1): SIMT FMAs in full
//     float32 (tensor cores in float32 are TF32, which rounds the inputs to
//     10 mantissa bits); grid = (q-row tiles of 64, heads, batch); each
//     block keeps its 64 pre-scaled query rows in shared memory and
//     streams 64-key tiles of K and V with an online softmax; 256 threads
//     each hold a 4 x 4 score micro-tile and a 4 x (D/16) output
//     micro-tile on strided rows/columns (conflict-free shared reads); key
//     tiles wholly past the causal diagonal or past key_len are never
//     loaded when every row still has a live key, and a key_len-0 block
//     visits every key;
//   * mha_decode_kernel<T, D> (both dtypes, Sq == 1 and Sk <=
//     kDecodeMaxKeys): one block of 8 warps per (head, image); the warps
//     stride over the live keys 4-16 at a time, each lane owning D/32
//     columns, a key's score a warp-shuffle sum; the float32 scores of the
//     row sit in shared memory (4 bytes a key), so the max, the sum and the
//     normalised P (rounded to V's dtype, as the plain version rounds it)
//     are formed once, without recomputing a score, and then O = P V is
//     accumulated over the same keys and summed across the warps.  A
//     longer cache (Sq == 1 past kDecodeMaxKeys) takes the block kernels.
// All read q, k, v in place in the [B, S, H*D] layout through their batch
// and row strides (no head transposes through device memory) and write
// the output as [B, Sq, H*D].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "flash_fwd_mma.cuh"

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

// float32 only (bf16 takes mha_fwd_mma_kernel, Sq == 1 mha_decode_kernel)
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

// ---------------------------------------------- bf16: tensor cores

namespace ff = flash_fwd;
using Args = ff::Args;

template <int D>
__global__ void __launch_bounds__(ff::kMmaThreads, ff::MmaTile<D>::kMinBlocks)
mha_fwd_mma_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ff::fwd_mma_body<D, true>(a, smem_raw);
}

// ------------------------------------------- Sq == 1: the decode body

constexpr int kDecWarps = 8;
constexpr int kDecThreads = 32 * kDecWarps;
// a row's float32 scores live in shared memory: 64 KB at this limit
constexpr int kDecodeMaxKeys = 16384;

template <int D>
constexpr size_t decode_smem(int Sk) {
  return sizeof(float) *
         ((size_t)((Sk + 3) & ~3) + kDecWarps * D + 2 * kDecWarps);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The DL = D / 32 columns a lane owns in a row: float32 lane + 32 i
// (4-byte loads), bf16 pairs 2 lane + 64 (i / 2) + (i % 2) (4-byte loads
// of two), so that a warp reads a row in coalesced 128-byte pieces.
template <typename T>
__device__ __forceinline__ int col_of(int i, int lane) {
  if constexpr (std::is_same_v<T, float>) {
    return lane + 32 * i;
  } else {
    return 2 * lane + 64 * (i >> 1) + (i & 1);
  }
}

template <int DL>
__device__ __forceinline__ void load_cols(const float* row, int lane,
                                          float (&x)[DL]) {
#pragma unroll
  for (int i = 0; i < DL; ++i) x[i] = row[lane + 32 * i];
}

template <int DL>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* row, int lane,
                                          float (&x)[DL]) {
#pragma unroll
  for (int i = 0; i < DL; i += 2) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(row + 2 * lane + 32 * i));
    x[i] = f.x;
    x[i + 1] = f.y;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kDecThreads)
mha_decode_kernel(Args a) {
  constexpr int DL = D / 32;  // columns a lane owns
  // keys a warp loads together (32 floats of K or V in flight a lane)
  constexpr int U = D <= 64 ? 16 : D <= 128 ? 8 : 4;
  extern __shared__ float smem[];
  float* sc = smem;                           // [Sk] scores, then P
  float* part = sc + ((a.Sk + 3) & ~3);       // [kDecWarps][D] partial O
  float* red = part + kDecWarps * D;          // [2][kDecWarps] reductions

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the keys of the softmax: below min(Sk, key_len); with key_len <= 0
  // every key, its score the same for all (mha_block's -1e30 mask)
  int kend = a.Sk;
  bool uniform = false;
  if (a.kv_len != nullptr) {
    const int n = (int)a.kv_len[b];  // f32 -> int32, as astype
    if (n <= 0) {
      uniform = true;
    } else {
      kend = min(kend, n);
    }
  }
  const T* qp = static_cast<const T*>(a.q) + b * a.q_bs + (long long)h * D;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_bs + (long long)h * D;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_bs + (long long)h * D;

  // 1. scores, into shared memory, and each warp's max
  float mw = uniform ? 0.f : -INFINITY;
  if (uniform) {
    for (int j = tid; j < kend; j += kDecThreads) sc[j] = 0.f;
  } else {
    float qv[DL];
    load_cols(qp, lane, qv);
#pragma unroll
    for (int i = 0; i < DL; ++i) qv[i] = to_f(from_f<T>(qv[i] * a.scale));
    for (int j0 = warp * U; j0 < kend; j0 += kDecWarps * U) {
      float kr[U][DL];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + u < kend) {
          load_cols(kp + (j0 + u) * a.k_rs, lane, kr[u]);
        } else {
#pragma unroll
          for (int i = 0; i < DL; ++i) kr[u][i] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < DL; ++i) s = fmaf(qv[i], kr[u][i], s);
        s = warp_sum(s);
        if (j0 + u < kend) {
          if (lane == 0) sc[j0 + u] = s;
          mw = fmaxf(mw, s);
        }
      }
    }
  }
  if (lane == 0) red[warp] = mw;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kDecWarps; ++w) m = fmaxf(m, red[w]);

  // 2. exp(s - m) and the row sum
  float ls = 0.f;
  for (int j = tid; j < kend; j += kDecThreads) {
    const float e = expf(sc[j] - m);
    sc[j] = e;
    ls += e;
  }
  ls = warp_sum(ls);
  if (lane == 0) red[kDecWarps + warp] = ls;
  __syncthreads();
  float l = 0.f;
#pragma unroll
  for (int w = 0; w < kDecWarps; ++w) l += red[kDecWarps + w];

  // 3. the normalised P, rounded to V's dtype before P V
  for (int j = tid; j < kend; j += kDecThreads)
    sc[j] = to_f(from_f<T>(sc[j] / l));
  __syncthreads();

  // 4. O = P V over the same keys, each warp its own, then summed
  float acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.f;
  for (int j0 = warp * U; j0 < kend; j0 += kDecWarps * U) {
    float vr[U][DL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 + u < kend) {
        load_cols(vp + (j0 + u) * a.v_rs, lane, vr[u]);
      } else {
#pragma unroll
        for (int i = 0; i < DL; ++i) vr[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = j0 + u < kend ? sc[j0 + u] : 0.f;
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[i] = fmaf(p, vr[u][i], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < DL; ++i) part[warp * D + col_of<T>(i, lane)] = acc[i];
  __syncthreads();
  T* op = static_cast<T*>(a.out) + ((long long)b * a.H + h) * D;
  for (int c = tid; c < D; c += kDecThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) o += part[w * D + c];
    op[c] = from_f<T>(o);
  }
}

// ------------------------------------------------------------ launches

template <int D>
cudaError_t launch_simt(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      mha_fwd_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  mha_fwd_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.kv_len,
      a.Sq, a.Sk, a.H, a.q_bs, a.q_rs, a.k_bs, a.k_rs, a.v_bs, a.v_rs,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_decode(const Args& a, cudaStream_t stream) {
  const size_t smem = decode_smem<D>(a.Sk);
  cudaError_t err = cudaFuncSetAttribute(
      mha_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)decode_smem<D>(kDecodeMaxKeys));
  if (err != cudaSuccess) return err;
  mha_decode_kernel<T, D><<<dim3(a.H, a.B), kDecThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// f(std::integral_constant<int, D>) for the supported head dims
template <typename F>
cudaError_t by_head_dim(int D, F&& f) {
  switch (D) {
    case 64:
      return f(std::integral_constant<int, 64>{});
    case 128:
      return f(std::integral_constant<int, 128>{});
    case 192:
      return f(std::integral_constant<int, 192>{});
    case 256:
      return f(std::integral_constant<int, 256>{});
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, Sq, H*D], k/v [B, Sk, H*D] (last dim contiguous, batch and row
// strides in elements), out [B, Sq, H*D] contiguous, key_len [B] float32
// or NULL.  dtype: 0 = float32, 1 = bfloat16 (q, k, v rows 16-byte
// aligned, else cudaErrorMisalignedAddress).  Sq == 1 with Sk <= 16384
// takes the decode body, anything else the block kernels.  Returns
// cudaGetLastError().
extern "C" int mha_block_fwd(const void* q, const void* k, const void* v,
                             void* out, const float* key_len, int B, int Sq,
                             int Sk, int H, int D, long long q_bs,
                             long long q_rs, long long k_bs, long long k_rs,
                             long long v_bs, long long v_rs, float scale,
                             int causal, int dtype, void* stream) {
  const Args a{q, k, v, out, nullptr, key_len, B, Sq, Sk, H, q_bs, q_rs,
               k_bs, k_rs, v_bs, v_rs, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && !ff::rows_aligned(a))
    return (int)cudaErrorMisalignedAddress;
  const bool decode = Sq == 1 && Sk <= kDecodeMaxKeys;
  return (int)by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (decode)
      return dtype == 0 ? launch_decode<float, kD>(a, s)
                        : launch_decode<__nv_bfloat16, kD>(a, s);
    return dtype == 0 ? launch_simt<kD>(a, s)
                      : ff::launch_mma<kD>(mha_fwd_mma_kernel<kD>, a, s);
  });
}
