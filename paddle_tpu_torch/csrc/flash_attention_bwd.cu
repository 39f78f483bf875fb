// Streaming (flash) attention backward for Hopper (sm_90a), plain C interface:
// two entries, each with a float32 and a bf16 kernel.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py's backward kernels, both
// called from _flash_bwd (:403):
//   * entry flash_attention_bwd_dq replaces _bwd_dq_kernel (:318, kernel
//     #4): the q-outer sweep for dQ;
//   * entry flash_attention_bwd_dkv replaces _bwd_dkv_kernel (:354, kernel
//     #5): the k-outer sweep for dK and dV.
// Same function, from the same residuals: q, k, v, dO, the forward's row
// logsumexp lse [B, H, Sq] and delta [B, H, Sq] = rowsum(dO o O) - g_lse
// (computed outside, as _flash_bwd does at :419-424):
//   S  = (q * scale) K^T in float32, q scaled and rounded in its own dtype;
//   P  = exp(S - lse) on live (row, key) pairs, 0 elsewhere: no second
//        softmax pass, the forward's lse normalises;
//   dP = dO V^T;  dS = P o (dP - delta);
//   dQ = scale * (dS K)            (dS rounded to K's dtype first),
//   dK = dS^T (q * scale)          (dS rounded to q's dtype first; q was
//                                   pre-scaled, so no further factor),
//   dV = P^T dO                    (P rounded to dO's dtype first);
// the rounding points of the Pallas bodies (:335, :347, :389, :392).  A key
// is live for a row when it is below kv_len[b] (float32 lengths compared as
// int32, clamped to [0, Sk]) and, under causal, at or left of the
// (Sk - Sq)-offset diagonal.  A kv_len-0 row visits no key in either sweep:
// its dQ, dK and dV are 0 (the forward gave out 0, lse -1e30).  Key tiles
// past kv_len or wholly right of the causal frontier are never loaded, and
// the dkv kernel writes zeros for key tiles that no live pair reaches
// (_pairs_k_outer, :135-151, keeps a program per k-block for the same
// reason).  The Pallas wrapper pads Sq and Sk to its block grid and, with
// kv_len past Sk, counts the zero padding keys as live; here the ragged
// edges are bounds checks and kv_len is clamped to Sk, as in
// flash_attention_fwd.cu.
//
// What bounds it on this card: at BERT-base pretraining at 2048 tokens
// (batch 16, 12 heads of 64, bf16) the dq sweep computes 3 tile products a
// live (row, key) pair and the dkv sweep 4, about 230 and 310 GFLOP at the
// masked legs' ~0.75 live share, against ~0.3 GB of reads and writes: both
// are bound by operations (bf16 tensor-core peak), not memory.
//
// bf16: tensor cores (mma.sync m16n8k16), the bodies in flash_bwd_mma.cuh,
// which mha_block_bwd.cu's kernels share:
//   * flash_bwd_dq_mma_kernel<D> (#4): q-outer; q (scaled, rounded) and dO
//     as A fragments, K and V streamed through a two-stage cp.async ring,
//     dQ += dS K with dS rounded to bf16 in registers, dQ written once;
//   * flash_bwd_dkv_mma_kernel<D> (#5): k-outer in the transposed
//     orientation, K and V as A fragments, q, dO, lse and delta streamed,
//     dV += P^T dO and dK += dS^T (q scale) in registers, written once.
// float32: the first version's SIMT kernels, flash_bwd_dq_kernel and
// flash_bwd_dkv_kernel, on float32 FMAs (tensor cores in float32 are TF32,
// which rounds the inputs to 10 mantissa bits: the float32 paths stay SIMT
// on purpose):
//   * grid (q tiles, heads, batch) for dq and (key tiles, heads, batch) for
//     dkv, 64-row tiles for D <= 128 and 32-row tiles above, so that four
//     operand tiles and the score tiles fit in shared memory;
//   * each block loops over the other axis inside the block (the Pallas
//     kernels' sequential grid axis), accumulates its dQ, or its dK and dV,
//     in registers and writes them once: no atomics, deterministic results;
//   * 256 threads each hold 4 x 4 (or 2 x 2) score micro-tiles and 4 x D/16
//     (or 2 x D/16) accumulator micro-tiles.
// All read q, k, v and dO in place in the [B, S, H*D] layout through their
// batch and row strides (the bf16 kernels need 16-byte aligned rows: the
// entries return cudaErrorMisalignedAddress otherwise) and write dQ, dK
// and dV as [B, S, H*D].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_bwd_mma.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads

// the SIMT kernels run float32 only (bf16 takes the
// tensor-core kernels)
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// x rounded to T and back: the Pallas bodies' astype before a dot
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

template <int D>
struct TileRows {
  static constexpr int value = D <= 128 ? 64 : 32;
};

// four [BT][D+1] operand tiles, n_score [BT][BT+1] score tiles, two [BT]
// row vectors
template <int D>
constexpr size_t smem_bytes(int n_score) {
  constexpr int BT = TileRows<D>::value;
  return sizeof(float) *
         (size_t)(4 * BT * (D + 1) + n_score * BT * (BT + 1) + 2 * BT);
}

using Args = flash_bwd::Args;

// rows [row0, row0 + BT) of a [S, H*D] slab (row stride rs, already offset
// to this image and head) into a [BT][D+1] float tile; rows >= S are 0.
// With prescale, each value is scaled and rounded in its own dtype first.
template <typename T, int D, int BT>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int S, long long rs, float scale,
                                          bool prescale) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < BT * D; i += kThreads) {
    const int r = i / D, c = i % D, row = row0 + r;
    float x = 0.f;
    if (row < S) {
      x = to_f(src[row * rs + c]);
      if (prescale) x = round_to<T>(x * scale);
    }
    dst[r * DP + c] = x;
  }
}

// lse and delta of rows [row0, row0 + BT) of this (image, head); rows >= Sq
// read as 0 (their dO is 0, so they add nothing)
template <int BT>
__device__ __forceinline__ void load_rows(float* lse_s, float* dl_s,
                                          const float* lse, const float* dl,
                                          int row0, int Sq) {
  for (int r = threadIdx.x; r < BT; r += kThreads) {
    const int row = row0 + r;
    lse_s[r] = row < Sq ? lse[row] : 0.f;
    dl_s[r] = row < Sq ? dl[row] : 0.f;
  }
}

// s[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over [BT][D+1] tiles
template <int D, int MT>
__device__ __forceinline__ void dot_rows(const float* A, const float* B,
                                         float (&s)[MT][MT], int tx, int ty) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[MT], b[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) a[i] = A[(ty + 16 * i) * DP + d];
#pragma unroll
    for (int j = 0; j < MT; ++j) b[j] = B[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < MT; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

__device__ __forceinline__ int live_len(const float* kv_len, int b, int Sk) {
  return kv_len != nullptr ? max(0, min(Sk, (int)kv_len[b])) : Sk;
}

// kernel #4: one block owns (q tile, head, image) and sweeps the key tiles
// up to its last live key
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(Args a) {
  constexpr int BT = TileRows<D>::value;
  constexpr int MT = BT / 16;  // micro-tile rows/cols per thread
  constexpr int DP = D + 1;
  constexpr int BTP = BT + 1;
  constexpr int DC = D / 16;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // [BT][DP] pre-scaled queries
  float* dOs = Qs + BT * DP;   // [BT][DP]
  float* Ks = dOs + BT * DP;   // [BT][DP]
  float* Vs = Ks + BT * DP;    // [BT][DP]
  float* Gs = Vs + BT * DP;    // [BT][BTP] dS, rounded to T
  float* row_lse = Gs + BT * BTP;
  float* row_dl = row_lse + BT;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Sq = a.Sq, Sk = a.Sk;
  const int off = Sk - Sq;
  const bool causal = a.causal != 0;
  // keys this block visits: with kl > 0, key 0 is live on every row, so a
  // row's lse is finite; with kl == 0 nothing is visited and dQ is 0
  int kend = live_len(a.kv_len, b, Sk);
  if (causal) kend = min(kend, min(q0 + BT, Sq) + off);

  const T* qp = static_cast<const T*>(a.q) + b * a.q_bs + (long long)h * D;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_bs + (long long)h * D;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_bs + (long long)h * D;
  const T* op = static_cast<const T*>(a.dout) + b * a.o_bs + (long long)h * D;
  const long long rows = ((long long)b * a.H + h) * Sq;
  load_tile<T, D, BT>(Qs, qp, q0, Sq, a.q_rs, a.scale, true);
  load_tile<T, D, BT>(dOs, op, q0, Sq, a.o_rs, 0.f, false);
  load_rows<BT>(row_lse, row_dl, a.lse + rows, a.delta + rows, q0, Sq);

  float acc[MT][DC];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += BT) {
    load_tile<T, D, BT>(Ks, kp, k0, kend, a.k_rs, 0.f, false);
    load_tile<T, D, BT>(Vs, vp, k0, kend, a.v_rs, 0.f, false);
    __syncthreads();
    float s[MT][MT], dp[MT][MT];
    dot_rows<D, MT>(Qs, Ks, s, tx, ty);
    dot_rows<D, MT>(dOs, Vs, dp, tx, ty);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int c = tx + 16 * j, key = k0 + c;
        float ds = 0.f;
        if (key < kend && row < Sq && !(causal && key > row + off)) {
          const float p = expf(s[i][j] - row_lse[r]);
          ds = p * (dp[i][j] - row_dl[r]);
        }
        Gs[r * BTP + c] = round_to<T>(ds);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BT; ++kk) {
      float g[MT], kv[DC];
#pragma unroll
      for (int i = 0; i < MT; ++i) g[i] = Gs[(ty + 16 * i) * BTP + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) kv[j] = Ks[kk * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(g[i], kv[j], acc[i][j]);
    }
    __syncthreads();
  }
  const long long hd = (long long)a.H * D;
  T* dq = static_cast<T*>(a.out0);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    T* dst = dq + ((long long)b * Sq + row) * hd + (long long)h * D;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      dst[tx + 16 * j] = from_f<T>(acc[i][j] * a.scale);
  }
}

// kernel #5: one block owns (key tile, head, image) and sweeps the query
// tiles that reach it
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(Args a) {
  constexpr int BT = TileRows<D>::value;
  constexpr int MT = BT / 16;
  constexpr int DP = D + 1;
  constexpr int BTP = BT + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;            // [BT][DP] pre-scaled queries
  float* dOs = Qs + BT * DP;   // [BT][DP]
  float* Ks = dOs + BT * DP;   // [BT][DP] this block's keys
  float* Vs = Ks + BT * DP;    // [BT][DP] this block's values
  float* Ps = Vs + BT * DP;    // [BT][BTP] P, query-major, rounded to T
  float* Gs = Ps + BT * BTP;   // [BT][BTP] dS, query-major, rounded to T
  float* row_lse = Gs + BT * BTP;
  float* row_dl = row_lse + BT;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Sq = a.Sq, Sk = a.Sk;
  const int off = Sk - Sq;
  const bool causal = a.causal != 0;
  const int kl = live_len(a.kv_len, b, Sk);
  const long long hd = (long long)a.H * D;

  float gk[MT][DC], gv[MT][DC];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) gk[i][j] = gv[i][j] = 0.f;

  // a tile at or past kv_len has no live key: its grads are 0 (kv_len 0
  // included)
  if (k0 < kl) {
    // rows wholly left of this tile's first key under the causal diagonal
    // (row + off < k0) see none of its keys
    int q_begin = 0;
    if (causal && k0 > off) q_begin = (k0 - off) / BT * BT;
    const T* qp = static_cast<const T*>(a.q) + b * a.q_bs + (long long)h * D;
    const T* op = static_cast<const T*>(a.dout) + b * a.o_bs + (long long)h * D;
    const long long rows = ((long long)b * a.H + h) * Sq;
    load_tile<T, D, BT>(Ks, static_cast<const T*>(a.k) + b * a.k_bs +
                                (long long)h * D,
                        k0, kl, a.k_rs, 0.f, false);
    load_tile<T, D, BT>(Vs, static_cast<const T*>(a.v) + b * a.v_bs +
                                (long long)h * D,
                        k0, kl, a.v_rs, 0.f, false);
    for (int q0 = q_begin; q0 < Sq; q0 += BT) {
      load_tile<T, D, BT>(Qs, qp, q0, Sq, a.q_rs, a.scale, true);
      load_tile<T, D, BT>(dOs, op, q0, Sq, a.o_rs, 0.f, false);
      load_rows<BT>(row_lse, row_dl, a.lse + rows, a.delta + rows, q0, Sq);
      __syncthreads();
      float s[MT][MT], dp[MT][MT];
      dot_rows<D, MT>(Qs, Ks, s, tx, ty);
      dot_rows<D, MT>(dOs, Vs, dp, tx, ty);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const int c = tx + 16 * j, key = k0 + c;
          float p = 0.f, ds = 0.f;
          if (row < Sq && key < kl && !(causal && key > row + off)) {
            p = expf(s[i][j] - row_lse[r]);
            ds = p * (dp[i][j] - row_dl[r]);
          }
          Ps[r * BTP + c] = round_to<T>(p);
          Gs[r * BTP + c] = round_to<T>(ds);
        }
      }
      __syncthreads();
      // gv[c][d] += sum_r P[r][c] dO[r][d];  gk[c][d] += sum_r dS[r][c] q[r][d]
#pragma unroll 4
      for (int rr = 0; rr < BT; ++rr) {
        float pc[MT], gc[MT], dov[DC], qv[DC];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          pc[i] = Ps[rr * BTP + ty + 16 * i];
          gc[i] = Gs[rr * BTP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          dov[j] = dOs[rr * DP + tx + 16 * j];
          qv[j] = Qs[rr * DP + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            gv[i][j] = fmaf(pc[i], dov[j], gv[i][j]);
            gk[i][j] = fmaf(gc[i], qv[j], gk[i][j]);
          }
      }
      __syncthreads();
    }
  }
  T* dk = static_cast<T*>(a.out0);
  T* dv = static_cast<T*>(a.out1);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Sk) continue;
    const long long at = ((long long)b * Sk + key) * hd + (long long)h * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      dk[at + tx + 16 * j] = from_f<T>(gk[i][j]);
      dv[at + tx + 16 * j] = from_f<T>(gv[i][j]);
    }
  }
}

template <typename T, bool DKV, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int BT = TileRows<D>::value;
  const size_t smem = smem_bytes<D>(DKV ? 2 : 1);
  if constexpr (DKV) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Sk + BT - 1) / BT, a.H, a.B);
    flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Sq + BT - 1) / BT, a.H, a.B);
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T, bool DKV>
cudaError_t dispatch_d(int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 64:
      return launch<T, DKV, 64>(a, s);
    case 128:
      return launch<T, DKV, 128>(a, s);
    case 192:
      return launch<T, DKV, 192>(a, s);
    case 256:
      return launch<T, DKV, 256>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ------------------------------------- kernels #4 and #5 in bf16

namespace fb = flash_bwd;

template <int D>
__global__ void __launch_bounds__(fb::kMmaThreads)
flash_bwd_dq_mma_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fb::q_outer_body<D, false, false>(a, smem_raw);
}

template <int D>
__global__ void __launch_bounds__(fb::kMmaThreads)
flash_bwd_dkv_mma_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fb::dkv_mma_body<D, false>(a, smem_raw);
}

template <int D>
cudaError_t launch_mma(const Args& a, bool dkv, cudaStream_t s) {
  if (dkv)
    return fb::launch(flash_bwd_dkv_mma_kernel<D>, fb::dkv_grid<D>(a),
                      fb::DkvTile<D>::kSmem, a, s);
  return fb::launch(flash_bwd_dq_mma_kernel<D>, fb::q_grid(a),
                    fb::QTile<D>::kSmem, a, s);
}

cudaError_t dispatch_mma(int D, const Args& a, bool dkv, cudaStream_t s) {
  if (!fb::rows_aligned(a)) return cudaErrorMisalignedAddress;
  switch (D) {
    case 64:
      return launch_mma<64>(a, dkv, s);
    case 128:
      return launch_mma<128>(a, dkv, s);
    case 192:
      return launch_mma<192>(a, dkv, s);
    case 256:
      return launch_mma<256>(a, dkv, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(const Args& a, int D, int dtype, bool dkv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(dkv ? dispatch_d<float, true>(D, a, s)
                     : dispatch_d<float, false>(D, a, s));
  if (dtype == 1) return (int)dispatch_mma(D, a, dkv, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/dout [B, Sq, H*D], k/v [B, Sk, H*D] (last dim contiguous, batch and row
// strides in elements); lse and delta [B, H, Sq] float32 contiguous;
// kv_len [B] float32 or NULL (every key live); dq [B, Sq, H*D] contiguous.
// dtype: 0 = float32 (SIMT kernel), 1 = bfloat16 (tensor-core kernel; q,
// k, v, dO rows 16-byte aligned).  Returns cudaGetLastError().
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, const float* kv_len,
    int B, int Sq, int Sk, int H, int D, long long q_bs, long long q_rs,
    long long k_bs, long long k_rs, long long v_bs, long long v_rs,
    long long o_bs, long long o_rs, float scale, int causal, int dtype,
    void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, kv_len, B, Sq, Sk, H,
               q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, scale, causal};
  return run(a, D, dtype, false, stream);
}

// The same inputs; dk and dv [B, Sk, H*D] contiguous.  dtype: 0 = float32
// (SIMT kernel), 1 = bfloat16 (tensor-core kernel; q, k, v, dO rows 16-byte
// aligned).
extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const float* kv_len, int B, int Sq, int Sk, int H, int D, long long q_bs,
    long long q_rs, long long k_bs, long long k_rs, long long v_bs,
    long long v_rs, long long o_bs, long long o_rs, float scale, int causal,
    int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, kv_len, B, Sq, Sk, H,
               q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, scale, causal};
  return run(a, D, dtype, true, stream);
}
