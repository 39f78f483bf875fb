// Exact multi-head attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces paddle_tpu/ops/pallas/mha_block.py:_mha_bwd_kernel (the Pallas
// single-block MHA backward, called from _mha_bwd_rule).  Same function,
// from the same residuals (q, k, v and the key lengths; not the output):
//   P     = softmax((q * scale) K^T) under the forward's masks, recomputed;
//   dP    = dO V^T;
//   delta = rowsum(P o dP);
//   dS    = P o (dP - delta);
//   dQ    = scale * dS K;   dK = dS^T (q * scale);   dV = P^T dO.
// q is scaled in its own dtype before the dot, and dK uses that pre-scaled
// q; dQ takes the scale after the dS K product.  Masked scores are the
// finite -1e30, as in the forward: a row with key_len > 0 gives masked
// keys P = 0 exactly, and a row whose keys are all masked (key_len <= 0)
// has P = 1/Sk over every key.  dS is not masked afterwards, exactly as in
// the Pallas kernel, so such a row passes a gradient to every key.  Key
// lengths are cast f32 -> int32 (astype), not clamped; one past Sk leaves
// every key live.
//
// What bounds it on this card: at the training shapes (transformer-base,
// D = 64, Sq = Sk = 256) the work is ~18 Sq Sk D FLOP per head against
// ~7 S D element reads and writes, so it is bound by arithmetic.  The
// Pallas kernel kept the whole [hc, Sq, Sk] score tile in VMEM; a Hopper
// block has at most 227 KB of shared memory, so both designs stream tiles
// and keep the softmax statistics as per-row vectors, with no atomics
// (the result is deterministic):
//
// bf16: tensor cores (mma.sync m16n8k16), three launches on the bodies of
// flash_bwd_mma.cuh in its mha_block mask mode (an image with key_len <= 0
// is visited "uniform": every key, scores taken as 0, lse = log Sk):
//   * mha_bwd_stats_mma_kernel, grid (q tiles, heads, batch): S and dP
//     over the live key tiles, an online row max, sum and rescaled
//     rowsum(P o dP); stores lse = m + log l and delta [B, H, Sq];
//   * mha_bwd_dq_mma_kernel: kernel #4's q-outer dQ body on that lse and
//     delta (3 products a live pair);
//   * mha_bwd_dkv_mma_kernel: kernel #5's k-outer dK/dV body (4 products).
//   2 + 3 + 4 = 9 tile products a live pair, as the SIMT pair computes.
// float32: the first version's SIMT kernels (tensor cores in float32 are
// TF32, which would round the inputs to 10 mantissa bits):
//   * mha_bwd_dq_kernel, grid (q tiles, heads, batch).  Pass 1 streams the
//     key tiles and keeps, per query row, the running max m, the running
//     sum l and the running rowsum of exp(s - m) dP, rescaled like l, so
//     that delta = that sum / l.  It stores m, 1/l and delta for the
//     second kernel.  Pass 2 streams the key tiles again, forms dS and
//     accumulates dS K in registers.
//   * mha_bwd_dkv_kernel, grid (key tiles, heads, batch), launched after
//     it on the same stream.  Each block keeps its K and V tile in shared
//     memory, streams the query tiles with their dO rows and row
//     statistics, recomputes P and dS, and accumulates P^T dO and dS^T q
//     in registers.
//   * 64-row tiles for D <= 128, 32-row tiles above, so that the four
//     operand tiles fit in shared memory.  256 threads hold 4 x 4 (or
//     2 x 2) score micro-tiles and 4 x D/16 (or 2 x D/16) accumulator
//     micro-tiles on strided rows and columns; float32 FMAs.
// All read q, k, v and dO in place in the [B, S, H*D] layout through their
// batch and row strides (bf16 rows must start on 16 bytes: the entry
// returns cudaErrorMisalignedAddress otherwise) and write dQ, dK and dV as
// [B, S, H*D].  Key tiles past key_len or wholly above the causal diagonal
// are skipped (their P and dS are 0), except where key_len <= 0, whose
// rows visit every key.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_bwd_mma.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr float kMasked = -1e30f;

// the SIMT kernels run float32 only (bf16 takes the
// tensor-core kernels)
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

template <int D>
struct TileRows {
  static constexpr int value = D <= 128 ? 64 : 32;
};

// four [BT][D+1] operand tiles, two [BT][BT+1] score tiles, three [BT] row
// vectors
template <int D>
constexpr size_t smem_bytes() {
  constexpr int BT = TileRows<D>::value;
  return sizeof(float) *
         (size_t)(4 * BT * (D + 1) + 2 * BT * (BT + 1) + 3 * BT);
}

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
      if (prescale) x = to_f(from_f<T>(x * scale));
    }
    dst[r * DP + c] = x;
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

// the score of (row, key) under the forward's masks
__device__ __forceinline__ float mask_score(float s, int row, int key, int off,
                                            bool causal, bool masked, int kl) {
  if (causal && key > row + off) s = kMasked;
  if (masked && key >= kl) s = kMasked;
  return s;
}

// How many keys a block of query rows [q0, q0 + rows) must visit: with a
// live key in every row (key_len > 0; causal alone always leaves key 0
// live, since Sq <= Sk), masked keys have P = 0 exactly and the tiles
// holding only such keys are skipped.  With key_len <= 0 every key is
// masked and all of them enter the softmax.
__device__ __forceinline__ int keys_to_visit(int q0, int rows, int Sq, int Sk,
                                             bool causal, bool masked,
                                             int kl) {
  int kend = Sk;
  if (!masked || kl > 0) {
    if (masked) kend = min(kend, kl);
    if (causal) kend = min(kend, min(q0 + rows, Sq) + (Sk - Sq));
  }
  return kend;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
mha_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  T* __restrict__ dq, float* __restrict__ stats,
                  const float* __restrict__ key_len, int B, int Sq, int Sk,
                  int H, long long q_bs, long long q_rs, long long k_bs,
                  long long k_rs, long long v_bs, long long v_rs,
                  long long o_bs, long long o_rs, float scale, int causal) {
  constexpr int BT = TileRows<D>::value;
  constexpr int MT = BT / 16;        // micro-tile rows/cols per thread
  constexpr int DP = D + 1;
  constexpr int BTP = BT + 1;
  constexpr int DC = D / 16;         // accumulator columns per thread
  constexpr int RT = kThreads / BT;  // threads per row in the row passes
  constexpr int CPT = BT / RT;       // columns per thread in the row passes
  extern __shared__ float smem[];
  float* Qs = smem;                // [BT][DP] pre-scaled queries
  float* dOs = Qs + BT * DP;       // [BT][DP]
  float* Ks = dOs + BT * DP;       // [BT][DP]
  float* Vs = Ks + BT * DP;        // [BT][DP]
  float* Ss = Vs + BT * DP;        // [BT][BTP] scores
  float* Gs = Ss + BT * BTP;       // [BT][BTP] dP, then dS
  float* row_m = Gs + BT * BTP;    // [BT] row max
  float* row_il = row_m + BT;      // [BT] 1 / row sum
  float* row_dl = row_il + BT;     // [BT] delta

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Sk - Sq;
  const bool masked = key_len != nullptr;
  const int kl = masked ? (int)key_len[b] : Sk;  // f32 -> int32, as astype
  const int kend = keys_to_visit(q0, BT, Sq, Sk, causal, masked, kl);

  const T* qp = q + b * q_bs + (long long)h * D;
  const T* kp = k + b * k_bs + (long long)h * D;
  const T* vp = v + b * v_bs + (long long)h * D;
  const T* op = dout + b * o_bs + (long long)h * D;
  load_tile<T, D, BT>(Qs, qp, q0, Sq, q_rs, scale, true);
  load_tile<T, D, BT>(dOs, op, q0, Sq, o_rs, 0.f, false);

  // ---- pass 1: m, l and delta of every row, online ----
  float m_run = -INFINITY, l_run = 0.f, d_run = 0.f;
  const int srow = tid / RT, spart = tid % RT;
  for (int k0 = 0; k0 < kend; k0 += BT) {
    load_tile<T, D, BT>(Ks, kp, k0, kend, k_rs, 0.f, false);
    load_tile<T, D, BT>(Vs, vp, k0, kend, v_rs, 0.f, false);
    __syncthreads();
    float s[MT][MT], dp[MT][MT];
    dot_rows<D, MT>(Qs, Ks, s, tx, ty);
    dot_rows<D, MT>(dOs, Vs, dp, tx, ty);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int c = tx + 16 * j, key = k0 + c;
        // not visited: outside this softmax entirely
        Ss[r * BTP + c] = key >= kend
            ? -INFINITY
            : mask_score(s[i][j], q0 + r, key, off, causal, masked, kl);
        Gs[r * BTP + c] = dp[i][j];
      }
    }
    __syncthreads();
    {
      const float* prow = Ss + srow * BTP + spart * CPT;
      const float* grow = Gs + srow * BTP + spart * CPT;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < CPT; ++c) mx = fmaxf(mx, prow[c]);
#pragma unroll
      for (int w = 1; w < RT; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      // finite: the first tile holds key 0 < kend, later tiles keep m_run
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);  // 0 on the first tile
      float sum = 0.f, dsum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = expf(prow[c] - m_new);
        sum += p;
        dsum = fmaf(p, grow[c], dsum);
      }
#pragma unroll
      for (int w = 1; w < RT; w <<= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
        dsum += __shfl_xor_sync(0xffffffffu, dsum, w);
      }
      l_run = l_run * alpha + sum;
      d_run = d_run * alpha + dsum;
      m_run = m_new;
    }
    __syncthreads();
  }
  if (spart == 0) {
    const float il = 1.f / l_run;
    row_m[srow] = m_run;
    row_il[srow] = il;
    row_dl[srow] = d_run * il;
    const int row = q0 + srow;
    if (row < Sq) {
      const long long base = ((long long)b * H + h) * Sq + row;
      const long long plane = (long long)B * H * Sq;
      stats[base] = m_run;
      stats[plane + base] = il;
      stats[2 * plane + base] = d_run * il;
    }
  }
  __syncthreads();

  // ---- pass 2: dQ = dS K ----
  float acc[MT][DC];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < kend; k0 += BT) {
    load_tile<T, D, BT>(Ks, kp, k0, kend, k_rs, 0.f, false);
    load_tile<T, D, BT>(Vs, vp, k0, kend, v_rs, 0.f, false);
    __syncthreads();
    float s[MT][MT], dp[MT][MT];
    dot_rows<D, MT>(Qs, Ks, s, tx, ty);
    dot_rows<D, MT>(dOs, Vs, dp, tx, ty);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int c = tx + 16 * j, key = k0 + c;
        float ds = 0.f;
        if (key < kend) {
          const float x = mask_score(s[i][j], q0 + r, key, off, causal,
                                     masked, kl);
          const float p = expf(x - row_m[r]) * row_il[r];
          ds = p * (dp[i][j] - row_dl[r]);
        }
        Gs[r * BTP + c] = ds;
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
  const long long hd = (long long)H * D;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    T* dst = dq + ((long long)b * Sq + row) * hd + (long long)h * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) dst[tx + 16 * j] = from_f<T>(acc[i][j] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
mha_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   T* __restrict__ dk, T* __restrict__ dv,
                   const float* __restrict__ stats,
                   const float* __restrict__ key_len, int B, int Sq, int Sk,
                   int H, long long q_bs, long long q_rs, long long k_bs,
                   long long k_rs, long long v_bs, long long v_rs,
                   long long o_bs, long long o_rs, float scale, int causal) {
  constexpr int BT = TileRows<D>::value;
  constexpr int MT = BT / 16;
  constexpr int DP = D + 1;
  constexpr int BTP = BT + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                // [BT][DP] pre-scaled queries
  float* dOs = Qs + BT * DP;       // [BT][DP]
  float* Ks = dOs + BT * DP;       // [BT][DP] this block's keys
  float* Vs = Ks + BT * DP;        // [BT][DP] this block's values
  float* Ps = Vs + BT * DP;        // [BT][BTP] P, query-major
  float* Gs = Ps + BT * BTP;       // [BT][BTP] dS, query-major
  float* row_m = Gs + BT * BTP;
  float* row_il = row_m + BT;
  float* row_dl = row_il + BT;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Sk - Sq;
  const bool masked = key_len != nullptr;
  const int kl = masked ? (int)key_len[b] : Sk;
  const bool all_masked = masked && kl <= 0;
  const long long hd = (long long)H * D;

  float gk[MT][DC], gv[MT][DC];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) gk[i][j] = gv[i][j] = 0.f;

  // keys past key_len have P = dS = 0 in every row: this tile's grads are 0
  const bool dead = masked && kl > 0 && k0 >= kl;
  if (!dead) {
    // with a live key in every row, rows wholly below this tile's first
    // causal diagonal see none of its keys
    int q_begin = 0;
    if (causal && !all_masked && k0 > off) q_begin = (k0 - off) / BT * BT;
    const T* qp = q + b * q_bs + (long long)h * D;
    const T* op = dout + b * o_bs + (long long)h * D;
    load_tile<T, D, BT>(Ks, k + b * k_bs + (long long)h * D, k0, Sk, k_rs,
                        0.f, false);
    load_tile<T, D, BT>(Vs, v + b * v_bs + (long long)h * D, k0, Sk, v_rs,
                        0.f, false);
    const long long plane = (long long)B * H * Sq;
    const long long base = ((long long)b * H + h) * Sq;
    for (int q0 = q_begin; q0 < Sq; q0 += BT) {
      load_tile<T, D, BT>(Qs, qp, q0, Sq, q_rs, scale, true);
      load_tile<T, D, BT>(dOs, op, q0, Sq, o_rs, 0.f, false);
      for (int r = tid; r < BT; r += kThreads) {
        const int row = q0 + r;
        const bool live = row < Sq;
        row_m[r] = live ? stats[base + row] : 0.f;
        row_il[r] = live ? stats[plane + base + row] : 0.f;
        row_dl[r] = live ? stats[2 * plane + base + row] : 0.f;
      }
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
          if (row < Sq && key < Sk) {
            const float x = mask_score(s[i][j], row, key, off, causal,
                                       masked, kl);
            p = expf(x - row_m[r]) * row_il[r];
            ds = p * (dp[i][j] - row_dl[r]);
          }
          Ps[r * BTP + c] = p;
          Gs[r * BTP + c] = ds;
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, void* dq, void* dk, void* dv,
                   float* stats, const float* key_len, int B, int Sq, int Sk,
                   int H, long long q_bs, long long q_rs, long long k_bs,
                   long long k_rs, long long v_bs, long long v_rs,
                   long long o_bs, long long o_rs, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int BT = TileRows<D>::value;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mha_bwd_dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  dim3 grid_q((Sq + BT - 1) / BT, H, B);
  mha_bwd_dq_kernel<T, D><<<grid_q, kThreads, smem, stream>>>(
      qt, kt, vt, ot, static_cast<T*>(dq), stats, key_len, B, Sq, Sk, H,
      q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_k((Sk + BT - 1) / BT, H, B);
  mha_bwd_dkv_kernel<T, D><<<grid_k, kThreads, smem, stream>>>(
      qt, kt, vt, ot, static_cast<T*>(dk), static_cast<T*>(dv), stats,
      key_len, B, Sq, Sk, H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs,
      scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* dout, void* dq, void* dk, void* dv,
                       float* stats, const float* key_len, int B, int Sq,
                       int Sk, int H, long long q_bs, long long q_rs,
                       long long k_bs, long long k_rs, long long v_bs,
                       long long v_rs, long long o_bs, long long o_rs,
                       float scale, int causal, cudaStream_t s) {
#define MHA_BWD_CASE(DIM)                                                    \
  case DIM:                                                                  \
    return launch<T, DIM>(q, k, v, dout, dq, dk, dv, stats, key_len, B, Sq, \
                          Sk, H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs,  \
                          o_rs, scale, causal, s);
  switch (D) {
    MHA_BWD_CASE(64)
    MHA_BWD_CASE(128)
    MHA_BWD_CASE(192)
    MHA_BWD_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef MHA_BWD_CASE
}

// ---------------------------------------------------- bf16: tensor cores

namespace fb = flash_bwd;

template <int D>
__global__ void __launch_bounds__(fb::kMmaThreads)
mha_bwd_stats_mma_kernel(fb::Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fb::q_outer_body<D, true, true>(a, smem_raw);
}

template <int D>
__global__ void __launch_bounds__(fb::kMmaThreads)
mha_bwd_dq_mma_kernel(fb::Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fb::q_outer_body<D, true, false>(a, smem_raw);
}

template <int D>
__global__ void __launch_bounds__(fb::kMmaThreads)
mha_bwd_dkv_mma_kernel(fb::Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fb::dkv_mma_body<D, true>(a, smem_raw);
}

// stats, then dQ, then dK/dV, on one stream; a = the dq launch's
// arguments, lse and delta pointing into the stats buffer
template <int D>
cudaError_t launch_mma(fb::Args a, void* dk, void* dv, cudaStream_t s) {
  constexpr size_t q_smem = fb::QTile<D>::kSmem;
  fb::Args st = a;
  st.out0 = const_cast<float*>(a.lse);
  st.out1 = const_cast<float*>(a.delta);
  cudaError_t err = fb::launch(mha_bwd_stats_mma_kernel<D>, fb::q_grid(a),
                               q_smem, st, s);
  if (err != cudaSuccess) return err;
  err = fb::launch(mha_bwd_dq_mma_kernel<D>, fb::q_grid(a), q_smem, a, s);
  if (err != cudaSuccess) return err;
  a.out0 = dk;
  a.out1 = dv;
  return fb::launch(mha_bwd_dkv_mma_kernel<D>, fb::dkv_grid<D>(a),
                    fb::DkvTile<D>::kSmem, a, s);
}

cudaError_t dispatch_mma(int D, const fb::Args& a, void* dk, void* dv,
                         cudaStream_t s) {
  if (!fb::rows_aligned(a) || !flash_mma::aligned16(dk, 0, 0) ||
      !flash_mma::aligned16(dv, 0, 0))
    return cudaErrorMisalignedAddress;
  switch (D) {
    case 64:
      return launch_mma<64>(a, dk, dv, s);
    case 128:
      return launch_mma<128>(a, dk, dv, s);
    case 192:
      return launch_mma<192>(a, dk, dv, s);
    case 256:
      return launch_mma<256>(a, dk, dv, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/dout [B, Sq, H*D], k/v [B, Sk, H*D] (last dim contiguous, batch and row
// strides in elements); dq [B, Sq, H*D] and dk/dv [B, Sk, H*D] contiguous;
// stats: float32 scratch of 3 * B * H * Sq (float32: m, 1/l, delta) or
// 2 * B * H * Sq (bf16: lse, delta); key_len [B] float32 or NULL.
// dtype: 0 = float32 (SIMT kernels), 1 = bfloat16 (tensor-core kernels;
// q, k, v, dO rows 16-byte aligned).  Returns cudaGetLastError().
extern "C" int mha_block_bwd(const void* q, const void* k, const void* v,
                             const void* dout, void* dq, void* dk, void* dv,
                             float* stats, const float* key_len, int B,
                             int Sq, int Sk, int H, int D, long long q_bs,
                             long long q_rs, long long k_bs, long long k_rs,
                             long long v_bs, long long v_rs, long long o_bs,
                             long long o_rs, float scale, int causal,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(D, q, k, v, dout, dq, dk, dv, stats,
                                  key_len, B, Sq, Sk, H, q_bs, q_rs, k_bs,
                                  k_rs, v_bs, v_rs, o_bs, o_rs, scale, causal,
                                  s);
  if (dtype == 1) {
    const flash_bwd::Args a{q, k, v, dout, stats,
                            stats + (long long)B * H * Sq, dq, nullptr,
                            key_len, B, Sq, Sk, H, q_bs, q_rs, k_bs, k_rs,
                            v_bs, v_rs, o_bs, o_rs, scale, causal};
    return (int)dispatch_mma(D, a, dk, dv, s);
  }
  return (int)cudaErrorInvalidValue;
}
