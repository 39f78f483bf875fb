// Streaming (flash) attention backward for Hopper (sm_90a), plain C interface:
// two kernels, two entries.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py's backward kernels, both
// called from _flash_bwd (:403):
//   * flash_bwd_dq_kernel (entry flash_attention_bwd_dq) replaces
//     _bwd_dq_kernel (:318, kernel #4): the q-outer sweep for dQ;
//   * flash_bwd_dkv_kernel (entry flash_attention_bwd_dkv) replaces
//     _bwd_dkv_kernel (:354, kernel #5): the k-outer sweep for dK and dV.
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
// dK/dV in bf16, flash_bwd_dkv_mma_kernel<D> (tensor cores, mma.sync
// m16n8k16), computed in the transposed orientation so that every operand
// but the streamed ones stays in registers:
//   * grid (key tiles, heads, batch), 4 warps; each warp owns 16 keys and,
//     at D 192 and 256, half of the D output columns (two warps share 16
//     keys and each recomputes the score tiles, so that the dK and dV
//     accumulators, D / 2 registers each, fit the register file): 64 keys
//     a block at D <= 128, 32 above;
//   * K and V are loaded once and, at D 64, kept as mma A fragments in
//     registers (at D > 64 they stay in shared memory and are read with
//     ldmatrix, for the same reason);
//   * the loop runs over q tiles (64 rows at D 64, 32 above) from the first
//     one that reaches the block's keys under causal; q, dO and the tile's
//     lse and delta stream through a two-stage cp.async ring, tile t+1's
//     copy issued before tile t's math; each thread scales and rounds the
//     q chunks it copied, in place, to the bf16 q * scale of the plain
//     version (1/sqrt(D) is not a power of two at D 128 and 192, so the
//     scale cannot fold into S^T) before the barrier that publishes them;
//   * each tile: S^T = K (q scale)^T, P^T = exp(S^T - lse) masked (only on
//     tiles that cross Sq, kv_len or the causal diagonal); dV += P^T dO
//     with P^T rounded to bf16 in registers as the A fragment; dP^T =
//     V dO^T; dS^T = P^T o (dP^T - delta); dK += dS^T (q scale) with dS^T
//     rounded to bf16 as the A fragment (the B fragments of q and dO by
//     ldmatrix, .trans for the dK and dV products);
//   * dK and dV stay in float32 registers and are written once, staged
//     through shared memory into 16-byte stores: no atomics,
//     deterministic; a key tile that no live pair reaches is written as
//     zeros.
// The rest is the first version's SIMT structure, on float32 FMAs:
//   * dq (kernel #4, both dtypes) and dK/dV in float32 (tensor cores in
//     float32 are TF32, which rounds the inputs to 10 mantissa bits: the
//     float32 paths stay SIMT on purpose);
//   * grid (q tiles, heads, batch) for dq and (key tiles, heads, batch) for
//     dkv, 64-row tiles for D <= 128 and 32-row tiles above, so that four
//     operand tiles and the score tiles fit in shared memory;
//   * each block loops over the other axis inside the block (the Pallas
//     kernels' sequential grid axis), accumulates its dQ, or its dK and dV,
//     in registers and writes them once: no atomics, deterministic results;
//   * 256 threads each hold 4 x 4 (or 2 x 2) score micro-tiles and 4 x D/16
//     (or 2 x D/16) accumulator micro-tiles.
// All read q, k, v and dO in place in the [B, S, H*D] layout through their
// batch and row strides (the bf16 dkv kernel needs 16-byte aligned rows:
// the entry returns cudaErrorMisalignedAddress otherwise) and write dQ, dK
// and dV as [B, S, H*D].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_mma.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  void* out0;          // dq, or dk
  void* out1;          // unused, or dv
  const float* kv_len; // [B] or NULL
  int B, Sq, Sk, H;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;
  float scale;
  int causal;
};

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

// ------------------------------------ kernel #5 in bf16: tensor cores

namespace fm = flash_mma;

constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;

template <int D>
struct DkvTile {
  static constexpr int kSplit = D <= 128 ? 1 : 2;  // warps sharing 16 keys
  static constexpr int kCols = D / kSplit;         // output columns a warp
  static constexpr int kKeys = 16 * kWarps / kSplit;
  static constexpr int kBQ = D == 64 ? 64 : 32;    // q rows a streamed tile
  static constexpr bool kKvRegs = D == 64;         // K, V as A fragments
  static constexpr int kStride = D + 8;            // padded shared row, bf16
  // K and V, then two stages of (q, dO), then two stages of (lse, delta)
  static constexpr size_t kSmem =
      sizeof(fm::bf16) * (size_t)(2 * kKeys + 4 * kBQ) * kStride +
      sizeof(float) * (size_t)(4 * kBQ);
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(Args a) {
  using Tile = DkvTile<D>;
  constexpr int S = Tile::kStride;
  constexpr int BQ = Tile::kBQ;
  constexpr int KEYS = Tile::kKeys;
  constexpr int KD = D / 16;           // k-steps of K q^T and V dO^T
  constexpr int NQ = BQ / 8;           // n-tiles of a score row (q rows)
  constexpr int NC = Tile::kCols / 8;  // n-tiles of this warp's dK, dV
  constexpr int CH = D / 8;            // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fm::bf16* Ks = reinterpret_cast<fm::bf16*>(smem_raw);  // [KEYS][S]
  fm::bf16* Vs = Ks + KEYS * S;                           // [KEYS][S]
  fm::bf16* Qs = Vs + KEYS * S;                           // [2][BQ][S]
  fm::bf16* Os = Qs + 2 * BQ * S;                         // [2][BQ][S] dO
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ * S);  // [2][BQ] lse
  float* Ds = Ls + 2 * BQ;                                // [2][BQ] delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw = warp / Tile::kSplit;              // key group
  const int c0 = (warp % Tile::kSplit) * Tile::kCols;  // first column
  const int k0 = blockIdx.x * KEYS;
  const int kb = k0 + 16 * kw;                     // this warp's first key
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Sq = a.Sq, Sk = a.Sk;
  const int off = Sk - Sq;
  const bool causal = a.causal != 0;
  const int kl = live_len(a.kv_len, b, Sk);

  float dk[NC][4], dv[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  // a tile at or past kv_len has no live key: its grads are 0 (kv_len 0
  // included)
  if (k0 < kl) {
    // rows wholly left of this tile's first key under the causal diagonal
    // (row + off < k0) see none of its keys
    const int q_begin = causal && k0 > off ? (k0 - off) / BQ * BQ : 0;
    const int n_qt = (Sq - q_begin + BQ - 1) / BQ;
    const fm::bf16* qp = static_cast<const fm::bf16*>(a.q) + b * a.q_bs +
                         (long long)h * D;
    const fm::bf16* op = static_cast<const fm::bf16*>(a.dout) + b * a.o_bs +
                         (long long)h * D;
    const long long rows = ((long long)b * a.H + h) * Sq;
    const float* lp = a.lse + rows;
    const float* dlp = a.delta + rows;
    {
      const fm::bf16* kp = static_cast<const fm::bf16*>(a.k) + b * a.k_bs +
                           (long long)h * D;
      const fm::bf16* vp = static_cast<const fm::bf16*>(a.v) + b * a.v_bs +
                           (long long)h * D;
      for (int i = tid; i < KEYS * CH; i += kMmaThreads) {
        const int r = i / CH, c = (i % CH) * 8, key = k0 + r;
        const bool in = key < kl;  // keys past kv_len read as zeros
        const long long kr = in ? key : 0;
        fm::cp_async16(Ks + r * S + c, kp + kr * a.k_rs + c, in);
        fm::cp_async16(Vs + r * S + c, vp + kr * a.v_rs + c, in);
      }
    }
    // q tile t's rows, dO rows, lse and delta into stage st; rows past Sq
    // are zero-filled
    auto load_q = [&](int t, int st) {
      const int q0 = q_begin + t * BQ;
      fm::bf16* qd = Qs + st * BQ * S;
      fm::bf16* od = Os + st * BQ * S;
      for (int i = tid; i < BQ * CH; i += kMmaThreads) {
        const int r = i / CH, c = (i % CH) * 8, row = q0 + r;
        const bool in = row < Sq;
        const long long rr = in ? row : 0;
        fm::cp_async16(qd + r * S + c, qp + rr * a.q_rs + c, in);
        fm::cp_async16(od + r * S + c, op + rr * a.o_rs + c, in);
      }
      if (tid < 2 * BQ) {
        const int r = tid % BQ, row = q0 + r;
        const bool in = row < Sq;
        float* dst = (tid < BQ ? Ls : Ds) + st * BQ + r;
        fm::cp_async4(dst, (tid < BQ ? lp : dlp) + (in ? row : 0), in);
      }
    };
    load_q(0, 0);
    fm::cp_async_commit();  // with K and V

    uint32_t kf[Tile::kKvRegs ? KD : 1][4], vf[Tile::kKvRegs ? KD : 1][4];
    for (int t = 0; t < n_qt; ++t) {
      const int st = t & 1;
      if (t + 1 < n_qt) {
        load_q(t + 1, st ^ 1);
        fm::cp_async_commit();
        fm::cp_async_wait<1>();
      } else {
        fm::cp_async_wait<0>();
      }
      const int q0 = q_begin + t * BQ;
      const fm::bf16* qs = Qs + st * BQ * S;
      const fm::bf16* os = Os + st * BQ * S;
      const float* ls = Ls + st * BQ;
      const float* ds = Ds + st * BQ;
      // q * scale, rounded to bf16, over the chunks this thread copied
      for (int i = tid; i < BQ * CH; i += kMmaThreads) {
        const int r = i / CH, c = (i % CH) * 8;
        if (q0 + r < Sq) {
          uint4* x = reinterpret_cast<uint4*>(Qs + st * BQ * S + r * S + c);
          uint4 y = *x;
          fm::scale8(y, a.scale);
          *x = y;
        }
      }
      __syncthreads();
      if constexpr (Tile::kKvRegs) {
        if (t == 0) {
#pragma unroll
          for (int kk = 0; kk < KD; ++kk) {
            fm::ldmatrix_x4(kf[kk], fm::a_frag(Ks, S, 16 * kw, 16 * kk, lane));
            fm::ldmatrix_x4(vf[kk], fm::a_frag(Vs, S, 16 * kw, 16 * kk, lane));
          }
        }
      }
      // S^T = K (q scale)^T and dP^T = V dO^T: 16 keys x BQ rows
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ak[4], av[4];
        if constexpr (Tile::kKvRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ak[i] = kf[kk][i];
            av[i] = vf[kk][i];
          }
        } else {
          fm::ldmatrix_x4(ak, fm::a_frag(Ks, S, 16 * kw, 16 * kk, lane));
          fm::ldmatrix_x4(av, fm::a_frag(Vs, S, 16 * kw, 16 * kk, lane));
        }
#pragma unroll
        for (int j = 0; j < BQ / 16; ++j) {
          uint32_t bq[4], bo[4];
          fm::ldmatrix_x4(bq, fm::b_pair(qs, S, 16 * j, 16 * kk, lane));
          fm::mma_bf16(s[2 * j], ak, bq[0], bq[1]);
          fm::mma_bf16(s[2 * j + 1], ak, bq[2], bq[3]);
          fm::ldmatrix_x4(bo, fm::b_pair(os, S, 16 * j, 16 * kk, lane));
          fm::mma_bf16(dp[2 * j], av, bo[0], bo[1]);
          fm::mma_bf16(dp[2 * j + 1], av, bo[2], bo[3]);
        }
      }
      // P^T = exp(S^T - lse) on live pairs, dS^T = P^T o (dP^T - delta);
      // the live test only on a tile that crosses Sq, kv_len or this
      // warp's causal diagonal
      const bool edge = q0 + BQ > Sq || kb + 16 > kl ||
                        (causal && kb + 15 > q0 + off);
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * n + 2 * t4 + (e & 1);
          float p = exp2f((s[n][e] - ls[r]) * fm::kLog2e);
          if (edge) {
            const int key = kb + g + 8 * (e >> 1), row = q0 + r;
            if (row >= Sq || key >= kl || (causal && key > row + off))
              p = 0.f;
          }
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - ds[r]);
        }
      // dV += P^T dO and dK += dS^T (q scale), A fragments rounded to bf16
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t ap[4], ag[4];
        fm::acc_to_a(ap, s, kk);
        fm::acc_to_a(ag, dp, kk);
#pragma unroll
        for (int j = 0; j < NC / 2; ++j) {
          uint32_t bo[4], bq[4];
          fm::ldmatrix_x4_trans(bo,
                                fm::bt_pair(os, S, 16 * kk, c0 + 16 * j, lane));
          fm::mma_bf16(dv[2 * j], ap, bo[0], bo[1]);
          fm::mma_bf16(dv[2 * j + 1], ap, bo[2], bo[3]);
          fm::ldmatrix_x4_trans(bq,
                                fm::bt_pair(qs, S, 16 * kk, c0 + 16 * j, lane));
          fm::mma_bf16(dk[2 * j], ag, bq[0], bq[1]);
          fm::mma_bf16(dk[2 * j + 1], ag, bq[2], bq[3]);
        }
      }
      __syncthreads();  // the stage is free for tile t + 2
    }
  }
  // dK and dV through this warp's own rows and columns of Ks and Vs (no
  // warp reads them any more), then 16-byte stores of keys below Sk
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int at = (16 * kw + g + 8 * hr) * S + c0 + 8 * n + 2 * t4;
      *reinterpret_cast<uint32_t*>(Ks + at) =
          fm::pack_bf16(dk[n][2 * hr], dk[n][2 * hr + 1]);
      *reinterpret_cast<uint32_t*>(Vs + at) =
          fm::pack_bf16(dv[n][2 * hr], dv[n][2 * hr + 1]);
    }
  __syncwarp();
  const long long hd = (long long)a.H * D;
  constexpr int WCH = Tile::kCols / 8;  // 16-byte chunks of a warp's row
  fm::bf16* dkp = static_cast<fm::bf16*>(a.out0);
  fm::bf16* dvp = static_cast<fm::bf16*>(a.out1);
  for (int i = lane; i < 16 * WCH; i += 32) {
    const int r = i / WCH, c = c0 + (i % WCH) * 8, key = kb + r;
    if (key >= Sk) continue;
    const long long at = ((long long)b * Sk + key) * hd + (long long)h * D + c;
    const int sa = (16 * kw + r) * S + c;
    *reinterpret_cast<uint4*>(dkp + at) =
        *reinterpret_cast<const uint4*>(Ks + sa);
    *reinterpret_cast<uint4*>(dvp + at) =
        *reinterpret_cast<const uint4*>(Vs + sa);
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

template <int D>
cudaError_t launch_dkv_mma(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = DkvTile<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int keys = DkvTile<D>::kKeys;
  dim3 grid((a.Sk + keys - 1) / keys, a.H, a.B);
  flash_bwd_dkv_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_dkv_mma(int D, const Args& a, cudaStream_t s) {
  // cp.async moves 16 bytes: every row must start aligned
  if (!fm::aligned16(a.q, a.q_bs, a.q_rs) ||
      !fm::aligned16(a.k, a.k_bs, a.k_rs) ||
      !fm::aligned16(a.v, a.v_bs, a.v_rs) ||
      !fm::aligned16(a.dout, a.o_bs, a.o_rs) ||
      !fm::aligned16(a.out0, 0, 0) || !fm::aligned16(a.out1, 0, 0))
    return cudaErrorMisalignedAddress;
  switch (D) {
    case 64:
      return launch_dkv_mma<64>(a, s);
    case 128:
      return launch_dkv_mma<128>(a, s);
    case 192:
      return launch_dkv_mma<192>(a, s);
    case 256:
      return launch_dkv_mma<256>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(const Args& a, int D, int dtype, bool dkv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(dkv ? dispatch_d<float, true>(D, a, s)
                     : dispatch_d<float, false>(D, a, s));
  if (dtype == 1)
    return (int)(dkv ? dispatch_dkv_mma(D, a, s)
                     : dispatch_d<__nv_bfloat16, false>(D, a, s));
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/dout [B, Sq, H*D], k/v [B, Sk, H*D] (last dim contiguous, batch and row
// strides in elements); lse and delta [B, H, Sq] float32 contiguous;
// kv_len [B] float32 or NULL (every key live); dq [B, Sq, H*D] contiguous.
// dtype: 0 = float32, 1 = bfloat16 (both SIMT).  Returns
// cudaGetLastError().
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
