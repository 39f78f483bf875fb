// The bf16 tensor-core bodies of the attention backward (sm_90a), shared
// by two sources, each of which wraps them in __global__ kernels of its
// own names (so a profile tells the two paths apart):
//   * flash_attention_bwd.cu: flash_bwd_dq_mma_kernel (kernel #4) and
//     flash_bwd_dkv_mma_kernel (#5), from the forward's lse and delta;
//   * mha_block_bwd.cu: mha_bwd_stats_mma_kernel (lse and delta
//     recomputed), then mha_bwd_dq_mma_kernel and mha_bwd_dkv_mma_kernel
//     (#2), on the same bodies in the mha_block mask mode.
//
// The function, from q, k, v, dO, the row logsumexp lse [B, H, Sq] and
// delta [B, H, Sq]:
//   S  = (q * scale) K^T in float32, q scaled and rounded to bf16 first;
//   P  = exp(S - lse) on live (row, key) pairs, 0 elsewhere;
//   dP = dO V^T;  dS = P o (dP - delta);
//   dQ = scale * (dS K)   (dS rounded to bf16 first),
//   dK = dS^T (q * scale) (dS rounded to bf16 first),
//   dV = P^T dO           (P rounded to bf16 first);
// the rounding points of the Pallas bodies (flash_attention.py:335, :347,
// :389, :392; mha_block.py:131, :137).
//
// Mask modes (the template flag kMha; each image's keys from
// flash_mma.cuh's live_keys()):
//   * flash (kMha false): a key is live below kv_len (float32 lengths
//     compared as int32, clamped to [0, Sk]) and, under causal, at or
//     left of the (Sk - Sq)-offset diagonal; a kv_len-0 image visits no
//     key, so its grads are exactly 0;
//   * mha_block (kMha true): the same for key_len > 0 (masked scores are
//     the finite -1e30 there, so P = 0 exactly on masked keys, as here).  An
//     image with key_len <= 0 has every score at -1e30, so P = 1/Sk over
//     every key, those right of the causal diagonal too; it is visited
//     "uniform": every key live, causal off, every score taken as 0, and
//     the stats kernel gives it lse = log Sk, so P = exp(0 - log Sk) =
//     1/Sk while dS and the products are unchanged.  dS is not masked
//     afterwards, as in the Pallas kernel: such an image passes a
//     gradient to every key.
//
// Design (mma.sync m16n8k16, bf16 in, float32 accumulate; fragment
// helpers in flash_mma.cuh):
//   * q_outer_body (the dQ kernels and the stats kernel): grid (q tiles,
//     heads, batch), 4 warps of 16 query rows, 64 rows a block; under
//     causal the q tiles launch heaviest (last) first.  q is read once,
//     scaled and rounded to bf16 in shared memory beside dO; at D <= 128
//     both are then held as A fragments in registers, at D 192 and 256
//     they are read with ldmatrix per k-step (so that the D / 2 float32
//     dQ accumulators fit the register file).  K and V stream through a
//     two-stage cp.async ring, tile t+1's copy issued before tile t's
//     math; keys past the block's last live key are never loaded, and a
//     warp whose 16 rows all lie left of a tile under causal skips its
//     math.  Each tile: S = Q K^T and dP = dO V^T (K and V as B fragments
//     by ldmatrix); then either
//       - dQ: P = exp2((S - lse) log2e), masked only on tiles that cross
//         kv_len or the warp's causal diagonal, dS = P o (dP - delta), and
//         dQ += dS K with dS rounded to bf16 as the A fragment and K's B
//         fragments by ldmatrix.trans from the same stage; dQ stays in
//         float32 registers, takes the scale once and is staged through
//         the warp's own q rows into 16-byte stores: no atomics;
//       - stats: an online row max m, sum l and rescaled rowsum(P o dP),
//         giving lse = m + log l and delta = rowsum / l.
//     Rows past Sq are zero-filled and never stored: a row of dQ sums
//     over its own keys only, so they need no mask.
//   * dkv_mma_body: kernel #5's k-outer sweep (see flash_attention_bwd.cu),
//     with the mask mode.  The mode is a template flag, so the flash
//     kernels carry no trace of it.
// Every operand row must start on 16 bytes (cp.async and the q/dO loads
// move 16 bytes): the entries check this and return
// cudaErrorMisalignedAddress otherwise.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_mma.cuh"

namespace flash_bwd {

namespace fm = flash_mma;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  void* out0;          // dq, or dk, or the stats kernel's lse (float32)
  void* out1;          // unused, or dv, or the stats kernel's delta
  const float* kv_len; // [B] or NULL
  int B, Sq, Sk, H;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;
  float scale;
  int causal;
};

// every operand row starts on 16 bytes
inline bool rows_aligned(const Args& a) {
  return fm::aligned16(a.q, a.q_bs, a.q_rs) &&
         fm::aligned16(a.k, a.k_bs, a.k_rs) &&
         fm::aligned16(a.v, a.v_bs, a.v_rs) &&
         fm::aligned16(a.dout, a.o_bs, a.o_rs) &&
         fm::aligned16(a.out0, 0, 0) && fm::aligned16(a.out1, 0, 0);
}

constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // q rows a block of q_outer_body

template <int D>
struct QTile {
  static constexpr int kBK = D == 64 ? 64 : 32;  // keys a streamed tile
  static constexpr bool kRegs = D <= 128;        // q, dO as A fragments
  static constexpr int kStride = D + 8;          // padded shared row, bf16
  // q and dO, then two stages of K and V
  static constexpr size_t kSmem =
      sizeof(fm::bf16) * (size_t)(2 * kRows + 4 * kBK) * kStride;
};

// kStats false: dQ into a.out0.  kStats true (mha_block mode only): lse
// and delta into a.out0 and a.out1 (float32 [B, H, Sq]); a.lse and
// a.delta are not read.
template <int D, bool kMha, bool kStats>
__device__ __forceinline__ void q_outer_body(const Args& a,
                                             unsigned char* smem_raw) {
  static_assert(kMha || !kStats, "the statistics pass is mha_block's");
  using Tile = QTile<D>;
  constexpr int BK = Tile::kBK;
  constexpr int S = Tile::kStride;
  constexpr int KD = D / 16;  // k-steps of Q K^T and dO V^T
  constexpr int NK = BK / 8;  // n-tiles of a score row
  constexpr int ND = D / 8;   // n-tiles of a dQ row
  constexpr int CH = D / 8;   // 16-byte chunks of a row
  fm::bf16* Qs = reinterpret_cast<fm::bf16*>(smem_raw);  // [kRows][S]
  fm::bf16* Os = Qs + kRows * S;                          // [kRows][S] dO
  fm::bf16* Ks = Os + kRows * S;                          // [2][BK][S]
  fm::bf16* Vs = Ks + 2 * BK * S;                         // [2][BK][S]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const fm::Live lv = fm::live_keys<kMha>(a.kv_len, a.Sk, a.causal, b);
  const bool uniform = kMha && lv.uniform;
  // heaviest first under causal: the last q tile sees the most keys
  const int q0 =
      (lv.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kRows;
  const int Sq = a.Sq, Sk = a.Sk;
  const int off = Sk - Sq;
  // keys this block visits: with kl > 0 key 0 is live on every row (Sq <=
  // Sk under causal), so every row's max is finite from tile 0 on
  int kend = lv.kl;
  if (lv.causal) kend = min(kend, min(q0 + kRows, Sq) + off);
  const int n_kt = (kend + BK - 1) / BK;
  const int wrow0 = q0 + 16 * warp;  // this warp's first query row

  const fm::bf16* qp = static_cast<const fm::bf16*>(a.q) + b * a.q_bs +
                       (long long)h * D;
  const fm::bf16* op = static_cast<const fm::bf16*>(a.dout) + b * a.o_bs +
                       (long long)h * D;
  const fm::bf16* kp = static_cast<const fm::bf16*>(a.k) + b * a.k_bs +
                       (long long)h * D;
  const fm::bf16* vp = static_cast<const fm::bf16*>(a.v) + b * a.v_bs +
                       (long long)h * D;
  const long long rows = ((long long)b * a.H + h) * Sq;

  // key tile kt into stage st; keys past kend are zero-filled
  auto load_kv = [&](int kt, int st) {
    fm::bf16* kd = Ks + st * BK * S;
    fm::bf16* vd = Vs + st * BK * S;
    for (int i = tid; i < BK * CH; i += kMmaThreads) {
      const int r = i / CH, c = (i % CH) * 8, key = kt * BK + r;
      const bool in = key < kend;
      const long long kr = in ? key : 0;
      fm::cp_async16(kd + r * S + c, kp + kr * a.k_rs + c, in);
      fm::cp_async16(vd + r * S + c, vp + kr * a.v_rs + c, in);
    }
  };
  if (n_kt > 0) {
    load_kv(0, 0);
    fm::cp_async_commit();
  }
  // q * scale rounded to bf16 (the plain version's), and dO; rows past Sq
  // are zeros
  for (int i = tid; i < kRows * CH; i += kMmaThreads) {
    const int r = i / CH, c = (i % CH) * 8, row = q0 + r;
    uint4 x = make_uint4(0, 0, 0, 0), y = x;
    if (row < Sq) {
      x = *reinterpret_cast<const uint4*>(qp + row * a.q_rs + c);
      fm::scale8(x, a.scale);
      y = *reinterpret_cast<const uint4*>(op + row * a.o_rs + c);
    }
    *reinterpret_cast<uint4*>(Qs + r * S + c) = x;
    *reinterpret_cast<uint4*>(Os + r * S + c) = y;
  }
  // rows g and g + 8 of the warp: lse and delta (dQ), or the running max
  // m, this lane's part of the running sum l and of rowsum(P o dP)
  float r0[2] = {0.f, 0.f}, r1[2] = {0.f, 0.f}, r2[2] = {0.f, 0.f};
  if constexpr (kStats) {
    r0[0] = r0[1] = -INFINITY;
  } else {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = wrow0 + g + 8 * hr;
      if (row < Sq) {
        r0[hr] = a.lse[rows + row];
        r1[hr] = a.delta[rows + row];
      }
    }
  }
  __syncthreads();
  uint32_t qf[Tile::kRegs ? KD : 1][4], of[Tile::kRegs ? KD : 1][4];
  if constexpr (Tile::kRegs) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      fm::ldmatrix_x4(qf[kk], fm::a_frag(Qs, S, 16 * warp, 16 * kk, lane));
      fm::ldmatrix_x4(of[kk], fm::a_frag(Os, S, 16 * warp, 16 * kk, lane));
    }
  }

  float dq[kStats ? 1 : ND][4];
#pragma unroll
  for (int n = 0; n < (kStats ? 1 : ND); ++n)
    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      load_kv(kt + 1, (kt + 1) & 1);
      fm::cp_async_commit();
      fm::cp_async_wait<1>();
    } else {
      fm::cp_async_wait<0>();
    }
    __syncthreads();
    const fm::bf16* kb = Ks + (kt & 1) * BK * S;
    const fm::bf16* vb = Vs + (kt & 1) * BK * S;
    const int k0 = kt * BK;
    // under causal a warp whose rows all lie left of this tile sees none
    // of its keys
    if (!(lv.causal && k0 > wrow0 + 15 + off)) {
      // S = Q K^T and dP = dO V^T: 16 rows x BK keys
      float s[NK][4], dp[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t aq[4], ao[4];
        if constexpr (Tile::kRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            aq[i] = qf[kk][i];
            ao[i] = of[kk][i];
          }
        } else {
          fm::ldmatrix_x4(aq, fm::a_frag(Qs, S, 16 * warp, 16 * kk, lane));
          fm::ldmatrix_x4(ao, fm::a_frag(Os, S, 16 * warp, 16 * kk, lane));
        }
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          uint32_t bk[4], bv[4];
          fm::ldmatrix_x4(bk, fm::b_pair(kb, S, 16 * j, 16 * kk, lane));
          fm::mma_bf16(s[2 * j], aq, bk[0], bk[1]);
          fm::mma_bf16(s[2 * j + 1], aq, bk[2], bk[3]);
          fm::ldmatrix_x4(bv, fm::b_pair(vb, S, 16 * j, 16 * kk, lane));
          fm::mma_bf16(dp[2 * j], ao, bv[0], bv[1]);
          fm::mma_bf16(dp[2 * j + 1], ao, bv[2], bv[3]);
        }
      }
      // the live test only on a tile that crosses kv_len or this warp's
      // causal diagonal
      const bool edge =
          k0 + BK > lv.kl || (lv.causal && k0 + BK - 1 > wrow0 + off);
      if constexpr (kStats) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = wrow0 + g + 8 * hr;
          float mx = -INFINITY;
#pragma unroll
          for (int n = 0; n < NK; ++n)
#pragma unroll
            for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
              float x = uniform ? 0.f : s[n][e];
              if (edge) {
                const int key = k0 + 8 * n + 2 * t4 + (e & 1);
                if (key >= lv.kl || (lv.causal && key > row + off))
                  x = -INFINITY;  // outside this softmax
              }
              s[n][e] = x;
              mx = fmaxf(mx, x);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          // finite: tile 0 holds key 0, live on every row
          const float m_new = fmaxf(r0[hr], mx);
          const float alpha = exp2f((r0[hr] - m_new) * fm::kLog2e);
          float sum = 0.f, dsum = 0.f;
#pragma unroll
          for (int n = 0; n < NK; ++n)
#pragma unroll
            for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
              const float p = exp2f((s[n][e] - m_new) * fm::kLog2e);
              sum += p;
              dsum = fmaf(p, dp[n][e], dsum);
            }
          r0[hr] = m_new;
          r1[hr] = r1[hr] * alpha + sum;
          r2[hr] = r2[hr] * alpha + dsum;
        }
      } else {
        // P = exp(S - lse) on live pairs, dS = P o (dP - delta), in s
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hr = e >> 1;
            const float x = uniform ? 0.f : s[n][e];
            float p = exp2f((x - r0[hr]) * fm::kLog2e);
            if (edge) {
              const int key = k0 + 8 * n + 2 * t4 + (e & 1);
              const int row = wrow0 + g + 8 * hr;
              if (key >= lv.kl || (lv.causal && key > row + off)) p = 0.f;
            }
            s[n][e] = p * (dp[n][e] - r1[hr]);
          }
        // dQ += dS K, dS rounded to bf16 as the A fragment
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t ag[4];
          fm::acc_to_a(ag, s, kk);
#pragma unroll
          for (int j = 0; j < D / 16; ++j) {
            uint32_t bk[4];
            fm::ldmatrix_x4_trans(bk,
                                  fm::bt_pair(kb, S, 16 * kk, 16 * j, lane));
            fm::mma_bf16(dq[2 * j], ag, bk[0], bk[1]);
            fm::mma_bf16(dq[2 * j + 1], ag, bk[2], bk[3]);
          }
        }
      }
    }
    __syncthreads();  // the stage is free for tile kt + 2
  }

  if constexpr (kStats) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float l = r1[hr], d = r2[hr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      const int row = wrow0 + g + 8 * hr;
      if (t4 == 0 && row < Sq) {
        static_cast<float*>(a.out0)[rows + row] = r0[hr] + logf(l);
        static_cast<float*>(a.out1)[rows + row] = d / l;
      }
    }
  } else {
    // dQ * scale through this warp's own q rows (no other warp reads
    // them), then 16-byte stores of rows below Sq
    fm::bf16* ow = Qs + 16 * warp * S;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<uint32_t*>(ow + (g + 8 * hr) * S + 8 * n + 2 * t4) =
            fm::pack_bf16(dq[n][2 * hr] * a.scale,
                          dq[n][2 * hr + 1] * a.scale);
    __syncwarp();
    const long long hd = (long long)a.H * D;
    fm::bf16* dqp = static_cast<fm::bf16*>(a.out0);
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, c = (i % CH) * 8, row = wrow0 + r;
      if (row < Sq)
        *reinterpret_cast<uint4*>(dqp + ((long long)b * Sq + row) * hd +
                                  (long long)h * D + c) =
            *reinterpret_cast<const uint4*>(ow + r * S + c);
    }
  }
}

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

// dK and dV into a.out0 and a.out1
template <int D, bool kMha>
__device__ __forceinline__ void dkv_mma_body(const Args& a,
                                             unsigned char* smem_raw) {
  using Tile = DkvTile<D>;
  constexpr int S = Tile::kStride;
  constexpr int BQ = Tile::kBQ;
  constexpr int KEYS = Tile::kKeys;
  constexpr int KD = D / 16;           // k-steps of K q^T and V dO^T
  constexpr int NQ = BQ / 8;           // n-tiles of a score row (q rows)
  constexpr int NC = Tile::kCols / 8;  // n-tiles of this warp's dK, dV
  constexpr int CH = D / 8;            // 16-byte chunks of a row
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
  const fm::Live lv = fm::live_keys<kMha>(a.kv_len, a.Sk, a.causal, b);
  const bool uniform = kMha && lv.uniform;
  const bool causal = lv.causal;
  const int kl = lv.kl;

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
          const float x = uniform ? 0.f : s[n][e];
          float p = exp2f((x - ls[r]) * fm::kLog2e);
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

// kernel<<<grid, kMmaThreads, smem>>>(a) after raising its dynamic shared
// memory limit
template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const Args& a,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

inline dim3 q_grid(const Args& a) {
  return dim3((a.Sq + kRows - 1) / kRows, a.H, a.B);
}

template <int D>
dim3 dkv_grid(const Args& a) {
  constexpr int keys = DkvTile<D>::kKeys;
  return dim3((a.Sk + keys - 1) / keys, a.H, a.B);
}

}  // namespace flash_bwd
