// The bf16 tensor-core body of the attention forward (sm_90a), shared by
// two sources, each of which wraps it in a __global__ kernel of its own
// name (so a profile and the launch counters tell the two paths apart):
//   * flash_attention_fwd.cu: flash_fwd_mma_kernel (kernel #3), flash mode,
//     with the row logsumexp;
//   * mha_block.cu: mha_fwd_mma_kernel (#1), mha_block mode, no lse.
//
// The function, from q, k, v [B, S, H*D] and optional key lengths [B]:
//   S = (q * scale) K^T in float32, q scaled and rounded to bf16 first;
//   softmax over each row's live keys (flash_mma.cuh's live_keys);
//   O = P V with P rounded to bf16 before the product.
// Mask modes (the template flag kMha):
//   * flash (kMha false): one sweep over the key tiles with an online
//     softmax (running max m, sum l, rescaled accumulator); P is rounded
//     unnormalised, O = acc / l and lse = m + log l at the end, as the
//     Pallas flash kernel does (flash_attention.py:_fwd_kernel).  A
//     kv_len-0 row visits no key: O = 0 and lse = -1e30;
//   * mha_block (kMha true): the Pallas kernel rounds the NORMALISED P to
//     V's dtype (mha_block.py:116), and rounding exp(S - m) before the
//     division can cost one more bf16 step of the output.  So the block
//     sweeps its live key tiles twice: first S = Q K^T alone for the row
//     max and sum (lse = m + log l, K only), then S again and
//     P = exp2(S log2e - lse log2e), rounded to bf16 as the A fragment of
//     O += P V; no final division, no lse output.  A key_len <= 0 image is
//     visited uniform (every key, causal off, scores 0): its rows come out
//     as the mean of V over every key, as the finite -1e30 mask gives.
//
// Design (mma.sync m16n8k16, bf16 in, float32 accumulate; fragment
// helpers in flash_mma.cuh):
//   * grid (q tiles, heads, batch), 64 query rows a block over 4 warps, 16
//     rows a warp; under causal the q tiles launch heaviest (last) first;
//   * Q is read once, scaled and rounded to bf16 as the plain version
//     does, and kept in registers as mma A fragments (at D 192 and 256 it
//     stays in shared memory and is read with ldmatrix per k-step, so that
//     the D/2 output accumulators fit the register file);
//   * K and V stream through a two-stage cp.async ring of key tiles, 64
//     keys at D <= 128 and 32 at D 192 / 256; tile j+1's copy is issued
//     before tile j's math (in mha_block mode across the two sweeps too;
//     the statistics sweep copies no V); rows padded by 16 bytes
//     (flash_mma.cuh), so ldmatrix is free of bank conflicts.  Occupancy
//     hides the copies' latency better than depth: at D 64 four blocks
//     fit an SM (46 KB of shared memory, registers held to 128), where a
//     deeper ring would leave fewer;
//   * S = Q K^T stays in registers (B fragments of K by ldmatrix); the
//     causal and key-length mask is applied only on tiles that cross the
//     diagonal or the last live key; tiles past the block's last live key
//     are never loaded; in mha_block mode a warp whose 16 rows all lie
//     left of a causal tile skips its math;
//   * the softmax runs on the accumulator fragments: a row's max and sum
//     take two __shfl_xor within its quad; P is rounded to bf16 and
//     repacked in registers as the A fragment of P V (V's B fragments by
//     ldmatrix.trans).  No score tile in shared memory, no barrier
//     between the two products (two a tile: data arrived, stage free);
//   * the epilogue stages O through the warp's own Q rows and writes
//     16-byte chunks.
// Every operand row must start on 16 bytes (cp.async and the Q loads move
// 16 bytes): rows_aligned() checks it for the entries, which return
// cudaErrorMisalignedAddress otherwise.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_mma.cuh"

namespace flash_fwd {

namespace fm = flash_mma;

constexpr float kMasked = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;           // [B, H, Sq] float32 (flash mode), or unused
  const float* kv_len;  // [B] or NULL
  int B, Sq, Sk, H;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;
  float scale;
  int causal;
};

constexpr int kWarps = 4;                // 16 query rows each
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kMmaBQ = 16 * kWarps;      // query rows per block

template <int D>
struct MmaTile {
  static constexpr int kBK = D <= 128 ? 64 : 32;  // keys per streamed tile
  static constexpr bool kQRegs = D <= 128;        // Q as register fragments
  static constexpr int kStride = D + 8;           // padded shared row, bf16
  // Q tile, then two stages of K and V
  static constexpr size_t kSmem =
      sizeof(fm::bf16) * (size_t)(kMmaBQ + 4 * kBK) * kStride;
  // at D 64 four blocks fit an SM's shared memory: the kernels hold the
  // registers to 128 a thread so that they fit its register file too
  static constexpr int kMinBlocks = D == 64 ? 4 : 1;
};

template <int D, bool kMha>
__device__ __forceinline__ void fwd_mma_body(const Args& a,
                                             unsigned char* smem_raw) {
  using Tile = MmaTile<D>;
  constexpr int BK = Tile::kBK;
  constexpr int S = Tile::kStride;
  constexpr int KD = D / 16;     // k-steps of Q K^T
  constexpr int NK = BK / 8;     // n-tiles of a score row
  constexpr int ND = D / 8;      // n-tiles of an output row
  constexpr int CH = D / 8;      // 16-byte chunks of a row
  fm::bf16* Qs = reinterpret_cast<fm::bf16*>(smem_raw);  // [kMmaBQ][S]
  fm::bf16* Ks = Qs + kMmaBQ * S;                         // [2][BK][S]
  fm::bf16* Vs = Ks + 2 * BK * S;                         // [2][BK][S]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const fm::Live lv = fm::live_keys<kMha>(a.kv_len, a.Sk, a.causal, b);
  const bool uniform = kMha && lv.uniform;
  // heaviest first under causal: the last q tile sees the most keys
  const int q0 =
      (lv.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kMmaBQ;
  const int Sq = a.Sq, Sk = a.Sk;
  const int off = Sk - Sq;
  // keys this block visits: with kl > 0 key 0 is live on every row (Sq <=
  // Sk under causal keeps it on the diagonal's side), so a row's running
  // max is finite from tile 0 on; a flash kv_len-0 image visits nothing
  int kend = lv.kl;
  if (lv.causal) kend = min(kend, min(q0 + kMmaBQ, Sq) + off);
  const int n_kt = (kend + BK - 1) / BK;
  // flash: one sweep; mha_block: the statistics sweep, then the P V sweep
  const int n_it = kMha ? 2 * n_kt : n_kt;
  const int wrow0 = q0 + 16 * warp;  // this warp's first query row

  const fm::bf16* qp = static_cast<const fm::bf16*>(a.q) + b * a.q_bs +
                       (long long)h * D;
  const fm::bf16* kp = static_cast<const fm::bf16*>(a.k) + b * a.k_bs +
                       (long long)h * D;
  const fm::bf16* vp = static_cast<const fm::bf16*>(a.v) + b * a.v_bs +
                       (long long)h * D;

  // the key tile of sweep step it into stage st (V only where P V runs);
  // rows past kend are zero-filled, so that P V adds exactly 0 for them
  auto load_kv = [&](int it, int st) {
    const int kt = kMha && it >= n_kt ? it - n_kt : it;
    const bool with_v = !kMha || it >= n_kt;
    fm::bf16* kd = Ks + st * BK * S;
    fm::bf16* vd = Vs + st * BK * S;
    for (int i = tid; i < BK * CH; i += kMmaThreads) {
      const int r = i / CH, c = (i % CH) * 8, key = kt * BK + r;
      const bool in = key < kend;
      const long long kr = in ? key : 0;
      fm::cp_async16(kd + r * S + c, kp + kr * a.k_rs + c, in);
      if (with_v) fm::cp_async16(vd + r * S + c, vp + kr * a.v_rs + c, in);
    }
  };
  if (n_it > 0) {
    load_kv(0, 0);
    fm::cp_async_commit();
  }
  // Q: scaled and rounded in bf16 (the plain version's q * scale)
  for (int i = tid; i < kMmaBQ * CH; i += kMmaThreads) {
    const int r = i / CH, c = (i % CH) * 8, row = q0 + r;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row < Sq) {
      x = *reinterpret_cast<const uint4*>(qp + row * a.q_rs + c);
      fm::scale8(x, a.scale);
    }
    *reinterpret_cast<uint4*>(Qs + r * S + c) = x;
  }
  __syncthreads();
  uint32_t qf[Tile::kQRegs ? KD : 1][4];
  if constexpr (Tile::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      fm::ldmatrix_x4(qf[kk], fm::a_frag(Qs, S, 16 * warp, 16 * kk, lane));
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // rows g and g + 8 of the warp: running max (natural units) and this
  // lane's part of the running sum; mha_block mode: then lse * log2e
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float lse2[2] = {0.f, 0.f};

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {
      load_kv(it + 1, (it + 1) & 1);
      fm::cp_async_commit();
      fm::cp_async_wait<1>();
    } else {
      fm::cp_async_wait<0>();
    }
    __syncthreads();
    const fm::bf16* kb = Ks + (it & 1) * BK * S;
    const fm::bf16* vb = Vs + (it & 1) * BK * S;
    const bool pv = !kMha || it >= n_kt;  // this step runs O += P V
    const int k0 = (kMha && it >= n_kt ? it - n_kt : it) * BK;

    // under causal a warp whose rows all lie left of this tile sees none
    // of its keys (mha_block mode skips its math; flash mode masks it)
    if (!(kMha && lv.causal && k0 > wrow0 + 15 + off)) {
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t aq[4];
        if constexpr (Tile::kQRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) aq[i] = qf[kk][i];
        } else {
          fm::ldmatrix_x4(aq, fm::a_frag(Qs, S, 16 * warp, 16 * kk, lane));
        }
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          uint32_t bk[4];
          fm::ldmatrix_x4(bk, fm::b_pair(kb, S, 16 * j, 16 * kk, lane));
          fm::mma_bf16(s[2 * j], aq, bk[0], bk[1]);
          fm::mma_bf16(s[2 * j + 1], aq, bk[2], bk[3]);
        }
      }

      if constexpr (kMha) {
        // the live test only on a tile that crosses the last live key or
        // this warp's causal diagonal; dead pairs leave the softmax
        const bool edge =
            k0 + BK > lv.kl || (lv.causal && k0 + BK - 1 > wrow0 + off);
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = uniform ? 0.f : s[n][e];
            if (edge) {
              const int key = k0 + 8 * n + 2 * t4 + (e & 1);
              const int row = wrow0 + g + 8 * (e >> 1);
              if (key >= lv.kl || (lv.causal && key > row + off))
                x = -INFINITY;
            }
            // the P V sweep: P = exp(S - lse), normalised, 0 if dead
            s[n][e] = pv ? exp2f(fmaf(x, fm::kLog2e, -lse2[e >> 1])) : x;
          }
        if (!pv) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            float mx = -INFINITY;
#pragma unroll
            for (int n = 0; n < NK; ++n)
              mx = fmaxf(mx, fmaxf(s[n][2 * hr], s[n][2 * hr + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            // finite: tile 0 holds key 0, live on every row
            const float m_new = fmaxf(m_run[hr], mx);
            const float alpha = exp2f((m_run[hr] - m_new) * fm::kLog2e);
            float sum = 0.f;
#pragma unroll
            for (int n = 0; n < NK; ++n)
#pragma unroll
              for (int e = 2 * hr; e < 2 * hr + 2; ++e)
                sum += exp2f((s[n][e] - m_new) * fm::kLog2e);
            l_run[hr] = l_run[hr] * alpha + sum;
            m_run[hr] = m_new;
          }
        }
      } else {
        // mask only a tile that crosses kend or this warp's causal diagonal
        if (k0 + BK > kend || (lv.causal && k0 + BK - 1 > wrow0 + off)) {
#pragma unroll
          for (int n = 0; n < NK; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + 8 * n + 2 * t4 + (e & 1);
              const int row = wrow0 + g + 8 * (e >> 1);
              if (key >= kend) {
                s[n][e] = -INFINITY;  // not visited: outside this softmax
              } else if (lv.causal && key > row + off) {
                s[n][e] = kMasked;
              }
            }
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float mx = -INFINITY;
#pragma unroll
          for (int n = 0; n < NK; ++n)
            mx = fmaxf(mx, fmaxf(s[n][2 * hr], s[n][2 * hr + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_run[hr], mx);
          const float alpha = exp2f((m_run[hr] - m_new) * fm::kLog2e);  // 0 first
          const float mb = m_new * fm::kLog2e;
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < NK; ++n)
#pragma unroll
            for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
              const float p = exp2f(fmaf(s[n][e], fm::kLog2e, -mb));
              s[n][e] = p;
              sum += p;
            }
          l_run[hr] = l_run[hr] * alpha + sum;
          m_run[hr] = m_new;
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            o[n][2 * hr] *= alpha;
            o[n][2 * hr + 1] *= alpha;
          }
        }
      }
      if (pv) {
        // O += P V, P rounded to bf16 in registers
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t ap[4];
          fm::acc_to_a(ap, s, kk);
#pragma unroll
          for (int j = 0; j < D / 16; ++j) {
            uint32_t bv[4];
            fm::ldmatrix_x4_trans(bv, fm::bt_pair(vb, S, 16 * kk, 16 * j, lane));
            fm::mma_bf16(o[2 * j], ap, bv[0], bv[1]);
            fm::mma_bf16(o[2 * j + 1], ap, bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // the stage is free for step it + 2
    if (kMha && it == n_kt - 1) {
      // end of the statistics sweep: lse of rows g and g + 8, log2 units
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float l = l_run[hr];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        lse2[hr] = fmaf(m_run[hr], fm::kLog2e, log2f(l));
      }
    }
  }

  // epilogue: flash mode divides by the full row sums and writes lse;
  // then O through this warp's own Q rows into 16-byte stores
  float inv[2] = {1.f, 1.f};
  if constexpr (!kMha) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float l = l_run[hr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[hr] = l == 0.f ? 0.f : 1.f / l;  // no live key -> O = 0
      const int row = wrow0 + g + 8 * hr;
      if (t4 == 0 && row < Sq)
        a.lse[((long long)b * a.H + h) * Sq + row] =
            l == 0.f ? kMasked : m_run[hr] + logf(l);
    }
  }
  fm::bf16* ow = Qs + 16 * warp * S;
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<uint32_t*>(ow + (g + 8 * hr) * S + 8 * n + 2 * t4) =
          fm::pack_bf16(o[n][2 * hr] * inv[hr], o[n][2 * hr + 1] * inv[hr]);
  __syncwarp();
  const long long hd = (long long)a.H * D;
  fm::bf16* op = static_cast<fm::bf16*>(a.out);
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8, row = wrow0 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(op + ((long long)b * Sq + row) * hd +
                                (long long)h * D + c) =
          *reinterpret_cast<const uint4*>(ow + r * S + c);
  }
}

// every operand row starts on 16 bytes
inline bool rows_aligned(const Args& a) {
  return fm::aligned16(a.q, a.q_bs, a.q_rs) &&
         fm::aligned16(a.k, a.k_bs, a.k_rs) &&
         fm::aligned16(a.v, a.v_bs, a.v_rs) && fm::aligned16(a.out, 0, 0);
}

// one launch of a kernel that wraps fwd_mma_body<D, ...>
template <int D, typename Kernel>
cudaError_t launch_mma(Kernel kernel, const Args& a, cudaStream_t stream) {
  constexpr size_t smem = MmaTile<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + kMmaBQ - 1) / kMmaBQ, a.H, a.B);
  kernel<<<grid, kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace flash_fwd
