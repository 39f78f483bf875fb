// Single-query decode attention streamed through a thread-block cluster
// (sm_90a): the one body of kernels #6 (flash_decode.cu, a dense cache)
// and #7 (flash_decode_paged.cu, a paged pool read through a block table).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:_decode_kernel (#6)
// and _paged_decode_kernel (#7).  One query row per (batch, head) attends
// the keys below its length; q is scaled in its own dtype, scores and the
// softmax are float32, P is rounded to V's dtype before P V, a row with
// no live key gives O = 0.  Lengths arrive as float32, int64 or int32 and
// compare as int32 after a float32 round trip (the Pallas kernels' astype
// chain), read here, so the wrapper runs no cast kernel.  Keys at or past
// the length are never read.
//
// What bounds it on this card: a key costs 4 D FLOP and 2 D itemsize
// bytes, about 0.5 FLOP a byte in float32 and 1 in bf16, far under the
// card's ridge (~20 FLOP a byte against float32's 67 TFLOP/s, ~295 against
// bf16's tensor cores).  So it is bound by memory (3.35 TB/s) on the live
// K/V bytes, and tensor cores would buy nothing: the design spends its
// effort on keeping bytes in flight.
//
//   * One cluster of `ranks` CTAs per (batch, head), one launch.  The key
//     axis is cut into 16-row tiles (a page of the Scheduler's 16-row
//     pool; a page of bs rows is bs / 16 tiles); tile t goes to rank
//     t % ranks, so a short row still spreads over every rank.  A rank
//     copies only live tiles: one whose tiles are all dead issues no copy
//     and contributes the merge identity.
//   * The prologue waits for one memory latency: q, the length and (#7)
//     the rank's slice of the block table (one clipped block id a tile,
//     kept in shared memory) are loaded together, before any K/V copy.
//   * Each tile's K and V rows of this head go global -> shared with
//     cp.async, 16 bytes a thread where every base and stride allows it
//     (else 8 or 4), into a ring of 24 KB (3 tiles in float32 at D 64, 6
//     in bf16); rows at or past the length are zero-filled, not read.
//   * 4 warps take 4 rows of each tile; a lane owns D / 32 columns as
//     pairs (lane 2l, 2l + 1 of every 64), so a warp reads one row as
//     one contiguous run of shared memory (no bank conflict).  The 4
//     rows' scores are summed over the warp in one butterfly (6 shuffles,
//     not 20), q carries log2(e) so each exponential is one exp2f, and
//     each warp keeps its own float32 online softmax: the loop is short
//     enough in instructions that 8 CTAs an SM keep up with memory.
//     Dead rows are masked by select, never by a zero P.
//   * The CTA merges its warps in warp order into (m, l, acc[D]) and
//     stores it through distributed shared memory into rank 0's staging
//     slot of its rank (after the first phase of a split cluster
//     barrier, arrived at on entry, shows that rank 0 is running).  After
//     a second barrier rank 0 merges the slots in rank order and
//     normalises (l == 0 -> O = 0).  No float atomics and no partials in
//     device memory: a row's output depends on its own inputs and `ranks`
//     alone, never on the batch or on timing.  Every CTA reaches both
//     barriers (no early exit).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_mma.cuh"

namespace decode_stream {

namespace cg = cooperative_groups;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16;                  // rows a tile
constexpr int kRows = kTile / kWarps;      // rows a warp takes of a tile
static_assert(kRows == 4, "row_scores reduces 4 rows a warp");
constexpr int kRingBytes = 24 * 1024;      // shared-memory ring budget
// CTAs an SM must hold: 8 (64 registers a thread) up to D 128, so that
// phase S's 512 CTAs run in one wave on the ~124 SMs a cluster launch
// reaches (the 24 KB ring lets 8 fit; both measured faster than a 32 KB
// ring at 4-6 CTAs an SM); 4 above, where the ring holds only 2 tiles
// and 64 registers would spill
__host__ __device__ constexpr int min_blocks(int d) {
  return d <= 128 ? 8 : 4;
}

// length dtypes (lengths == nullptr: every key of the reach is live)
enum LenKind { kLenF32 = 0, kLenI64 = 1, kLenI32 = 2 };

struct Args {
  const void* q;        // [B, 1, H*D], batch stride q_bs, last dim dense
  const void* k;        // dense: [B, Sk, H*D]; paged: [N, bs, H*D]
  const void* v;
  void* out;            // [B, 1, H*D] contiguous
  const void* table;    // paged: [B, M] block ids (int32 or int64)
  const void* lengths;  // [B] live keys, or nullptr
  long long q_bs;
  long long k_bs, k_rs;  // dense: batch / row stride; paged: block / row
  long long v_bs, v_rs;
  long long tab_bs, tab_cs, len_s;
  int B, H;
  int reach;            // dense: Sk; paged: M * bs
  int bs, N;            // paged: rows a block, blocks in the pool
  int ranks;            // CTAs a cluster (the cluster's x extent)
  int slots;            // paged: block ids a rank holds (shared memory)
  int len_kind, tab64, width;  // width: bytes a cp.async (16, 8 or 4)
  float scale;
};

template <typename T>
__host__ __device__ constexpr int stages(int d) {
  const int tile = 2 * kTile * d * (int)sizeof(T);
  const int s = kRingBytes / tile;
  return s < 2 ? 2 : (s > 8 ? 8 : s);
}

template <typename T>
__host__ __device__ constexpr int ring_bytes(int d) {
  return stages<T>(d) * 2 * kTile * d * (int)sizeof(T);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// two adjacent elements of shared memory as float32
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

constexpr float kLog2e = 1.4426950408889634f;

// The sums over the warp of a lane's 4 partial scores, in 6 shuffles (a
// butterfly that halves the values a lane carries, then a plain
// reduction): lane L ends with the sum of row (L >> 3) & 3.
__device__ __forceinline__ float row_scores(const float (&part)[4],
                                            int lane) {
  const bool hi16 = lane & 16, hi8 = lane & 8;
  float a0 = hi16 ? part[2] : part[0];
  float a1 = hi16 ? part[3] : part[1];
  a0 += __shfl_xor_sync(0xffffffffu, hi16 ? part[0] : part[2], 16);
  a1 += __shfl_xor_sync(0xffffffffu, hi16 ? part[1] : part[3], 16);
  float x = hi8 ? a1 : a0;
  x += __shfl_xor_sync(0xffffffffu, hi8 ? a0 : a1, 8);
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// live keys of row b: the length as float32, then int32, clamped into
// [0, reach]
__device__ __forceinline__ int live_keys(const Args& a, int b) {
  if (a.lengths == nullptr) return a.reach;
  float f;
  if (a.len_kind == kLenF32)
    f = static_cast<const float*>(a.lengths)[b * a.len_s];
  else if (a.len_kind == kLenI64)
    f = (float)static_cast<const long long*>(a.lengths)[b * a.len_s];
  else
    f = (float)static_cast<const int*>(a.lengths)[b * a.len_s];
  return min(a.reach, max(0, (int)f));
}

// block id of table entry (b, j), clipped into [0, N)
__device__ __forceinline__ int block_id(const Args& a, int b, int j) {
  const long long off = b * a.tab_bs + j * a.tab_cs;
  const long long id = a.tab64 ? static_cast<const long long*>(a.table)[off]
                               : static_cast<const int*>(a.table)[off];
  return (int)min(max(id, 0LL), (long long)a.N - 1);
}

// The L2 policy of the K/V copies: each byte is read once, so its lines
// go first when the cache needs room, and the stream neither displaces
// nor forces the write-back of what other kernels keep in the L2.
__device__ __forceinline__ uint64_t stream_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// W bytes global -> shared under `policy`, zero-filled (nothing read) when
// in_bounds is false; 16-byte copies bypass L1 (.cg), narrower ones
// cannot (.ca)
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool in_bounds, uint64_t policy) {
  const uint32_t d = flash_mma::smem_u32(dst);
  const int n = in_bounds ? W : 0;
  if (W == 16)
    asm volatile(
        "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
        ::"r"(d), "l"(src), "r"(n), "l"(policy) : "memory");
  else if (W == 8)
    asm volatile(
        "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 8, %2, %3;\n"
        ::"r"(d), "l"(src), "r"(n), "l"(policy) : "memory");
  else
    asm volatile(
        "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2, %3;\n"
        ::"r"(d), "l"(src), "r"(n), "l"(policy) : "memory");
}

// Copy tile rows [0, 16) of K and V (this head's D columns) into the ring
// slot: W bytes a cp.async; rows at or past `live` are zero-filled and
// read nothing (their source is the tile's row 0, always in bounds).
template <typename T, int D, int W>
__device__ __forceinline__ void copy_tile(T* ks, T* vs, const T* kp,
                                          const T* vp, long long k_rs,
                                          long long v_rs, int live,
                                          uint64_t policy) {
  constexpr int kPerRow = D * (int)sizeof(T) / W;
  constexpr int kElems = W / (int)sizeof(T);
#pragma unroll
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kElems;
    const bool in = r < live;
    const long long kr = in ? r * k_rs : 0, vr = in ? r * v_rs : 0;
    cp_async<W>(ks + r * D + c, kp + kr + c, in, policy);
    cp_async<W>(vs + r * D + c, vp + vr + c, in, policy);
  }
}

// Dynamic shared memory: the ring, then rank 0's staging of every rank's
// (acc[D], m, l), then (#7) the rank's block ids.
template <typename T>
__host__ __device__ constexpr int smem_bytes(int d, int ranks, int slots) {
  return ring_bytes<T>(d) + ranks * (4 * d + 8) + (4 * slots + 15) / 16 * 16;
}

// barrier.cluster in two halves: arrive (relaxed: it only marks this CTA
// as started; release: this CTA's shared-memory stores before it are seen
// by every CTA that waits) and wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The body: grid (ranks, H, B), cluster (ranks, 1, 1), kThreads threads,
// smem_bytes<T>(D, ranks, slots) bytes of dynamic shared memory.
template <typename T, int D, bool kPaged, int kStages>
__device__ __forceinline__ void body(const Args& a) {
  constexpr int DP = D / 64;  // column pairs a lane owns
  constexpr int kTileElems = kTile * D;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float w_m[kWarps], w_l[kWarps];
  __shared__ float2 w_acc[kWarps][D / 2];

  cluster_arrive_relaxed();  // this CTA has started (waited on at the end)
  T* ring = reinterpret_cast<T*>(smem);
  float2* stage_acc = reinterpret_cast<float2*>(smem + ring_bytes<T>(D));
  float* stage_ml = reinterpret_cast<float*>(stage_acc + a.ranks * (D / 2));
  int* pages = reinterpret_cast<int*>(stage_ml + 2 * a.ranks);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // The loads that depend on nothing go out together, so the prologue
  // waits for one memory latency, not three: q (lane columns 64 i + 2 lane),
  // #7's block ids of every tile this rank could own, and the length.
  const T* qp = static_cast<const T*>(a.q) + b * a.q_bs + (long long)h * D;
  T q_in[2 * DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    q_in[2 * i] = qp[64 * i + 2 * lane];
    q_in[2 * i + 1] = qp[64 * i + 2 * lane + 1];
  }
  if (kPaged) {
    const int per_block = a.bs / kTile, reach_tiles = a.reach / kTile;
    for (int i = threadIdx.x; i < a.slots; i += kThreads) {
      const int t = rank + i * a.ranks;
      if (t < reach_tiles) pages[i] = block_id(a, b, t / per_block);
    }
  }
  const int kl = live_keys(a, b);
  const int n_tiles = (kl + kTile - 1) / kTile;
  // this rank's tiles: rank, rank + ranks, ... < n_tiles
  const int mine = rank < n_tiles ? (n_tiles - 1 - rank) / a.ranks + 1 : 0;
  if (kPaged) __syncthreads();  // pages[] before the first copy

  const T* kbase = static_cast<const T*>(a.k) + (long long)h * D;
  const T* vbase = static_cast<const T*>(a.v) + (long long)h * D;
  const uint64_t policy = stream_policy();
  auto issue = [&](int i) {  // my i-th tile into ring slot i % kStages
    const int t = rank + i * a.ranks;
    const T* kp;
    const T* vp;
    if (kPaged) {
      const int row0 = (t * kTile) % a.bs;
      kp = kbase + pages[i] * a.k_bs + row0 * a.k_rs;
      vp = vbase + pages[i] * a.v_bs + row0 * a.v_rs;
    } else {
      kp = kbase + b * a.k_bs + (long long)t * kTile * a.k_rs;
      vp = vbase + b * a.v_bs + (long long)t * kTile * a.v_rs;
    }
    T* ks = ring + (i % kStages) * 2 * kTileElems;
    const int live = kl - t * kTile;
    T* vs = ks + kTileElems;
    if (a.width == 16)
      copy_tile<T, D, 16>(ks, vs, kp, vp, a.k_rs, a.v_rs, live, policy);
    else if (a.width == 8)
      copy_tile<T, D, 8>(ks, vs, kp, vp, a.k_rs, a.v_rs, live, policy);
    else
      copy_tile<T, D, 4>(ks, vs, kp, vp, a.k_rs, a.v_rs, live, policy);
  };

#pragma unroll 1
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < mine) issue(i);
    flash_mma::cp_async_commit();
  }

  // q scaled in its own dtype, then float32 and by log2(e): scores and
  // their maxima are in base 2, so every exponential is one exp2f
  float2 qv[DP], acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qv[i].x = to_f(from_f<T>(to_f(q_in[2 * i]) * a.scale)) * kLog2e;
    qv[i].y = to_f(from_f<T>(to_f(q_in[2 * i + 1]) * a.scale)) * kLog2e;
    acc[i] = make_float2(0.f, 0.f);
  }
  float m = -INFINITY, l = 0.f;
  const int my_row = (lane >> 3) & 3;  // the row whose score a lane ends with

#pragma unroll 1
  for (int i = 0; i < mine; ++i) {
    flash_mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed for all; slot (i - 1) % S is free
    if (i + kStages - 1 < mine) issue(i + kStages - 1);
    flash_mma::cp_async_commit();

    const int t = rank + i * a.ranks;
    const int row0 = warp * kRows;
    const int live = kl - t * kTile - row0;  // live rows of mine, from 0
    if (live <= 0) continue;                 // warp-uniform
    const T* ks = ring + (i % kStages) * 2 * kTileElems + row0 * D;
    const T* vs = ks + kTileElems;
    float part[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      part[u] = 0.f;
#pragma unroll
      for (int j = 0; j < DP; ++j) {
        const float2 kv = pair(ks + u * D + 64 * j + 2 * lane);
        part[u] = fmaf(qv[j].x, kv.x, part[u]);
        part[u] = fmaf(qv[j].y, kv.y, part[u]);
      }
    }
    // the 4 rows' scores, or -inf where dead, one a lane group of 8
    const float s = row_scores(part, lane);
    const float s_live = my_row < live ? s : -INFINITY;
    float mx = fmaxf(s_live, __shfl_xor_sync(0xffffffffu, s_live, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float m_new = fmaxf(m, mx);     // finite: row 0 of mine is live
    const float alpha = exp2f(m - m_new);  // 0 on the first live tile
    const float p_mine = my_row < live ? exp2f(s - m_new) : 0.f;
    l *= alpha;
#pragma unroll
    for (int j = 0; j < DP; ++j) {
      acc[j].x *= alpha;
      acc[j].y *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (u >= live) break;  // warp-uniform select of the live rows
      const float p = __shfl_sync(0xffffffffu, p_mine, 8 * u);
      l += p;
      const float pv = round_to(p, (T*)nullptr);  // P in V's dtype
#pragma unroll
      for (int j = 0; j < DP; ++j) {
        const float2 vv = pair(vs + u * D + 64 * j + 2 * lane);
        acc[j].x = fmaf(pv, vv.x, acc[j].x);
        acc[j].y = fmaf(pv, vv.y, acc[j].y);
      }
    }
    m = m_new;
  }
  flash_mma::cp_async_wait<0>();

  // the CTA's warps, merged in warp order
  if (lane == 0) {
    w_m[warp] = m;
    w_l[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < DP; ++j) w_acc[warp][32 * j + lane] = acc[j];
  __syncthreads();
  float mx = -INFINITY, L = 0.f;
  float2 A = make_float2(0.f, 0.f);
  if (threadIdx.x < D / 2) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, w_m[w]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float sc = w_m[w] == -INFINITY ? 0.f : exp2f(w_m[w] - mx);
      L = fmaf(w_l[w], sc, L);
      A.x = fmaf(w_acc[w][threadIdx.x].x, sc, A.x);
      A.y = fmaf(w_acc[w][threadIdx.x].y, sc, A.y);
    }
  }
  // Every rank has started (first barrier phase), so rank 0's shared
  // memory exists: push this rank's triple into rank 0's staging slot.
  cluster_wait();
  if (threadIdx.x < D / 2) {
    cluster.map_shared_rank(stage_acc, 0)[rank * (D / 2) + threadIdx.x] = A;
    if (threadIdx.x == 0) {
      float* ml = cluster.map_shared_rank(stage_ml, 0) + 2 * rank;
      ml[0] = mx;
      ml[1] = L;
    }
  }
  cluster_arrive_release();
  cluster_wait();  // every rank's triple is in rank 0's shared memory
  if (rank != 0 || threadIdx.x >= D / 2) return;

  mx = -INFINITY;
  for (int r = 0; r < a.ranks; ++r) mx = fmaxf(mx, stage_ml[2 * r]);
  L = 0.f;
  A = make_float2(0.f, 0.f);
  for (int r = 0; r < a.ranks; ++r) {  // in rank order
    const float mr = stage_ml[2 * r];
    const float sc = mr == -INFINITY ? 0.f : exp2f(mr - mx);
    const float2 ra = stage_acc[r * (D / 2) + threadIdx.x];
    L = fmaf(stage_ml[2 * r + 1], sc, L);
    A.x = fmaf(ra.x, sc, A.x);
    A.y = fmaf(ra.y, sc, A.y);
  }
  const float inv = L == 0.f ? 0.f : 1.f / L;  // no live key -> O = 0
  T* op = static_cast<T*>(a.out) + ((long long)b * a.H + h) * D;
  op[2 * threadIdx.x] = from_f<T>(A.x * inv);
  op[2 * threadIdx.x + 1] = from_f<T>(A.y * inv);
}

// The widest cp.async (16, 8 or 4 bytes) that every K/V row start allows,
// or 0 when a row does not start on 4 bytes.
inline int copy_width(const Args& a, int itemsize) {
  for (int w = 16; w >= 4; w /= 2) {
    const long long e = w / itemsize;  // elements a copy
    if (reinterpret_cast<uintptr_t>(a.k) % w == 0 &&
        reinterpret_cast<uintptr_t>(a.v) % w == 0 && a.k_bs % e == 0 &&
        a.k_rs % e == 0 && a.v_bs % e == 0 && a.v_rs % e == 0)
      return w;
  }
  return 0;
}

// Launch `kern` as one cluster of a.ranks CTAs per (head, batch).  The
// first launch of each (shared memory, ranks) asks the occupancy
// calculator whether one such cluster fits an SM group at all; a launch it
// refuses returns cudaErrorInvalidConfiguration and never runs.
template <typename Kern>
cudaError_t launch(Kern kern, std::atomic<long long>& checked, Args a,
                   size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.ranks, a.H, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const long long key = ((long long)smem << 8) | a.ranks;
  if (checked.load() != key) {
    cudaError_t err = cudaSuccess;
    if (a.ranks > 8)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int clusters = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err == cudaSuccess && clusters < 1)
      err = cudaErrorInvalidConfiguration;
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch must not see it
      return err;
    }
    checked.store(key);
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace decode_stream
