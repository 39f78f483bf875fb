// Single-query decode attention over a paged KV pool for Hopper (sm_90a),
// plain C interface: kernel #7.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:_paged_decode_kernel
// (called from flash_decode_paged).  Same function: one query row per
// (batch, head) attends the keys of its block chain: logical key position
// p of row b lives in pool block table[b, p / bs], row p % bs.  Table
// entries are clipped into [0, N) (int32 or int64 tables, read as they
// are); positions at or past lengths[b] (float32, int64 or int32 lengths,
// compared as int32 after a float32 round trip, capped at M * bs, the
// table's reach) are NEVER read, so stale or junk entries past
// ceil(len / bs) cannot change the output, and a row with lengths[b] == 0
// gives O = 0.  q is scaled in its own dtype first, scores and softmax are
// float32, P is rounded to V's dtype before P V, as in the Pallas kernel.
//
// What bounds it and how: memory, on the live pool bytes; the body is
// csrc/decode_stream.cuh's (one cluster of CTAs per (batch, head), 16-row
// tiles handed to the ranks round-robin and streamed through a cp.async
// ring, the ranks merged in rank order through distributed shared
// memory).  Each CTA first reads the block ids of every tile it could own
// into shared memory, one table entry a tile, so no K/V address waits on
// a table read inside the loop.  The Pallas kernel streamed one pool block
// per grid step, its DMA index map reading the table from scalar
// prefetch, sequentially per (batch, head group).  No dense
// [B, M * bs, H * D] view is ever built.

#include "decode_stream.cuh"

namespace {

namespace ds = decode_stream;

template <typename T, int D>
__global__ void __launch_bounds__(ds::kThreads, ds::min_blocks(D))
paged_decode_kernel(const ds::Args a) {
  ds::body<T, D, true, ds::stages<T>(D)>(a);
}

template <typename T, int D>
cudaError_t launch(const ds::Args& a, cudaStream_t s) {
  static std::atomic<long long> checked{-1};
  return ds::launch(paged_decode_kernel<T, D>, checked, a,
                    ds::smem_bytes<T>(D, a.ranks, a.slots), s);
}

template <typename T>
cudaError_t dispatch_d(int D, ds::Args a, cudaStream_t s) {
  a.width = ds::copy_width(a, sizeof(T));
  if (a.width == 0) return cudaErrorMisalignedAddress;
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
// and row strides in elements, last dim contiguous, bs a multiple of 16),
// table [B, M] (strides tab_bs, tab_cs; tab64 1 for int64, 0 for int32),
// lengths [B] (element stride len_s; len_kind 0 float32, 1 int64, 2
// int32), out [B, 1, H*D] contiguous.  ranks: CTAs a cluster, a power of
// two up to 16; slots: the most tiles a rank can hold, ceil(M * bs / 16 /
// ranks).  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaErrorMisalignedAddress when a K/V row does not start on 4 bytes,
// cudaErrorInvalidConfiguration when a cluster cannot be scheduled, else
// the launch's error.
extern "C" int flash_decode_paged_fwd(
    const void* q, const void* k, const void* v, void* out, const void* table,
    int tab64, const void* lengths, int len_kind, int B, int N, int bs, int M,
    int H, int D, int ranks, int slots, long long q_bs, long long k_blk,
    long long k_rs, long long v_blk, long long v_rs, long long tab_bs,
    long long tab_cs, long long len_s, float scale, int dtype, void* stream) {
  if (bs % ds::kTile != 0) return (int)cudaErrorInvalidValue;
  ds::Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.table = table;
  a.tab64 = tab64;
  a.tab_bs = tab_bs;
  a.tab_cs = tab_cs;
  a.lengths = lengths;
  a.len_kind = len_kind;
  a.len_s = len_s;
  a.q_bs = q_bs;
  a.k_bs = k_blk;
  a.k_rs = k_rs;
  a.v_bs = v_blk;
  a.v_rs = v_rs;
  a.B = B;
  a.H = H;
  a.reach = M * bs;
  a.bs = bs;
  a.N = N;
  a.ranks = ranks;
  a.slots = slots;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(D, a, s);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(D, a, s);
  return (int)cudaErrorInvalidValue;
}
