// Single-query decode attention over a dense KV cache for Hopper (sm_90a),
// plain C interface: kernel #6.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:_decode_kernel (called
// from _decode_core).  Same function: one query row per (batch, head)
// attends the cached keys below kv_len[b] (float32 lengths compared as
// int32, clamped to [0, Sk]; no kv_len: every key), q scaled in its own
// dtype first, softmax in float32, P rounded to V's dtype before P V.
// Keys at or past kv_len are NEVER read, and a row with kv_len == 0 gives
// O = 0 (the Pallas kernel skips every block and its finalize maps l == 0
// to 0) — unlike mha_block, where an all-masked row is the mean of V.
//
// What bounds it and how: memory, on the live cache bytes; the body is
// csrc/decode_stream.cuh's (one cluster of CTAs per (batch, head), 16-row
// tiles of the cache handed to the ranks round-robin and streamed through
// a cp.async ring, the ranks merged in rank order through distributed
// shared memory), with a tile at b * k_bs + 16 t * k_rs.  The Pallas
// kernel walked the key blocks sequentially for each (batch, head group)
// and padded the single query to 16 sublanes; neither carries over.

#include "decode_stream.cuh"

namespace {

namespace ds = decode_stream;

template <typename T, int D>
__global__ void __launch_bounds__(ds::kThreads, ds::min_blocks(D))
dense_decode_kernel(const ds::Args a) {
  ds::body<T, D, false, ds::stages<T>(D)>(a);
}

template <typename T, int D>
cudaError_t launch(const ds::Args& a, cudaStream_t s) {
  static std::atomic<long long> checked{-1};
  return ds::launch(dense_decode_kernel<T, D>, checked, a,
                    ds::smem_bytes<T>(D, a.ranks, 0), s);
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

// q [B, 1, H*D], k/v [B, Sk, H*D] (last dim contiguous, batch and row
// strides in elements), out [B, 1, H*D] contiguous, kv_len [B] (element
// stride len_s; len_kind 0 float32, 1 int64, 2 int32) or NULL (every key
// live).  ranks: CTAs a cluster, a power of two up to 16.  dtype: 0 =
// float32, 1 = bfloat16.  Returns cudaErrorMisalignedAddress when a K/V
// row does not start on 4 bytes, cudaErrorInvalidConfiguration when a
// cluster cannot be scheduled, else the launch's error.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                void* out, const void* kv_len, int len_kind,
                                int B, int Sk, int H, int D, int ranks,
                                long long q_bs, long long k_bs, long long k_rs,
                                long long v_bs, long long v_rs,
                                long long len_s, float scale, int dtype,
                                void* stream) {
  ds::Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lengths = kv_len;
  a.len_kind = len_kind;
  a.len_s = len_s;
  a.q_bs = q_bs;
  a.k_bs = k_bs;
  a.k_rs = k_rs;
  a.v_bs = v_bs;
  a.v_rs = v_rs;
  a.B = B;
  a.H = H;
  a.reach = Sk;
  a.ranks = ranks;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(D, a, s);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(D, a, s);
  return (int)cudaErrorInvalidValue;
}
