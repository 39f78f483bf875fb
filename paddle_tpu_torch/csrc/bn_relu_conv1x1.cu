// Batch-norm affine + relu folded into a 1x1 convolution, for Hopper
// (sm_90a), plain C interface.
//
// Replaces tools/conv1x1_fuse_probe.py:fused_kernel (called from
// pallas_bn_relu_conv1x1).  Same function: for y [B, C, HW], per-channel
// scale/bias [C] (float32) and w [C, K],
//   a = relu(float(y) * scale + bias), rounded to w's dtype,
//   z[b, k, p] = sum_c w[c, k] * a[b, c, p], summed in float32,
// written in y's dtype as [B, K, HW].  The activation a is made in
// registers as each y tile is loaded and lives only in shared memory: it is
// never written to device memory, which is the point of the kernel.
//
// What bounds it on this card: at ResNet-50's conv3 sites (batch 256,
// bf16) it reads y and w once and writes z once, 66-514 MB against 26.3
// GFLOP, so the 56x56, 28x28 and 14x14 sites are bound by memory bandwidth
// (3.35 TB/s) and the 7x7 one by the bf16 tensor cores (989 TFLOP/s).  The
// Pallas kernel walked a (B, HW/512) grid with the whole of w in VMEM; on
// Hopper a block holds at most 227 KB, so:
//   * the product is a GEMM with M = K (output channels), N = B*HW (every
//     pixel of every image, flattened, so HW = 49 or 196 leaves no ragged
//     tile per image) and a reduction over C; one block computes a
//     128 x 64 tile of z, looping over C in chunks of 32;
//   * each chunk's y tile is loaded (coalesced along the pixels),
//     transformed in float32 (scale, bias and relu, with the product and
//     the sum rounded separately, as the plain version's two ops) and
//     stored as w's dtype into shared memory, transposed so that the
//     tensor-core fragments read 32-bit pairs; the next chunk's loads are
//     issued before this chunk's products (register prefetch);
//   * bf16: 8 warps, each a 32 x 32 sub-tile of mma.sync m16n8k16 with
//     float32 accumulators; float32: the same sub-tiles with SIMT FMAs in
//     full float32 (no TF32);
//   * the tile of z is staged through shared memory and written along the
//     pixels, coalesced; consecutive blocks share a y tile (the grid walks
//     the output channels fastest), so its re-reads come from L2.
// Channels past C read as 0 on both operands, pixels past B*HW and output
// channels past K are masked.  wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;   // output channels per block
constexpr int kBN = 64;    // pixels per block
constexpr int kBK = 32;    // input channels per chunk
constexpr int kThreads = 256;
constexpr int kYRows = kBK * kBN / kThreads;  // y elements a thread loads
constexpr int kWRows = kBK * kBM / kThreads;  // w elements a thread loads

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

template <typename T> struct Smem {
  static constexpr int kLd = kBK + (sizeof(T) == 2 ? 8 : 4);  // staging row
  static constexpr int kLdC = kBN + 4;                         // z tile row
  static constexpr int kStage = (kBM + kBN) * kLd * (int)sizeof(T);
  static constexpr int kOut = kBM * kLdC * (int)sizeof(T);
  static constexpr int kBytes = kStage > kOut ? kStage : kOut;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[mt][nt][4] holds the m16n8 accumulator fragment layout: element
// (h * 2 + j) is row g + 8 h, column tig * 2 + j of that sub-tile.
__device__ __forceinline__ void chunk_product(
    __nv_bfloat16 (*sa)[Smem<__nv_bfloat16>::kLd],
    __nv_bfloat16 (*sb)[Smem<__nv_bfloat16>::kLd], int m_off,
    int n_off, int g, int tig, float (*acc)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = m_off + mt * 16 + g;
      a[mt][0] = ld32(&sa[r][kk + tig * 2]);
      a[mt][1] = ld32(&sa[r + 8][kk + tig * 2]);
      a[mt][2] = ld32(&sa[r][kk + tig * 2 + 8]);
      a[mt][3] = ld32(&sa[r + 8][kk + tig * 2 + 8]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n_off + nt * 8 + g;
      b[nt][0] = ld32(&sb[col][kk + tig * 2]);
      b[nt][1] = ld32(&sb[col][kk + tig * 2 + 8]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
  }
}

__device__ __forceinline__ void chunk_product(
    float (*sa)[Smem<float>::kLd], float (*sb)[Smem<float>::kLd],
    int m_off, int n_off, int g, int tig, float (*acc)[4][4]) {
#pragma unroll 4
  for (int k = 0; k < kBK; ++k) {
    float av[2][2], bv[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) av[mt][h] = sa[m_off + mt * 16 + g + 8 * h][k];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) bv[nt][j] = sb[n_off + nt * 8 + tig * 2 + j][k];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            acc[mt][nt][h * 2 + j] =
                fmaf(av[mt][h], bv[nt][j], acc[mt][nt][h * 2 + j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_relu_conv1x1_kernel(const T* __restrict__ y, const float* __restrict__ scale,
                       const float* __restrict__ bias, const T* __restrict__ w,
                       T* __restrict__ z, int C, int K, int HW, long long N,
                       int m_tiles) {
  using S = Smem<T>;
  __shared__ __align__(16) unsigned char smem[S::kBytes];
  T (*sa)[S::kLd] = reinterpret_cast<T (*)[S::kLd]>(smem);  // [kBM][kLd]
  T (*sb)[S::kLd] =
      reinterpret_cast<T (*)[S::kLd]>(smem + kBM * S::kLd * sizeof(T));
  T (*sc)[S::kLdC] = reinterpret_cast<T (*)[S::kLdC]>(smem);  // [kBM][kLdC]

  const int tid = threadIdx.x;
  const int m0 = (int)(blockIdx.x % m_tiles) * kBM;
  const long long n0 = (long long)(blockIdx.x / m_tiles) * kBN;

  // this thread's pixel column, for the y loads and the z stores
  const int col = tid % kBN;
  const int yrow = tid / kBN;                  // 0..3
  const long long n = n0 + col;
  const bool n_ok = n < N;
  long long ybase = 0, zbase = 0;
  if (n_ok) {
    const long long b = n / HW, p = n % HW;
    ybase = b * C * HW + p;
    zbase = b * K * HW + p;
  }
  // this thread's output channel, for the w loads
  const int wcol = tid % kBM;
  const int wrow = tid / kBM;                  // 0..1
  const bool k_ok = m0 + wcol < K;

  float yv[kYRows];
  T wv[kWRows];
  auto load = [&](int c0) {
#pragma unroll
    for (int i = 0; i < kYRows; ++i) {
      const int c = c0 + yrow + 4 * i;
      float v = 0.f;
      if (n_ok && c < C) {
        v = __fadd_rn(__fmul_rn(to_f(y[ybase + (long long)c * HW]),
                                __ldg(scale + c)),
                      __ldg(bias + c));
        v = fmaxf(v, 0.f);
      }
      yv[i] = v;
    }
#pragma unroll
    for (int i = 0; i < kWRows; ++i) {
      const int c = c0 + wrow + 2 * i;
      wv[i] = (k_ok && c < C) ? w[(long long)c * K + m0 + wcol] : from_f<T>(0.f);
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int m_off = (warp % 4) * 32, n_off = (warp / 4) * 32;
  const int g = lane >> 2, tig = lane & 3;
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  load(0);
  for (int c0 = 0; c0 < C; c0 += kBK) {
    __syncthreads();   // the previous chunk's products are done with smem
#pragma unroll
    for (int i = 0; i < kYRows; ++i) sb[col][yrow + 4 * i] = from_f<T>(yv[i]);
#pragma unroll
    for (int i = 0; i < kWRows; ++i) sa[wcol][wrow + 2 * i] = wv[i];
    __syncthreads();
    if (c0 + kBK < C) load(c0 + kBK);
    chunk_product(sa, sb, m_off, n_off, g, tig, acc);
  }

  __syncthreads();     // the staging area becomes the z tile
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          sc[m_off + mt * 16 + g + 8 * h][n_off + nt * 8 + tig * 2 + j] =
              from_f<T>(acc[mt][nt][h * 2 + j]);
  __syncthreads();
  if (!n_ok) return;
  for (int m = yrow; m < kBM && m0 + m < K; m += kThreads / kBN)
    z[zbase + (long long)(m0 + m) * HW] = sc[m][col];
}

template <typename T>
cudaError_t launch(const void* y, const void* scale, const void* bias,
                   const void* w, void* z, int B, int C, int K, int HW,
                   cudaStream_t stream) {
  const long long N = (long long)B * HW;
  const int m_tiles = (K + kBM - 1) / kBM;
  const long long blocks = m_tiles * ((N + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  bn_relu_conv1x1_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const T*>(w),
      static_cast<T*>(z), C, K, HW, N, m_tiles);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (y, w and z alike).  Returns the CUDA error
// of the launch (0 when it was accepted).
extern "C" int bn_relu_conv1x1(const void* y, const void* scale,
                               const void* bias, const void* w, void* z,
                               int B, int C, int K, int HW, int dtype,
                               void* stream) {
  if (B <= 0 || C <= 0 || K <= 0 || HW <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1 ? launch<__nv_bfloat16>(y, scale, bias, w, z, B, C, K, HW, s)
      : dtype == 0 ? launch<float>(y, scale, bias, w, z, B, C, K, HW, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}
