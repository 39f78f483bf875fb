// Batch-norm affine + relu folded into a 1x1 convolution, for Hopper
// (sm_90a), plain C interface.
//
// Replaces tools/conv1x1_fuse_probe.py:fused_kernel (called from
// pallas_bn_relu_conv1x1).  Same function: for y [B, C, HW], per-channel
// scale/bias [C] (float32) and w [C, K],
//   a = relu(float(y) * scale + bias), rounded to w's dtype,
//   z[b, k, p] = sum_c w[c, k] * a[b, c, p], summed in float32,
// written in y's dtype as [B, K, HW].  The activation a lives only in
// shared memory: it is never written to device memory, which is the point
// of the kernel.  The product and the sum of the affine are rounded
// separately (__fmul_rn, __fadd_rn), as the plain version's two ops: nvcc
// would otherwise contract them into one FMA.
//
// What bounds it on this card: at ResNet-50's conv3 sites (batch 256,
// bf16) it reads y and w once and writes z once, 66-514 MB against 26.3
// GFLOP, so the 56x56, 28x28 and 14x14 sites are bound by memory bandwidth
// (3.35 TB/s) and the 7x7 one by the bf16 tensor cores (989 TFLOP/s).  The
// Pallas kernel walked a (B, HW/512) grid with the whole of w in VMEM; on
// Hopper a block holds at most 227 KB.  The product is a GEMM with M = K
// (output channels), N = B*HW (every pixel of every image, flattened, so
// HW = 49 or 196 leaves no ragged tile per image) and a reduction over C.
// Two kernels, chosen by dtype in the entry:
//
// bf16, bn_relu_conv1x1_mma_kernel<kPix> (tensor cores, mma.sync m16n8k16,
// fragment helpers in flash_mma.cuh):
//   * a block computes a 128 x 128 tile of z (output channels x pixels)
//     with 8 warps of 64 x 32; the grid walks the output channels fastest,
//     so the blocks that share a y tile run together and its re-reads come
//     from L2;
//   * w, y, scale and bias stream through a 4-stage cp.async ring of
//     32-channel stages, the copy of stage s + 3 issued before stage s's
//     products: w in 16-byte copies along the output channels, y in
//     copies of kPix pixels along the pixel axis;
//   * the affine + relu is applied once per element a block, in shared
//     memory, one stage ahead of the products (so one barrier a stage
//     orders the copies, the transform and the products), and rounded to
//     bf16;
//   * both fragments come from ldmatrix.trans: A (w^T) from the [c][k]
//     tile, B (the activation) from the [c][pixel] tile; rows padded by 16
//     bytes, so ldmatrix is free of bank conflicts;
//   * the z tile is staged through shared memory and written along the
//     pixels in copies of kPix pixels.
//   A (b, c) row of y starts at (b C + c) HW elements, so the pixel chunks
//   stay aligned and inside one image only where HW allows: kPix 8 (16
//   bytes) when HW % 8 == 0 (56x56, 28x28), kPix 4 (8 bytes) when
//   HW % 4 == 0 (14x14).  Otherwise (7x7, HW 49), with C % 8 == 0, the
//   rows c0..c0+31 of one image are one 16-byte aligned run of 32 HW
//   elements: kPix 0 copies that run for every image the tile touches
//   (at most 4 at HW 49) into a region ring, in 16-byte copies, and the
//   transform reads each pixel from it; any other shape takes kPix 1,
//   which copies each pixel's aligned 4-byte word.  Both write z 2 bytes
//   a pixel.  w takes scalar loads when K % 8 != 0.
// float32, bn_relu_conv1x1_kernel (SIMT FMAs in full float32, no TF32):
//   128 x 64 tiles, 8 warps of 32 x 32, 32-channel chunks transformed in
//   registers as they are loaded and stored transposed into shared memory,
//   the next chunk's loads issued before this chunk's products.
// Channels past C read as 0 on both operands, pixels past B*HW and output
// channels past K are masked.  wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

// ------------------------------------------------ float32: SIMT kernel

constexpr int kBM = 128;   // output channels per block
constexpr int kBN = 64;    // pixels per block
constexpr int kBK = 32;    // input channels per chunk
constexpr int kThreads = 256;
constexpr int kYRows = kBK * kBN / kThreads;  // y elements a thread loads
constexpr int kWRows = kBK * kBM / kThreads;  // w elements a thread loads

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

template <typename T> struct Smem {
  static constexpr int kLd = kBK + 4;                          // staging row
  static constexpr int kLdC = kBN + 4;                         // z tile row
  static constexpr int kStage = (kBM + kBN) * kLd * (int)sizeof(T);
  static constexpr int kOut = kBM * kLdC * (int)sizeof(T);
  static constexpr int kBytes = kStage > kOut ? kStage : kOut;
};

// acc[mt][nt][4] holds the m16n8 accumulator fragment layout: element
// (h * 2 + j) is row g + 8 h, column tig * 2 + j of that sub-tile.
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


// -------------------------------------------------- bf16: tensor cores

namespace fm = flash_mma;

constexpr int kMmaBM = 128;       // output channels a block
constexpr int kMmaBN = 128;       // pixels a block
constexpr int kMmaBK = 32;        // input channels a stage
constexpr int kMmaThreads = 256;  // 8 warps: 2 along K x 4 along the pixels
constexpr int kLdA = kMmaBM + 8;  // padded shared rows, bf16
constexpr int kLdB = kMmaBN + 8;
// the image-region path takes images of at most this many pixels
constexpr int kRegionMaxHW = 128;

// kPix, how y reaches shared memory: 8 or 4 pixels a copy (16 or 8
// bytes, in place), 1 (a pixel's aligned 4-byte word into a word ring),
// 0 (the whole [32][HW] region of each image the tile touches, in 16-byte
// copies, into a region ring sized at launch)
template <int kPix>
struct MmaCfg {
  static constexpr bool kInPlace = kPix >= 4;
  static constexpr int kStages = 4;
  static constexpr int kStore = kInPlace ? kPix : 1;  // pixels a z store
  static constexpr int kChunks = kMmaBN / kStore;     // stores a channel row
  static constexpr int kRowStep = kMmaThreads / kChunks;
  // y copies of a thread a stage (kPix 8, 4, 1: the store mapping)
  static constexpr int kCopies = kMmaBK * kChunks / kMmaThreads;
  static constexpr int kA = kMmaBK * kLdA;          // bf16 of a w stage
  static constexpr int kB = kMmaBK * kLdB;          // bf16 of a y stage
  // y stages: kStages in place, or 2 beside a word or region ring
  static constexpr int kBStages = kInPlace ? kStages : 2;
  static constexpr int kWords = kPix == 1 ? kMmaBK * kMmaBN : 0;
  // w and y stages, the word ring, then scale and bias of each stage
  static constexpr size_t kFixed =
      2 * (size_t)(kStages * kA + kBStages * kB) +
      4 * (size_t)kStages * (kWords + 2 * kMmaBK);
  static constexpr size_t kOut = 2 * (size_t)kMmaBM * kLdB;  // the z tile
};

// a (float32) -> relu(a * scale + bias), rounded like the plain version
__device__ __forceinline__ float affine_relu(float y, float sc, float bi) {
  return fmaxf(__fadd_rn(__fmul_rn(y, sc), bi), 0.f);
}

// kPix / 2 packed bf16 pairs transformed in place; all zero when !live
template <int kPix>
__device__ __forceinline__ void transform_pairs(uint32_t* p, float sc,
                                                float bi, bool live) {
#pragma unroll
  for (int i = 0; i < kPix / 2; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
    p[i] = live ? fm::pack_bf16(affine_relu(f.x, sc, bi),
                                affine_relu(f.y, sc, bi))
                : 0u;
  }
}

template <int kPix>
__global__ void __launch_bounds__(kMmaThreads, 2)
bn_relu_conv1x1_mma_kernel(const fm::bf16* __restrict__ y,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           const fm::bf16* __restrict__ w,
                           fm::bf16* __restrict__ z, int C, int K, int HW,
                           long long N, int m_tiles, int region) {
  using Cfg = MmaCfg<kPix>;
  constexpr int NS = Cfg::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fm::bf16* As = reinterpret_cast<fm::bf16*>(smem_raw);  // [NS][BK][kLdA]
  fm::bf16* Bs = As + NS * Cfg::kA;                       // [kBStages][BK][kLdB]
  uint32_t* Ws = reinterpret_cast<uint32_t*>(Bs + Cfg::kBStages * Cfg::kB);
  float* SBs = reinterpret_cast<float*>(Ws + NS * Cfg::kWords);  // [NS][2][BK]
  fm::bf16* Rs = reinterpret_cast<fm::bf16*>(SBs + NS * 2 * kMmaBK);
  fm::bf16* Zs = As;  // [BM][kLdB] after the last stage

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = (int)(blockIdx.x % m_tiles) * kMmaBM;
  const long long n0 = (long long)(blockIdx.x / m_tiles) * kMmaBN;
  const long long total = N * C;  // elements of y

  // this thread's pixel chunk of the z stores (and, for kPix 8, 4, 1, of
  // the y copies)
  const int pc = tid % Cfg::kChunks;
  const int row0 = tid / Cfg::kChunks;
  const long long n = n0 + (long long)pc * Cfg::kStore;
  const bool n_ok = n < N;  // a chunk never straddles N: N % kStore == 0
  long long ybase = 0, zbase = 0;
  if (n_ok) {
    const long long b = n / HW, p = n % HW;
    ybase = b * C * HW + p;
    zbase = b * K * HW + p;
  }
  // kPix 0: the images this tile touches, and each of this thread's four
  // transform pixels (pairs 2 lane, +1 and 64 + 2 lane, +1 of rows
  // warp + 8 i) as an offset into a region stage
  const long long b_first = n0 / HW;
  const int n_img =
      (int)(min(N / HW, (n0 + kMmaBN - 1) / HW + 1) - b_first);
  int px_off[4] = {0, 0, 0, 0};
  bool px_ok[4] = {false, false, false, false};
  if constexpr (kPix == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long nq = n0 + 2 * lane + 64 * (q >> 1) + (q & 1);
      px_ok[q] = nq < N;
      if (px_ok[q])
        px_off[q] = (int)(nq / HW - b_first) * kMmaBK * HW + (int)(nq % HW);
    }
  }
  const bool w16 = K % 8 == 0;  // w rows as 16-byte copies
  const int n_stages = (C + kMmaBK - 1) / kMmaBK;

  // w, y, scale and bias of stage s into ring slot s % NS; nothing past
  // the last stage, but a group is committed anyway so that the wait
  // counts line up
  auto issue = [&](int s) {
    if (s < n_stages) {
      const int c0 = s * kMmaBK;
      fm::bf16* a_st = As + (s % NS) * Cfg::kA;
      if (tid < 2 * kMmaBK) {
        const int c = c0 + (tid & (kMmaBK - 1));
        const float* src = tid < kMmaBK ? scale : bias;
        fm::cp_async4(SBs + (s % NS) * 2 * kMmaBK + tid, c < C ? src + c : src,
                      c < C);
      }
      if (w16) {
#pragma unroll
        for (int i = 0; i < kMmaBK * kMmaBM / 8 / kMmaThreads; ++i) {
          const int e = tid + i * kMmaThreads;
          const int r = e / (kMmaBM / 8), mc = (e % (kMmaBM / 8)) * 8;
          const bool in = c0 + r < C && m0 + mc < K;
          fm::cp_async16(a_st + r * kLdA + mc,
                         in ? w + (long long)(c0 + r) * K + m0 + mc : w, in);
        }
      } else {
        for (int e = tid; e < kMmaBK * kMmaBM; e += kMmaThreads) {
          const int r = e / kMmaBM, mc = e % kMmaBM;
          a_st[r * kLdA + mc] = c0 + r < C && m0 + mc < K
                                    ? w[(long long)(c0 + r) * K + m0 + mc]
                                    : __float2bfloat16(0.f);
        }
      }
      if constexpr (kPix == 0) {
        // rows c0..c0+rows of an image are one run of rows * HW elements,
        // 16-byte aligned and a multiple of 8 long (C % 8 == 0)
        fm::bf16* reg = Rs + (s % NS) * region;
        const int per = min(kMmaBK, C - c0) * HW / 8;
        for (int k = tid; k < n_img * per; k += kMmaThreads) {
          const int i = k / per, q = k % per;
          fm::cp_async16(reg + i * kMmaBK * HW + q * 8,
                         y + ((b_first + i) * C + c0) * HW + q * 8, true);
        }
      } else {
#pragma unroll
        for (int i = 0; i < Cfg::kCopies; ++i) {
          const int r = row0 + i * Cfg::kRowStep;
          const bool in = n_ok && c0 + r < C;
          const long long e = ybase + (long long)(c0 + r) * HW;
          if constexpr (kPix == 8) {
            fm::cp_async16(Bs + (s % NS) * Cfg::kB + r * kLdB + pc * 8,
                           in ? y + e : y, in);
          } else if constexpr (kPix == 4) {
            fm::cp_async8(Bs + (s % NS) * Cfg::kB + r * kLdB + pc * 4,
                          in ? y + e : y, in);
          } else {
            uint32_t* dst = Ws + (s % NS) * Cfg::kWords + r * kMmaBN + pc;
            // the aligned word holding element e; the last element of an
            // odd-sized y has no word inside y, so it is read alone
            if (in && (e & 1) == 0 && e + 1 == total) {
              *dst = __bfloat16_as_ushort(y[e]);
            } else {
              fm::cp_async4(dst, in ? y + (e & ~1LL) : y, in);
            }
          }
        }
      }
    }
    fm::cp_async_commit();
  };

  // the activation of stage s (after a barrier: from any thread's
  // copies): in place (kPix 8, 4), or into y slot s & 1 from the word
  // ring (kPix 1) or the region ring (kPix 0)
  auto transform = [&](int s) {
    const int c0 = s * kMmaBK;
    const float* sb = SBs + (s % NS) * 2 * kMmaBK;
    if constexpr (kPix == 0) {
      const fm::bf16* reg = Rs + (s % NS) * region;
      fm::bf16* bs = Bs + (s & 1) * Cfg::kB;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = warp + 8 * i;
        const bool live = c0 + r < C;
        const float sc = sb[r], bi = sb[kMmaBK + r];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          float a[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int q = 2 * h2 + j;
            a[j] = live && px_ok[q]
                       ? affine_relu(__bfloat162float(reg[px_off[q] + r * HW]),
                                     sc, bi)
                       : 0.f;
          }
          *reinterpret_cast<uint32_t*>(bs + r * kLdB + 2 * lane + 64 * h2) =
              fm::pack_bf16(a[0], a[1]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < Cfg::kCopies; ++i) {
        const int r = row0 + i * Cfg::kRowStep, c = c0 + r;
        const bool live = n_ok && c < C;
        const float sc = sb[r], bi = sb[kMmaBK + r];
        if constexpr (kPix == 1) {
          const uint32_t word = Ws[(s % NS) * Cfg::kWords + r * kMmaBN + pc];
          const long long e = ybase + (long long)c * HW;
          const unsigned short bits =
              (unsigned short)(e & 1 ? word >> 16 : word);
          const float a = affine_relu(
              __bfloat162float(__ushort_as_bfloat16(bits)), sc, bi);
          Bs[(s & 1) * Cfg::kB + r * kLdB + pc] =
              __float2bfloat16(live ? a : 0.f);
        } else {
          transform_pairs<kPix>(
              reinterpret_cast<uint32_t*>(Bs + (s % NS) * Cfg::kB +
                                          r * kLdB + pc * kPix),
              sc, bi, live);
        }
      }
    }
  };

  // warp tile: output channels wm*64..+63 x pixels wn*32..+31
  const int wm = warp & 1, wn = warp >> 1;
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // the transform runs one stage ahead of the products, so that one
  // barrier a stage orders both: at stage s, stage s+1's copies have
  // landed and stage s's activation is complete in every warp
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) issue(s);
  fm::cp_async_wait<NS - 2>();
  __syncthreads();
  transform(0);
  for (int s = 0; s < n_stages; ++s) {
    fm::cp_async_wait<NS - 3>();  // this thread's copies of stage s+1
    __syncthreads();  // ... everyone's; stage s transformed; s-1 consumed
    if (s + 1 < n_stages) transform(s + 1);
    issue(s + NS - 1);
    const fm::bf16* a_st = As + (s % NS) * Cfg::kA;
    const fm::bf16* b_st =
        Bs + (Cfg::kInPlace ? s % NS : s & 1) * Cfg::kB;
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t af[4][4], bf[2][4];
      // A = w^T from the [c][k] tile, B = a from the [c][pixel] tile, both
      // by ldmatrix.trans
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        fm::ldmatrix_x4_trans(
            af[mt], fm::b_pair(a_st, kLdA, 16 * kk, wm * 64 + 16 * mt, lane));
#pragma unroll
      for (int np = 0; np < 2; ++np)
        fm::ldmatrix_x4_trans(
            bf[np], fm::bt_pair(b_st, kLdB, 16 * kk, wn * 32 + 16 * np, lane));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          fm::mma_bf16(acc[mt][2 * np], af[mt], bf[np][0], bf[np][1]);
          fm::mma_bf16(acc[mt][2 * np + 1], af[mt], bf[np][2], bf[np][3]);
        }
    }
  }

  // the z tile through shared memory (the ring is free once every copy
  // has landed and every warp is past its last products)
  fm::cp_async_wait<0>();
  __syncthreads();
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<uint32_t*>(
            Zs + (wm * 64 + 16 * mt + g + 8 * hr) * kLdB + wn * 32 + 8 * nt +
            2 * t4) = fm::pack_bf16(acc[mt][nt][2 * hr], acc[mt][nt][2 * hr + 1]);
  __syncthreads();
  if (!n_ok) return;
  for (int m = row0; m < kMmaBM && m0 + m < K; m += Cfg::kRowStep) {
    const fm::bf16* src = Zs + m * kLdB + pc * Cfg::kStore;
    fm::bf16* dst = z + zbase + (long long)(m0 + m) * HW;
    if constexpr (kPix == 8) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else if constexpr (kPix == 4) {
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
    } else {
      *dst = *src;
    }
  }
}

// ------------------------------------------------------------ launches

cudaError_t launch_f32(const void* y, const void* scale, const void* bias,
                       const void* w, void* z, int B, int C, int K, int HW,
                       cudaStream_t stream) {
  const long long N = (long long)B * HW;
  const int m_tiles = (K + kBM - 1) / kBM;
  const long long blocks = m_tiles * ((N + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  bn_relu_conv1x1_kernel<float><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(y), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(w),
      static_cast<float*>(z), C, K, HW, N, m_tiles);
  return cudaGetLastError();
}

template <int kPix>
cudaError_t launch_mma(const void* y, const void* scale, const void* bias,
                       const void* w, void* z, int B, int C, int K, int HW,
                       cudaStream_t stream) {
  using Cfg = MmaCfg<kPix>;
  // kPix 0: a region stage holds the [32][HW] rows of every image a
  // 128-pixel tile can touch
  const int region =
      kPix == 0 ? ((kMmaBN - 1 + HW - 1) / HW + 1) * kMmaBK * HW : 0;
  size_t smem = Cfg::kFixed + 2 * (size_t)Cfg::kStages * region;
  if (smem < Cfg::kOut) smem = Cfg::kOut;
  const long long N = (long long)B * HW;
  const int m_tiles = (K + kMmaBM - 1) / kMmaBM;
  const long long blocks = m_tiles * ((N + kMmaBN - 1) / kMmaBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      bn_relu_conv1x1_mma_kernel<kPix>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  bn_relu_conv1x1_mma_kernel<kPix>
      <<<(unsigned)blocks, kMmaThreads, smem, stream>>>(
          static_cast<const fm::bf16*>(y), static_cast<const float*>(scale),
          static_cast<const float*>(bias), static_cast<const fm::bf16*>(w),
          static_cast<fm::bf16*>(z), C, K, HW, N, m_tiles, region);
  return cudaGetLastError();
}

}  // namespace

// y [B, C, HW], w [C, K] and z [B, K, HW] contiguous, scale/bias [C]
// float32.  dtype: 0 float32, 1 bfloat16 (y, w and z alike; y, w and z
// must start on 16 bytes, else cudaErrorMisalignedAddress).  Returns the
// CUDA error of the launch (0 when it was accepted).
extern "C" int bn_relu_conv1x1(const void* y, const void* scale,
                               const void* bias, const void* w, void* z,
                               int B, int C, int K, int HW, int dtype,
                               void* stream) {
  if (B <= 0 || C <= 0 || K <= 0 || HW <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_f32(y, scale, bias, w, z, B, C, K, HW, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (!fm::aligned16(y, 0, 0) || !fm::aligned16(w, 0, 0) ||
      !fm::aligned16(z, 0, 0))
    return (int)cudaErrorMisalignedAddress;
  if (HW % 8 == 0)
    return (int)launch_mma<8>(y, scale, bias, w, z, B, C, K, HW, s);
  if (HW % 4 == 0)
    return (int)launch_mma<4>(y, scale, bias, w, z, B, C, K, HW, s);
  if (C % 8 == 0 && HW <= kRegionMaxHW)
    return (int)launch_mma<0>(y, scale, bias, w, z, B, C, K, HW, s);
  return (int)launch_mma<1>(y, scale, bias, w, z, B, C, K, HW, s);
}
