// The Hopper weight-gradient GEMM of a 3x3 SAME conv: for NHWC input A
// (B, H, W, C) and output gradient G (B, H, W, F), over the pixels p,
//   dk[f, tap * C + c] = sum_p G[p, f] * A[p + (ky - 1, kx - 1), c]
//   db[f]              = sum_p G[p, f]
// in float32, D (F x 9C) = G^T * im2col(A) with the pixels as the
// reduction dimension (csrc/wgrad.cuh's function, on wgmma and TMA).
//
// Operands come straight from TMA boxes of the natural NHWC tensors over
// 8 x 16 pixel patches (a K step of 128 pixels), 128-byte swizzled:
//   A = G^T: two boxes (64 f, 16 x, 8 y, 1 b) at (f0 + 64 w, x0, y0, b), one
//      per consumer warpgroup w: each is M-contiguous (MN-major);
//   B = im2col(A): TN / 64 boxes (64 c, 16 x, 8 y, 1 b) at (c, x0 + kx - 1,
//      y0 + ky - 1, b) for the tap and channels of each 64-column piece of
//      the tile (C % 64 == 0, so a piece never straddles two taps):
//      N-contiguous (MN-major) too.  TMA's zero fill outside the image is
//      the SAME halo.
// wgmma reads both transposed (imm-trans 1): descriptors with SBO = 1024
// (the next 8 pixel rows) and LBO = the distance between 64-column boxes;
// a k16 step advances 16 pixel rows (2048 bytes).
// Tile: 128 f x TN K-columns (TN = 128, or 64 where C % 128 != 0); a
// block reduces one of a fixed number of contiguous ranges of patches
// (split-K, planned on the host to fill the 132 SMs) through a 3-stage
// ring of 64 KB fed by one producer thread, and writes its float32 partial
// tile.  Where F % 128 != 0 the last f tile runs its first warpgroup only.
// The operands stream from L2 at 64 FLOP a byte, which bounds this tile
// as it does the conv core's 128-wide one; on an H100 a 256-wide tile
// (two 96 KB stages, or four of 48 KB over 4 x 16 patches) and a two-block
// cluster multicasting the input boxes both ran slower.  The blocks of the
// first column tile also sum G's columns (the bias gradient) from the
// boxes in shared memory, in a fixed order.  wgrad.cuh's second pass adds
// the partials in split order and writes (F, C, 3, 3): no atomics, so the
// result is bit-identical run to run.
//
// Bound on the H100: operations (2 * 9 * C * F multiply-adds a pixel).
// Shapes: H % 8 == 0, W % 16 == 0, C % 64 == 0, F % 64 == 0.
#pragma once

#include "conv3x3_sm90.cuh"

namespace tu {
namespace sm90 {
namespace {

template <int TN>
struct WgradSmem {
  static constexpr int STAGE = (2 + TN / 64) * BOX_BYTES;  // 2 G boxes + TN / 64 input boxes
  static constexpr int STAGES = RING_BYTES / STAGE;
  static constexpr int SB_OFF = STAGES * STAGE;             // bias partials, 8 floats a thread
  static constexpr int BAR_OFF = SB_OFF + CONSUMERS * 8 * 4;
  static constexpr int DYN = BAR_OFF + 2 * STAGES * 8 + 1024;
};

struct WgradArgs {
  float* part;   // (nsplit, F, 9C)
  float* bpart;  // (nsplit, F)
  int B, H, W, C, F;
};

template <int TN>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_sm90_kernel(const __grid_constant__ CUtensorMap gmap,
                  const __grid_constant__ CUtensorMap amap, WgradArgs p) {
  using S = WgradSmem<TN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + S::STAGES;
  const int tid = threadIdx.x;
  const int K = 9 * p.C;
  const int k0 = blockIdx.x * TN, f0 = blockIdx.y * 128, s = blockIdx.z, ns = gridDim.z;
  const int nwg = p.F - f0 >= 128 ? 2 : 1;  // active consumer warpgroups
  const int tiles_w = p.W / PATCH_W, tiles_hw = (p.H / PATCH_H) * tiles_w;
  const long long npatch = static_cast<long long>(p.B) * tiles_hw;
  const int q_begin = static_cast<int>(s * npatch / ns);
  const int n_it = static_cast<int>((s + 1) * npatch / ns) - q_begin;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128 * nwg);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warpgroup: one thread issues every load
    producer_regs();
    if (tid == CONSUMERS) {
      for (int it = 0; it < n_it; ++it) {
        const int st = it % S::STAGES;
        if (it >= S::STAGES) mbar_wait(&empty[st], ((it / S::STAGES) - 1) & 1);
        const int q = q_begin + it, b = q / tiles_hw, thw = q - b * tiles_hw;
        const int y0 = (thw / tiles_w) * PATCH_H, x0 = (thw % tiles_w) * PATCH_W;
        uint8_t* base = smem + st * S::STAGE;
        mbar_expect_tx(&full[st], (nwg + TN / 64) * BOX_BYTES);
        for (int w = 0; w < nwg; ++w)
          tma_load_4d(base + w * BOX_BYTES, &gmap, &full[st], f0 + 64 * w, x0, y0, b);
#pragma unroll
        for (int h = 0; h < TN / 64; ++h) {
          const int kk = k0 + 64 * h, tap = kk / p.C, c = kk - tap * p.C;
          const int ky = tap / 3, kx = tap - 3 * ky;
          tma_load_4d(base + (2 + h) * BOX_BYTES, &amap, &full[st], c, x0 + kx - 1, y0 + ky - 1,
                      b);
        }
      }
    }
    return;
  }

  consumer_regs();
  const int wg = tid >> 7, lt = tid & 127, lane = tid & 31;
  if (wg >= nwg) return;
  const bool bias = blockIdx.x == 0;
  float acc[TN / 2], bacc[8];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) bacc[j] = 0.f;
  // the bias sums: thread lt reads logical 16-byte chunk lt & 7 (8 channels)
  // of pixel rows lt / 8 + 16 i, found at physical chunk (lt & 7) ^ (row & 7)
  const int bchunk = ((lt & 7) ^ ((lt >> 3) & 7)) * 16;
  for (int it = 0; it < n_it; ++it) {
    const int st = it % S::STAGES;
    mbar_wait(&full[st], (it / S::STAGES) & 1);
    const uint8_t* base = smem + st * S::STAGE;
    const uint64_t da = desc_sw128(base + wg * BOX_BYTES, BOX_BYTES, 1024);
    const uint64_t db = desc_sw128(base + 2 * BOX_BYTES, BOX_BYTES, 1024);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < PATCH / 16; ++k)  // 16 pixel rows (2048 bytes) a step
      wgmma<TN, 1, 1>(acc, da + 128 * k, db + 128 * k, 1);
    wgmma_commit();
    if (bias) {
      const uint8_t* g = base + wg * BOX_BYTES + (lt >> 3) * 128 + bchunk;
#pragma unroll
      for (int i = 0; i < PATCH / 16; ++i) {
        const uint4 u = *reinterpret_cast<const uint4*>(g + i * 16 * 128);
        const bf16* v = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int j = 0; j < 8; ++j) bacc[j] += __bfloat162float(v[j]);
      }
    }
    wgmma_wait<1>();  // the previous step's products are done: release its stage
    if (it > 0) mbar_arrive(&empty[(it - 1) % S::STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  float* out = p.part + static_cast<size_t>(s) * p.F * K;
  const int f = f0 + wg * 64 + (lt >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < TN / 8; ++i) {
    const int k = k0 + 8 * i + 2 * (lane & 3);
    *reinterpret_cast<float2*>(out + static_cast<size_t>(f) * K + k) =
        make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(out + static_cast<size_t>(f + 8) * K + k) =
        make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
  if (bias) {  // the 16 threads of each chunk, added in thread order
    float* sb = reinterpret_cast<float*>(smem + S::SB_OFF) + wg * 128 * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) sb[lt * 8 + j] = bacc[j];
    bar_sync(1, 128 * nwg);
    if (lt < 64) {
      const int chunk = lt >> 3, j = lt & 7;
      float sum = 0.f;
      for (int rr = 0; rr < 16; ++rr) sum += sb[(rr * 8 + chunk) * 8 + j];
      p.bpart[static_cast<size_t>(s) * p.F + f0 + wg * 64 + lt] = sum;
    }
  }
}

template <int TN>
cudaError_t launch_wgrad_tn(const Launch& L, const bf16* gout, const bf16* in,
                            const WgradArgs& a, cudaStream_t stream) {
  using S = WgradSmem<TN>;
  const dim3 grid = L.grid();
  if (static_cast<int>(grid.z) != L.nsplit()) return cudaErrorInvalidConfiguration;
  CUtensorMap mg, ma;
  cudaError_t e = make_map(&mg, gout, L.map(0));
  if (e != cudaSuccess) return e;
  e = make_map(&ma, in, L.map(1));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(wgrad_sm90_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           S::DYN);
  if (e != cudaSuccess) return e;
  wgrad_sm90_kernel<TN><<<grid, THREADS, S::DYN, stream>>>(mg, ma, a);
  return cudaGetLastError();
}

// The GEMM per its launch record (gout (B, H, W, F) under map 0, in
// (B, H, W, C) under map 1), into part / bpart of `work`.
inline cudaError_t launch_wgrad_sm90(const int64_t* record, const bf16* gout, const bf16* in,
                                     const WgradArgs& a, cudaStream_t stream) {
  const Launch L{record};
  if (L.op() != OP_WGRAD) return cudaErrorInvalidConfiguration;
  if (L.tile_n() == 128) return launch_wgrad_tn<128>(L, gout, in, a, stream);
  if (L.tile_n() == 64) return launch_wgrad_tn<64>(L, gout, in, a, stream);
  return cudaErrorInvalidConfiguration;
}

}  // namespace
}  // namespace sm90
}  // namespace tu
