// Shared by the loss kernels, csrc/loss.cu (#27, #29) and
// csrc/loss_logits.cu (#25, #26): the tile of 128 pixels, the per-class
// sums of a tile, a block's partial row, and the second launch that adds
// the blocks' partial rows in block order (no float atomics, so a loss is
// the same on every run).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;          // threads a block = pixels a tile
constexpr int LDP = NT + 1;      // row stride of the per-class tiles [C][LDP]
constexpr int MAX_BLOCKS = 1024; // partial-sum rows (the wrapper allocates them)

// the pixel's clamped target: min(t, C); C is the ignore class
__device__ __forceinline__ int clamp_target(uint8_t t, int C) { return t > C ? C : t; }

// the block's sum of v, valid in thread 0; red holds NT / 32 floats
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < NT / 32; ++w) s += red[w];
  return s;
}

// The per-class dice and f_score sums of a thread over the tiles of its
// block: thread tid sums class tid % C over the pixels tid / C, + NT / C,
// ... of each tile (threads past (NT / C) * C idle).
struct ClassSums {
  float tp = 0.f, ps = 0.f, ts = 0.f, tpt = 0.f, pts = 0.f;

  // P[c * LDP + i]: the tile's probabilities; Ts[i]: its clamped targets
  // (C + 1 and zero probabilities for a pixel past the end)
  __device__ void add(const float* P, const int* Ts, int C) {
    const int G = NT / C, tid = threadIdx.x;
    if (tid >= G * C) return;
    const int cc = tid % C;
    for (int i = tid / C; i < NT; i += G) {
      const float pv = P[cc * LDP + i];
      const bool hit = Ts[i] == cc, pos = pv > 0.5f;
      tp += hit ? pv : 0.f;
      ps += pv;
      ts += hit ? 1.f : 0.f;
      tpt += (hit && pos) ? 1.f : 0.f;
      pts += pos ? 1.f : 0.f;
    }
  }
};

// A block's partial row [s0, s1, tp[C], psum[C], tsum[C], tp@0.5[C],
// pos@0.5[C]]; R holds 5 * NT floats of scratch.
__device__ void write_partial(float* row, float s0, float s1, const ClassSums& a, float* R,
                              int C) {
  const int tid = threadIdx.x, G = NT / C;
  if (tid < G * C) {
    R[0 * NT + tid] = a.tp;
    R[1 * NT + tid] = a.ps;
    R[2 * NT + tid] = a.ts;
    R[3 * NT + tid] = a.tpt;
    R[4 * NT + tid] = a.pts;
  }
  __syncthreads();
  if (tid < C) {
    for (int q = 0; q < 5; ++q) {
      float s = 0.f;
      for (int g = 0; g < G; ++g) s += R[q * NT + g * C + tid];
      row[2 + q * C + tid] = s;
    }
  }
  __syncthreads();
  const float x = block_sum(s0, R);
  const float y = block_sum(s1, R);
  if (tid == 0) {
    row[0] = x;
    row[1] = y;
  }
}

// out[j] = sum over the nb rows of partial[:, j], in row order
__global__ void sum_rows_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                int nb, int M) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= M) return;
  float s = 0.f;
  for (int r = 0; r < nb; ++r) s += partial[static_cast<size_t>(r) * M + j];
  out[j] = s;
}

// blocks of a grid-stride pass over n pixels: one a tile, at most MAX_BLOCKS
inline int blocks_for(long long n) {
  const long long tiles = (n + NT - 1) / NT;
  return static_cast<int>(tiles < MAX_BLOCKS ? tiles : MAX_BLOCKS);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
