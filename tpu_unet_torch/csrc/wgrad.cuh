// The mma.sync weight-gradient GEMM of the up_conv head's backward
// (csrc/upconv.cu; the other training kernels take csrc/wgrad_sm90.cuh):
// for a 3x3 SAME conv with NHWC input A and output gradient G over the
// B * H * W pixels p,
//   dk[f, c, ky, kx] = sum_p G[p, f] * A[p + (ky - 1, kx - 1), c]
//   db[f]            = sum_p G[p, f]
// in float32.  D (F x K) = G^T (F x P) * im2col(A) (P x K) with the pixels
// as the reduction dimension; the im2col operand is gathered by one of the
// forward's loaders (csrc/conv3x3.cuh), so SAME padding gives zero halos
// and the packed K index is the forward's (ky * 3 + kx) * C + c (K = 9C,
// padded to a multiple of 64 with zero columns).
// Both operands are staged pixel-major in shared memory (32 pixels a
// stage, 144-byte rows) and read into the mma.sync m16n8k16 fragments with
// ldmatrix.trans, which transposes 8x8 tiles on the way and reads every
// bank once.  A block owns a 64 (f) x 64 (K) output tile and one of a fixed
// number of contiguous pixel ranges (split-K, sized on the host to fill the
// 132 SMs); it writes its float32 partial tile, and the blocks of the first
// column tile also the float32 column sums of G (the bias gradient) from
// the values they stage.  A second pass adds the partials in split order
// and writes (F, C, 3, 3).  No atomics, so the result is bit-identical run
// to run.  Shapes: H * W * B % 32 == 0, F % 64 == 0, 8 | C.
#pragma once

#include "conv3x3.cuh"

namespace tu {
namespace {

constexpr int WM = 64;      // output channels f per block
constexpr int WN = 64;      // packed K columns (tap * C + c) per block
constexpr int WP = 32;      // pixels per shared-memory stage
constexpr int WLD = 64 + 8; // 144-byte rows: conflict-free ldmatrix
constexpr int WT = 128;     // 4 warps as 2 (f) x 2 (K), 32 x 32 each

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// part (nsplit, F, K) and bpart (nsplit, F) float32, K the padded width;
// grid (K / WN, F / WM, nsplit); the pixels are cut into P / WP chunks of
// consecutive pixels and split s takes chunks [s * n / nsplit,
// (s + 1) * n / nsplit).
template <class Loader>
__global__ void __launch_bounds__(WT)
wgrad_kernel(Loader ld, const bf16* __restrict__ gout, float* __restrict__ part,
             float* __restrict__ bpart, int H, int W, int F, int K, int nchunks) {
  __shared__ __align__(16) bf16 sg[WP * WLD];  // G stage, pixel-major
  __shared__ __align__(16) bf16 sa[WP * WLD];  // A stage, pixel-major
  __shared__ float sb[WT * 8];                 // bias partials
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  const int q = lane >> 3, r8 = lane & 7;
  const int n0 = blockIdx.x * WN, m0 = blockIdx.y * WM, s = blockIdx.z, ns = gridDim.z;
  const int c_begin = static_cast<int>(static_cast<long long>(s) * nchunks / ns);
  const int c_end = static_cast<int>(static_cast<long long>(s + 1) * nchunks / ns);
  const bool bias = blockIdx.x == 0;
  const int hw = H * W;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  float bacc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bacc[j] = 0.f;

  // thread's two (pixel, 8-channel) slots of a stage: pixel v >> 3, sub v & 7
  uint4 rg[2], ra[2];
  auto fetch = [&](int ch) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * WT, sub = v & 7;
      const int p = ch * WP + (v >> 3);
      const int b = p / hw, rem = p - b * hw, y = rem / W, x = rem - y * W;
      rg[i] = *reinterpret_cast<const uint4*>(gout + static_cast<size_t>(p) * F + m0 + sub * 8);
      ra[i] = ld(b, y, x, n0 + sub * 8);
    }
  };

  if (c_begin < c_end) fetch(c_begin);
  for (int ch = c_begin; ch < c_end; ++ch) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * WT, o = (v >> 3) * WLD + (v & 7) * 8;
      *reinterpret_cast<uint4*>(&sg[o]) = rg[i];
      *reinterpret_cast<uint4*>(&sa[o]) = ra[i];
      if (bias) {
        const bf16* gv = reinterpret_cast<const bf16*>(&rg[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) bacc[j] += __bfloat162float(gv[j]);
      }
    }
    __syncthreads();
    if (ch + 1 < c_end) fetch(ch + 1);  // next stage's loads in flight
#pragma unroll
    for (int ks = 0; ks < WP; ks += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)  // (pixels, f) tiles -> A = G^T fragments
        ldsm_x4_trans(af[mi], &sg[(ks + (q >> 1) * 8 + r8) * WLD + wm * 32 + mi * 16 + (q & 1) * 8]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {  // (pixels, K) tiles -> B fragments
        uint32_t tb[4];
        ldsm_x4_trans(tb, &sa[(ks + (q & 1) * 8 + r8) * WLD + wn * 32 + nj * 16 + (q >> 1) * 8]);
        bfr[2 * nj][0] = tb[0];
        bfr[2 * nj][1] = tb[1];
        bfr[2 * nj + 1][0] = tb[2];
        bfr[2 * nj + 1][1] = tb[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();
  }

  float* out = part + static_cast<size_t>(s) * F * K;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int f = m0 + wm * 32 + mi * 16 + g, k = n0 + wn * 32 + ni * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + static_cast<size_t>(f) * K + k) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(out + static_cast<size_t>(f + 8) * K + k) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
  if (bias) {  // the 16 threads of each 8-channel slot, added in thread order
#pragma unroll
    for (int j = 0; j < 8; ++j) sb[tid * 8 + j] = bacc[j];
    __syncthreads();
    if (tid < WM) {
      const int sub = tid >> 3, j = tid & 7;
      float sum = 0.f;
      for (int rr = 0; rr < WT / 8; ++rr) sum += sb[(rr * 8 + sub) * 8 + j];
      bpart[static_cast<size_t>(s) * F + m0 + tid] = sum;
    }
  }
}

// dk (F, C, 3, 3) = sum over splits of part (nsplit, F, K), in split order
// (columns past 9C dropped); db (F) likewise from bpart (nsplit, F).
__global__ void __launch_bounds__(256)
wgrad_reduce_kernel(const float* __restrict__ part, const float* __restrict__ bpart,
                    float* __restrict__ dk, float* __restrict__ db, int F, int C, int K,
                    int nsplit) {
  const size_t n = static_cast<size_t>(F) * K;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx < n) {
    const int f = static_cast<int>(idx / K), k = static_cast<int>(idx % K);
    if (k < 9 * C) {
      float sum = 0.f;
      for (int i = 0; i < nsplit; ++i) sum += part[i * n + idx];
      const int tap = k / C, c = k - tap * C;
      dk[(static_cast<size_t>(f) * C + c) * 9 + tap] = sum;
    }
  }
  if (idx < static_cast<size_t>(F)) {
    float sum = 0.f;
    for (int i = 0; i < nsplit; ++i) sum += bpart[static_cast<size_t>(i) * F + idx];
    db[idx] = sum;
  }
}

// The padded K of a C-channel input; work for a launch holds
// nsplit * F * (wgrad_k(C) + 1) floats.
inline int wgrad_k(int C) { return (9 * C + WN - 1) / WN * WN; }

// Both passes on `stream`: part = work, bpart = work + nsplit * F * K.
template <class Loader>
cudaError_t launch_wgrad(const Loader& ld, const bf16* gout, float* work, float* dk, float* db,
                         int B, int H, int W, int C, int F, int nsplit, cudaStream_t stream) {
  const int K = wgrad_k(C), nchunks = B * H * W / WP;
  float* part = work;
  float* bpart = work + static_cast<size_t>(nsplit) * F * K;
  wgrad_kernel<Loader><<<dim3(K / WN, F / WM, nsplit), WT, 0, stream>>>(ld, gout, part, bpart, H,
                                                                        W, F, K, nchunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t n = static_cast<size_t>(F) * K;
  wgrad_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      part, bpart, dk, db, F, C, K, nsplit);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tu

